"""Device time from the card: the profiler's trace of a stretch of the run,
read into device operations and host spans, and the CUDA-event timer behind
a held stream for when the profiler sees no device time. ``union_us`` and
``held_events_ms`` are frozen copies of the repo's ``chip_smoke.py``
helpers of those names."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch


def union_us(spans, lo, hi):
    """Microseconds of [lo, hi] covered by the (start, end) spans, sorted by start."""
    total, cur = 0.0, lo
    for a, b in spans:
        a, b = max(a, cur), min(b, hi)
        if b > a:
            total += b - a
            cur = b
    return total


_SLEEP_CYCLES_PER_MS = []


def held_events_ms(fn, reps):
    """Device time of one call of fn by CUDA events: a sleep kernel holds the
    stream while reps calls are queued behind it, so the events around them
    time the card's work without the host's gaps. If the card reached the
    first call before the last was queued, the hold doubles and it runs
    again; it raises if that never holds."""

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    if not _SLEEP_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        a, b = events()
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / a.elapsed_time(b))
    hold_ms = 5.0
    for _ in range(6):
        start, end = events()
        torch.cuda._sleep(int(hold_ms * _SLEEP_CYCLES_PER_MS[0]))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        hold_ms *= 2
    raise AssertionError(f"held_events_ms: the card ran ahead of the host even behind a {hold_ms / 2:.0f} ms hold")


@dataclass
class Trace:
    """A profiled stretch, times in microseconds on the profiler's clock:
    ``device`` (name, start, end) of every kernel, copy and set on the card,
    sorted by start; ``spans`` {name: sorted [(start, end)]} of the
    benchmark's host spans, names from the outermost to the innermost
    (see ``spans.py``); ``lo``/``hi`` the stretch's own span."""

    device: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    lo: float = 0.0
    hi: float = 0.0

    @property
    def wall_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        """Time in [lo, hi] in which a device operation ran."""
        return union_us([(a, b) for _, a, b in self.device], self.lo, self.hi)

    def kernel_us(self, match) -> float:
        """Summed durations of the device operations whose names contain one
        of ``match``."""
        return sum(b - a for n, a, b in self.device if any(m in n for m in match))

    def top_ops(self, k=10):
        total = {}
        for n, a, b in self.device:
            total[n] = total.get(n, 0.0) + (b - a)
        return sorted(total.items(), key=lambda kv: -kv[1])[:k]

    def open_span(self, t: float) -> str:
        """The innermost host span open at time t, ``host`` when none."""
        found = "host"
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                found = name
        return found

    def idle_gaps(self, k=10):
        """The card's idle time in [lo, hi], each gap named by the innermost
        host span open at its middle, summed by name."""
        by_name, cur = {}, self.lo
        for _, a, b in self.device + [("end", self.hi, self.hi)]:
            a = min(a, self.hi)
            if a > cur:
                name = self.open_span(0.5 * (a + cur))
                by_name[name] = by_name.get(name, 0.0) + (a - cur)
            cur = max(cur, b)
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:k]


def read_profile(prof, span_names, stretch: str) -> Trace:
    """The profiler's events as a ``Trace`` of the host span ``stretch``;
    ``span_names`` from the outermost to the innermost."""
    dev, spans = [], {n: [] for n in span_names}
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.name() in spans:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                spans[e.name()].append((a, b))
        elif e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            dev.append((e.name(), a, b))
    dev.sort(key=lambda x: x[1])
    for ivs in spans.values():
        ivs.sort()
    own = spans.pop(stretch, [])
    lo, hi = own[0] if own else (0.0, 0.0)
    return Trace(device=dev, spans=spans, lo=lo, hi=hi)
