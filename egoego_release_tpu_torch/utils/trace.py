"""The program's span recorder: where the host's time goes, from the eval
driver down to each kernel launch, on the clock ``torch.profiler`` stamps
its events with.

A span has a name (``NAMES``), a start and an end in Unix-epoch
nanoseconds (``time.time_ns``, the clock of the profiler's events, so a
span and the card's operations in one profile line up gap by gap), the span
it opened inside (its parent, -1 for none), the index of its batch in the
driver call (inherited from the parent, -1 outside a driver call) and a
tag (the kernel's name on a launch span). Spans are kept in memory as
packed rows of ``ROW.size`` (27) bytes, recorded from one thread.

The recorder is on while ``enable()`` holds it on, and for the length of a
driver call (``eval/pipeline.py run_batches_pipelined``) or a window chain
or window (``diffusion/gaussian_diffusion.py``) that begins while a
``torch.profiler`` profile records (``entry``). While ``torch.export``
traces, it records nothing. Off, a span costs one test of ``ON``: the step
and launch spans are written as inline tests of it (``begin`` / ``end``,
``leaf``, ``launch``), the driver and window spans as ``span`` blocks,
which while a profiler records also open a ``record_function`` range of
the span's name, so a Chrome trace names them.

Spans (the layer that records each):

  driver.prefetch     eval/pipeline.py: a batch's GT FK, floors, uploads
    driver.stage1       and, in stage-1 mode, stage 1
  driver.prechain     the batch's chain conditioning (``_prechain``)
  driver.chain        the chain and the FK of its output
  driver.metrics      the metric suite's dispatch
  driver.copy         the pinned buffer, the device-to-host copy, the event
  driver.collect      a batch's collection: the wait for its copy
    driver.wait         (``done.synchronize()``) and the unpacking
  window              diffusion/gaussian_diffusion.py ``_sample_window``
    window.canonicalize the canonical frame and the masks
    window.loop         the reverse chain (``_loop``)
      loop.setup          ops/fused_step.py: draws, masks, scalars,
                          embeddings and the packed A before the first step
      step.noise          a step's noise draw
      step                one reverse step (``fused_denoise_step``)
        launch.args         ops/cuda_kernels.py: a launch's checks and
                            argument struct; tag = its kernel (a replayed
                            step: the copy of its step-table row, tag
                            "step_graph")
        launch.entry        the launch through the C entry; tag = its kernel
                            (a replayed step: the graph's launch)
    window.decode       the model's output back to motion
  window.inpaint_fk   the FK re-projection of the overlap for the next window
  window.stitch       the head-continuity move and the concatenations

``spans()`` gives the records as arrays, ``summary`` each name's count,
total and self time (what ``utils/logging.profile_trace`` writes as
``spans.json``), ``clear()`` empties the buffer.
"""

from __future__ import annotations

import functools
import struct
import time

import numpy as np
import torch

NAMES = ("driver.prefetch", "driver.stage1", "driver.prechain", "driver.chain", "driver.metrics", "driver.copy",
         "driver.collect", "driver.wait", "window", "window.canonicalize", "window.loop", "window.decode",
         "window.inpaint_fk", "window.stitch", "loop.setup", "step.noise", "step", "launch.args", "launch.entry")
_ID = {n: i for i, n in enumerate(NAMES)}
_ARGS, _ENTRY = _ID["launch.args"], _ID["launch.entry"]

# one row: start, end, parent, batch, tag, name
ROW = struct.Struct("<qqiiHB")
_LAUNCH = struct.Struct("<" + 2 * "qqiiHB")
_END = struct.Struct("<q")
DTYPE = np.dtype({"names": ["start_ns", "end_ns", "parent", "batch", "tag", "name"],
                  "formats": ["<i8", "<i8", "<i4", "<i4", "<u2", "u1"],
                  "offsets": [0, 8, 16, 20, 24, 26], "itemsize": ROW.size})

ON = False
now = time.time_ns

_rows = bytearray()
_open: list[tuple[int, int]] = []  # (row, batch) of each open span, outermost first
_TAGS = [""]
_TAG_ID = {"": 0}


def enable() -> None:
    """Record spans until ``disable()``."""
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def clear() -> None:
    """Forget every recorded span."""
    _rows.clear()
    _open.clear()


def _new_tag(tag: str) -> int:
    _TAG_ID[tag] = len(_TAGS)
    _TAGS.append(tag)
    return _TAG_ID[tag]


def begin(name: str, batch: int = -1) -> int:
    """Open a span ``name`` inside the innermost open one (of its batch
    unless ``batch`` is given) and return its row for ``end``."""
    parent, inherited = _open[-1] if _open else (-1, -1)
    row = len(_rows) // ROW.size
    _rows.extend(ROW.pack(now(), 0, parent, inherited if batch < 0 else batch, 0, _ID[name]))
    _open.append((row, inherited if batch < 0 else batch))
    return row


def end(row: int) -> None:
    """End the span of ``row``, and any left open inside it (by an exception)."""
    if row * ROW.size < len(_rows):  # not forgotten by ``clear``
        _END.pack_into(_rows, row * ROW.size + 8, now())
    while _open and _open[-1][0] >= row:
        _open.pop()


def leaf(name: str, start: int) -> None:
    """A span ``name`` from ``start`` to now, with no span inside it."""
    parent, batch = _open[-1] if _open else (-1, -1)
    _rows.extend(ROW.pack(start, now(), parent, batch, 0, _ID[name]))


def launch(kernel: str, start: int, entry: int) -> None:
    """One launch of ``kernel``: ``launch.args`` from ``start`` to
    ``entry``, then ``launch.entry`` from ``entry`` to now."""
    parent, batch = _open[-1] if _open else (-1, -1)
    tag = _TAG_ID.get(kernel) or _new_tag(kernel)
    _rows.extend(_LAUNCH.pack(start, entry, parent, batch, tag, _ARGS, entry, now(), parent, batch, tag, _ENTRY))


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "batch", "row", "rf")

    def __init__(self, name: str, batch: int):
        self.name, self.batch, self.rf = name, batch, None

    def __enter__(self):
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.row = begin(self.name, self.batch)

    def __exit__(self, *exc):
        end(self.row)
        if self.rf is not None:
            self.rf.__exit__(*exc)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL = _Null()


def span(name: str, batch: int = -1):
    """A driver- or window-level span over a ``with`` block; nothing when off."""
    return _Span(name, batch) if ON else _NULL


class _Switch:
    __slots__ = ("state", "saved")

    def __init__(self, state: bool):
        self.state = state

    def __enter__(self):
        global ON
        self.saved, ON = ON, self.state

    def __exit__(self, *exc):
        global ON
        ON = self.saved


def paused():
    """The recorder held off for a ``with`` block: what runs there is not
    the program's own work (a reverse step's capture, ops/fused_step.py)."""
    return _Switch(False) if ON else _NULL


def entry():
    """The recorder's switch at a driver call or window: on for its length
    when a profiler records, off while ``torch.export`` traces; otherwise
    as it was."""
    if torch.compiler.is_exporting():
        return _Switch(False) if ON else _NULL
    if not ON and _profiling():
        return _Switch(True)
    return _NULL


def entered(fn):
    """``fn`` with the recorder's switch (``entry``) around each call."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with entry():
            return fn(*args, **kwargs)
    return wrapped


def spanned(name: str):
    """A decorator: a span ``name`` (``span``) around each call."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return wrap


def spans() -> dict:
    """The records, in the order they were opened: ``name`` and ``tag``
    (str), ``start_ns`` and ``end_ns`` (an end of 0: not closed),
    ``parent`` (an index into these arrays, -1 for none) and ``batch``."""
    rec = np.frombuffer(bytes(_rows), dtype=DTYPE)
    return {"name": np.asarray(NAMES)[rec["name"]], "tag": np.asarray(_TAGS)[rec["tag"]],
            "start_ns": rec["start_ns"].astype(np.int64), "end_ns": rec["end_ns"].astype(np.int64),
            "parent": rec["parent"].astype(np.int64), "batch": rec["batch"].astype(np.int64)}


def self_ns(rec: dict) -> np.ndarray:
    """Each span's duration less its children's durations."""
    dur = np.where(rec["end_ns"] > 0, rec["end_ns"] - rec["start_ns"], 0)
    inner = np.zeros_like(dur)
    child = rec["parent"] >= 0
    np.add.at(inner, rec["parent"][child], dur[child])
    return dur - inner


def summary(since_ns: int = 0) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} of the closed spans that
    began at or after ``since_ns``."""
    rec = spans()
    own = self_ns(rec)
    keep = (rec["start_ns"] >= since_ns) & (rec["end_ns"] > 0)
    out = {}
    for name in NAMES:
        sel = keep & (rec["name"] == name)
        if sel.any():
            out[name] = {"count": int(sel.sum()),
                         "total_ms": float((rec["end_ns"][sel] - rec["start_ns"][sel]).sum() / 1e6),
                         "self_ms": float(own[sel].sum() / 1e6)}
    return out
