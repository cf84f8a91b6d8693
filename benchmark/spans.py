"""The benchmark's wrappers around the program's layers: host spans (with
``--trace 1``) and the capture of what the timed path produced, for the
check. They are installed from here and removed after; nothing in the
program is edited.

Spans, from the outermost to the innermost:

  run_batches_pipelined    the driver (eval/pipeline.py), one call a group of batches
  stage2_generate_batched  one batch's chain (eval/pipeline.py EgoEgoPipeline)
  sample_window            one window: canonicalize, reverse loop, decode
                           (diffusion/gaussian_diffusion.py CondGaussianDiffusion._sample_window)
  reverse_loop             its reverse chain (CondGaussianDiffusion._loop)
  denoise_step             one reverse step's wrapper calls (ops/fused_step.py fused_denoise_step)
"""

from __future__ import annotations

import contextlib
import time

import torch

SPANS = ("run_batches_pipelined", "stage2_generate_batched", "sample_window", "reverse_loop", "denoise_step")


class Spans:
    """Host seconds of each span; while ``profiling``, each span is also a
    ``torch.profiler.record_function`` range, so the trace can name what
    the host was doing."""

    def __init__(self):
        self.seconds = {n: [] for n in SPANS}
        self.profiling = False

    def span(self, name):
        return _Span(self, name)

    def wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


class _Span:
    def __init__(self, spans, name):
        self.spans, self.name, self.rf = spans, name, None

    def __enter__(self):
        if self.spans.profiling:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.spans.seconds[self.name].append(time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)


@contextlib.contextmanager
def layer_spans(spans: Spans, pipeline):
    """Wrap the program's sampler layers and the pipeline's chain in spans."""
    from egoego_release_tpu_torch.diffusion import gaussian_diffusion as gd
    from egoego_release_tpu_torch.ops import fused_step as fs

    cls = gd.CondGaussianDiffusion
    saved = [(cls, "_sample_window", cls._sample_window), (cls, "_loop", cls._loop),
             (fs, "fused_denoise_step", fs.fused_denoise_step),
             (pipeline, "stage2_generate_batched", pipeline.stage2_generate_batched)]
    cls._sample_window = spans.wrap("sample_window", cls._sample_window)
    cls._loop = spans.wrap("reverse_loop", cls._loop)
    fs.fused_denoise_step = spans.wrap("denoise_step", fs.fused_denoise_step)
    pipeline.stage2_generate_batched = spans.wrap("stage2_generate_batched", pipeline.stage2_generate_batched)
    try:
        yield spans
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


class Capture:
    """What the timed path produced for each batch: the chain's ``local_aa``
    and ``root_pos`` at ``stage2_generate_batched``'s return and the FK
    positions (``jpos``) the eval path computes from them. It keeps the
    tensors themselves (the program writes neither again), so that it
    neither copies nor waits for the card inside the window; the check
    reads its rows after the window. ``batch`` counts the chains as they
    are dispatched."""

    def __init__(self):
        self.batch = 0
        self.out = {}

    @contextlib.contextmanager
    def installed(self, pipeline):
        gen, fk = pipeline.stage2_generate_batched, pipeline.fk

        def stage2(head_poses, *args, **kwargs):
            local_aa, root_pos = gen(head_poses, *args, **kwargs)
            self.out[self.batch] = {"local_aa": local_aa, "root_pos": root_pos}
            self.batch += 1
            return local_aa, root_pos

        def fk_out(root_pos, local_aa):
            jrot, jpos = fk(root_pos, local_aa)
            self.out[self.batch - 1]["jpos"] = jpos
            return jrot, jpos

        pipeline.stage2_generate_batched, pipeline.fk = stage2, fk_out
        try:
            yield self
        finally:
            pipeline.stage2_generate_batched, pipeline.fk = gen, fk
