"""The port's span recorder (egoego_release_tpu_torch/utils/trace.py) on the
CPU: off it records nothing and costs a test of a flag a span; on, spans
nest with their parents and batches; under ``torch.profiler`` it turns
itself on at the driver's and a window's entry, on the profiler's clock;
while ``torch.export`` traces it records nothing. The test marked ``cuda``
counts a bf16 reverse step's launch spans on the card:

    python -m pytest tests/test_torch_trace.py -q --noconftest
"""

import json
import timeit

import numpy as np
import pytest
import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig, NormStats
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline, run_batches_pipelined
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_step as fs
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.utils import trace
from egoego_release_tpu_torch.utils.logging import profile_trace

# 20 frames: a 12-frame window and one more of 12 (stride 8); 4 steps each
CFG = dict(d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=4, overlap_frames=4)
N_BATCHES, N_SEQS, FRAMES, WINDOWS = 2, 2, 20, 2


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def make_pipeline(cfg=CFG):
    diff = CondGaussianDiffusion(DiffusionConfig(**cfg), device="cpu", seed=0)
    rest = torch.from_numpy(np.random.RandomState(0).randn(22, 3).astype(np.float32) * 0.1)
    rest[0] = 0.0
    return EgoEgoPipeline(diff, NormStats(torch.full((22, 3), -3.0), torch.full((22, 3), 3.0)), rest)


def gt_batches(seed=0):
    rng = np.random.RandomState(seed)
    return [{"gt_trans": np.cumsum(rng.randn(N_SEQS, FRAMES, 3).astype(np.float32) * 0.02, 1),
             "gt_root_orient": rng.randn(N_SEQS, FRAMES, 3).astype(np.float32) * 0.3,
             "gt_body_pose": rng.randn(N_SEQS, FRAMES, 63).astype(np.float32) * 0.2} for _ in range(N_BATCHES)]


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def count(rec, name):
    return int((rec["name"] == name).sum())


def test_off_records_nothing_and_costs_a_flag_test_a_span():
    """Off (no ``enable``, no profiler), a driver call records nothing. The
    off path of one bf16 reverse step at the release depth, written as the
    program writes it (ops/fused_step.py, ops/cuda_kernels.py): a test of
    ``ON`` for the step, one for its noise and one for each of its 22
    launches, each with the local tests that follow; at most 5 us a step."""
    run_batches_pipelined(make_pipeline(), gt_batches(), TorchNoise("cpu", 1))
    assert len(trace.spans()["name"]) == 0

    def off_step():
        t0 = trace.ON and trace.now()
        if t0:
            trace.leaf("step.noise", t0)
        span = trace.begin("step") if trace.ON else -1
        for _ in range(22):
            t0 = trace.ON and trace.now()
            t1 = t0 and trace.now()
            if t0:
                trace.launch("gemm_wgmma", t0, t1)
        if span >= 0:
            trace.end(span)

    per_step = min(timeit.repeat(off_step, number=2000, repeat=5)) / 2000
    assert per_step <= 5e-6, f"{per_step * 1e6:.2f} us a step"
    assert len(trace.spans()["name"]) == 0


def test_nested_spans_carry_parent_batch_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(trace, "now", lambda: next(clock))
    trace.enable()
    with trace.span("driver.chain", 3):             # 0 .. 100
        with trace.span("window"):                 # 10 .. 90
            row = trace.begin("step")              # 20 .. 60
            t0 = trace.now()                       # 30
            t1 = trace.now()                       # 40
            trace.launch("gemm_wgmma", t0, t1)     # args 30 .. 40, entry 40 .. 50
            trace.end(row)
            trace.leaf("step.noise", trace.now())  # 70 .. 80
    with trace.span("driver.collect", 4):           # 110 .. 120
        pass
    rec = trace.spans()
    assert list(rec["name"]) == ["driver.chain", "window", "step", "launch.args", "launch.entry", "step.noise",
                                 "driver.collect"]
    assert list(rec["parent"]) == [-1, 0, 1, 2, 2, 1, -1]
    assert list(rec["batch"]) == [3, 3, 3, 3, 3, 3, 4]
    assert list(rec["tag"]) == ["", "", "", "gemm_wgmma", "gemm_wgmma", "", ""]
    dur = rec["end_ns"] - rec["start_ns"]
    assert list(dur) == [100, 80, 40, 10, 10, 10, 10]
    own = trace.self_ns(rec)
    assert list(own) == [100 - 80, 80 - 40 - 10, 40 - 20, 10, 10, 10, 10]
    assert trace.summary()["window"] == {"count": 1, "total_ms": pytest.approx(80e-6), "self_ms": pytest.approx(30e-6)}


def test_a_span_left_open_by_an_exception_is_closed_by_its_parent():
    trace.enable()
    with pytest.raises(RuntimeError):
        with trace.span("window"):
            trace.begin("step")
            raise RuntimeError("a failing launch")
    with trace.span("window"):
        pass
    rec = trace.spans()
    assert list(rec["parent"]) == [-1, 0, -1]
    assert rec["end_ns"][0] > 0 and rec["end_ns"][1] == 0


def test_driver_spans_share_the_profilers_clock():
    """Each driver-level span lies inside the ``record_function`` range of
    its name, within 50 us at each end (both on the Unix-epoch clock)."""
    pipe, batches = make_pipeline(), gt_batches()
    prof, _ = profiled(lambda: run_batches_pipelined(pipe, batches, TorchNoise("cpu", 1)))
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    rec = trace.spans()
    for name in ("driver.prechain", "driver.copy"):
        ours = sorted(zip(rec["start_ns"][rec["name"] == name], rec["end_ns"][rec["name"] == name]))
        theirs = sorted(ranges[name])
        assert len(ours) == len(theirs) == N_BATCHES
        for (a, b), (ra, rb) in zip(ours, theirs):
            assert 0 <= a - ra <= 50_000 and 0 <= rb - b <= 50_000, (name, a - ra, rb - b)


def test_on_under_a_profiler_only_from_a_driver_or_window_entry():
    pipe = make_pipeline()
    diff = pipe.diffusion
    jpos = torch.zeros(1, FRAMES, 3)
    jquat = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(1, FRAMES, 4).contiguous()

    def no_entry():
        x0 = torch.zeros(1, 12, 198)
        with trace.span("window"):  # not an entry: off
            fs.fused_p_sample_loop(diff, x0, torch.ones_like(x0), noise=TorchNoise("cpu", 2))
        return trace.ON

    prof, on_inside = profiled(no_entry)
    assert not on_inside and len(trace.spans()["name"]) == 0

    ons = []
    prof, _ = profiled(lambda: (ons.append(trace.ON), diff.sample_sliding_window_w_canonical(
        jpos, jquat, pipe.stats, pipe.rest_offsets, noise=TorchNoise("cpu", 2)), ons.append(trace.ON)))
    assert ons == [False, False] and not trace.ON
    rec = trace.spans()
    assert count(rec, "window") == WINDOWS and count(rec, "window.stitch") == WINDOWS
    assert count(rec, "step") == WINDOWS * CFG["timesteps"]
    assert not (rec["name"] == "driver.chain").any()


def test_tiny_driver_call_under_a_profiler_records_each_layer_once():
    pipe, batches = make_pipeline(), gt_batches()
    profiled(lambda: run_batches_pipelined(pipe, batches, TorchNoise("cpu", 1)))
    rec = trace.spans()
    for name in ("driver.prefetch", "driver.prechain", "driver.chain", "driver.metrics", "driver.copy",
                 "driver.collect"):
        assert sorted(rec["batch"][rec["name"] == name]) == list(range(N_BATCHES)), name
    assert count(rec, "driver.stage1") == count(rec, "driver.wait") == 0  # GT-head mode, the CPU
    for name in ("window", "window.canonicalize", "window.loop", "window.decode", "loop.setup",
                 "window.inpaint_fk", "window.stitch"):
        assert count(rec, name) == N_BATCHES * WINDOWS, name
    steps = rec["name"] == "step"
    assert steps.sum() == count(rec, "step.noise") == N_BATCHES * WINDOWS * CFG["timesteps"]
    assert set(rec["name"][rec["parent"][steps]]) == {"window.loop"}
    assert sorted(np.unique(rec["batch"][steps], return_counts=True)[1]) == [WINDOWS * CFG["timesteps"]] * N_BATCHES
    assert (rec["end_ns"] >= rec["start_ns"]).all() and not (rec["name"] == "launch.entry").any()


def test_profile_trace_writes_the_spans_by_name(tmp_path):
    pipe, batches = make_pipeline(), gt_batches()
    with profile_trace(str(tmp_path)):
        run_batches_pipelined(pipe, batches, TorchNoise("cpu", 1))
    assert (tmp_path / "trace.json").exists()
    got = json.loads((tmp_path / "spans.json").read_text())
    assert got["driver.chain"]["count"] == N_BATCHES
    assert got["step"]["count"] == N_BATCHES * WINDOWS * CFG["timesteps"]
    chain = got["driver.chain"]
    assert 0 < chain["self_ms"] < chain["total_ms"]


def test_export_records_nothing_and_keeps_no_profiler_op():
    """With the recorder held on and a profiler recording, ``torch.export``
    traces a chain: nothing recorded, no profiler op in its graph."""
    from egoego_release_tpu_torch.serving import export as sx

    pipe = make_pipeline(dict(CFG, d_model=16, n_head=1, d_k=8, d_v=8, window=8, timesteps=2, overlap_frames=2))
    trace.enable()
    prof, prog = profiled(lambda: sx.export_chain(pipe, 1, 8))
    assert len(trace.spans()["name"]) == 0
    targets = {str(n.target) for gm in prog.graph_module.modules() for n in gm.graph.nodes if n.op == "call_function"}
    assert "egoego.gemm.default" in targets
    assert not [t for t in targets if "profiler" in t or "record_function" in t], targets


@pytest.mark.cuda
def test_bf16_step_records_a_launch_span_per_kernel_launch():
    """One bf16 ``fused_denoise_step`` at 2 x 121 with the recorder on: one
    ``step``, 22 ``launch.entry`` spans (and as many ``launch.args``) inside
    it, tagged as ``kernel_launches`` counts the launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ck.build()
    card = torch.device("cuda")
    cfg = DiffusionConfig()
    diff = CondGaussianDiffusion(cfg, device=card, seed=0)
    prep = fs.prepare_step_params(diff.model, True)
    g = torch.Generator(device=card).manual_seed(1)
    bsz, frames = 2, 120
    x, xc, noise = (torch.randn(bsz, frames, cfg.d_feats, generator=g, device=card) for _ in range(3))
    emb = fs.noise_level_embeddings(diff.model, [500])[0]
    pos = prep["pos_table"][1: frames + 2].contiguous()
    mask = torch.ones(bsz, frames + 1, device=card)
    xa = fs.pack_xa(x, xc, prep["wst"].shape[1], prep["wst"].dtype)
    step = lambda: fs.fused_denoise_step(x, xc, emb, pos, mask, noise, (0.5, 0.5, 0.1), None, None, prep,
                                         n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v, xa=xa)
    step()
    before = dict(ck.kernel_launches)
    trace.enable()
    step()
    trace.disable()
    torch.cuda.synchronize()
    delta = {k: v - before.get(k, 0) for k, v in ck.kernel_launches.items() if v > before.get(k, 0)}
    rec = trace.spans()
    entry = rec["name"] == "launch.entry"
    assert count(rec, "step") == 1 and entry.sum() == count(rec, "launch.args") == 22 == sum(delta.values())
    tags, counts = np.unique(rec["tag"][entry], return_counts=True)
    assert dict(zip(tags.tolist(), counts.tolist())) == delta
    assert set(rec["name"][rec["parent"][entry]]) == {"step"}
