"""The harness end to end on the CPU at a tiny size, through the port's plain
versions: a run comes out correct, each fault the cells can have comes out
not correct, the control comes out not correct, and a cell, configuration
and metric added as files are found with no edit.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import check, inputs, run, spec
from benchmark.reference import Reference

HERE = Path(spec.__file__).resolve().parent

TINY = {"name": "tiny_f32", "source": "test", "d_feats": 198, "d_model": 32, "n_head": 2, "n_dec_layers": 2,
        "d_k": 16, "d_v": 16, "window": 16, "overlap_frames": 4, "timesteps": 8, "objective": "pred_x0",
        "beta_schedule": "cosine", "compute_dtype": "float32", "peak": "tf32", "element_bytes": 4, "control": "tf32"}
# two batches a group; 20 frames = a 16-frame window and an 8-frame tail with the overlap inpaint
TRAFFIC = {"batch_seqs": 4, "frames": 20, "group_batches": 2, "warmup_steps": 2, "check_batches": 2, "check_rows": 4}
LIMITS = {"rot_gap_mean": 1e-4, "root_gap_mean_m": 1e-4, "jpos_gap_mean_m": 1e-4, "metrics_gap_mean": 1e-4}


def make_bench(tmp_path: Path, cells=(("tiny.eval", "tiny_f32", "tiny_traffic"),)) -> tuple[Path, Path]:
    """A checkout root with its BENCHMARK.json and a benchmark directory of
    the tiny cells' files and the real metric readers."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (here / sub).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", here / "metrics")
    real = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench = {**real, "workloads": [], "configs": []}
    for name, config, traffic in cells:
        (here / "configs" / f"{config}.json").write_text(json.dumps({**TINY, "name": config}))
        (here / "traffic" / f"{traffic}.json").write_text(json.dumps(TRAFFIC))
        (here / "workloads" / f"{name}.json").write_text(json.dumps({"limits": LIMITS}))
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, here


def tiny_run(tmp_path, trace=False, seed=2**31 + 7):
    root, here = make_bench(tmp_path)
    cell = spec.load_cell("tiny.eval", root, here)
    return run.run_cell(cell, seed, 0.0, trace, device="cpu", here=here)


def test_tiny_run_is_correct_and_reports_every_metric(tmp_path):
    res = tiny_run(tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    for n, c in res["checks"].items():
        assert c["value"] < c["limit"] / 10, n


def test_tiny_traced_run_reads_the_per_layer_metrics(tmp_path):
    res = tiny_run(tmp_path, trace=True)
    assert res["correct"], res["checks"]
    # the CPU has no device trace: what is read from it is left out
    assert {"driver_ms_per_batch", "window_host_ms", "step_host_ms", "step_mfu"} <= set(res["metrics"])
    assert not {"kernels_roofline", "device_idle_share", "launches_per_step"} & set(res["metrics"])


def _identity_step(x, *args, **kwargs):
    return x


def _half_batch(gen):
    def stage2(head_poses, noise):
        local_aa, root_pos = gen(head_poses, noise)
        half = local_aa.shape[0] // 2
        return (torch.cat([local_aa[:half], local_aa[:half].mean(0, keepdim=True).expand_as(local_aa[half:])]),
                torch.cat([root_pos[:half], root_pos[:half].mean(0, keepdim=True).expand_as(root_pos[half:])]))
    return stage2


def _altered_answer(gen):
    def stage2(head_poses, noise):
        local_aa, root_pos = gen(head_poses, noise)
        root_pos = root_pos.clone()
        root_pos[-1, :, 0] += 0.01  # one sequence's root trajectory 1 cm off
        return local_aa, root_pos
    return stage2


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_faults_come_out_not_correct(tmp_path, monkeypatch, fault):
    """The timed path broken underneath: a reverse step that returns its
    state unchanged; half of the batch left out, its rows the mean of the
    rest; one answer (a sequence's root trajectory) altered where it is
    produced. (One chip: there is no exchange between chips to leave out.)"""
    from egoego_release_tpu_torch.eval import pipeline as pl
    from egoego_release_tpu_torch.ops import fused_step as fs

    if fault == "state_unchanged":
        monkeypatch.setattr(fs, "fused_denoise_step", _identity_step)
    else:
        wrap = _half_batch if fault == "half_batch" else _altered_answer
        orig = pl.EgoEgoPipeline.stage2_generate_batched
        monkeypatch.setattr(pl.EgoEgoPipeline, "stage2_generate_batched",
                            lambda self, hp, noise: wrap(lambda h, n: orig(self, h, n))(hp, noise))
    res = tiny_run(tmp_path)
    assert res["correct"] is False
    assert max(c["value"] / c["limit"] for c in res["checks"].values()) > 1


def test_control_comes_out_not_correct():
    """The control, the reference at the precision below the configuration's
    (TF32 for f32), in the program's place: its gaps to the f32 reference
    pass a limit."""
    cfg, seed = TINY, 5
    weights = inputs.make_weights(cfg, seed, "cpu")
    stats, offsets = inputs.norm_stats(seed), inputs.skeleton(seed)
    params = inputs.motion_batch(seed, 0, TRAFFIC["batch_seqs"], TRAFFIC["frames"])
    rows = list(range(TRAFFIC["batch_seqs"]))
    want = Reference(cfg, weights, offsets, stats).run_batch(params, inputs.batch_noise("cpu", seed, 0), rows)
    got = Reference(cfg, weights, offsets, stats, precision=cfg["control"]).run_batch(
        params, inputs.batch_noise("cpu", seed, 0), rows)
    program = {"local": got["local"], "root_pos": got["root"], "jpos": got["jpos"]}
    numbers = check.gaps(program, got["metrics"], want)
    assert not check.verdict(numbers, LIMITS), numbers


def test_added_cell_config_and_metric_are_found_without_edits(tmp_path):
    root, here = make_bench(tmp_path, cells=(("tiny.eval", "tiny_f32", "tiny_traffic"),
                                             ("tiny.other", "tiny_other", "other_traffic")))
    (here / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "new_metric", "unit": "x", "better": "lower", "source": "program_counter",
                               "layer": "device", "moves": "frames_per_s", "workloads": ["tiny.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    other = spec.load_cell("tiny.other", root, here)
    assert other.config["name"] == "tiny_other" and other.traffic == TRAFFIC
    assert "new_metric" in [m["name"] for m in other.per_layer]
    assert "new_metric" not in [m["name"] for m in spec.load_cell("tiny.eval", root, here).per_layer]
    assert spec.reader("new_metric", here)(None) == 42.0


def test_profiler_records_the_spans_and_not_each_operator():
    """The traced run's profiler keeps the benchmark's host spans and leaves
    out the operators, whose recording would slow the host's side."""
    with run.user_ranges_only(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            (torch.ones(4) + 1).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "outer" in names and not [n for n in names if n.startswith("aten::")], names


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["stage2_bf16.eval_b64", "stage2_bf16.captures_b128_470"])
def test_control_fails_every_limit_on_the_card(cell):
    """The control at the cell's own size on the card, one batch's checked
    rows: every number of the cell's file reads past its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' limits hold at the cells' sizes on the card")
    c = spec.load_cell(cell)
    cfg, traffic, seed = c.config, c.traffic, 2**31 + 11
    weights = inputs.make_weights(cfg, seed, "cuda")
    stats, offsets = inputs.norm_stats(seed), inputs.skeleton(seed)
    rows = run.checked(seed, [0], traffic)[0]
    params = inputs.motion_batch(seed, 0, traffic["batch_seqs"], traffic["frames"])
    want = Reference(cfg, weights, offsets, stats).run_batch(params, inputs.batch_noise("cuda", seed, 0), rows)
    got = Reference(cfg, weights, offsets, stats, precision=cfg["control"]).run_batch(
        params, inputs.batch_noise("cuda", seed, 0), rows)
    numbers = check.gaps({"local": got["local"], "root_pos": got["root"], "jpos": got["jpos"]}, got["metrics"], want)
    assert all(numbers[n] > c.limits[n] for n in c.limits), numbers
