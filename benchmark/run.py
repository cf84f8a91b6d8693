"""One run of one cell of the benchmark on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the stage-2 eval pipeline of ``egoego_release_tpu_torch`` with
weights, skeleton and stats from the seed, warms up every shape of the cell
with a few-step DDIM, then runs whole groups of batches through the
program's ``eval/pipeline.py`` ``run_batches_pipelined`` until ``--seconds``
have passed, and checks what the window produced against the plain
reference (``reference.py``). It prints the card, the set-up's parts and
each checked number beside its limit on standard error, and as the last
line of standard output one JSON object: ``correct``, ``attempted`` and
``failed`` (sequences), ``metrics`` (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics, with the profiler over one
more group of batches after the window), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``.

It exits non-zero and prints no result without a CUDA device (it never
falls back to the CPU), with fewer devices than the cell asks for, or when
JAX or the JAX package is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import replace  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "CUDA_CACHE_PATH": "cuda"}
# top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "egoego_release_tpu")
# the share by which the profiled group's pace may depart from the window's
# before the traced run says that its idle gaps do not stand for the window
PROFILE_DRIFT = 0.05
# DiffusionConfig fields a configuration file sets
PROGRAM_KEYS = ("d_feats", "d_model", "n_head", "n_dec_layers", "d_k", "d_v", "window", "timesteps", "objective",
                "beta_schedule", "overlap_frames", "compute_dtype")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(torch) -> dict:
    """The card's name and count, and its power limit from nvidia-smi."""
    limit = "unknown"
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "power": limit}


# -- the program ---------------------------------------------------------------


def build_program(cfg: dict, seed: int, device):
    """The eval pipeline of the port on ``device`` with the seed's weights
    (loaded by the checkpoint's keys), skeleton and stats. Returns it and the
    weights the benchmark made."""
    import torch

    from benchmark import inputs
    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
        CondGaussianDiffusion,
        DiffusionConfig,
        NormStats,
        new_denoiser,
    )
    from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline

    dcfg = DiffusionConfig(**{k: cfg[k] for k in PROGRAM_KEYS})
    weights = inputs.make_weights(cfg, seed, device)
    with torch.device(device):
        model = new_denoiser(dcfg)
    model.load_state_dict(weights)
    diffusion = CondGaussianDiffusion(dcfg, device=device, model=model)
    as_t = lambda a: torch.as_tensor(a, device=device)
    pipeline = EgoEgoPipeline(diffusion=diffusion, stats=NormStats(*map(as_t, inputs.norm_stats(seed))),
                              rest_offsets=as_t(inputs.skeleton(seed)))
    return pipeline, weights


def run_group(pipeline, traffic: dict, seed: int, ids, device, stream=None, span=contextlib.nullcontext()):
    """Batches ``ids`` through ``run_batches_pipelined`` (inside ``span``),
    each with its own noise source; returns their metric dicts."""
    from benchmark import inputs
    from egoego_release_tpu_torch.eval.pipeline import run_batches_pipelined

    kw = {} if stream is None else {"stream": stream}
    batches = [inputs.motion_batch(seed, i, traffic["batch_seqs"], traffic["frames"], **kw) for i in ids]
    noises = [inputs.batch_noise(device, seed, i, **kw) for i in ids]
    with span:
        out = run_batches_pipelined(pipeline, batches, noises)
    return [r["metrics"] for r in out]


def warm_up(pipeline, traffic: dict, seed: int, device) -> None:
    """One group of the cell's batches (its every shape) through the same
    path and kernels, with a DDIM of ``warmup_steps`` steps."""
    from benchmark import inputs

    diffusion = pipeline.diffusion
    full = diffusion.cfg
    diffusion.cfg = replace(full, sampler="ddim", ddim_steps=traffic["warmup_steps"])
    try:
        run_group(pipeline, traffic, seed, range(traffic["group_batches"]), device, stream=inputs.WARMUP)
    finally:
        diffusion.cfg = full


@contextlib.contextmanager
def user_ranges_only():
    """While a profiler starts inside, it records on the host only the
    ``record_function`` ranges (the benchmark's spans) and not every
    operator: recording each operator slows the host's side of a step by
    half or more, which would read as idle time on the card."""
    import torch.autograd.profiler as ap
    from torch._C._profiler import RecordScope

    enable = ap._enable_profiler
    ap._enable_profiler = lambda config, activities, scopes=None: enable(config, activities, {RecordScope.USER_SCOPE})
    try:
        yield
    finally:
        ap._enable_profiler = enable


def held_step_seconds(pipeline, batch: int, t_data: int) -> float:
    """Device seconds of one reverse step at (batch, t_data) by CUDA events
    behind a held stream: for when the profiler sees no device time."""
    import torch

    from benchmark.devtime import held_events_ms
    from egoego_release_tpu_torch.ops import fused_step as fs

    diffusion = pipeline.diffusion
    cfg, prep = diffusion.cfg, diffusion.step_params()
    dev = diffusion.device
    x, xc, noise = (torch.randn(batch, t_data, cfg.d_feats, device=dev) for _ in range(3))
    emb = fs.noise_level_embeddings(diffusion.model, [cfg.timesteps - 1])[0]
    pos = prep["pos_table"][1: t_data + 2].contiguous()
    mask = torch.ones(batch, t_data + 1, device=dev)
    xa = fs.pack_xa(x, xc, prep["wst"].shape[1], prep["wst"].dtype)
    step = lambda: fs.fused_denoise_step(x, xc, emb, pos, mask, noise, (0.5, 0.5, 0.1), None, None, prep,
                                         n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v, xa=xa)
    return held_events_ms(step, 20) / 1e3


# -- one run -------------------------------------------------------------------


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", here: Path | None = None):
    """One run of ``cell`` (``spec.Cell``); returns the result object, or
    None when a forbidden module is loaded. ``device`` "cpu" runs the
    program's plain versions (the CPU tests); ``here`` holds the metric
    readers."""
    import torch

    from benchmark import check, flops, inputs, spec
    from benchmark.devtime import read_profile
    from benchmark.reference import Reference
    from benchmark.spans import SPANS, Capture, Spans, layer_spans
    from egoego_release_tpu_torch.ops import cuda_kernels as ck

    cfg, traffic = cell.config, cell.traffic
    cuda = device != "cpu"
    log(f"setup: interpreter, imports and the card's name {time.perf_counter() - _T0:.3f} s")
    if cuda:
        built = ck.build()
        log(f"setup: kernels {built['seconds']:.3f} s, nvcc ran: {'yes, ' + ', '.join(built['ptxas']) if built['ptxas'] else 'no'}")
    t = time.perf_counter()
    pipeline, weights = build_program(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    log(f"setup: weights, skeleton, stats and pipeline {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    warm_up(pipeline, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    log(f"setup: warm-up ({traffic['warmup_steps']}-step DDIM, {traffic['group_batches']} batches) "
        f"{time.perf_counter() - t:.3f} s")

    # -- the window
    bs, group = traffic["batch_seqs"], traffic["group_batches"]
    spans = Spans() if trace else None
    capture = Capture()
    results, failed, k, group_s = {}, 0, 0, []
    launches0 = dict(ck.kernel_launches)
    with contextlib.ExitStack() as stack:
        stack.enter_context(capture.installed(pipeline))
        if trace:
            stack.enter_context(layer_spans(spans, pipeline))
        t_w0 = time.perf_counter()
        setup_s = t_w0 - _T0
        log(f"setup_s {setup_s:.4f}")
        while True:
            ids = range(k, k + group)
            capture.batch = k
            try:
                out = run_group(pipeline, traffic, seed, ids, device,
                                span=spans.span("run_batches_pipelined") if trace else contextlib.nullcontext())
                results.update(zip(ids, out))
            except Exception:  # a batch that raises counts its sequences as failed
                traceback.print_exc()
                failed += group * bs
            k += group
            group_s.append(time.perf_counter() - t_w0 - sum(group_s))
            if time.perf_counter() - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
        launches = {n: c - launches0.get(n, 0) for n, c in ck.kernel_launches.items() if c > launches0.get(n, 0)}
        log(f"window: {k} batches ({len(results)} done) in {window_s:.4f} s, groups of {group} "
            f"{' '.join(f'{g:.4f}' for g in group_s)} s; launches {launches}")

        metrics, device_info, breakdown = {}, {}, None
        frames = len(results) * bs * traffic["frames"]
        if trace:
            window_spans = {n: list(v) for n, v in spans.seconds.items()}
            held = None
            capture.batch = k
            acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            spans.profiling = True
            with user_ranges_only(), torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("profiled_group"):
                    run_group(pipeline, traffic, seed, range(k, k + group), device)
                    if cuda:
                        torch.cuda.synchronize()
            spans.profiling = False
            t = time.perf_counter()
            prof_trace = read_profile(prof, ("profiled_group",) + SPANS, "profiled_group")
            if cuda and not prof_trace.device:
                log("trace: the profiler saw no device operation; kernel time by held-stream CUDA events")
                held = group * sum(steps * held_step_seconds(pipeline, b, td) for b, td, steps in work_of(cfg, traffic))
            log(f"trace: {len(prof_trace.device)} device operations read in {time.perf_counter() - t:.3f} s")
            # the card's busy time a batch comes from the profile, its share
            # from the window: tracing costs the host some microseconds a
            # launch, so the profiled group runs slower than the window while
            # its device operations take as long
            busy_group = prof_trace.busy_us() / 1e6 if prof_trace.device else held
            busy_s = None if busy_group is None else busy_group / group * len(results)
            profiled, windowed = prof_trace.wall_us / 1e6 / group, window_s / max(len(results), 1)
            log(f"trace: the profiled group took {profiled:.4f} s a batch, the window {windowed:.4f} s a batch "
                f"({(profiled / windowed - 1) * 100:+.2f}%)"
                + ("" if busy_group is None else f"; the card was busy {busy_group / group:.4f} s a batch"))
            if abs(profiled / windowed - 1) > PROFILE_DRIFT:
                log(f"trace: the profiled group's pace departs from the window's by more than {PROFILE_DRIFT:.0%}: "
                    "its idle gaps (breakdown) hold the profiler's host cost; busy_s and window_s are the window's")
            ctx = SimpleNamespace(cfg=cfg, traffic=traffic, spans=window_spans, window_s=window_s,
                                  batches=len(results), frames=frames, launches=launches, trace=prof_trace,
                                  step_kernels=list(launches), held_kernel_s=held, work=work_of(cfg, traffic),
                                  profiled_batches=group, busy_s=busy_s, flops=flops)
            for entry in cell.per_layer:
                value = spec.reader(entry["name"], **({} if here is None else {"here": here}))(ctx)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
            if busy_s is not None:
                device_info = {"busy_s": busy_s, "window_s": window_s}
            if prof_trace.device:
                breakdown = {"device_ops": [[n, s / 1e6] for n, s in prof_trace.top_ops()],
                             "idle_gaps": [[n, s / 1e6] for n, s in prof_trace.idle_gaps()]}
        else:
            values = {"frames_per_s": frames / window_s, "setup_s": setup_s}
            metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]} for e in cell.end_to_end}

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    # -- the check, once the program's state is freed
    rows = checked(seed, sorted(results), traffic)
    chosen = sorted(rows)
    produced = {i: check.rows_to_device(capture.out[i], rows[i]) for i in chosen}
    capture.out.clear()
    del pipeline, capture
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings = []
    if chosen:
        ref = Reference(cfg, weights, inputs.skeleton(seed), inputs.norm_stats(seed))
        for i in chosen:
            params = inputs.motion_batch(seed, i, bs, traffic["frames"])
            out = ref.run_batch(params, inputs.batch_noise(device, seed, i), rows[i])
            readings.append(check.gaps(produced[i], [results[i][j] for j in rows[i]], out))
    numbers = check.widest(readings) if readings else {n: float("inf") for n in cell.limits}
    log(f"numbers: {json.dumps(numbers)}")
    log(f"check: batches {chosen}, rows {[rows[i] for i in chosen]}, reference {time.perf_counter() - t:.3f} s")
    correct = bool(readings) and failed == 0 and check.verdict(numbers, cell.limits)

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return None
    result = {"correct": correct, "attempted": k * bs, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": numbers[n], "limit": cell.limits[n]} for n in cell.limits}
    for n in cell.limits:
        log(f"check {n} = {numbers[n]!r} (limit {cell.limits[n]!r})")
    return result


def checked(seed: int, done: list, traffic: dict) -> dict:
    """{batch: rows} the check compares: ``check_batches`` of the batches
    done and ``check_rows`` rows of each, drawn from the seed."""
    from benchmark import inputs

    if not done:
        return {}
    r = inputs.rng(seed, inputs.CHECK)
    n, bs = min(traffic["check_batches"], len(done)), traffic["batch_seqs"]
    return {int(i): sorted(int(j) for j in r.choice(bs, size=min(traffic["check_rows"], bs), replace=False))
            for i in sorted(r.choice(done, size=n, replace=False))}


def work_of(cfg: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """[(batch, frames of the window, steps)] of one batch of the cell: each
    window of the chained sampler runs every DDPM timestep."""
    from benchmark import flops

    return [(traffic["batch_seqs"], tw, cfg["timesteps"]) for tw in flops.chain_windows(cfg, traffic["frames"])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        path = ROOT / "build" / "bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card and does not run on the CPU")
        return 2
    cell = spec.load_cell(args.workload)
    info = card(torch)
    log(f"card: {info['kind']} x {info['count']}, power limit {info['power']}")
    if info["count"] < cell.chips:
        log(f"{args.workload} needs {cell.chips} devices, found {info['count']}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
