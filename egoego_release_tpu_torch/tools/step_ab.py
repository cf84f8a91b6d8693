"""Two or more checkouts of the repo on one card: the denoise step's wrappers
and its LayerNorm launches in bf16 compute, and the wrappers and the step in
f32 compute (the CLIs' default numerics), timed alike.

    python3 -m egoego_release_tpu_torch.tools.step_ab ROOT [ROOT ...] [--json PATH]

Each ROOT is a checkout of the repo (say the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists, and ``.``). For
each ROOT, in the order given (give them as A B B A to see the card drift),
a child process imports ``egoego_release_tpu_torch`` from ROOT, builds
ROOT's ``csrc/`` into ROOT's build directory and times, at 64 windows of
121 and of 31 tokens with bf16 compute and f32 inter-layer activations
(the default) and random weights from seed 0:

- ``stem_layer``, ``decoder_layer``, ``layer_epilogue`` (the update with
  the inpaint) and ``fused_decoder_layer``, each called as phase 2 and
  phase 6 of ``chip_smoke.py`` call them (an f32 input whose bf16 copy the
  wrapper makes);
- the fc and w2 LayerNorm launches of a middle layer (f32 residual, f32
  output and its bf16 copy; w2 also without the copy);
- in f32 compute, ``stem_layer`` (given an f32 xa = [x | x_cond | 0], which
  a checkout whose f32 stem reads x and x_cond itself ignores),
  ``decoder_layer`` and ``layer_epilogue`` (the update with the inpaint, no
  xa), and their sum over a step, ``f32 step`` = stem_layer + (L - 2)
  decoder_layer + layer_epilogue, from each timer.

Each is timed twice on the device: torch.profiler's device time a call
(``chip_smoke.device_time_ms``, as phase 2) and CUDA events behind a held
stream (``chip_smoke.held_events_ms``, as phase 12); and on the host: the
host's time to issue one call (``host_ms``: the median of 9 runs of 20
calls queued behind a held stream, so none waits on the card). It passes the
wrappers only arguments that checkouts from before the bf16-activation
mode take as well, checks nothing (``chip_smoke.py`` does), and needs the
card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TOKENS = (121, 31)


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn, cs, reps: int = 20, repeats: int = 9, hold_ms: float = 50.0) -> float:
    """The host's ms to issue one call of fn: the median over ``repeats``
    runs of reps calls queued behind a sleep kernel that holds the stream
    (the card's sleep rate from ``cs.held_events_ms``, cs the loaded
    chip_smoke), on the host clock."""
    import statistics

    import torch

    if not cs._SLEEP_CYCLES_PER_MS:
        cs.held_events_ms(fn, 1)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * cs._SLEEP_CYCLES_PER_MS[0]))
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def measure(root: Path) -> dict:
    """The table of one checkout; runs in a process of its own."""
    sys.path.insert(0, str(root))
    import torch

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops import fused_layer as fl
    from egoego_release_tpu_torch.ops import fused_step as fs

    if Path(ck.__file__).resolve().parents[2] != root.resolve():
        raise RuntimeError(f"imported {ck.__file__}, not the checkout {root}")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    built = ck.build(force=True)
    cfg = DiffusionConfig(compute_dtype="bfloat16")
    model = CondGaussianDiffusion(cfg, device=dev, seed=0).model
    p = fs.prepare_step_params(model, True)
    lp = p["layers"][1]
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    dm, d = cfg.d_model, cfg.d_feats
    g = torch.Generator(device=dev).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    table = {"root": str(root), "build_s": built["seconds"]}
    for tokens in TOKENS:
        b, t = cs.BATCH, tokens - 1
        x, xc, noise, ipv, h = rn(b, t, d), rn(b, t, d), rn(b, t, d), rn(b, t, d), rn(b, tokens, dm)
        mask = torch.ones(b, tokens, device=dev)
        ipm = torch.zeros(b, t, device=dev)
        ipm[:, :cfg.overlap_frames] = 1.0
        emb = fs.noise_level_embeddings(model, [999])[0]
        pos = p["pos_table"][1: t + 2].contiguous()
        xa = fs.pack_xa(x, xc, p["wst"].shape[1])
        rows = b * tokens
        ctx = rn(rows, cfg.n_head * cfg.d_v).to(bf)
        h1 = torch.relu(rn(rows, dm)).to(bf)
        res, m = h.reshape(rows, dm), mask.reshape(rows)
        out, outb = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, dtype=bf, device=dev)
        ln = lambda a, w, bias, s, sb, copy: lambda: ck.gemm(
            ck.LAYER_NORM, a, w, bias, out, M=rows, res=res, ln_s=s, ln_b=sb, row_mask=m,
            out_b=outb if copy else None)
        fns = {
            "stem_layer": (lambda: fs.stem_layer(x, xc, emb, pos, mask, p, xa=xa, **kw), True),
            "decoder_layer": (lambda: fl.decoder_layer(h, mask, lp, **kw), True),
            "layer_epilogue": (lambda: fs.layer_epilogue(h, mask, x, noise, cs.UPDATE, ipv, ipm, p, xa=xa, **kw),
                               True),
            "fused_decoder_layer": (lambda: fl.fused_decoder_layer(h, mask, lp, **kw), True),
            "fc_ln": (ln(ctx, lp["wfc"], lp["bfc"], lp["ln1s"], lp["ln1b"], True), False),
            "w2_ln": (ln(h1, lp["w2"], lp["b2"], lp["ln2s"], lp["ln2b"], True), False),
            "w2_ln no copy": (ln(h1, lp["w2"], lp["b2"], lp["ln2s"], lp["ln2b"], False), False),
        }
        # f32 compute: the split weights (when the checkout has them) are made here
        p32 = fs.prepare_step_params(model, False)
        xa32 = torch.zeros(b, t, p32["wst"].shape[1], device=dev)
        xa32[..., :d], xa32[..., d: 2 * d] = x, xc
        f32 = {
            "stem_layer f32": lambda: fs.stem_layer(x, xc, emb, pos, mask, p32, xa=xa32, **kw),
            "decoder_layer f32": lambda: fl.decoder_layer(h, mask, p32["layers"][1], **kw),
            "layer_epilogue f32": lambda: fs.layer_epilogue(h, mask, x, noise, cs.UPDATE, ipv, ipm, p32, **kw),
        }
        fns.update({name: (fn, True) for name, fn in f32.items()})
        for name, (fn, chain) in fns.items():
            prof_ms, kernels = cs.device_time_ms(fn, chain=chain)
            table[f"{name} {b}x{tokens}"] = {"profiler_ms": prof_ms, "events_ms": cs.held_events_ms(fn, 20),
                                            "host_ms": host_ms(fn, cs), "kernels": kernels}
        per_step = {"stem_layer f32": 1, "decoder_layer f32": cfg.n_dec_layers - 2, "layer_epilogue f32": 1}
        table[f"f32 step {b}x{tokens}"] = {k: sum(n * table[f"{name} {b}x{tokens}"][k] for name, n in per_step.items())
                                          for k in ("profiler_ms", "events_ms", "host_ms")}
    torch.cuda.synchronize()
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repo, timed in this order")
    ap.add_argument("--json", help="also write the tables to this file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(Path(args.roots[0]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    tables = []
    for root in args.roots:
        where = str(Path(root).resolve())
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", where],
                              capture_output=True, text=True, env=env, cwd=where)
        if proc.returncode:
            raise RuntimeError(f"step_ab on {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        table = json.loads(proc.stdout.strip().splitlines()[-1])
        tables.append(table)
        for key, r in table.items():
            if isinstance(r, dict):
                print(f"step_ab {root}: {key}: profiler {r['profiler_ms']:.4f} ms, held events "
                      f"{r['events_ms']:.4f} ms, host {r['host_ms']:.4f} ms a call [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "tables": tables}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
