"""Where the wgmma GEMM's time goes: variants of ``csrc/gemm.cu`` timed on the card.

Each variant is ``csrc/gemm.cu`` with one part of ``gemm_wgmma_kernel``
switched off by a guard the compiler cannot fold (the instructions stay in
the kernel; they are skipped at run time), built into
``build/gemm_variants/`` with the flags of ``ops/cuda_kernels.py``:

- ``kernel``: the source as it is;
- ``mainloop_only``: the consumers skip the epilogue (TMA ring + wgmma, one
  launch, no stores);
- ``no_stores``: the epilogue runs (and stages its outputs) but stores
  none to device memory;
- ``no_residual``: the LayerNorm epilogue reads zeros for the residual.

Every layer product of a step (QKV, fc + LayerNorm, w1 + ReLU, w2 +
LayerNorm; the LayerNorms with and without their bf16 copy) runs at 64 x 121
and 64 x 31 tokens (release widths) on random bf16 operands; each variant's
device time (torch.profiler, over 20 calls) is printed beside
``torch.matmul`` bf16 at the same (M, K, N). The variants' outputs are
wrong by design: this times, it checks nothing (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` do). Needs the card and nvcc:

    python3 -m egoego_release_tpu_torch.tools.gemm_variants [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from egoego_release_tpu_torch.ops import cuda_kernels as ck

OUT_DIR = ck.BUILD_DIR.parent / "gemm_variants"
EPILOGUE_CALL = "      wgmma_epilogue<SPLIT_N>(p, acc, out_stage"
RESIDUAL_LOAD = "const float2 r = R[h] < p.M ? *reinterpret_cast<const float2*>(p.res"
STORE = "      if (R < p.M && C < p.N) {\n        const uint4 v"  # store_block (bias/ReLU modes)
LN_STORE = "        if (C < p.N && R[h] < p.M) {\n          const float2 g"  # the LayerNorm modes
VARIANTS = {
    "kernel": [],
    "mainloop_only": [(EPILOGUE_CALL, EPILOGUE_CALL.replace("      wgmma", "      if (p.M < 0) wgmma"))],
    "no_residual": [(RESIDUAL_LOAD, RESIDUAL_LOAD.replace("R[h] < p.M ?", "R[h] < 0 ?"))],
    "no_stores": [(STORE, STORE.replace("C < p.N) {", "C < p.N && p.M < 0) {")),
                  (LN_STORE, LN_STORE.replace("R[h] < p.M) {", "R[h] < p.M && p.M < 0) {"))],
}
LN_ONLY = ("no_residual",)
PRODUCTS = {  # name: (mode, K, N) at d_model 512, 4 heads of 256
    "qkv": (ck.BIAS, 512, 3072), "fc_ln": (ck.LAYER_NORM, 1024, 512),
    "w1_relu": (ck.BIAS_RELU, 512, 512), "w2_ln": (ck.LAYER_NORM, 512, 512),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (ck.CSRC / "gemm.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's anchor is not in csrc/gemm.cu once: {old!r}")
            text = text.replace(old, new)
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "gemm.cu").write_text(text)
        for h in ck.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        procs[name] = subprocess.Popen([ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(d / "libgemm.so"), str(d / "gemm.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT_DIR / name / "libgemm.so"))
        lib.egoego_gemm.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.egoego_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """torch.profiler's device time of one call of fn (one kernel a call).
    CUPTI now and then delivers no device event for a run: it runs again,
    up to `tries` times."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if dev:
            return sum(e.self_device_time_total for e in dev) / max(e.count for e in dev) / 1e3
    raise RuntimeError(f"torch.profiler saw no device time in {tries} runs")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_variants needs a CUDA card")
    libs = build_variants()
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    table = []
    for tokens in (121, 31):
        m = 64 * tokens
        for name, (mode, k, n) in PRODUCTS.items():
            a = torch.randn(m, k, generator=g, device=dev).to(bf)
            w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5).to(bf)
            bias = torch.zeros(n, device=dev)
            ln = mode == ck.LAYER_NORM
            out = torch.empty(m, n, device=dev, dtype=torch.float32 if ln else bf)
            res, ones, mask = torch.randn(m, n, generator=g, device=dev), torch.ones(n, device=dev), torch.ones(m, device=dev)
            out_b = torch.empty(m, n, device=dev, dtype=bf)
            lib_ms = device_ms(lambda: torch.matmul(a, w.t()))
            for copy in ((False, True) if ln else (False,)):
                p = ck.GemmArgs(a=a.data_ptr(), w=w.data_ptr(), bias=bias.data_ptr(), out=out.data_ptr(), M=m, N=n,
                                K=k, lda=k, ldw=k, ldo=n, a_bf16=1, out_bf16=int(not ln), compute_bf16=1, mode=mode,
                                w_nk=1)
                if ln:
                    p.res, p.ln_s, p.ln_b, p.row_mask = res.data_ptr(), ones.data_ptr(), bias.data_ptr(), mask.data_ptr()
                    p.out_b = out_b.data_ptr() if copy else None
                row = {"product": name + ("+copy" if copy else ""), "mkn": [m, k, n], "torch_matmul_ms": lib_ms}
                for vname, lib in libs.items():
                    if not ln and vname in LN_ONLY:
                        continue
                    call = lambda: ck._check(lib.egoego_gemm(ctypes.byref(p), stream), vname)
                    row[vname + "_ms"] = device_ms(call)
                table.append(row)
                print(f"gemm_variants {row['product']} {tokens} tokens (M, K, N) = ({m}, {k}, {n}): "
                      + ", ".join(f"{key[:-3]} {v:.4f}" for key, v in row.items() if key.endswith("_ms"))
                      + f" ms [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
