"""Where the wgmma GEMM's time goes: variants of ``csrc/gemm.cu`` timed on the card.

Each variant is ``csrc/gemm.cu`` with one part of ``gemm_wgmma_kernel``
switched off by a guard the compiler cannot fold (the instructions stay in
the kernel; they are skipped at run time), built into
``build/gemm_variants/`` with the flags of ``ops/cuda_kernels.py``
(``tools/attention_variants.py`` does the same for the layer's attention):

- ``kernel``: the source as it is;
- ``mainloop_only``: the consumers skip the epilogue (TMA ring + wgmma, one
  launch, no stores; the LayerNorm cluster kernel loads no residual);
- ``no_stores``: the epilogue runs (and stages its outputs; the update also
  reads x, noise and the inpaint values) but stores none to device memory
  (QKV and w1 start no TMA store);
- ``no_residual``: the LayerNorm epilogue reads no residual from device
  memory (zeros in the f32 kernel's, what shared memory holds in the
  cluster kernel's).

Every product of a step (QKV, fc + LayerNorm, w1 + ReLU, w2 + LayerNorm, the
LayerNorms with and without their bf16 copy; the stem from the packed xa,
and the update with the inpaint and its write into xa) runs at 64 x 121 and
64 x 31 tokens (release widths) on random bf16 operands; each variant's
device time (torch.profiler, over 20 calls) is printed beside
``torch.matmul`` bf16 at the same (M, K, N) (the stem's K without xa's
padding). The variants' outputs are
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

EPILOGUE_CALL = "      wgmma_epilogue<T>(p, acc, out_stage"
LN_EPILOGUE_CALL = "      ln_cluster_epilogue<T>(p, acc, buf"  # gemm_wgmma_ln_kernel (bf16 LayerNorm modes)
RESIDUAL_LOAD = "if (R[h] < p.M) {\n            const size_t e"  # the f32 kernel's LayerNorm residual
LN_RES_TX = "mbar_expect_tx(res_full, T::kResBoxes * 8192);"  # the cluster kernel's residual, by its producer
LN_RES_LOOP = "for (int b = 0; b < T::kResBoxes; ++b)\n              tma_load_2d("
LN_RES_WAIT = "if (jt > 0) mbar_wait(res_empty"  # the cluster kernel's producer, before the next residual
STORE = "if (c0 + 64 * (b0 + b) < p.N) tma_store_2d("  # store_block_tma (bias/ReLU modes): a box's TMA store
LN_STORE = "        if (C < p.N && R[h] < p.M) {\n          const float2 g"  # the f32 kernel's LayerNorm modes
LN_CLUSTER_STORE = "b * 64 < T::kBN; ++b) tma_store_2d("  # the cluster kernel's bf16 rows (TMA)
LN_CLUSTER_F32 = "if (ln_f32_out(T::kEpi) && R < p.M)\n"  # its f32 rows, from the fragment
NO_LN_STORES = [(LN_CLUSTER_STORE, LN_CLUSTER_STORE.replace("< T::kBN;", "< T::kBN && p.M < 0;")),
                (LN_CLUSTER_F32, LN_CLUSTER_F32.replace("R < p.M", "R < p.M && p.M < 0"))]
NO_RESIDUAL_TMA = [(LN_RES_TX, LN_RES_TX.replace(");", " * (p.M < 0));")),
                   (LN_RES_LOOP, LN_RES_LOOP.replace("b < T::kResBoxes;", "b < T::kResBoxes * (p.M < 0);"))]
STEM_STORE = "      if (r < rows && C < p.N) {\n        const float4 a"  # store_block_f32 (kStem)
STEM_TOKEN0 = "      if (C < p.N) {\n        const float2 e"  # kStem: token 0 of each window
STEP_STORE = "          *reinterpret_cast<float4*>(out + f) ="  # kStep: x_next, 16-byte pieces
STEP_STORE_1 = "            out[g] = o;"  # kStep: x_next at the span's ends
STEP_XA = "} else if (p.out_b != nullptr) {\n      const int pieces"  # kStep: bf16(x_next) into xa
NO_STORE = lambda anchor, cond: (anchor, anchor.replace(cond, cond[:-3] + " && p.M < 0) {"))
VARIANTS = {
    "kernel": [],
    "mainloop_only": [(EPILOGUE_CALL, EPILOGUE_CALL.replace("      wgmma", "      if (p.M < 0) wgmma")),
                      (LN_EPILOGUE_CALL, LN_EPILOGUE_CALL.replace("      ln", "      if (p.M < 0) ln")),
                      (LN_RES_WAIT, LN_RES_WAIT.replace("jt > 0", "jt > 0 && p.M < 0"))] + NO_RESIDUAL_TMA,
    "no_residual": [(RESIDUAL_LOAD, RESIDUAL_LOAD.replace("R[h] < p.M", "R[h] < 0"))] + NO_RESIDUAL_TMA,
    "no_stores": [(STORE, STORE.replace("< p.N)", "< p.N && p.M < 0)")), NO_STORE(LN_STORE, "R[h] < p.M) {"),
                  *NO_LN_STORES,
                  NO_STORE(STEM_STORE, "C < p.N) {"), NO_STORE(STEM_TOKEN0, "C < p.N) {"),
                  NO_STORE(STEP_XA, "nullptr) {"),
                  (STEP_STORE, STEP_STORE.replace("*", "if (p.M < 0) *", 1)),
                  (STEP_STORE_1, STEP_STORE_1.replace("out[g]", "if (p.M < 0) out[g]"))],
}
ONLY = {"no_residual": (ck.LAYER_NORM,)}  # variants that change one mode only
PRODUCTS = {  # name: (mode, K, N) at d_model 512, 4 heads of 256, d = 198
    "qkv": (ck.BIAS, 512, 3072), "fc_ln": (ck.LAYER_NORM, 1024, 512),
    "w1_relu": (ck.BIAS_RELU, 512, 512), "w2_ln": (ck.LAYER_NORM, 512, 512),
    "stem": (ck.STEM, 400, 512), "step": (ck.STEP, 512, 198),
}
D = 198  # features of a frame; the stem's K is 2 D padded to 400


def build_variants(source: str = "gemm", variants: dict = VARIANTS) -> dict[str, ctypes.CDLL]:
    """Each variant of ``csrc/{source}.cu`` (its edits: (anchor, new text)
    pairs, each anchor once in the source) built into its own library under
    ``build/{source}_variants/``; returns {variant: its loaded library}."""
    src = (ck.CSRC / f"{source}.cu").read_text()
    out_dir = ck.BUILD_DIR.parent / f"{source}_variants"
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's anchor is not in csrc/{source}.cu once: {old!r}")
            text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{source}.cu").write_text(text)
        for h in ck.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        procs[name] = subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(d / f"lib{source}.so"), str(d / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / name / f"lib{source}.so"))
        entry = getattr(lib, f"egoego_{source}")
        entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        entry.restype = ctypes.c_int
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
    scal = torch.tensor([0.9, 0.1, 0.05], device=dev)  # the update's a1, a2, a3, read by the kernel on the card
    for tokens in (121, 31):
        t = tokens - 1
        for name, (mode, k, n) in PRODUCTS.items():
            # rows of A, of out; the stem multiplies data rows and writes tokens, the step the reverse
            m_a, m = {ck.STEM: (64 * t, 64 * tokens), ck.STEP: (64 * tokens, 64 * t)}.get(mode, (64 * tokens,) * 2)
            rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
            a = rn(m_a, k).to(bf)
            w = (rn(n + n % 8, k) / k ** 0.5).to(bf)
            bias = torch.zeros(n, device=dev)
            ln, f32_out = mode == ck.LAYER_NORM, mode in (ck.LAYER_NORM, ck.STEM, ck.STEP)
            out = torch.empty(m, n, device=dev, dtype=torch.float32 if f32_out else bf)
            res, ones, mask = rn(m, n), torch.ones(n, device=dev), torch.ones(m, device=dev)
            out_b = torch.empty(m, 400 if mode == ck.STEP else n, device=dev, dtype=bf)
            x, noise, ipv, ipm = rn(m, n), rn(m, n), rn(m, n), (rn(m) > 0).float()
            pos, emb = rn(tokens, n), rn(n)
            k_lib = 2 * D if mode == ck.STEM else k
            a_l = a[:, :k_lib].contiguous()
            lib_ms = device_ms(lambda: torch.matmul(a_l, w[:n, :k_lib].t()))
            for copy in ((False, True) if ln else (False,)):
                p = ck.GemmArgs(a=a.data_ptr(), w=w.data_ptr(), bias=bias.data_ptr(), out=out.data_ptr(), M=m, N=n,
                                K=k, lda=k, ldw=k, ldo=n, ldb=n, a_bf16=1, out_bf16=int(not f32_out),
                                compute_bf16=1, mode=mode, t_data=t, scal=scal.data_ptr())
                if ln:
                    p.res, p.ln_s, p.ln_b, p.row_mask = res.data_ptr(), ones.data_ptr(), bias.data_ptr(), mask.data_ptr()
                    p.out_b = out_b.data_ptr() if copy else None
                elif mode == ck.STEM:
                    p.pos, p.emb, p.out_b = pos.data_ptr(), emb.data_ptr(), out_b.data_ptr()
                elif mode == ck.STEP:
                    p.x, p.noise, p.ipv, p.ipm = x.data_ptr(), noise.data_ptr(), ipv.data_ptr(), ipm.data_ptr()
                    p.out_b, p.ldb = out_b.data_ptr(), 400
                row = {"product": name + ("+copy" if copy else ""), "mkn": [m_a, k_lib, n], "torch_matmul_ms": lib_ms}
                for vname, lib in libs.items():
                    if vname in ONLY and mode not in ONLY[vname]:
                        continue
                    call = lambda: ck._check(lib.egoego_gemm(ctypes.byref(p), stream), vname)
                    row[vname + "_ms"] = device_ms(call)
                table.append(row)
                print(f"gemm_variants {row['product']} {tokens} tokens (M, K, N) = {tuple(row['mkn'])}: "
                      + ", ".join(f"{key[:-3]} {v:.4f}" for key, v in row.items() if key.endswith("_ms"))
                      + f" ms [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
