"""Where the layer's attention spends its time: variants of ``csrc/attention.cu`` timed on the card.

Each variant is ``csrc/attention.cu`` with one part of
``attention_wgmma_kernel`` switched off by a guard the compiler cannot fold
(``p.T < 0``: the instructions stay in the kernel and are skipped at run
time), built as ``tools/gemm_variants.py`` builds its variants:

- ``kernel``: the source as it is;
- ``no_softmax``: no exp and no divide (p is the masked, scaled score);
- ``no_products``: no wgmma (the loads, the softmax on zeros and the
  stores stay);
- ``no_stores``: ctx is staged but not stored to device memory.

Each runs at 64 x 121, 64 x 31 and 1 x 121 tokens (4 heads of 256, bf16,
random qkv); its device time (torch.profiler, over 20 calls) is printed
beside SDPA bf16 on the same q, k, v. The variants' outputs are wrong by
design: this times, it checks nothing (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` do). Needs the card and nvcc:

    python3 -m egoego_release_tpu_torch.tools.attention_variants [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch
import torch.nn.functional as F

from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.tools.gemm_variants import build_variants, device_ms

OFF = "p.T < 0"  # a guard that is false at run time
EXP = "        v = expf(v - mx[r]);"
DIVIDE = "      pa[kk][i] = pack_bf16(quotient(s[base], r), quotient(s[base + 1], r));"
SS = "    for (int kk = 0; kk < 4; ++kk) wgmma_ss<NK>("
RS = "      wgmma_rs_n64(o + 32 * c,"
STORE = "    if (t < p.T)\n      *reinterpret_cast<uint4*>(ctx"
VARIANTS = {
    "kernel": [],
    "no_softmax": [(EXP, EXP.replace("v = expf(v - mx[r]);", f"v = {OFF} ? expf(v - mx[r]) : v;")),
                   (DIVIDE, DIVIDE.replace("pack_bf16(quotient(s[base], r), quotient(s[base + 1], r))",
                                           f"{OFF} ? pack_bf16(quotient(s[base], r), quotient(s[base + 1], r)) "
                                           f": pack_bf16(s[base], s[base + 1])"))],
    "no_products": [(SS, SS.replace("wgmma_ss", f"if ({OFF}) wgmma_ss")),
                    (RS, RS.replace("wgmma_rs_n64", f"if ({OFF}) wgmma_rs_n64"))],
    "no_stores": [(STORE, STORE.replace("t < p.T)", f"t < p.T && {OFF})"))],
}
SHAPES = ((64, 121), (64, 31), (1, 121))  # (windows, tokens)
N_HEAD, D_HEAD = 4, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants needs a CUDA card")
    libs = build_variants("attention", VARIANTS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    table = []
    for b, t in SHAPES:
        width = N_HEAD * D_HEAD
        qkv = torch.randn(b * t, 3 * width, generator=g, device=dev).to(torch.bfloat16)
        ctx = torch.empty(b * t, width, dtype=torch.bfloat16, device=dev)
        q, k, v = (qkv[:, i * width:(i + 1) * width].reshape(b, t, N_HEAD, D_HEAD).transpose(1, 2) for i in range(3))
        p = ck.attention_args(qkv, ctx, B=b, T=t, t_keys=t, n_head=N_HEAD, d_k=D_HEAD, d_v=D_HEAD,
                              kernel="attention_wgmma")
        row = {"shape": f"{b}x{t}", "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
        for name, lib in libs.items():
            row[name + "_ms"] = device_ms(lambda: ck._check(lib.egoego_attention(ctypes.byref(p), stream), name))
        table.append(row)
        print(f"attention_variants {b}x{t} tokens: " + ", ".join(
            f"{key[:-3]} {val:.4f}" for key, val in row.items() if key.endswith("_ms")) + f" ms [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
