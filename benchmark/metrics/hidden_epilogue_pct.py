"""Kernels (csrc/gemm.cu): the share of the bf16 QKV and w1 output tiles
whose stores ran under a next tile's products on the same block, in %,
from the program's ``gemm_tiles`` counter (ops/cuda_kernels.py):
``bias_hidden`` over ``bias``. The counter is the process's own (warm-up,
window and profiled group), which run the same shapes on the same path; a
replayed step adds its captured launches' tiles. None where the program has
no such counter or launched no such tile."""


def read(ctx):
    try:
        from egoego_release_tpu_torch.ops import cuda_kernels as ck
    except ImportError:
        return None
    tiles = getattr(ck, "gemm_tiles", None)
    if not tiles or not tiles.get("bias"):
        return None
    return tiles.get("bias_hidden", 0) / tiles["bias"] * 100.0
