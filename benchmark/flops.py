"""The work of the stage-2 reverse step, counted from shapes, and the peaks it
is held to (a frozen copy of the repo's ``tools/chain_mfu.py`` FLOP model,
with the NVIDIA H100's peaks in place of the TPU's).

Operations count multiply-adds as two. Bytes read each input once and
write each output once, at the configuration's element size, whatever a
kernel reads again; biases, LayerNorm vectors and the elementwise work
(under 0.1% of the products) are left out. A fused or re-tiled kernel does
the same work, so it reads the same counts.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: TF32 and bf16 tensor-core rates, HBM3
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def step_launches(cfg: dict, batch: int, t_data: int) -> list[tuple[str, int, int]]:
    """[(name, operations, bytes)] of one reverse step over ``batch``
    windows of ``t_data`` frames (t_data + 1 tokens): the stem over
    [x | x_cond], per layer the QKV product, the attention (scores and
    context), fc, the FFN's two products, and linear_out on the frames."""
    d, dm, h, dk, dv, n_layers = (cfg[k] for k in ("d_feats", "d_model", "n_head", "d_k", "d_v", "n_dec_layers"))
    e = cfg["element_bytes"]
    tok = t_data + 1

    def gemm(name, m, k, n):
        return name, 2 * m * k * n, e * (m * k + n * k + m * n)

    out = [gemm("stem", batch * t_data, 2 * d, dm)]
    for i in range(n_layers):
        qkv = h * (2 * dk + dv)
        attn_ops = 2 * batch * h * tok * tok * (dk + dv)
        attn_bytes = e * (batch * tok * qkv + batch * tok * h * dv)
        out += [gemm(f"qkv{i}", batch * tok, dm, qkv), (f"attention{i}", attn_ops, attn_bytes),
                gemm(f"fc{i}", batch * tok, h * dv, dm), gemm(f"w1_{i}", batch * tok, dm, dm),
                gemm(f"w2_{i}", batch * tok, dm, dm)]
    out.append(gemm("linear_out", batch * t_data, dm, d))
    return out


def step_flops(cfg: dict, batch: int, t_data: int) -> int:
    """Useful operations of one reverse step (``chain_mfu.forward_flops``
    times the batch): 182.4 GFLOP at 64 x 120 frames of the release model."""
    return sum(ops for _, ops, _ in step_launches(cfg, batch, t_data))


def step_least_seconds(cfg: dict, batch: int, t_data: int) -> float:
    """The least time the card could take for one step: the sum over its
    products and attention of max(operations / peak, bytes / peak bytes)."""
    peak = PEAK_FLOPS[cfg["peak"]]
    return sum(max(ops / peak, nbytes / PEAK_BYTES_PER_S) for _, ops, nbytes in step_launches(cfg, batch, t_data))


def chain_windows(cfg: dict, frames: int) -> list[int]:
    """Frames of each window of the chained sampler over ``frames`` frames
    (windows of ``window``, each next one starting ``overlap`` frames
    before the last ended; a remainder of ``overlap`` frames or fewer is
    dropped)."""
    w, ov = cfg["window"], cfg["overlap_frames"]
    out = []
    for start in range(0, frames, w - ov):
        tw = min(w, frames - start)
        if tw <= ov:
            break
        out.append(tw)
    return out
