"""Everything a run feeds the program and the reference alike, made from
``--seed``: the denoiser's weights (by the reference checkpoint's
``state_dict`` keys), the skeleton, the normalization stats, the batches of
AMASS-layout SMPL parameters and each batch's noise source.

The same seed gives the same inputs; every seed gives the same sizes. This
module is the traffic generator: a traffic file under ``benchmark/traffic/``
only sets its parameters. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# streams of np.random.SeedSequence([seed, stream, index])
WEIGHTS, SKELETON, STATS, BATCH, NOISE, WARMUP, CHECK = range(7)

# SMPL's 22-joint rest offsets from each joint's parent (y up, metres),
# rounded from the published neutral body; each run scales and perturbs
# them (``skeleton``)
SMPL_REST_OFFSETS = (
    (0.0, 0.0, 0.0), (0.06, -0.09, -0.01), (-0.06, -0.09, -0.01), (0.0, 0.11, -0.02),
    (0.04, -0.38, 0.0), (-0.04, -0.38, 0.0), (0.0, 0.13, 0.0), (-0.01, -0.40, -0.04),
    (0.01, -0.40, -0.04), (0.0, 0.05, 0.02), (0.04, -0.06, 0.12), (-0.04, -0.06, 0.12),
    (0.0, 0.21, -0.03), (0.08, 0.12, -0.02), (-0.08, 0.12, -0.02), (0.0, 0.09, 0.05),
    (0.12, 0.05, -0.01), (-0.12, 0.05, -0.01), (0.26, -0.01, -0.02), (-0.26, -0.01, -0.02),
    (0.25, 0.01, 0.0), (-0.25, 0.01, 0.0),
)


def derive(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for one stream of one run (torch and numpy take it)."""
    return int(np.random.SeedSequence([int(seed), stream, index]).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream, index))


# -- the denoiser's weights ------------------------------------------------


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The released stage-2 checkpoint's ``state_dict`` keys and shapes
    (lijiaman/egoego_release ``TransformerDiffusionModel``): the noise-level
    MLP (64 Fourier features -> 256 -> d_model), the Conv1d(k=1) stem over
    [x | x_cond], per layer w_q/w_k/w_v/fc and a LayerNorm, then the
    Conv1d(k=1) FFN and a LayerNorm, and linear_out."""
    d, dm, h, dk, dv = (cfg[k] for k in ("d_feats", "d_model", "n_head", "d_k", "d_v"))
    shapes = {"time_mlp.1.weight": (256, 64), "time_mlp.1.bias": (256,),
              "time_mlp.3.weight": (dm, 256), "time_mlp.3.bias": (dm,),
              "motion_transformer.start_conv.weight": (dm, 2 * d, 1),
              "motion_transformer.start_conv.bias": (dm,)}
    for i in range(cfg["n_dec_layers"]):
        a, f = f"motion_transformer.layer_stack.{i}.self_attn.", f"motion_transformer.layer_stack.{i}.pos_ffn."
        shapes.update({a + "w_q.weight": (h * dk, dm), a + "w_q.bias": (h * dk,),
                       a + "w_k.weight": (h * dk, dm), a + "w_k.bias": (h * dk,),
                       a + "w_v.weight": (h * dv, dm), a + "w_v.bias": (h * dv,),
                       a + "fc.weight": (dm, h * dv), a + "fc.bias": (dm,),
                       a + "layer_norm.weight": (dm,), a + "layer_norm.bias": (dm,),
                       f + "w_1.weight": (dm, dm, 1), f + "w_1.bias": (dm,),
                       f + "w_2.weight": (dm, dm, 1), f + "w_2.bias": (dm,),
                       f + "layer_norm.weight": (dm,), f + "layer_norm.bias": (dm,)})
    shapes.update({"linear_out.weight": (d, dm), "linear_out.bias": (d,)})
    return shapes


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 weights on ``device`` from one uniform draw of a generator there:
    each weight and bias uniform in +-1/sqrt(fan_in) (torch's default for
    Linear and Conv1d), each LayerNorm scale 1 +- 0.1 and shift +-0.1."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS))
    flat = torch.rand(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device) * 2.0 - 1.0
    out, off, fan_in = {}, 0, 1
    for key, shape in shapes.items():
        v = flat[off: off + math.prod(shape)].view(shape)
        off += math.prod(shape)
        if "layer_norm" in key:
            out[key] = 1.0 + 0.1 * v if key.endswith("weight") else 0.1 * v
            continue
        if key.endswith("weight"):
            fan_in = math.prod(shape[1:])
        out[key] = v * (1.0 / math.sqrt(fan_in))
    return out


# -- skeleton and normalization stats --------------------------------------


def skeleton(seed: int) -> np.ndarray:
    """(22, 3) f32 rest offsets: SMPL's, scaled by a body size in
    [0.9, 1.1] and each moved by up to 1 cm."""
    r = rng(seed, SKELETON)
    off = np.asarray(SMPL_REST_OFFSETS, np.float64) * r.uniform(0.9, 1.1)
    off[1:] += r.uniform(-0.01, 0.01, (21, 3))
    return off.astype(np.float32)


def norm_stats(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Min/max stats (22, 3) each of the canonical joint positions, about
    the released window-120 stats' ranges (x, y within about 1.2 m of the
    window's first head position, z from the floor to 1.9 m)."""
    r = rng(seed, STATS)
    lo = np.asarray([-1.2, -1.2, -0.05]) - r.uniform(0.0, 0.2, (22, 3))
    hi = np.asarray([1.2, 1.2, 1.9]) + r.uniform(0.0, 0.2, (22, 3))
    return lo.astype(np.float32), hi.astype(np.float32)


# -- motion ----------------------------------------------------------------


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([o, z, z, z, c, -s, z, s, c], -1).reshape(a.shape + (3, 3))


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(a.shape + (3, 3))


def _matrix_to_axis_angle(m: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), angles in
    [0, pi], through the unit quaternion of the largest pivot."""
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = (np.moveaxis(m, (-2, -1), (0, 1)))
    four_sq = np.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    rows = np.stack([np.stack([four_sq[..., 0], m21 - m12, m02 - m20, m10 - m01], -1),
                     np.stack([m21 - m12, four_sq[..., 1], m10 + m01, m02 + m20], -1),
                     np.stack([m02 - m20, m10 + m01, four_sq[..., 2], m12 + m21], -1),
                     np.stack([m10 - m01, m02 + m20, m12 + m21, four_sq[..., 3]], -1)], -2)
    best = np.argmax(four_sq, -1)[..., None, None]
    q = np.take_along_axis(rows, np.broadcast_to(best, best.shape[:-1] + (4,)), -2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.where(q[..., :1] < 0, -q, q)
    v = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    return q[..., 1:] * (2.0 * np.arctan2(v, q[..., :1]) / np.maximum(v, 1e-12))


def motion_batch(seed: int, index: int, n: int, frames: int, fps: float = 30.0, stream: int = BATCH) -> dict:
    """Batch ``index`` of ``n`` smooth AMASS-layout sequences of ``frames``
    frames: ``gt_trans`` (n, T, 3), ``gt_root_orient`` (n, T, 3) and
    ``gt_body_pose`` (n, T, 63), f32. The root walks a smooth curve at a
    steady pelvis height, upright (SMPL's y up turned to z up) with a
    slowly turning heading; each body joint swings as a sinusoid."""
    r = rng(seed, stream, index)
    s = np.arange(frames)[None, :, None] / fps
    f, ph = r.uniform(0.05, 0.3, (n, 1, 3)), r.uniform(0.0, 2.0 * np.pi, (n, 1, 3))
    trans = np.sin(2.0 * np.pi * f * s + ph) * [1.0, 1.0, 0.02] + [0.0, 0.0, 0.9]
    yaw = r.uniform(-np.pi, np.pi, (n, 1)) + 0.3 * np.sin(2.0 * np.pi * r.uniform(0.05, 0.2, (n, 1)) * s[..., 0])
    tilt = np.pi / 2.0 + 0.05 * np.sin(2.0 * np.pi * r.uniform(0.1, 0.5, (n, 1)) * s[..., 0])
    root = _matrix_to_axis_angle(_rot_z(yaw) @ _rot_x(tilt))
    fb, pb = r.uniform(0.2, 1.0, (n, 1, 63)), r.uniform(0.0, 2.0 * np.pi, (n, 1, 63))
    body = r.uniform(0.05, 0.4, (n, 1, 63)) * np.sin(2.0 * np.pi * fb * s + pb)
    return {"gt_trans": trans.astype(np.float32), "gt_root_orient": root.astype(np.float32),
            "gt_body_pose": body.astype(np.float32)}


# -- noise -------------------------------------------------------------------


class SeededNoise:
    """One batch's noise source: every draw from one ``torch.Generator`` on
    the device, seeded from (seed, batch). The program and the reference
    each get a fresh source of the same seed, so they draw the same numbers
    as long as they draw the same shapes in the same order."""

    def __init__(self, device, seed: int):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def window(self) -> "SeededNoise":
        return self

    def _draw(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    initial = cond = step = _draw


def batch_noise(device, seed: int, index: int, stream: int = NOISE) -> SeededNoise:
    return SeededNoise(device, derive(seed, stream, index))
