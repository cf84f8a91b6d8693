"""Batched rotation algebra on torch tensors.

Port of egoego_release_tpu/ops/rotations.py with the same conventions:
quaternions are (w, x, y, z); matrices act on column vectors; the 6d
representation is the first two ROWS of the matrix. Every function works
over any leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_conjugate(q: Tensor) -> Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_invert(q: Tensor) -> Tensor:
    """Inverse of a unit quaternion, its conjugate."""
    return quat_conjugate(q)


def quat_multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_apply(q: Tensor, v: Tensor) -> Tensor:
    """Rotate v (..., 3) by unit q (..., 4): v + 2 w (u x v) + 2 u x (u x v)."""
    u, w = q[..., 1:], q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_between(x: Tensor, y: Tensor) -> Tensor:
    """Unnormalized quaternion rotating vector x onto y (callers normalize)."""
    w = torch.sqrt((x * x).sum(-1) * (y * y).sum(-1)) + (x * y).sum(-1)
    return torch.cat([w[..., None], _cross(x, y)], dim=-1)


def standardize_quat(q: Tensor) -> Tensor:
    """Flip the sign so that w >= 0 (pytorch3d.standardize_quaternion)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix_np(q) -> np.ndarray:
    """Numpy twin of ``quat_to_matrix`` for the host-side data loaders."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / np.sum(q * q, axis=-1)
    m = np.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat_np(m) -> np.ndarray:
    """Numpy twin of ``matrix_to_quat`` (same pivot and sign conventions)."""
    m = np.asarray(m, np.float32)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    sqrtp = lambda x: np.sqrt(np.maximum(x, 0.0))
    q_abs = np.stack([
        sqrtp(1.0 + m00 + m11 + m22), sqrtp(1.0 + m00 - m11 - m22),
        sqrtp(1.0 - m00 + m11 - m22), sqrtp(1.0 - m00 - m11 + m22),
    ], axis=-1)
    quat_by_w = np.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    quat_by_x = np.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], axis=-1)
    quat_by_y = np.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], axis=-1)
    quat_by_z = np.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], axis=-1)
    cand = np.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], axis=-2)
    cand = cand / (2.0 * np.maximum(q_abs, 0.1))[..., None]
    best = np.argmax(q_abs, axis=-1)
    out = np.take_along_axis(cand, best[..., None, None].astype(np.int64), axis=-2)[..., 0, :]
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)


def quat_to_matrix(q: Tensor) -> Tensor:
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: Tensor) -> Tensor:
    """sqrt(max(x, 0)) with a zero gradient where x <= 0. The candidates of
    ``matrix_to_quat`` that are not chosen get a zero gradient, but sqrt's
    infinite one at 0 would turn that into NaN: JAX's twin does, whenever a
    rotation about one axis rounds to 0 (the values are the same)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


def matrix_to_quat(m: Tensor) -> Tensor:
    """Rotation matrix -> unit quaternion by Shepperd's method: all four
    candidates, the one with the largest pivot kept (first on ties), the
    same 0.1 denominator floor as pytorch3d. The branch choice is
    numerically sensitive, so this follows the JAX version line for line."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = torch.stack([
        _sqrt_positive_part(1.0 + m00 + m11 + m22),
        _sqrt_positive_part(1.0 + m00 - m11 - m22),
        _sqrt_positive_part(1.0 - m00 + m11 - m22),
        _sqrt_positive_part(1.0 - m00 - m11 + m22),
    ], dim=-1)

    quat_by_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    quat_by_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    quat_by_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    quat_by_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    quat_candidates = torch.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], dim=-2)

    denom = 2.0 * torch.clamp_min(q_abs, 0.1)
    quat_candidates = quat_candidates / denom[..., None]

    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    out = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    return quat_normalize(out)


def axis_angle_to_quat(aa: Tensor, eps: float = 1e-6) -> Tensor:
    angle_sq = (aa * aa).sum(-1, keepdim=True)
    angle = torch.sqrt(torch.clamp_min(angle_sq, 1e-30))
    half = 0.5 * angle
    small = angle < eps
    sin_half_over_angle = torch.where(
        small, 0.5 - angle_sq / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(half), aa * sin_half_over_angle], dim=-1)


def quat_to_axis_angle(q: Tensor, eps: float = 1e-6) -> Tensor:
    norm_xyz = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half_angle = torch.atan2(norm_xyz, q[..., :1])
    angle = 2.0 * half_angle
    small = torch.abs(angle) < eps
    sin_half = torch.where(small, torch.ones_like(half_angle), torch.sin(half_angle))
    scale = torch.where(small, 2.0 + angle * angle / 12.0, angle / sin_half)
    return q[..., 1:] * scale


def axis_angle_to_matrix(aa: Tensor) -> Tensor:
    return quat_to_matrix(axis_angle_to_quat(aa))


def matrix_to_axis_angle(m: Tensor) -> Tensor:
    return quat_to_axis_angle(matrix_to_quat(m))


def matrix_to_rot6d(m: Tensor) -> Tensor:
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def rot6d_to_matrix(d6: Tensor) -> Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt, rows stacked."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = _cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-2)


def quat_to_rot6d(q: Tensor) -> Tensor:
    """(..., 4) -> (..., 6) (JAX ``ops/rotations.py:273``)."""
    return matrix_to_rot6d(quat_to_matrix(q))


def rot6d_to_quat(d6: Tensor) -> Tensor:
    """(..., 6) -> (..., 4) (JAX ``ops/rotations.py:277``)."""
    return matrix_to_quat(rot6d_to_matrix(d6))
