"""Heading extraction and per-window canonicalization (port of
egoego_release_tpu/ops/heading.py ``get_heading_quat``, ``de_heading`` and
``rotate_at_frame``)."""

from __future__ import annotations

import torch

from egoego_release_tpu_torch.ops import rotations as rot


def get_heading_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The heading (z-axis) part of wxyz quaternions: x and y zeroed, then
    renormalized (JAX ``ops/heading.py:23``)."""
    heading = q * q.new_tensor([1.0, 0.0, 0.0, 1.0])
    return heading / torch.linalg.norm(heading, dim=-1, keepdim=True).clamp_min(eps)


def de_heading(q: torch.Tensor) -> torch.Tensor:
    """``q`` without its heading: heading(q)^-1 * q (JAX ``ops/heading.py:34``)."""
    return rot.quat_multiply(rot.quat_invert(get_heading_quat(q)), q)


def rotate_at_frame(trans: torch.Tensor, quat: torch.Tensor, cano_t_idx: int = 0,
                    eps: float = 1e-8):
    """Canonicalize a trajectory so frame ``cano_t_idx`` faces +x.

    trans (B, T, 3), quat (B, T, 4) wxyz. Returns (new_trans, new_quat,
    yrot (B, 1, 1, 4)), where applying yrot maps back to the scene. The
    two normalizations divide by (norm + eps), as the reference's lafan1
    ``normalize`` does; they do not clamp.
    """
    key_q = quat[:, cano_t_idx: cano_t_idx + 1, :]
    x_axis = trans.new_tensor([1.0, 0.0, 0.0]).expand(key_q.shape[:-1] + (3,))
    forward = rot.quat_apply(key_q, x_axis) * trans.new_tensor([1.0, 1.0, 0.0])
    forward = forward / (torch.linalg.norm(forward, dim=-1, keepdim=True) + eps)

    yrot = rot.quat_between(x_axis, forward)
    yrot = yrot / (torch.linalg.norm(yrot, dim=-1, keepdim=True) + eps)

    yrot_inv = rot.quat_invert(yrot)
    new_quat = rot.quat_multiply(yrot_inv, quat)
    new_trans = rot.quat_apply(yrot_inv, trans)
    return new_trans, new_quat, yrot[:, None]
