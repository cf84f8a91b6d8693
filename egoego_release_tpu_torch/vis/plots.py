"""Matplotlib visualization (host-side; port of egoego_release_tpu/vis/plots.py,
copied, ``SMPL_PARENTS`` from the port's ``ops/fk.py``).

Ports the useful plots from egoego/vis/head_motion.py (head-pose trajectory
3D/2D plots, single or comparative) and egoego/vis/pose.py
(show3Dpose_animation — 22-joint skeleton animation over the SMPL tree).
scenepic HTML output is out of scope (vis-only dependency); OBJ export for
Blender lives in vis/mesh_export.py.
"""

from __future__ import annotations

import os

import numpy as np

from egoego_release_tpu_torch.ops.fk import SMPL_PARENTS

_BONES = [(j, int(SMPL_PARENTS[j])) for j in range(1, 22)]


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def vis_head_pose_traj(
    head_trans: np.ndarray,            # (T, 3)
    head_rot_mat: np.ndarray | None,   # (T, 3, 3) optional orientation arrows
    out_path: str,
    gt_head_trans: np.ndarray | None = None,
    stride: int = 10,
):
    """3D head trajectory (optionally vs GT) with forward-direction quivers
    (head_motion.py vis_single_head_pose_traj / vis_multiple_head_pose_traj)."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.plot(*head_trans.T, "-b", label="pred")
    if gt_head_trans is not None:
        ax.plot(*gt_head_trans.T, "-g", label="gt")
    if head_rot_mat is not None:
        idx = np.arange(0, head_trans.shape[0], stride)
        fwd = head_rot_mat[idx, :, 0] * 0.1  # body-x forward
        ax.quiver(*head_trans[idx].T, *fwd.T, color="r", length=1.0)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def vis_head_traj_2d(head_trans: np.ndarray, out_path: str,
                     gt_head_trans: np.ndarray | None = None):
    """Top-down xy trajectory plot (head_motion.py 2d variants)."""
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(head_trans[:, 0], head_trans[:, 1], "-b", label="pred")
    if gt_head_trans is not None:
        ax.plot(gt_head_trans[:, 0], gt_head_trans[:, 1], "-g", label="gt")
    ax.set_aspect("equal"); ax.legend(); ax.set_xlabel("x"); ax.set_ylabel("y")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def show3dpose_animation(
    jpos_seqs: np.ndarray,   # (K, T, 22, 3) one or more skeletons to overlay
    out_path: str,
    fps: int = 30,
):
    """Skeleton animation over the SMPL 22-joint tree -> gif/mp4
    (pose.py show3Dpose_animation)."""
    plt = _require_mpl()
    from matplotlib import animation

    jpos_seqs = np.asarray(jpos_seqs)
    if jpos_seqs.ndim == 3:
        jpos_seqs = jpos_seqs[None]
    k, t = jpos_seqs.shape[:2]
    colors = ["b", "g", "r", "m"]

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    mins = jpos_seqs.reshape(-1, 3).min(0)
    maxs = jpos_seqs.reshape(-1, 3).max(0)
    lines = []
    for ki in range(k):
        lines.append([
            ax.plot([], [], [], "-", c=colors[ki % len(colors)])[0] for _ in _BONES
        ])
    ax.set_xlim(mins[0], maxs[0]); ax.set_ylim(mins[1], maxs[1]); ax.set_zlim(mins[2], maxs[2])

    def update(f):
        for ki in range(k):
            for li, (j, p) in enumerate(_BONES):
                seg = jpos_seqs[ki, f, [p, j]]
                lines[ki][li].set_data(seg[:, 0], seg[:, 1])
                lines[ki][li].set_3d_properties(seg[:, 2])
        return sum(lines, [])

    anim = animation.FuncAnimation(fig, update, frames=t, interval=1000 / fps)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
