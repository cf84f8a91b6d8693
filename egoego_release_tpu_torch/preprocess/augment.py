"""AMASS augmentation for physics-controller (UHC) training data (host
numpy, copied from egoego_release_tpu/preprocess/augment.py; its one import
from the JAX package, ``matrix_to_quat_np``, comes from this package's
``ops.rotations``).

The computational core of the reference's
kinpoly/copycat/data_process/augment_amass.py (the copycat training-set
augmenter): SMPL left-right mirroring (:28-49), random-hemisphere root
sampling (:52-58), random window sampling (:60-80), random body shape
(:82-87), and the begin-feet height fix with the crawling guard and
ground-penetration veto (:89-109).

Host-side numpy by design: these run once per dataset at preprocessing
time (the reference also runs them on the CPU); the trainers consume the
resulting pickles. Deviations from the reference:

- ``flip_smpl`` avoids the reference's per-joint scipy ZXY-euler round
  trip: negating the Z and Y angles of an intrinsic ZXY decomposition is
  conjugation of the rotation by the sagittal reflection S = diag(-1, 1, 1)
  (R' = S R S), so the mirror is one batched matrix conjugation plus the
  left/right joint permutation.
- ``fix_height_qpos`` takes the world body positions (wbpos) from an FK
  instead of re-running the reference's MuJoCo ``get_expert`` env round
  trip.
"""

from __future__ import annotations

import numpy as np

# augment_amass.py:26 — SMPL joint permutation swapping left<->right limbs
LEFT_RIGHT_IDX = np.array(
    [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
     21, 20, 23, 22],
    np.int64,
)

_SAGITTAL = np.diag([-1.0, 1.0, 1.0]).astype(np.float64)


def _aa_to_matrix_np(aa: np.ndarray) -> np.ndarray:
    """Batched axis-angle -> rotation matrix (Rodrigues), numpy."""
    aa = np.asarray(aa, np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    safe = np.where(theta < 1e-12, 1.0, theta)
    axis = aa / safe
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    k = np.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], axis=-1
    ).reshape(aa.shape[:-1] + (3, 3))
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + np.sin(t) * k + (1.0 - np.cos(t)) * (k @ k)


def _matrix_to_aa_np(m: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> axis-angle via the quaternion converter
    (``ops.rotations.matrix_to_quat_np`` is robust across the whole angle
    range, including near pi where the matrix-log antisymmetric part
    degenerates)."""
    from egoego_release_tpu_torch.ops.rotations import matrix_to_quat_np

    m = np.asarray(m, np.float64)
    q = matrix_to_quat_np(m.reshape(-1, 3, 3))
    w = np.clip(q[:, 0], -1.0, 1.0)
    v = q[:, 1:]
    vn = np.linalg.norm(v, axis=-1)
    theta = 2.0 * np.arctan2(vn, w)
    safe = np.where(vn < 1e-12, 1.0, vn)
    aa = v / safe[:, None] * theta[:, None]
    return aa.reshape(m.shape[:-2] + (3,))


def flip_smpl(pose: np.ndarray) -> np.ndarray:
    """Left-right mirror a batch of SMPL poses (augment_amass.py:34-49).

    pose: (T, 72) axis-angle (24 joints x 3).  Returns (T, 72).

    The reference converts every joint to intrinsic ZXY euler, negates the
    Z and Y angles, and converts back; that map is R -> S R S with
    S = diag(-1,1,1) (sagittal reflection), applied here directly.  The
    joint permutation then swaps left/right limbs.
    """
    t = pose.shape[0]
    mats = _aa_to_matrix_np(pose.reshape(t, 24, 3))
    mirrored = _SAGITTAL @ mats @ _SAGITTAL
    aa = _matrix_to_aa_np(mirrored)
    aa = aa[:, LEFT_RIGHT_IDX, :]
    return aa.reshape(t, 72).astype(pose.dtype if pose.dtype.kind == "f"
                                    else np.float64)


def sample_random_hemisphere_root(rng: np.random.RandomState) -> np.ndarray:
    """Random root orientation on the downward hemisphere
    (augment_amass.py:52-58): compose Rx(pi + U[0,pi/3)) with
    Ry(U[0,2pi)) and return the axis-angle vector."""
    rot = rng.random_sample() * np.pi * 2
    pitch = rng.random_sample() * np.pi / 3 + np.pi
    r = _aa_to_matrix_np(np.array([[pitch, 0.0, 0.0]]))[0]
    r2 = _aa_to_matrix_np(np.array([[0.0, rot, 0.0]]))[0]
    return _matrix_to_aa_np((r @ r2)[None])[0]


def sample_seq_length(seq, tran, seq_length: int = 150,
                      rng: np.random.RandomState | None = None):
    """Window sampling with jittered start points (augment_amass.py:60-80).

    Returns (seqs, trans, start_points); seq_length=-1 passes through.
    The reference draws from the global numpy RNG; ours takes an explicit
    generator (identical draw structure)."""
    rng = rng or np.random
    if seq_length == -1:
        return [seq], [tran], []
    num_possible_seqs = seq.shape[0] // seq_length
    max_seq = seq.shape[0]
    start_idx = rng.randint(0, 10)
    start_points = [max(0, max_seq - (seq_length + start_idx))]
    for i in range(1, num_possible_seqs - 1):
        start_points.append(i * seq_length + rng.randint(-10, 10))
    if num_possible_seqs >= 2:
        start_points.append(max_seq - seq_length - rng.randint(0, 10))
    seqs = [seq[i:(i + seq_length)] for i in start_points]
    trans = [tran[i:(i + seq_length)] for i in start_points]
    return seqs, trans, start_points


def get_random_shape(batch_size: int,
                     rng: np.random.RandomState | None = None) -> np.ndarray:
    """Random betas, first three from N(0, 1.5) (augment_amass.py:82-87);
    numpy instead of torch."""
    rng = rng or np.random
    shape = np.tile(rng.random_sample((1, 10)), (batch_size, 1))
    shape[:, :3] = rng.normal(scale=1.5, size=(3,))
    return shape.astype(np.float32)


#: augment_amass.py:89-109 hyperparameters
FEET_OFFSET = 0.015
GROUND_PENETRATION_THRESH = -0.15
CRAWLING_ROOT_Z = 0.3
CRAWLING_FEET_Z = -0.1
#: SMPL body indices of the ankles in the 24-joint wbpos layout (:92)
_ANKLE_IDX = (4, 8)


def fix_height_qpos(qpos: np.ndarray, wbpos: np.ndarray):
    """Shift a qpos trajectory so the first frame's feet touch the ground
    (augment_amass.py:89-109).

    qpos: (T, 76); wbpos: (T, 24, 3) world body positions from FK of qpos
    (the reference takes them from its MuJoCo get_expert record).

    Returns (shifted_qpos, status) where status is one of
      "fixed"    — z shifted by (begin_feet - FEET_OFFSET)
      "crawling" — sequence starts prone (root z < 0.3 with feet above
                   -0.1): left unshifted, as in the reference
      "invalid"  — after shifting, a foot penetrates below -0.15 m: the
                   reference drops the sequence (returns None); we return
                   the shifted qpos with the veto so callers decide.

    The penetration check uses the SAME wbpos shifted by the z offset —
    valid because a rigid global z translation of qpos translates every
    FK body position equally (the reference re-runs get_expert to get the
    same answer).
    """
    wbpos = wbpos.reshape(wbpos.shape[0], 24, 3)
    begin_feet = min(wbpos[0, _ANKLE_IDX[0], 2], wbpos[0, _ANKLE_IDX[1], 2])
    begin_root = wbpos[0, 0, 2]
    if begin_root < CRAWLING_ROOT_Z and begin_feet > CRAWLING_FEET_Z:
        return qpos, "crawling"
    shift = begin_feet - FEET_OFFSET
    out = np.array(qpos, copy=True)
    out[:, 2] -= shift
    new_feet = wbpos[:, _ANKLE_IDX, 2] - shift
    if new_feet.min() < GROUND_PENETRATION_THRESH:
        return out, "invalid"
    return out, "fixed"
