"""Floor-height estimation on the device, batched over sequences (port of
egoego_release_tpu/ops/floor.py).

Same result as ``ops.geometry.determine_floor_height_and_contacts(...)[0]``
up to f32 eps-ball membership (``h + eps`` rounds in f32; the host
version compares in float64): static toe frames (speed <
FLOOR_VEL_THRESH), a 1-D DBSCAN (eps 0.005, min_samples 3) over their
heights with the noise label as a cluster, floor = the lowest cluster
median minus FLOOR_HEIGHT_OFFSET, 0 when no frame is static.

Sorted 1-D DBSCAN clusters are contiguous ranges of the sorted heights, so
the program is a sort, two searchsorted calls, running max/min scans and
segment reductions, with no pairwise matrix.
"""

from __future__ import annotations

import torch

from egoego_release_tpu_torch.ops.geometry import FLOOR_HEIGHT_OFFSET, FLOOR_VEL_THRESH

_EPS = 0.005
_MIN_SAMPLES = 3
_LEFT_TOE, _RIGHT_TOE = 10, 11


def _toe_speed(seq: torch.Tensor) -> torch.Tensor:
    """(N, T, 3) -> (N, T) displacement norms, the last repeated."""
    v = torch.linalg.norm(seq[:, 1:] - seq[:, :-1], dim=-1)
    return torch.cat([v, v[:, -1:]], dim=1)


def _flip_cum(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.flip(fn(torch.flip(x, [-1]), dim=-1).values, [-1])


def floor_heights(jpos: torch.Tensor) -> torch.Tensor:
    """(N, T, 22, 3) global joint positions -> (N,) f32 floor heights."""
    lt, rt = jpos[:, :, _LEFT_TOE], jpos[:, :, _RIGHT_TOE]
    static = torch.cat([_toe_speed(lt), _toe_speed(rt)], dim=1) < FLOOR_VEL_THRESH
    h = torch.cat([lt[..., 2], rt[..., 2]], dim=1).float()
    n, m = h.shape
    n_valid = static.sum(-1, keepdim=True)
    hs = torch.sort(torch.where(static, h, torch.full_like(h, float("inf"))), dim=-1).values
    pos = torch.arange(m, device=h.device).expand(n, m)
    valid = pos < n_valid
    inf = torch.full_like(hs, float("inf"))

    # cluster labels in [0, m); m marks noise and invalid points
    hi = torch.searchsorted(hs, hs + _EPS, right=True)
    lo = torch.searchsorted(hs, hs - _EPS, right=False)
    core = valid & (hi - lo >= _MIN_SAMPLES)
    prev_core_h = torch.cummax(torch.where(core, hs, -inf), dim=-1).values
    prev_excl = torch.cat([torch.full_like(hs[:, :1], float("-inf")), prev_core_h[:, :-1]], 1)
    new_cluster = core & (hs - prev_excl > _EPS)
    core_label = torch.cumsum(new_cluster.long(), dim=-1) - 1
    next_core_h = _flip_cum(torch.cummin, torch.where(core, hs, inf))
    lab_fwd = torch.cummax(torch.where(core, core_label, torch.full_like(core_label, -1)), dim=-1).values
    lab_bwd = _flip_cum(torch.cummin, torch.where(core, core_label, torch.full_like(core_label, m)))
    d_prev = hs - prev_core_h
    d_next = next_core_h - hs
    take_prev = d_prev <= d_next
    border = valid & ~core & (torch.where(take_prev, d_prev, d_next) <= _EPS)
    big = torch.full_like(core_label, m)
    labels = torch.where(core, core_label, torch.where(border, torch.where(take_prev, lab_fwd, lab_bwd), big))
    labels = torch.where(valid, labels, big)

    # contiguous-range medians of the real clusters
    starts = torch.full((n, m + 1), m, dtype=torch.long, device=h.device).scatter_reduce(
        1, labels, pos, reduce="amin", include_self=True)[:, :m]
    sizes = torch.zeros((n, m + 1), dtype=torch.long, device=h.device).scatter_add(
        1, labels, torch.ones_like(labels))[:, :m]
    exists = sizes > 0
    s_safe = torch.where(exists, starts, torch.zeros_like(starts))
    lo_med = torch.gather(hs, 1, torch.clamp(s_safe + (sizes - 1) // 2, 0, m - 1))
    hi_med = torch.gather(hs, 1, torch.clamp(s_safe + sizes // 2, 0, m - 1))
    med = (lo_med + hi_med) * 0.5
    cluster_min = torch.where(exists, med, torch.full_like(med, float("inf"))).amin(-1)

    # the noise "cluster" is not contiguous: its median by noise rank
    is_noise = (labels == m) & valid
    n_noise = is_noise.sum(-1, keepdim=True)
    nrank = torch.cumsum(is_noise.long(), dim=-1)
    zero = torch.zeros_like(hs)
    lo_n = torch.where(is_noise & (nrank == (n_noise - 1) // 2 + 1), hs, zero).sum(-1)
    hi_n = torch.where(is_noise & (nrank == n_noise // 2 + 1), hs, zero).sum(-1)
    noise_med = torch.where(n_noise[:, 0] > 0, (lo_n + hi_n) * 0.5, torch.full_like(lo_n, float("inf")))

    floor = torch.minimum(cluster_min, noise_med)
    return torch.where(n_valid[:, 0] > 0, floor - FLOOR_HEIGHT_OFFSET, torch.zeros_like(floor))
