"""The comparison that decides ``correct``: what the timed path produced for
the checked rows against the plain reference (``reference.py``) run on the
same inputs, and each number beside the limit that the cell's file sets.
Each gap is taken per item (a rotation, a root or joint position of a
frame, a metric value) over the checked rows of a batch, as its widest and
its mean; the run reads each number's widest over the checked batches. A
cell's file names the numbers it compares:

  rot_gap, rot_gap_mean           the chain's local joint rotations (its
                                  ``local_aa`` as matrices): the largest entry
                                  of a rotation's difference
  root_gap_m, root_gap_mean_m     the chain's root positions, metres
  jpos_gap_m, jpos_gap_mean_m     the FK joint positions the metric suite
                                  reads, metres
  metrics_gap, metrics_gap_mean   the returned metric dicts: |program -
                                  reference| over max(|reference|, 1), in
                                  each metric's own unit
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import F64, axis_angle_to_matrix


def _both(widest: str, mean: str, per_item: torch.Tensor) -> dict:
    per_item = per_item.reshape(-1)
    return {widest: per_item.max().item(), mean: per_item.mean().item()}


def gaps(program: dict, metric_dicts: list, reference: dict) -> dict:
    """``program``: the checked rows' ``local_aa`` (or their rotation
    matrices ``local``), ``root_pos`` and ``jpos`` as the timed path produced
    them; ``metric_dicts`` their returned metrics; ``reference``:
    ``Reference.run_batch``'s result for those rows."""
    dev = reference["root"].device
    pr = program["local"].to(dev, F64) if "local" in program else axis_angle_to_matrix(
        program["local_aa"].to(dev, F64))
    out = {**_both("rot_gap", "rot_gap_mean", (pr - reference["local"]).abs().amax((-2, -1))),
           **_both("root_gap_m", "root_gap_mean_m", (program["root_pos"].to(dev, F64) - reference["root"]).abs().amax(-1)),
           **_both("jpos_gap_m", "jpos_gap_mean_m", (program["jpos"].to(dev, F64) - reference["jpos"]).abs().amax(-1))}
    per_value = []
    for got, want in zip(metric_dicts, reference["metrics"], strict=True):
        if set(got) != set(want):
            return {**out, "metrics_gap": float("inf"), "metrics_gap_mean": float("inf")}
        for key, w in want.items():
            w = np.asarray(w, np.float64)
            per_value.append((np.abs(np.asarray(got[key], np.float64) - w) / np.maximum(np.abs(w), 1.0)).reshape(-1))
    out.update(_both("metrics_gap", "metrics_gap_mean", torch.as_tensor(np.concatenate(per_value))))
    return out


def widest(readings: list[dict]) -> dict:
    """Each number's widest reading over several batches (NaN counts as
    infinitely wide)."""
    return {k: max((float("inf") if not r[k] == r[k] else r[k]) for r in readings) for k in readings[0]}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def rows_to_device(captured: dict, rows) -> dict:
    idx = torch.as_tensor(rows)
    return {k: v[idx.to(v.device)] for k, v in captured.items()}
