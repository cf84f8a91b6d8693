"""What the capability tools share about their data."""

from __future__ import annotations

import numpy as np


def tool_rest_offsets() -> np.ndarray:
    """The tools' synthetic skeleton (the SMPL assets are licence-gated):
    zero root offset, the rest uniform in [-0.2, 0.2) from RandomState(0)."""
    rng = np.random.RandomState(0)
    return np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32)
