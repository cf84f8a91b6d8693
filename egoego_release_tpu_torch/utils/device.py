"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU:
    a CUDA device without CUDA raises, it never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
