"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.  Asking
    for CUDA on a machine without it raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; pass "
            "device='cpu' to run the port's plain versions on the CPU")
    return dev
