"""Device resolution for the port's public entry points.

Every entry point takes an explicit ``device``.  The default is the
card (``"cuda"``); the CPU is used only when the caller asks for it, as
the tests do.  Asking for CUDA where there is none raises: nothing falls
back to the CPU behind the caller's back.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only when asked (``"meta"``, for
    shapes without storage, too); raise when CUDA is asked for and
    missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device: {dev}")
    return dev
