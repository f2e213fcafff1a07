"""PyTorch/CUDA port of the PPCC reproduction (``repro``).

The layout mirrors the JAX package file for file (``core/``,
``kernels/``); the JAX package stays the reference.  The port imports
``torch`` and never ``jax``.  Public entry points run on the card unless
the caller passes ``device="cpu"`` (``repro_torch.device.resolve``).
"""
from .device import resolve as resolve_device  # noqa: F401
