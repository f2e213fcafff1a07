"""Architecture registry of the port: the reference's ten architectures,
every feature of which ``repro_torch.models`` runs.

Each module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family configuration for CPU tests), copied
from ``repro/configs``.  ``get(name)`` / ``get_smoke(name)`` /
``ARCH_NAMES`` / ``ALIASES`` are the public API; ``--arch <id>`` in the
launchers resolves through here.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_NAMES: List[str] = [
    "yi_34b",
    "llama3p2_1b",
    "qwen3_0p6b",
    "stablelm_1p6b",
    "rwkv6_3b",
    "llama4_maverick_400b",
    "dbrx_132b",
    "llama3p2_vision_11b",
    "hubert_xlarge",
    "zamba2_1p2b",
]

# accepted aliases (assignment spelling -> module name)
ALIASES: Dict[str, str] = {
    "yi-34b": "yi_34b",
    "llama3.2-1b": "llama3p2_1b",
    "qwen3-0.6b": "qwen3_0p6b",
    "stablelm-1.6b": "stablelm_1p6b",
    "rwkv6-3b": "rwkv6_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "dbrx-132b": "dbrx_132b",
    "llama-3.2-vision-11b": "llama3p2_vision_11b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-1.2b": "zamba2_1p2b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"{__name__}.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
