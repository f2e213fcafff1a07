"""Mesh construction: the port of ``repro/launch/mesh.py``.

Functions, never module constants, so importing this module touches no
process group.  The single-pod mesh is ``(data=16, model=16)`` = 256
ranks; multi-pod adds a leading ``pod`` axis, ``(pod=2, data=16,
model=16)`` = 512 ranks.  ``pod`` is a pure data-parallel axis, outermost,
so gradient sums reduce within a pod first.  Each needs a process group
(``sharding.init_distributed``) with at least the mesh's ranks; the mesh
takes the first ones in row-major order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import sharding


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the world's first ranks (tests, elastic
    re-meshing)."""
    n = int(np.prod(shape))
    return sharding.mesh_of_ranks(np.arange(n).reshape(shape), axes)


def make_host_mesh(model: Optional[int] = None) -> DeviceMesh:
    """``(world // model, model)`` over every rank."""
    n = sharding.world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"model={model} does not divide the world of {n}")
    return make_mesh((n // model, model), ("data", "model"))
