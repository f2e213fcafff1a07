"""Elastic scaling: re-mesh and reshard live state when the pool of
ranks changes (a node lost, capacity added): the port of
``repro/runtime/elastic.py``.

The mechanism does not depend on the sharding, because checkpoints store
each shard with its index into the global array (``checkpoint/ckpt.py``):
``reshard_tree`` moves a live tree of DTensors onto a new mesh by
re-deriving the placements for it (``reshard_params`` from the rules);
data pipelines re-partition by themselves (``make_global_batch`` draws
each row from its own seed).  On a real fleet the surviving ranks
restore the latest checkpoint with the new mesh's placements: ``restore``
fills each target shard from whatever shards were saved.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..checkpoint import ckpt
from ..launch import mesh as mesh_mod
from ..models.config import ModelConfig
from ..parallel import sharding as shd


def remesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the world's first ranks (a subset of the
    world when it is smaller)."""
    return mesh_mod.make_mesh(shape, axes)


def reshard_params(cfg: ModelConfig, lm: torch.nn.Module,
                   new_mesh: DeviceMesh) -> torch.nn.Module:
    """Move a live model's parameters onto ``new_mesh`` (shrink or grow),
    placed by the rules for it, in place; returns ``lm``.  Every rank of
    the old mesh takes part (each parameter is gathered whole first)."""
    return shd.shard_params(cfg, lm, new_mesh)


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` placed by the ``NamedSharding`` at the same
    place in ``shardings`` (a tree of the same structure)."""
    targets = [s for _, s in ckpt._leaves(shardings)]
    return ckpt._rebuild(tree, iter(
        shd.distribute(x, s) for (_, x), s in zip(ckpt._leaves(tree),
                                                   targets)))
