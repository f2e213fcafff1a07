"""Carry parameters between the JAX package's layout and the port's.

The reference keeps a model's parameters as a nested dict whose block
leaves are stacked along a leading layer axis (``blocks/attn/wq`` is
``[L, d, Hq*Dh]``); the port's ``LM`` holds one module per block
(``blocks.3.attn.wq`` is ``[d, Hq*Dh]``).  Weight layouts are the same
(``[d_in, d_out]``), so a tensor carries over as it is.

* ``jax_tree_shapes(cfg)``: ``{path: shape}`` of the reference's tree,
  derived from the port's modules (no JAX needed).
* ``params_from_jax(cfg, tree)``: the reference's tree, as numpy arrays,
  to the port's ``state_dict`` (``LM.load_state_dict``).
* ``random_jax_tree(cfg, seed)``: a tree of seeded float32 numpy
  weights in the reference's layout, the same on every machine (one
  PCG64 stream per tensor, uniform draws only), for checks that need
  the same weights in both packages.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .lm import LM

Path = Tuple[str, ...]


def _port_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    lm = LM(cfg, device="meta")
    return {k: tuple(v.shape) for k, v in lm.state_dict().items()}


def _jax_path(name: str) -> Tuple[Path, int]:
    """``blocks.3.attn.wq`` -> (("blocks", "attn", "wq"), 3); a top-level
    leaf -> ((name,), -1)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("blocks", *parts[2:]), int(parts[1])
    return tuple(parts), -1


def jax_tree_shapes(cfg: ModelConfig) -> Dict[Path, tuple]:
    """``{path: shape}`` of the reference's parameter tree for ``cfg``."""
    out = {}
    for name, shape in _port_shapes(cfg).items():
        path, layer = _jax_path(name)
        out[path] = (cfg.n_layers, *shape) if layer >= 0 else shape
    return out


def _leaf(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a) -> torch.Tensor:
    """numpy (float32, float16 or ml_dtypes bfloat16) -> torch, sharing
    the array's memory and strides."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(cfg: ModelConfig, tree) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (nested dicts of numpy arrays) as
    the port's ``state_dict`` on the CPU, each tensor in the leaf's
    dtype; raises on a missing leaf or a shape that differs."""
    sd = {}
    for name, shape in _port_shapes(cfg).items():
        path, layer = _jax_path(name)
        a = _leaf(tree, path)
        if layer >= 0:
            a = a[layer]
        if tuple(a.shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(a.shape)}, "
                             f"the port's {name} is {shape}")
        sd[name] = _tensor(a)
    return sd


def _scale_shift(path: Path, shape: tuple):
    """(scale, centre) of a leaf's random values, after the reference's
    init: ones for norms, 0.5 for mixes, -6 for w0, fan-in scale for
    weights, with some spread everywhere."""
    leaf = path[-1]
    if leaf.startswith("ln") or leaf.endswith("_norm"):
        return 0.1, 1.0
    if leaf.startswith("mu_"):
        return 0.1, 0.5
    if leaf == "w0":
        return 0.5, -6.0
    if leaf == "u":
        return 0.1, 0.0
    if leaf in ("mix_B", "wB"):
        return 0.01, 0.0
    if leaf == "embed":
        return shape[-1] ** -0.5, 0.0
    return shape[-2] ** -0.5, 0.0


def random_jax_tree(cfg: ModelConfig, seed: int):
    """Seeded float32 weights in the reference's layout: leaf ``i`` (in
    sorted path order) is ``centre + scale * sqrt(3) * (2 U - 1)``, U
    from ``default_rng([seed, i]).random(dtype=float32)``; the dead
    WKV-head rows of ``time/wo`` are zeroed, as the init does."""
    tree: dict = {}
    for i, (path, shape) in enumerate(sorted(jax_tree_shapes(cfg).items())):
        scale, centre = _scale_shift(path, shape)
        u = np.random.default_rng([seed, i]).random(shape, dtype=np.float32)
        a = (u * np.float32(2) - np.float32(1)) * np.float32(scale * 3 ** 0.5)
        a += np.float32(centre)
        if path[-2:] == ("time", "wo"):
            a[:, cfg.d_model:] = 0
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return tree


def tree_sha256(tree) -> str:
    """sha256 over every leaf's first 4,096 values (little-endian
    float32), in sorted path order: shows that two machines drew the
    same weights."""
    h = hashlib.sha256()

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], prefix + (key,))
            else:
                h.update("/".join(prefix + (key,)).encode())
                h.update(np.ascontiguousarray(
                    node[key].reshape(-1)[:4096], "<f4").tobytes())
    walk(tree, ())
    return h.hexdigest()
