"""Carry parameters between the JAX package's layout and the port's.

The reference keeps a model's parameters as a nested dict whose block
leaves are stacked along leading axes (``blocks/attn/wq`` is ``[L, d,
Hq*Dh]``, an MoE layer's ``blocks/moe/wi_gate`` ``[L, E, d, f]``;
llama4's ``dense_blocks/...`` and ``moe_blocks/...`` ``[L / 2, ...]``;
the vlm family's ``self_blocks/...`` ``[n_cross, per_group, ...]`` and
``cross_blocks/...`` ``[n_cross, ...]``, its gates ``[n_cross]``; the
hybrid family's ``mamba_groups/ssm/wz`` ``[n_groups, every, d,
d_inner]``, ``mamba_tail/...`` ``[tail, ...]`` and ``shared_attn/...``
unstacked); the port's ``LM`` holds one module per block
(``blocks.3.attn.wq`` is ``[d, Hq*Dh]``, ``self_blocks.1.2.mlp.wo``
``[f, d]``, ``cross_blocks.1.gate_attn`` 0-d).  Weight layouts are the
same (``[d_in, d_out]``), so a tensor carries over as it is.

* ``jax_tree_shapes(cfg)``: ``{path: shape}`` of the reference's tree,
  derived from the port's modules (no JAX needed).
* ``params_from_jax(cfg, tree)``: the reference's tree, as numpy arrays,
  to the port's ``state_dict`` (``LM.load_state_dict``).
* ``tree_from_port(cfg, tensors)``: the reverse map: the port's
  tensors by parameter name (parameters, gradients, optimizer moments or
  master weights) as the reference's tree of numpy arrays, each
  per-block tensor written into its slot of the stacked leaf, so that a
  test compares gradients and optimizer state leaf by leaf.
* ``random_jax_tree(cfg, seed)``: a tree of seeded float32 numpy
  weights in the reference's layout, the same on every machine (one
  PCG64 stream per tensor, uniform draws only), for checks that need
  the same weights in both packages.  float32 is the reference's dtype
  of every leaf at ``param_dtype="float32"``, and of the Mamba2 mixers'
  ``A_log``, ``D`` and ``dt_bias`` at any ``param_dtype``.
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .lm import LM

Path = Tuple[str, ...]


def _port_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    lm = LM(cfg, device="meta")
    return {k: tuple(v.shape) for k, v in lm.state_dict().items()}


def _jax_path(name: str) -> Tuple[Path, Tuple[int, ...]]:
    """A port name -> (the reference's path, the indices into its
    leading stack axes): ``blocks.3.attn.wq`` -> (("blocks", "attn",
    "wq"), (3,)); ``mamba_groups.1.4.ln`` (or ``self_blocks.1.4.ln``) ->
    (("mamba_groups", "ln"), (1, 4)); ``shared_attn.attn.wq`` or a
    top-level leaf -> (path, ())."""
    parts = name.split(".")
    idx = tuple(int(a) for a in parts[1:] if a.isdigit())
    return (parts[0], *(a for a in parts[1:] if not a.isdigit())), idx


def jax_tree_shapes(cfg: ModelConfig) -> Dict[Path, tuple]:
    """``{path: shape}`` of the reference's parameter tree for ``cfg``:
    each stacked leaf's leading axes are its largest indices plus one."""
    shapes, lead = {}, {}
    for name, shape in _port_shapes(cfg).items():
        path, idx = _jax_path(name)
        shapes[path] = shape
        lead[path] = tuple(max(a, i + 1) for a, i in
                           zip(lead.get(path, (0,) * len(idx)), idx))
    return {path: (*lead[path], *shape) for path, shape in shapes.items()}


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
        path, idx = _jax_path(name)
        a = np.asarray(_leaf(tree, path)[idx])     # a 0-d gate stays an array
        if tuple(a.shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(a.shape)}, "
                             f"the port's {name} is {shape}")
        sd[name] = _tensor(a)
    return sd


def tree_from_port(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]
                   ) -> dict:
    """Tensors keyed by the port's parameter names (every one of them) as
    the reference's nested dict of numpy arrays: float tensors as float32
    (bf16 widened exactly), stacked along the reference's leading axes."""
    shapes = jax_tree_shapes(cfg)
    tree: dict = {}
    for name in _port_shapes(cfg):
        path, idx = _jax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if path[-1] not in node:
            node[path[-1]] = np.zeros(shapes[path], np.float32)
        t = tensors[name].detach().cpu()
        node[path[-1]][idx] = t.float().numpy() if t.is_floating_point() \
            else t.numpy()
    return tree


def _scale_shift(path: Path, shape: tuple):
    """(scale, centre) of a leaf's random values, after the reference's
    init: ones for norms and ``D``, 0.5 for mixes, -6 for w0, the
    Mamba2 mixers' ``A_log`` (log 1 .. log 16) and ``dt_bias`` (the
    inverse softplus of 1e-3 .. 0.1) about their ranges, fan-in scale
    for weights and conv taps, with some spread everywhere.  The cross
    blocks' gates, 0 at init (which would pass the block's input
    through), are drawn from 0.25 .. 0.95, so that a check that uses
    these weights runs the cross-attention and its MLP."""
    leaf = path[-1]
    if leaf.startswith("gate_"):
        return 0.2, 0.6
    if leaf.startswith("ln") or leaf.endswith("_norm") or \
            leaf in ("norm_g", "D"):
        return 0.1, 1.0
    if leaf == "A_log":
        return 0.8, 1.4
    if leaf == "dt_bias":
        return 1.0, -4.5
    if leaf == "conv_b":
        return 0.1, 0.0
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


CHUNK = 1 << 24                  # values a thread draws at once (even)


def _fill(out: np.ndarray, entropy, start: int, scale: float,
          centre: float) -> None:
    """``out`` (a flat slice from value ``start``, even) as
    ``random_jax_tree`` draws it: a PCG64 stream of ``entropy`` advanced
    by ``start / 2`` outputs gives the values from ``start`` on (a
    float32 draw takes half of one 64-bit output)."""
    bits = np.random.PCG64(entropy)
    bits.advance(start // 2)
    np.random.Generator(bits).random(out=out, dtype=np.float32)
    out *= np.float32(2)
    out -= np.float32(1)
    out *= np.float32(scale * 3 ** 0.5)
    out += np.float32(centre)


def random_jax_tree(cfg: ModelConfig, seed: int):
    """Seeded float32 weights in the reference's layout: leaf ``i`` (in
    sorted path order) is ``centre + scale * sqrt(3) * (2 U - 1)``, U
    from ``default_rng([seed, i]).random(dtype=float32)``; the dead
    WKV-head rows of ``time/wo`` are zeroed, as the init does.  Drawn in
    chunks of ``CHUNK`` values on a pool of threads (numpy draws and
    computes outside the interpreter lock), each chunk from its own
    advanced copy of the leaf's stream, so the values are those of one
    draw of the whole leaf (a full-width layer of dbrx-132b is 4.5 G
    values)."""
    tree: dict = {}
    jobs = []
    for i, (path, shape) in enumerate(sorted(jax_tree_shapes(cfg).items())):
        scale, centre = _scale_shift(path, shape)
        a = np.empty(shape, np.float32)
        flat = a.reshape(-1)
        jobs += [(flat[j:j + CHUNK], [seed, i], j, scale, centre)
                 for j in range(0, flat.size, CHUNK)]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for f in [pool.submit(_fill, *job) for job in jobs]:
            f.result()
    for path in jax_tree_shapes(cfg):
        if path[-2:] == ("time", "wo"):
            _leaf(tree, path)[:, cfg.d_model:] = 0
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
