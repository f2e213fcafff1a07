"""Gradient compression with error feedback: the port of
``repro/optim/compress.py``.

int8 quantisation per block of ``BLOCK`` values with a float32 scale
(``max|x| / 127 + 1e-12``), round half to even (``torch.round``, as
``jnp.round``), and an error-feedback accumulator that carries each
step's residual to the next.  Trees are dicts of tensors; every result
is the reference's to the bit (IEEE float32 division, multiplication and
subtraction on the same values).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

BLOCK = 256
Tree = Dict[str, torch.Tensor]


class EFState(NamedTuple):
    error: Tree              # float32 residual, grad-shaped


def init_ef(grads: Tree) -> EFState:
    return EFState(error={k: torch.zeros(g.shape, dtype=torch.float32,
                                         device=g.device)
                          for k, g in grads.items()})


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    flat = flat.reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(flat / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape
                  ) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compress_grads(grads: Tree, ef: EFState
                   ) -> Tuple[Tree, Tree, EFState]:
    """Returns (int8 codes ``[blocks, BLOCK]``, float32 scales ``[blocks,
    1]``, the new error state) per leaf: the value sent is the gradient
    plus the carried error; what the codes cannot hold is carried on."""
    qs, ss, es = {}, {}, {}
    for k, g in grads.items():
        target = g.float() + ef.error[k]
        qs[k], ss[k] = _quant_leaf(target)
        es[k] = target - _dequant_leaf(qs[k], ss[k], g.shape)
    return qs, ss, EFState(error=es)


def decompress_grads(q_tree: Tree, s_tree: Tree, like: Tree) -> Tree:
    return {k: _dequant_leaf(q_tree[k], s_tree[k], g.shape).to(g.dtype)
            for k, g in like.items()}


def compressed_bytes(q_tree: Tree, s_tree: Tree) -> int:
    return sum(q.numel() for q in q_tree.values()) + \
        sum(4 * s.numel() for s in s_tree.values())
