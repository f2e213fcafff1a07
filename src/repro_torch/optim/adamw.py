"""AdamW with float32 master weights, global-norm clipping and a cosine
schedule: the port of ``repro/optim/adamw.py``.

Parameters, gradients and the state's ``m``, ``v`` and ``master`` are
dicts of tensors keyed by parameter name (``LM.named_parameters()``
order).  The arithmetic is the reference's, in float32: the step, the
schedule, the bias corrections ``1 - b ** step`` and the clipping scale
``min(1, clip / (gnorm + 1e-9))`` are float32 tensors, read back once a
step as the exact float32 values they hold, so every elementwise update
multiplies by the float32 constant the reference uses (a Python float64
would differ in the last bits).  ``global_norm`` sums the squares leaf by
leaf in the dict's order where the reference sums its stacked leaves in
its own order: the two agree to float32 rounding, not to the bit.

``update`` works in place: ``m``, ``v`` and ``master`` are updated and
each parameter is overwritten by its master weight cast to its dtype
(the reference returns new arrays and its train step donates the old
ones).  The train step (``launch.steps``) calls it only after a finite
loss, so a non-finite step changes nothing, the step counter included.
The elementwise passes run over groups of parameters of at most
``GROUP_ELEMS`` elements, so that their float32 temporaries stay near
two groups' worth (rwkv6-3b's 3.3 G parameters would otherwise need 26
GB of them on top of its 53 GB of state); every element's arithmetic is
the same as over the whole list at once.

Sharded parameters (DTensors, ``parallel.sharding.shard_params``) get a
state that shards like them, as the reference's does: ``m``, ``v`` and
``master`` are DTensors with each parameter's placements, and the update
runs on the local shards.  ``global_norm`` then sums each leaf's squares
over its shards on every rank that holds a distinct one, before the sum
over the leaves in the same order: on a mesh of one rank the step is the
unsharded step to the bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..parallel import sharding

Tree = Dict[str, torch.Tensor]
GROUP_ELEMS = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 0-d
    m: Tree                      # float32, param-shaped
    v: Tree                      # float32, param-shaped
    master: Tree                 # float32 master copy of the params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_ratio * peak_lr`` at ``total_steps``; float32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = ((step - cfg.warmup_steps) / decay_steps).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tree) -> AdamWState:
    """Zero moments and float32 master copies, on the params' device (a
    sharded parameter's are sharded like it)."""
    dev = next(iter(params.values())).device

    def like(p, x):
        return sharding.from_local(x, p) if sharding.is_sharded(p) else x

    def zeros(p):
        return like(p, torch.zeros(sharding.local(p).shape,
                                   dtype=torch.float32, device=p.device))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: zeros(p) for k, p in params.items()},
        v={k: zeros(p) for k, p in params.items()},
        master={k: like(p, sharding.local(p).detach().float().clone())
                for k, p in params.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a sharded
    leaf's over all its shards)."""
    terms = [torch.sum(torch.square(sharding.local(x).float()))
             for x in tree.values()]
    if sharding.mesh_of(tree.values()) is not None:
        terms = sharding.sharded_sums(torch.stack(terms),
                                      list(tree.values())).unbind()
    return torch.sqrt(sum(terms))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree
           ) -> Tuple[Tree, AdamWState, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics:
    ``grad_norm``, ``lr``)."""
    names = list(params)
    gnorm = global_norm({k: grads[k] for k in names})
    # the elementwise passes run on the local shards, in place
    loc = {k: sharding.local(params[k]) for k in names}
    loc_grads = {k: sharding.local(grads[k]) for k in names}
    loc_state = AdamWState(state.step, *({k: sharding.local(v)
                                          for k, v in tree.items()}
                                         for tree in state[1:]))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    # the float32 values, as Python floats (exact), for the foreach ops
    scale_, lr_, b1c_, b2c_ = (float(x) for x in
                               torch.stack([scale, lr, b1c, b2c]).cpu())
    for group in _groups(names, loc):
        _apply(cfg, group, loc_grads, loc_state, loc, scale_, lr_, b1c_,
               b2c_)
    state = AdamWState(step, state.m, state.v, state.master)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _groups(names: list, params: Tree) -> list:
    """``names`` cut in order into runs of at most ``GROUP_ELEMS``
    elements (a larger parameter alone)."""
    groups, cur, n = [], [], 0
    for k in names:
        size = params[k].numel()
        if cur and n + size > GROUP_ELEMS:
            groups.append(cur)
            cur, n = [], 0
        cur.append(k)
        n += size
    return groups + [cur] if cur else groups


def _apply(cfg, names, grads, state, params, scale_, lr_, b1c_, b2c_):
    """The elementwise update of the parameters ``names``, in place."""
    m = [state.m[k] for k in names]
    v = [state.v[k] for k in names]
    w = [state.master[k] for k in names]
    g = torch._foreach_mul([grads[k].float() for k in names], scale_)
    # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    gg = torch._foreach_mul(g, 1 - cfg.b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, gg)
    del g, gg
    # master -= lr (mhat / (sqrt(vhat) + eps) + wd master)
    den = torch._foreach_div(v, b2c_)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(m, b1c_)
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_add_(upd, torch._foreach_mul(w, cfg.weight_decay))
    torch._foreach_mul_(upd, lr_)
    torch._foreach_sub_(w, upd)
    del upd
    for k, mw in zip(names, w):
        params[k].copy_(mw)
