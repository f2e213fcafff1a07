"""Step functions: the port of ``repro/launch/steps.py``
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``).

The reference builds an ``LM`` from a config and passes the parameters to
each call; here ``LM`` holds its parameters, so each maker takes the
model, and the train step takes the model in the parameters' place.

A model whose parameters are DTensors (``sharding.shard_params``) trains
on their mesh, as the reference's step does under its ambient mesh: each
rank takes its rows of the batch (a ``make_global_batch`` DTensor's local
shard, or its block of a whole batch), gathers each block's parameters on
use, and weights its cross-entropy by its share of the global token
count, so the loss is the mean over the global batch; each gradient is
the sum over the data ranks, held on the parameter's shards, and AdamW
updates the shards.  The MoE load-balance term is the mean of the data
ranks' (each over its rows), where the reference's is the global
batch's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import layers
from ..models.lm import LM
from ..optim import adamw
from ..parallel import sharding


def _split(batch, accum: int):
    """``accum`` microbatches along the batch axis, in order."""
    return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def loss_and_grads(model: LM, batch):
    """(loss, metrics, grads): ``LM.loss`` on ``batch`` and its gradient
    with respect to every parameter of ``model``, by parameter name, in
    the parameter's dtype (zeros for a parameter the loss does not
    reach), as ``jax.value_and_grad`` gives them."""
    names, params = zip(*model.named_parameters())
    mesh = sharding.mesh_of(params)
    if mesh is not None:
        return _sharded_loss_and_grads(model, _local_rows(batch, mesh),
                                       names, params, mesh)
    total, metrics = model.loss(batch)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _local_rows(batch, mesh):
    return {k: sharding.local_rows(v, mesh) for k, v in batch.items()}


def _sharded_loss_and_grads(model, batch, names, params, mesh):
    """``loss_and_grads`` of a model with DTensor parameters on this
    rank's rows ``batch``: its cross-entropy weighted by its share of the
    global token count, gradients summed over the data ranks onto the
    shards; the metrics are the global batch's."""
    _, metrics = model.loss(batch)
    ce, aux, count = metrics["ce"], metrics["aux"], metrics["tokens"]
    n_data = sharding.data_shard(mesh)[1]
    share = count / sharding.data_sum(count, mesh)
    total = ce * share + 0.01 * aux / n_data
    grads = torch.autograd.grad(total, params, allow_unused=True)
    out = {}
    for n, p, g in zip(names, params, grads):
        if g is None:
            g = sharding.from_local(torch.zeros_like(sharding.local(p)), p)
        elif g.placements != p.placements:
            g = g.redistribute(mesh, p.placements)
        out[n] = g
    ce_g = sharding.data_sum(ce.detach() * share.detach(), mesh)
    aux_g = sharding.data_sum(aux.detach(), mesh) / n_data
    return (sharding.data_sum(total.detach(), mesh),
            {"ce": ce_g, "aux": aux_g,
             "tokens": sharding.data_sum(count, mesh)}, out)


def make_train_step(lm: LM, opt_cfg: Optional[adamw.AdamWConfig] = None,
                    accum: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)`` for models of ``lm``'s config (``model`` is ``lm`` or one
    built like it; ``layers.trainable`` makes its parameters require
    grad).  The gradients of ``LM.loss`` go to ``adamw.update``, which
    updates the model and the state in place.  ``accum`` > 1 splits the
    batch into microbatches along its first axis, sums their gradients in
    float32 and divides by ``accum``; the loss is the microbatches' mean
    and the other metrics the last microbatch's, as the reference's scan
    returns them.  A non-finite loss applies nothing: the model, the
    moments, the master weights and the step counter stay as they were,
    and the metrics say ``skipped``.  Metrics: ``ce``, ``aux``,
    ``tokens``, ``loss``, ``grad_norm``, ``lr`` (0-d tensors)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if accum < 1:
        raise ValueError(f"accum={accum}")

    def train_step(model, opt_state, batch):
        if model.cfg != lm.cfg:
            raise ValueError(f"train step of {lm.cfg.name} given a model of "
                             f"{model.cfg.name}")
        if accum == 1:
            loss, metrics, grads = loss_and_grads(model, batch)
        else:
            names, params = zip(*model.named_parameters())
            mesh = sharding.mesh_of(params)
            if mesh is not None:
                batch = _local_rows(batch, mesh)
            grads, loss = None, 0.0
            for mb in _split(batch, accum):
                l, metrics, g = loss_and_grads(model, mb) if mesh is None \
                    else _sharded_loss_and_grads(model, mb, names, params,
                                                 mesh)
                if grads is None:
                    grads = {k: torch.zeros_like(v, dtype=torch.float32)
                             for k, v in g.items()}
                for k, v in g.items():
                    grads[k] += v.float()
                loss = loss + l
                del g
            grads = {k: v / accum for k, v in grads.items()}
            loss = loss / accum
        metrics = dict(metrics, loss=loss)
        if not bool(torch.isfinite(loss)):
            return model, opt_state, dict(metrics, skipped=True)
        params = dict(model.named_parameters())
        _, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state,
                                                 params)
        return model, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_prefill_step(lm: LM):
    """Inference forward over the full sequence -> last-token logits
    ``[B, V]``, for every family: the batch holds ``tokens``, and the
    vlm family's ``img [B, T, d]`` or the audio family's ``frames [B, S,
    d]`` in place of tokens."""
    cfg = lm.cfg

    @torch.inference_mode()
    def prefill_step(batch):
        x = lm._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = lm._backbone(x, positions, batch)
        x = layers.rmsnorm(x, lm.ln_f, cfg.norm_eps)
        return lm._unembed(x[:, -1:, :])[:, 0, :]

    return prefill_step


def make_serve_step(lm: LM):
    """One decode step: (caches, token, pos) -> (logits, caches), the
    caches those of ``lm.init_caches`` (a stacked ``KVCache``, bf16,
    float32 or int8 with its scales, of the dense and moe families; the
    vlm family's dict with its cross caches; an ``RWKVCache``; the hybrid
    family's dict), updated in place.  The audio encoder does not
    decode."""

    @torch.inference_mode()
    def serve_step(caches, token, pos):
        return lm.decode_step(caches, token, pos)

    return serve_step
