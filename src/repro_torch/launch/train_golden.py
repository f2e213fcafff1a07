"""The full-width training runs that ``golden/train_full_width.json``
and ``golden/train_rwkv_full_width.json`` record, on the port's side.

Per architecture of ``GOLDENS``: qwen3-0.6b at its published width (d
1,024, 16 query and 8 KV heads of 128, d_ff 3,072, vocab 151,936, tied)
cut from 28 layers to ``LAYERS``, or rwkv6-3b at its (d 2,560, d_ff
8,960, vocab 65,536, 40 WKV heads of 64 padded to 48) cut from 32, in
float32, with seeded weights (``models.convert.random_jax_tree``) and
``SyntheticLM`` batches of B x S = ``B`` x ``S`` (seed ``SEED``):

1. the loss and gradients of step 0's batch: the loss, ce, the global
   gradient norm and each leaf's gradient norm (the reference's stacked
   leaves, by path);
2. ``STEPS`` AdamW steps (``OPT``: warmup and cosine branches, clipping
   on) through ``launch.steps.make_train_step``, on the batches of steps
   0, 1, 2: each step's loss, ce and ``grad_norm``.

``tests/test_torch_train.py --write-golden [--arch rwkv6_3b]`` runs the
JAX reference the same way and writes the golden; the CPU tests and
``chip_smoke.py`` (phases 11 and 12, and phase 13 on a mesh) hold the
port's run to it.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from .. import configs
from ..data import pipeline
from ..models import convert, layers
from ..models.config import ModelConfig, ShapeSpec
from ..models.lm import LM
from ..optim import adamw
from ..parallel import sharding
from . import steps as steps_mod

ARCH = "qwen3_0p6b"
GOLDEN_DIR = Path(__file__).resolve().parents[1] / "golden"
GOLDENS = {"qwen3_0p6b": GOLDEN_DIR / "train_full_width.json",
           "rwkv6_3b": GOLDEN_DIR / "train_rwkv_full_width.json"}
LAYERS = 2
B, S = 2, 128
STEPS = 3
SEED = 24
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=3)


def golden_config(arch: str = ARCH) -> ModelConfig:
    return configs.get(arch).with_(n_layers=LAYERS, param_dtype="float32",
                                   compute_dtype="float32")


def host_batches(cfg: ModelConfig) -> list:
    data = pipeline.SyntheticLM(cfg, ShapeSpec("golden", S, B, "train"),
                                seed=SEED)
    return [data.host_batch(step=i) for i in range(STEPS)]


def run_record(arch: str = ARCH) -> dict:
    return {"arch": arch, "layers": LAYERS, "batch": B, "seq": S,
            "steps": STEPS, "seed": SEED, "opt": OPT,
            "dtype": "float32"}


def leaf_norms(cfg: ModelConfig, grads: dict) -> dict:
    """Each of the reference's leaves' gradient norm (summed in float64),
    by ``/``-joined path, from the port's per-block gradients."""
    out = {}

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], prefix + (key,))
            else:
                out["/".join(prefix + (key,))] = math.sqrt(float(
                    np.sum(node[key].astype(np.float64) ** 2)))
    walk(convert.tree_from_port(cfg, grads), ())
    return out


def port_run(device, tree=None, arch: str = ARCH, mesh=None) -> dict:
    """The port's record of ``arch``'s run on ``device``: ``{"loss0",
    "ce0", "grad_norm0", "leaf_grad_norms", "loss", "ce", "grad_norm"}``
    (the last three one value a step).  With a ``mesh`` the model is
    sharded on it by the rules and the batches are
    ``make_global_batch``'s."""
    cfg = golden_config(arch)
    tree = convert.random_jax_tree(cfg, SEED) if tree is None else tree
    lm = LM(cfg, device=device)
    lm.load_state_dict(convert.params_from_jax(cfg, tree))   # a copy
    del tree           # freed here when the caller passed its only reference
    layers.trainable(lm)
    if mesh is None:
        batches = [pipeline.to_device(h, device) for h in host_batches(cfg)]
    else:
        sharding.shard_params(cfg, lm, mesh)
        data = pipeline.SyntheticLM(cfg, ShapeSpec("golden", S, B, "train"),
                                    seed=SEED)
        batches = [data.make_global_batch(mesh, i) for i in range(STEPS)]
    loss, metrics, grads = steps_mod.loss_and_grads(lm, batches[0])
    out = {"loss0": float(loss), "ce0": float(metrics["ce"]),
           "grad_norm0": float(adamw.global_norm(grads))}
    grads = {k: v.full_tensor() if sharding.is_sharded(v) else v
             for k, v in grads.items()}
    out["leaf_grad_norms"] = leaf_norms(cfg, grads)
    del grads
    step = steps_mod.make_train_step(lm, adamw.AdamWConfig(**OPT))
    opt = adamw.init(dict(lm.named_parameters()))
    rec = {"loss": [], "ce": [], "grad_norm": []}
    for b in batches:
        lm, opt, m = step(lm, opt, b)
        for k in rec:
            rec[k].append(float(m[k]))
    return {**out, **rec}
