"""The full-width teacher-forced run that ``golden/lm_full_width.json``
records, on the port's side.

For each model of ``ARCHES`` at its published width, cut in depth to
``LAYERS`` and run in float32 (``golden_config``), with seeded weights
(``models.convert.random_jax_tree``) and seeded tokens (``inputs``):

1. the prefill of B = 2 prompts of S = 128 tokens: the dense family's
   ``LM.prefill``, the RWKV and hybrid families' ``make_prefill_step``
   (the reference's ``LM.prefill`` is dense-only);
2. then ``STEPS`` decode steps on fixed tokens at positions S .. S + 7:
   a dense model with a bf16 or float32 cache continues from the
   prefill's caches, padded to S + STEPS slots; every other model first
   decodes the prompt token by token from empty caches (``init_caches``):
   RWKV and hybrid because their prefill returns no cache, yi-34b because
   its prefill's caches are float32 (the reference quantises only in
   decode), so that its int8 cache is what the decode reads.

The cuts (``LAYERS``, ``CUTS``): 2 layers for qwen3-0.6b, rwkv6-3b and
yi-34b (with its published int8 cache); zamba2-1.2b keeps 13 of its 38
layers (2 groups of 6 Mamba2 blocks, each closed by the shared attention
block, and a tail of 1, so the shared block runs twice over two caches)
and its sliding window is cut from 4,096 to 64, so that the 128-token
prompt masks keys in the prefill's flash and the 136 decode steps wrap
the 64-slot ring twice.

``port_run`` returns each step's logits at ``N_IDS`` fixed vocabulary ids
and each row's logsumexp.  ``tests/test_torch_lm.py --write-golden``
runs the JAX reference the same way and writes the golden;
``chip_smoke.py`` holds the port's run on the card to it.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import configs
from ..models import attention as attn_mod
from ..models.config import ModelConfig
from ..models.lm import LM
from . import steps as steps_mod

ARCHES = ("qwen3_0p6b", "rwkv6_3b", "yi_34b", "zamba2_1p2b")
SEED = 14
B, S, STEPS, N_IDS = 2, 128, 8, 256
LAYERS = {"qwen3_0p6b": 2, "rwkv6_3b": 2, "yi_34b": 2, "zamba2_1p2b": 13}
CUTS = {"zamba2_1p2b": {"sliding_window": 64}}


def golden_config(arch: str) -> ModelConfig:
    return configs.get(arch).with_(n_layers=LAYERS[arch],
                                   param_dtype="float32",
                                   compute_dtype="float32",
                                   **CUTS.get(arch, {}))


def run_record() -> dict:
    """The run's description as the golden file records it."""
    return {"seed": SEED, "batch": B, "prompt": S, "steps": STEPS,
            "ids": N_IDS, "layers": LAYERS, "cuts": CUTS}


def decodes_prompt(cfg: ModelConfig) -> bool:
    """Whether the golden run decodes the prompt from empty caches (else
    it continues from the prefill's)."""
    return cfg.family != "dense" or cfg.cache_dtype == "int8"


def inputs(cfg: ModelConfig):
    """(prompt int32 [B, S], continuation int32 [B, STEPS], sorted ids
    int64 [N_IDS]) from ``default_rng(SEED)``."""
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    cont = rng.integers(0, cfg.vocab, (B, STEPS), dtype=np.int32)
    ids = np.sort(rng.choice(cfg.vocab, N_IDS, replace=False))
    return prompt, cont, ids


def summarize(logits: torch.Tensor, ids) -> tuple:
    """(logits at ``ids``, logsumexp of each row), float64 numpy."""
    lg = logits.double()
    return (lg[:, torch.as_tensor(ids, device=lg.device)].cpu().numpy(),
            torch.logsumexp(lg, -1).cpu().numpy())


@torch.inference_mode()
def port_run(lm: LM, prompt, cont, ids) -> dict:
    """The run above through the port's ``lm``: ``{"prefill_logits" [B,
    N_IDS], "prefill_lse" [B], "decode_logits" [STEPS, B, N_IDS],
    "decode_lse" [STEPS, B]}`` as numpy float64."""
    dev = lm.device
    tok = torch.as_tensor(prompt, device=dev)
    nxt = torch.as_tensor(cont, device=dev)
    if lm.cfg.family == "dense":
        logits, pre = lm.prefill({"tokens": tok})
    else:
        logits = steps_mod.make_prefill_step(lm)({"tokens": tok})
    if decodes_prompt(lm.cfg):
        caches = lm.init_caches(tok.shape[0], tok.shape[1] + nxt.shape[1])
        for t in range(tok.shape[1]):
            _, caches = lm.decode_step(caches, tok[:, t:t + 1], t)
    else:
        pad = (0, 0, 0, 0, 0, nxt.shape[1])
        caches = attn_mod.KVCache(
            torch.nn.functional.pad(pre.k, pad),
            torch.nn.functional.pad(pre.v, pad),
            torch.nn.functional.pad(pre.pos, (0, nxt.shape[1]), value=-1))
    out = dict(zip(("prefill_logits", "prefill_lse"), summarize(logits, ids)))
    dl, dlse = [], []
    for i in range(nxt.shape[1]):
        logits, caches = lm.decode_step(caches, nxt[:, i:i + 1],
                                        tok.shape[1] + i)
        a, b = summarize(logits, ids)
        dl.append(a)
        dlse.append(b)
    out["decode_logits"] = np.stack(dl)
    out["decode_lse"] = np.stack(dlse)
    return out
