"""The full-width teacher-forced run that ``golden/lm_full_width.json``
records, on the port's side.

For each model of ``ARCHES`` at its published width, cut in depth to
``LAYERS`` and run in float32 (``golden_config``), with seeded weights
(``models.convert.random_jax_tree``) and seeded tokens (``inputs``):

1. the prefill of B = 2 prompts of S = 128 tokens: the dense family's
   ``LM.prefill``, the other families' ``make_prefill_step`` (the
   reference's ``LM.prefill`` is dense-only); the vlm family's with
   seeded image tokens ``img [B, 1601, d]``, the audio family's on
   seeded frames ``[B, S, d]`` in place of tokens;
2. then ``STEPS`` decode steps on fixed tokens at positions S .. S + 7:
   a dense model with a bf16 or float32 cache continues from the
   prefill's caches, padded to S + STEPS slots; every other model first
   decodes the prompt token by token from empty caches (``init_caches``):
   RWKV, hybrid, moe and vlm because their prefill returns no cache,
   yi-34b because its prefill's caches are float32 (the reference
   quantises only in decode), so that its int8 cache is what the decode
   reads.  The vlm model's cross caches hold seeded keys and values
   (nothing in the reference fills them).  The audio encoder does not
   decode: its record is the prefill's.

The cuts (``LAYERS``, ``CUTS``): 2 layers for qwen3-0.6b, rwkv6-3b and
yi-34b (with its published int8 cache); zamba2-1.2b keeps 13 of its 38
layers (2 groups of 6 Mamba2 blocks, each closed by the shared attention
block, and a tail of 1, so the shared block runs twice over two caches)
and its sliding window is cut from 4,096 to 64, so that the 128-token
prompt masks keys in the prefill's flash and the 136 decode steps wrap
the 64-slot ring twice; dbrx-132b keeps 1 of its 40 MoE layers (4.49 G
parameters, 18 GB in float32); llama-3.2-vision-11b 5 of its 40 (one
group of 4 self blocks and its cross block); hubert-xlarge all 48.
dbrx-132b and llama-3.2-vision-11b decode through float32 KV caches in
place of their bf16 ones: a bf16 cache rounds each k and v, and where
the two machines' float32 values differ by an ulp the rounding can land
on neighbouring bf16 values, which moved the logits by 3e-4 and 1.3e-3
between the port on the CPU and the reference; in float32 the golden
holds the decode as tightly as the prefill.

``port_run`` returns each step's logits at ``N_IDS`` fixed vocabulary ids
and each row's logsumexp.  ``tests/test_torch_lm.py --write-golden``
runs the JAX reference the same way and writes the golden;
``chip_smoke.py`` holds the port's run on the card to it.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import configs
from ..models import attention as attn_mod
from ..models.config import ModelConfig
from ..models.lm import LM, vlm_layout
from . import steps as steps_mod

ARCHES = ("qwen3_0p6b", "rwkv6_3b", "yi_34b", "zamba2_1p2b", "dbrx_132b",
          "llama3p2_vision_11b", "hubert_xlarge")
SEED = 14
B, S, STEPS, N_IDS = 2, 128, 8, 256
LAYERS = {"qwen3_0p6b": 2, "rwkv6_3b": 2, "yi_34b": 2, "zamba2_1p2b": 13,
          "dbrx_132b": 1, "llama3p2_vision_11b": 5, "hubert_xlarge": 48}
CUTS = {"zamba2_1p2b": {"sliding_window": 64},
        "dbrx_132b": {"cache_dtype": "float32"},
        "llama3p2_vision_11b": {"cache_dtype": "float32"}}


def golden_config(arch: str) -> ModelConfig:
    return configs.get(arch).with_(n_layers=LAYERS[arch],
                                   param_dtype="float32",
                                   compute_dtype="float32",
                                   **CUTS.get(arch, {}))


def run_record() -> dict:
    """The run's description as the golden file records it."""
    return {"seed": SEED, "batch": B, "prompt": S, "steps": STEPS,
            "ids": N_IDS, "layers": LAYERS, "cuts": CUTS}


def decodes(cfg: ModelConfig) -> bool:
    """Whether the golden run decodes (the audio encoder does not)."""
    return cfg.family != "audio"


def decodes_prompt(cfg: ModelConfig) -> bool:
    """Whether the golden run decodes the prompt from empty caches (else
    it continues from the prefill's)."""
    return cfg.family != "dense" or cfg.cache_dtype == "int8"


def inputs(cfg: ModelConfig):
    """(prompt int32 [B, S], continuation int32 [B, STEPS], sorted ids
    int64 [N_IDS], extra) from ``default_rng(SEED)``; ``extra`` holds the
    vlm family's image tokens ``img`` float32 [B, n_img_tokens, d] and its
    cross caches' ``cross_k``/``cross_v`` float32 [n_cross, B,
    n_img_tokens, H_eff, Dh], or the audio family's ``frames`` float32
    [B, S, d], drawn after the rest (so the others' draws are as they
    were), standard normal."""
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    cont = rng.integers(0, cfg.vocab, (B, STEPS), dtype=np.int32)
    ids = np.sort(rng.choice(cfg.vocab, N_IDS, replace=False))
    extra = {}
    if cfg.family == "vlm":
        n_cross = vlm_layout(cfg)[0]
        h = attn_mod.effective_kv_heads(cfg, cfg.kv_repeat)
        extra["img"] = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model),
                                           dtype=np.float32)
        for key in ("cross_k", "cross_v"):
            extra[key] = rng.standard_normal(
                (n_cross, B, cfg.n_img_tokens, h, cfg.head_dim),
                dtype=np.float32)
    elif cfg.family == "audio":
        extra["frames"] = rng.standard_normal((B, S, cfg.d_model),
                                              dtype=np.float32)
    return prompt, cont, ids, extra


def inputs_sha256(prompt, cont, extra) -> str:
    """sha256 of the run's inputs: the tokens, then each extra array in
    sorted key order (for the four models without one, the tokens'
    digest as before)."""
    h = hashlib.sha256(prompt.tobytes() + cont.tobytes())
    for key in sorted(extra):
        h.update(np.ascontiguousarray(extra[key]).tobytes())
    return h.hexdigest()


def prefill_batch(cfg: ModelConfig, prompt, extra) -> dict:
    """The prefill's batch as numpy arrays: tokens (or the audio family's
    frames in their place) and the vlm family's image tokens."""
    batch = {} if cfg.family == "audio" else {"tokens": prompt}
    batch.update({k: extra[k] for k in ("img", "frames") if k in extra})
    return batch


def summarize(logits: torch.Tensor, ids) -> tuple:
    """(logits at ``ids``, logsumexp of each row), float64 numpy."""
    lg = logits.double()
    return (lg[:, torch.as_tensor(ids, device=lg.device)].cpu().numpy(),
            torch.logsumexp(lg, -1).cpu().numpy())


@torch.inference_mode()
def port_run(lm: LM, prompt, cont, ids, extra) -> dict:
    """The run above through the port's ``lm``: ``{"prefill_logits" [B,
    N_IDS], "prefill_lse" [B], "decode_logits" [STEPS, B, N_IDS],
    "decode_lse" [STEPS, B]}`` as numpy float64 (the audio encoder's the
    first two only)."""
    dev = lm.device
    tok = torch.as_tensor(prompt, device=dev)
    nxt = torch.as_tensor(cont, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in prefill_batch(lm.cfg, prompt, extra).items()}
    if lm.cfg.family == "dense":
        logits, pre = lm.prefill(batch)
    else:
        logits = steps_mod.make_prefill_step(lm)(batch)
    out = dict(zip(("prefill_logits", "prefill_lse"), summarize(logits, ids)))
    if not decodes(lm.cfg):
        return out
    if decodes_prompt(lm.cfg):
        caches = lm.init_caches(tok.shape[0], tok.shape[1] + nxt.shape[1])
        for key in ("cross_k", "cross_v"):
            if key in extra:
                caches[key].copy_(torch.as_tensor(extra[key]))
        for t in range(tok.shape[1]):
            _, caches = lm.decode_step(caches, tok[:, t:t + 1], t)
    else:
        pad = (0, 0, 0, 0, 0, nxt.shape[1])
        caches = attn_mod.KVCache(
            torch.nn.functional.pad(pre.k, pad),
            torch.nn.functional.pad(pre.v, pad),
            torch.nn.functional.pad(pre.pos, (0, nxt.shape[1]), value=-1))
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
