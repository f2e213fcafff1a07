"""The port's language model (``repro_torch.models``, ``repro_torch.launch``)
against the JAX reference (``repro.models``, ``repro.launch``), on the CPU.

The same weights (the reference's own init, carried across by
``convert.params_from_jax``) and the same numpy inputs go through both
packages, for every family: dense, moe (dbrx-132b, llama4-maverick), vlm
(llama-3.2-vision-11b, its cross-block gates set non-zero and its cross
caches seeded), audio (hubert-xlarge, on frames; its caches and decode
raise in both), rwkv and hybrid.  Tolerances: float32 1e-4, element by
element, absolute and relative (sums taken in another order); bf16 3e-2
of the tensor's largest magnitude (at least 1), absolute: the two
frameworks round to bf16 at different places (XLA keeps fused
elementwise chains in float32), so two correct runs differ by a few bf16
steps of the residual stream's largest values, 0.047 at magnitude ~4 in
the smoke configs, RWKV included, which has no attention; and the port's
full-sequence attention keeps its softmax weights in float32 where the
reference's ``_sdpa`` casts them to bf16.  In bf16 an MoE model takes
every expert for every token (``cfg_of``).  yi-34b runs with its
published int8 cache forced onto its smoke config (``yi_34b:int8``; the
smoke config's own cache is bf16): decoding through int8 codes against
the prefill's unquantised attention is held to 3e-2 of the largest
magnitude in both dtypes, since a code carries 8 bits, as bf16's
significand does.  The serving loop's tick and token counts are held
exactly to ``python -m repro.launch.serve``.

Run ``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_lm.py
--write-golden`` to regenerate ``src/repro_torch/golden/lm_full_width.json``
(about half an hour of CPU and 20 GB of memory): the reference's
full-width float32 run of ``repro_torch.launch.golden`` for qwen3-0.6b,
rwkv6-3b, yi-34b (int8 cache), zamba2-1.2b (13 layers, window 64),
dbrx-132b (1 layer), llama-3.2-vision-11b (5 layers) and hubert-xlarge
(48 layers, prefill only), each model's tolerance measured from the
port's CPU run against it (and for yi-34b how far one int8 step moves
the logits), and the reference's ``serve`` summaries, which
``chip_smoke.py`` holds the port to on the card.
"""
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import golden as G  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "lm_full_width.json"
ARCHS = ("qwen3_0p6b", "llama3p2_1b", "rwkv6_3b", "zamba2_1p2b",
         "yi_34b:int8", "dbrx_132b", "llama4_maverick_400b",
         "llama3p2_vision_11b", "hubert_xlarge")
# the audio encoder does not decode
DECODE_ARCHS = tuple(a for a in ARCHS if a != "hubert_xlarge")
B, S = 2, 32
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
INT8_TOL = 3e-2          # decode through int8 codes against the prefill
F32 = dict(param_dtype="float32", compute_dtype="float32")


def np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol):
    """float32 (tol < 1e-2): element by element; bf16: the largest
    difference within ``tol`` of the largest magnitude (at least 1)."""
    got, want = np.asarray(got.float()), np32(want)
    if tol < 1e-2:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def pair(cfg, seed=0):
    """(JAX params, port LM on the CPU) with the reference's init; the vlm
    family's cross-block gates, 0 at init (the block would pass its input
    through), set to 0.3 .. 0.9 in both."""
    params = JLM(cfg).init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, params)
    if cfg.family == "vlm":
        cross = tree["cross_blocks"]
        n = cross["gate_attn"].shape[0]
        cross["gate_attn"] = np.linspace(0.3, 0.9, n, dtype=np.float32)
        cross["gate_mlp"] = np.linspace(0.9, 0.3, n, dtype=np.float32)
        params = jax.tree.map(jnp.asarray, tree)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(convert.params_from_jax(cfg, tree))
    return params, lm


def cfg_of(arch, dtype):
    """The smoke config of ``arch`` (``name:int8`` forces the int8
    cache), in float32 or its own bf16.  In bf16 an MoE model routes each
    token to every expert (``top_k = n_experts``): the two frameworks
    round the router's input differently, and a token whose top-k choice
    lies that close to a tie takes another expert in each, two correct
    results a whole expert output apart (in llama4's smoke model one
    token of 64 does).  With every expert taken no choice is left to
    flip, and the dispatch, the experts and the combine are still held;
    float32 runs the published top_k, and tests/test_torch_moe.py holds
    the order of exact ties."""
    name, _, cache = arch.partition(":")
    cfg = configs.get_smoke(name)
    if cache:
        cfg = cfg.with_(cache_dtype=cache)
    if dtype == "float32":
        return cfg.with_(**F32)
    return cfg.with_(top_k=cfg.n_experts) if cfg.family == "moe" else cfg


def leaves(caches):
    """The port's caches in ``jax.tree.leaves`` order: dict keys sorted,
    NamedTuple fields in order, absent (None) fields skipped."""
    if isinstance(caches, dict):
        return [a for k in sorted(caches) for a in leaves(caches[k])]
    if torch.is_tensor(caches):
        return [caches]
    return [a for a in caches if a is not None]


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def batches(cfg, shape, seed=1):
    """(the reference's batch, the port's) of ``shape`` (B, S): tokens;
    the audio family's frames ``[B, S, d]`` in their place; the vlm
    family's image tokens ``img [B, n_img_tokens, d]`` beside them."""
    rng = np.random.default_rng([seed, 7])
    if cfg.family == "audio":
        arrays = {"frames": rng.standard_normal((*shape, cfg.d_model),
                                                dtype=np.float32)}
    else:
        arrays = {"tokens": tokens(cfg, shape, seed)}
    if cfg.family == "vlm":
        arrays["img"] = rng.standard_normal(
            (shape[0], cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if "tokens" in tb:
        tb["tokens"] = tb["tokens"].long()
    return {k: jnp.asarray(v) for k, v in arrays.items()}, tb


def seed_cross_caches(cfg, caches, jcaches, seed=9):
    """Write the same seeded keys and values into the vlm family's cross
    caches on both sides (``init_caches`` leaves them zero, and nothing
    in the reference fills them); returns the reference's caches."""
    rng = np.random.default_rng(seed)
    jcaches = dict(jcaches)
    for key in ("cross_k", "cross_v"):
        a = rng.standard_normal(caches[key].shape, dtype=np.float32)
        caches[key].copy_(torch.from_numpy(a))
        jcaches[key] = jnp.asarray(a, jcaches[key].dtype)
    return jcaches


# ---------------------------------------------------------------- layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    g = rng.standard_normal(16, dtype=np.float32)
    pos = np.arange(5, dtype=np.int32)
    close(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
          jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(g)), 1e-5)
    close(tlayers.rope_frequencies(16, 1e6),
          jlayers.rope_frequencies(16, 1e6), 1e-7)
    close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    w = [rng.standard_normal(s, dtype=np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    mlp = tlayers.MLP(16, 24, torch.float32, "cpu")
    mlp.load_state_dict(dict(zip(("wi_gate", "wi_up", "wo"),
                                 map(torch.from_numpy, w))))
    close(tlayers.mlp_apply(mlp, torch.from_numpy(x[:, :, 0])),
          jlayers.mlp_apply(dict(zip(("wi_gate", "wi_up", "wo"),
                                     map(jnp.asarray, w))),
                            jnp.asarray(x[:, :, 0])), 1e-5)
    # bf16 rounding points: rmsnorm casts back, rope returns x's dtype
    xb = torch.from_numpy(x).bfloat16()
    close(tlayers.rmsnorm(xb, torch.from_numpy(g)),
          jlayers.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g)),
          1e-2)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_attention_prefill_and_decode_match(kv_repeat):
    """Both ported branches: the full sequence with its returned cache,
    then decode steps into a cache, one of them with a slot past the end
    (``dynamic_update_slice`` clamps it to the last slot)."""
    cfg = configs.get_smoke("qwen3_0p6b").with_(kv_repeat=kv_repeat, **F32)
    p = JLM(cfg).init(jax.random.PRNGKey(2))["blocks"]["attn"]
    p = jax.tree.map(lambda a: a[0], p)
    att = tattn.Attention(cfg, "cpu")
    att.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 12, cfg.d_model), dtype=np.float32)
    pos = np.arange(12, dtype=np.int32)
    y, cache = tattn.attention(att, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos), kv_repeat=kv_repeat,
                               return_cache=True)
    jy, jcache = jattn.attention(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                                 kv_repeat=kv_repeat, return_cache=True)
    close(y, jy, 1e-5)
    for a, b in zip(cache, (jcache.k, jcache.v, jcache.pos)):
        close(a, b, 1e-5)
    tc = tattn.init_cache(cfg, B, 8, kv_repeat=kv_repeat,
                          cache_dtype="float32")
    jc = jattn.init_cache(cfg, B, 8, kv_repeat=kv_repeat,
                          cache_dtype="float32")
    for step, slot in ((0, 0), (1, 1), (2, 2), (11, 11)):
        xs = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        ps = np.asarray([step], np.int32)
        ty, tc = tattn.attention(att, cfg, torch.from_numpy(xs),
                                 torch.from_numpy(ps), kv_repeat=kv_repeat,
                                 cache=tc, cache_pos=slot)
        jy, jc = jattn.attention(p, cfg, jnp.asarray(xs), jnp.asarray(ps),
                                 kv_repeat=kv_repeat, cache=jc,
                                 cache_pos=jnp.int32(slot))
        close(ty, jy, 1e-5)
        for a, b in zip(tc, (jc.k, jc.v, jc.pos)):
            close(a, b, 1e-5)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_reference(arch, dtype):
    """``_backbone``, the prefill (``LM.prefill`` for the dense family,
    ``make_prefill_step`` for all) and ``decode_step`` with its caches,
    past the cache's end included; the vlm family with non-zero gates,
    its image tokens and seeded cross caches; the audio encoder's
    caches and decode raise in both packages."""
    cfg = cfg_of(arch, dtype)
    tol = TOL[dtype]
    params, lm = pair(cfg)
    jlm = JLM(cfg)
    batch, tbatch = batches(cfg, (B, S))
    pos = np.arange(S)
    with torch.inference_mode():
        x, aux = lm._backbone(lm._embed(tbatch), torch.from_numpy(pos),
                              tbatch)
        jx, jaux = jlm._backbone(params, jlm._embed(params, batch),
                                 jnp.asarray(pos), batch)
        close(x, jx, tol)
        # the MoE load-balance loss: in bf16 the router reads a residual
        # stream that the two frameworks round differently
        np.testing.assert_allclose(float(aux), float(jaux),
                                   atol=1e-6 if dtype == "float32" else tol)
        close(tsteps.make_prefill_step(lm)(tbatch),
              jax.jit(jsteps.make_prefill_step(cfg))(params, batch), tol)
        if cfg.family == "dense":
            logits, caches = lm.prefill(tbatch)
            jlogits, jcaches = jlm.prefill(params, batch)
            close(logits, jlogits, tol)
            for a, b in zip(caches, (jcaches.k, jcaches.v, jcaches.pos)):
                close(a, b, tol)
        else:
            with pytest.raises(NotImplementedError):
                lm.prefill(tbatch)
        if cfg.family == "audio":
            for init in (lm.init_caches, jlm.init_caches):
                with pytest.raises(ValueError, match="no decode caches"):
                    init(B, 8)
            with pytest.raises(ValueError, match="does not decode"):
                lm.decode_step(None, torch.zeros((B, 1), dtype=torch.long),
                               0)
            return
        caches = lm.init_caches(B, 8)
        jcaches = jlm.init_caches(B, 8)
        assert len(leaves(caches)) == len(jax.tree.leaves(jcaches))
        if cfg.family == "vlm":
            jcaches = seed_cross_caches(cfg, caches, jcaches)
        jstep = jax.jit(jsteps.make_serve_step(cfg))
        step = tsteps.make_serve_step(lm)
        nxt = tokens(cfg, (4, B, 1), seed=5)
        for t, p_ in enumerate((0, 1, 2, 9)):
            logits, caches = step(caches, torch.from_numpy(nxt[t]).long(),
                                  p_)
            jlogits, jcaches = jstep(params, jcaches, jnp.asarray(nxt[t]),
                                     jnp.int32(p_))
            close(logits, jlogits, tol)
        for a, b in zip(leaves(caches), jax.tree.leaves(jcaches)):
            close(a, b, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_prefill(arch, dtype):
    """Decoding a prompt token by token gives the full forward's logits
    at the last position (``tests/test_arch_smoke.py:86`` for the port);
    in float32 with a float32 KV cache (the default cache is bf16), and
    through an int8 cache within ``INT8_TOL``.  zamba2's 16 tokens fill
    its ring of 16 slots (window 32) and its chunk of 16.  The MoE models
    run at a capacity factor of their expert count, so that the prefill
    drops no token (a decode step, at 8 slots an expert, drops none), and
    the vlm model's cross caches hold its image tokens'
    keys and values, projected by each cross block as its prefill
    projects them; its gates are set non-zero."""
    cfg = cfg_of(arch, dtype)
    tol = TOL[dtype]
    if cfg.cache_dtype == "int8":
        tol = INT8_TOL
    elif dtype == "float32":
        cfg = cfg.with_(cache_dtype="float32")
    if cfg.family == "moe":     # room for every token: no prefill drop
        cfg = cfg.with_(capacity_factor=float(cfg.n_experts))
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    _, batch = batches(cfg, (B, 16), seed=6)
    tok = batch["tokens"]
    caches = lm.init_caches(B, 16)
    if cfg.family == "vlm":
        with torch.no_grad():
            for g, cross in enumerate(lm.cross_blocks):
                cross.gate_attn.fill_(0.5)
                cross.gate_mlp.fill_(0.7)
                img = batch["img"].to(lm.ln_f.dtype)
                _, k, v = tattn._project_qkv(cross.xattn, cfg, img, img,
                                             None, cfg.kv_repeat)
                caches["cross_k"][g] = k
                caches["cross_v"][g] = v
    want = tsteps.make_prefill_step(lm)(batch)
    with torch.inference_mode():
        for t in range(16):
            got, caches = lm.decode_step(caches, tok[:, t:t + 1], t)
    close(got, want.float().numpy(), tol)


# ---------------------------------------------- weights and initialisation

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_params_from_jax_every_config(arch):
    """At full width: the reference's tree has the shapes the port
    derives, and ``params_from_jax`` turns it into exactly the port's
    ``state_dict`` keys, shapes and dtypes (zero-stride stand-ins, so no
    memory is spent on the weights)."""
    cfg = configs.get(arch)
    shapes = jax.eval_shape(JLM(jconfigs.get(arch)).init,
                            jax.random.PRNGKey(0))
    flat = {tuple(k.key for k in path): (tuple(v.shape), v.dtype)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v[0] for k, v in flat.items()} == convert.jax_tree_shapes(cfg)
    tree = {}
    for path, (shape, dt) in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.lib.stride_tricks.as_strided(
            np.zeros(1, dt), shape, (0,) * len(shape))
    sd = convert.params_from_jax(cfg, tree)
    want = LM(cfg, device="meta").state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert (tuple(sd[k].shape), sd[k].dtype) == (tuple(v.shape),
                                                     v.dtype), k
    with pytest.raises(ValueError):
        bad = dict(tree, ln_f=np.zeros(3, np.float32))
        convert.params_from_jax(cfg, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_dtypes_padding_and_scale(arch):
    """The port's own init: the reference's shapes and dtypes (leaf by
    leaf against ``jax.eval_shape``, every block of a stack), zeroed
    padded-head rows, ones for norms, and the truncated normal's spread
    within 5%."""
    cfg = cfg_of(arch, "bfloat16")
    cfg = cfg.with_(rwkv_pad_heads=6) if cfg.family == "rwkv" \
        else cfg.with_(pad_q_heads=max(6, cfg.n_heads + 2))
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
    sd = lm.state_dict()
    stacked = {"blocks": 1, "mamba_groups": 2, "mamba_tail": 1,
               "dense_blocks": 1, "moe_blocks": 1, "self_blocks": 2,
               "cross_blocks": 1}
    seen = set()
    for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        lead = v.shape[:stacked.get(keys[0], 0)]
        for idx in np.ndindex(*lead):
            name = ".".join([keys[0], *map(str, idx), *keys[1:]])
            shape = v.shape[len(lead):]
            assert tuple(sd[name].shape) == tuple(shape), name
            assert str(sd[name].dtype).split(".")[-1] == str(v.dtype), name
            seen.add(name)
    assert seen == set(sd)
    blk = (lm.shared_attn if cfg.family == "hybrid" else
           lm.self_blocks[0][0] if cfg.family == "vlm" else
           lm.dense_blocks[0] if hasattr(lm, "dense_blocks") else
           lm.blocks[0])
    if cfg.family == "rwkv":
        wo = blk.time.wo
        assert wo.shape[0] > cfg.d_model
        assert not wo[cfg.d_model:].any() and wo[:cfg.d_model].any()
        assert (blk.time.w0 == -6).all() and (blk.time.mu_x == 0.5).all()
    else:
        wo = blk.attn.wo
        live = cfg.n_heads * cfg.head_dim
        assert wo.shape[0] == cfg.pad_q_heads * cfg.head_dim
        assert not wo[live:].any() and wo[:live].any()
    assert (blk.ln1 == 1).all() and (lm.ln_f == 1).all()
    if cfg.family == "hybrid":
        m = lm.mamba_groups[1][0]
        assert (m.ln == 1).all() and (m.ssm.D == 1).all()
        assert m.ssm.A_log.dtype == torch.float32
    if cfg.family == "vlm":
        cross = lm.cross_blocks[-1]
        assert not cross.gate_attn and not cross.gate_mlp
        wo = cross.xattn.wo
        assert not wo[live:].any() and wo[:live].any()
    emb = (lm.in_proj if cfg.family == "audio" else lm.embed).float()
    want = 0.98658 * cfg.d_model ** -0.5     # std of N(0,1) cut at +-3
    assert abs(float(emb.std()) / want - 1) < 0.05
    assert float(emb.abs().max()) <= 3 * cfg.d_model ** -0.5 * 1.01


def test_registry_matches_reference_and_raises_for_unported():
    """All ten of the reference's configs, published and smoke, equal the
    reference's; an unknown name raises ``KeyError``; every smoke config
    builds; a model with the sharding pins on (``act_constraints``, and
    the WKV pins) under an ambient mesh gives the unpinned model's
    logits."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for arch in configs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get(arch)) == \
            dataclasses.asdict(jconfigs.get(arch))
        assert dataclasses.asdict(configs.get_smoke(arch)) == \
            dataclasses.asdict(jconfigs.get_smoke(arch))
        LM(configs.get_smoke(arch), device="cpu")
    assert configs.ALIASES == jconfigs.ALIASES
    assert configs.get("qwen3-0.6b") == configs.get("qwen3_0p6b")
    assert configs.get("dbrx-132b") == configs.get("dbrx_132b")
    assert configs.get_smoke("hubert-xlarge") == \
        configs.get_smoke("hubert_xlarge")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("llama4_scout")
    LM(configs.get_smoke("yi_34b").with_(cache_dtype="int8"), device="cpu")
    # the sharding pins: a pinned model gives the unpinned model's logits
    for arch in ("qwen3_0p6b", "zamba2_1p2b", "dbrx_132b",
                 "llama3p2_vision_11b", "rwkv6_3b"):
        cfg = configs.get_smoke(arch).with_(**F32)
        plain = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        pinned = LM(cfg.with_(act_constraints=True,
                              rwkv_wkv_pins=cfg.family == "rwkv"),
                    device="cpu")
        pinned.load_state_dict(plain.state_dict())
        _, tb = batches(cfg, (2, 16))
        want = tsteps.make_prefill_step(plain)(tb)
        with sharding.use_mesh({"data": 2, "model": 2}):
            got = tsteps.make_prefill_step(pinned)(tb)
        assert torch.equal(got, want), arch


# -------------------------------------------------------------- serving

POLICIES = ("ppcc", "2pl", "occ")


DEFAULT_ARCH = "qwen3_0p6b"       # ``python -m repro.launch.serve``'s


def reference_serve(runs):
    """``{(arch, policy): (ticks, tokens)}`` from the summary lines that
    ``python -m repro.launch.serve --arch A --policy P`` prints at its
    defaults, for each (arch, policy) of ``runs``: the module's ``main``
    run as ``__main__`` once per pair, in one subprocess, so JAX is
    imported once and each model's decode step compiled once."""
    code = ("import runpy, sys\n"
            "args = sys.argv[1:]\n"
            "for a, p in zip(args[::2], args[1::2]):\n"
            "    sys.argv = ['serve', '--arch', a, '--policy', p]\n"
            "    runpy.run_module('repro.launch.serve', run_name='__main__',"
            " alter_sys=True)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, *(x for run in runs for x in run)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    found = re.findall(r"policy=(\S+) .*ticks=(\d+) tokens=(\d+)",
                       out.stdout)
    assert [f[0] for f in found] == [p for _, p in runs], out.stdout
    return {run: (int(t), int(n)) for run, (_, t, n) in zip(runs, found)}


@pytest.fixture(scope="module")
def reference_counts():
    return reference_serve([(a, p) for a in (DEFAULT_ARCH, "zamba2_1p2b")
                            for p in POLICIES])


@pytest.mark.parametrize("policy", POLICIES)
def test_serve_matches_reference(policy, reference_counts):
    """The smoke models' ``serve()`` against the reference's summary: qwen3
    and rwkv6 against the server's default arch (the counts depend on the
    scheduler only), zamba2 against ``--arch zamba2_1p2b`` (its ring of 32
    slots wraps at the server's 64 positions), and under ppcc dbrx and
    vision (the moe and vlm decode steps) against the default arch's; the
    audio encoder, which has no decode caches, raises the reference's
    error.  The golden's counts for dbrx and vision, the reference's own
    runs of their smoke configs, equal the default arch's."""
    new = ("dbrx_132b", "llama3p2_vision_11b")
    for arch in (DEFAULT_ARCH, "rwkv6_3b", "zamba2_1p2b",
                 *(new if policy == "ppcc" else ())):
        want = reference_counts.get((arch, policy),
                                    reference_counts[DEFAULT_ARCH, policy])
        lm = LM(configs.get_smoke(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        out = tserve.serve(lm, policy=policy)
        assert (out["ticks"], out["tokens"]) == want, arch
    gold = json.loads(GOLDEN.read_text())["serve"]
    want = reference_counts[DEFAULT_ARCH, policy]
    assert (gold["policies"][policy]["ticks"],
            gold["policies"][policy]["tokens"]) == want
    got = gold["by_arch"]["zamba2_1p2b"][policy]
    assert (got["ticks"], got["tokens"]) == \
        reference_counts["zamba2_1p2b", policy]
    for arch in ("dbrx_132b", "llama3p2_vision_11b"):
        got = gold["by_arch"][arch][policy]
        assert (got["ticks"], got["tokens"]) == want, arch
    lm = LM(configs.get_smoke("hubert_xlarge"), device="cpu")
    with pytest.raises(ValueError, match="no decode caches"):
        tserve.serve(lm, policy=policy)


# sha256 of each model entry of ``lm_full_width.json`` (``json.dumps(entry,
# sort_keys=True)``) as it was before the golden gained the moe, vlm and
# audio models: the entries of the four models it held stay as they were
KEPT_ENTRIES = {
    "qwen3_0p6b":
        "580dfbc808e7919855344c9ffe7e51eedb53988f2d6345a7530af27907a07fd1",
    "rwkv6_3b":
        "cefd0c6c329e77bfaccec18d7c08b3460d21bf0f55dcc48f89cfa261797fd334",
    "yi_34b":
        "1cda42e69383a510fcb7c95c8b062e719b5980818a532f5122f48456f3734666",
    "zamba2_1p2b":
        "981c4731c0875f8431c8ff6f736484959b6fe567df44a1026f176afd7ab94c3f",
}


def test_golden_describes_the_run():
    gold = json.loads(GOLDEN.read_text())
    assert gold["run"] == G.run_record()
    assert set(gold["models"]) == set(G.ARCHES)
    tol = gold["tolerance"]
    assert tol["how"] and set(tol["atol"]) == set(G.ARCHES)
    assert all(tol["atol"][a] > 0 for a in G.ARCHES)
    assert tol["atol"]["yi_34b"] >= tol["int8_step"]["yi_34b"] > 0
    assert set(gold["serve"]["by_arch"]) == {
        "yi_34b", "zamba2_1p2b", "dbrx_132b", "llama3p2_vision_11b"}
    for arch, digest in KEPT_ENTRIES.items():
        rec = json.dumps(gold["models"][arch], sort_keys=True)
        assert hashlib.sha256(rec.encode()).hexdigest() == digest, arch
    for arch, rec in gold["models"].items():
        cfg = G.golden_config(arch)
        prompt, cont, ids, extra = G.inputs(cfg)
        assert rec["ids"] == ids.tolist()
        assert rec["prompt_sha256"] == G.inputs_sha256(prompt, cont, extra)
        assert sorted(extra) == {"vlm": ["cross_k", "cross_v", "img"],
                                 "audio": ["frames"]}.get(cfg.family, [])
        assert np.asarray(rec["prefill_logits"]).shape == (G.B, G.N_IDS)
        assert np.asarray(rec["prefill_lse"]).shape == (G.B,)
        if not G.decodes(cfg):          # the encoder: a prefill record
            assert cfg.family == "audio"
            assert "decode_logits" not in rec and "decode_lse" not in rec
            continue
        assert np.asarray(rec["decode_logits"]).shape == (G.STEPS, G.B,
                                                          G.N_IDS)
        assert np.asarray(rec["decode_lse"]).shape == (G.STEPS, G.B)


# ------------------------------------------------------- golden writer

def to_jax(tree):
    """The numpy tree as JAX arrays, each leaf replaced in place, so that
    a leaf's numpy memory can go as its JAX copy comes (dbrx's float32
    layer is 18 GB); returns the tree."""
    for key, val in tree.items():
        tree[key] = to_jax(val) if isinstance(val, dict) else \
            jnp.asarray(val)
    return tree


def jax_run(cfg, tree, prompt, cont, ids, extra):
    """The reference's side of ``repro_torch.launch.golden.port_run``;
    ``tree`` becomes the JAX tree (``to_jax``)."""
    params = to_jax(tree)
    jlm = JLM(cfg)
    batch = {k: jnp.asarray(v)
             for k, v in G.prefill_batch(cfg, prompt, extra).items()}
    step = jax.jit(jsteps.make_serve_step(cfg))

    def summ(lg):
        lg = np.asarray(lg, np.float64)
        m = lg.max(-1, keepdims=True)
        lse = (m + np.log(np.exp(lg - m).sum(-1, keepdims=True)))[:, 0]
        return lg[:, ids], lse

    if cfg.family == "dense":
        logits, pre = jax.jit(jlm.prefill)(params, batch)
    else:
        logits = jax.jit(jsteps.make_prefill_step(cfg))(params, batch)
    out = dict(zip(("prefill_logits", "prefill_lse"), summ(logits)))
    if not G.decodes(cfg):
        return out
    if G.decodes_prompt(cfg):
        caches = jlm.init_caches(prompt.shape[0],
                                 prompt.shape[1] + cont.shape[1])
        if "cross_k" in extra:
            caches = dict(caches, cross_k=jnp.asarray(extra["cross_k"]),
                          cross_v=jnp.asarray(extra["cross_v"]))
        for t in range(prompt.shape[1]):
            _, caches = step(params, caches, jnp.asarray(prompt[:, t:t + 1]),
                             jnp.int32(t))
    else:
        pad = ((0, 0), (0, 0), (0, cont.shape[1]), (0, 0), (0, 0))
        caches = jattn.KVCache(jnp.pad(pre.k, pad), jnp.pad(pre.v, pad),
                               jnp.pad(pre.pos, ((0, 0), (0, cont.shape[1])),
                                       constant_values=-1), None, None)
    dl, dlse = [], []
    for i in range(cont.shape[1]):
        logits, caches = step(params, caches, jnp.asarray(cont[:, i:i + 1]),
                              jnp.int32(prompt.shape[1] + i))
        a, b = summ(logits)
        dl.append(a)
        dlse.append(b)
    out["decode_logits"] = np.stack(dl)
    out["decode_lse"] = np.stack(dlse)
    return out


def quantize_other_way(x):
    """``attention._quantize`` with every code that is not exact moved to
    its other neighbour (the code on the far side of the half-step): what
    one int8 step on every element does."""
    x = x.float()
    scale = x.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    r = x / scale
    q = torch.round(r)
    q = (q + torch.sign(r - q)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def round_tol(m):
    """``m`` (at least 1e-4) rounded up to one digit."""
    m = max(1e-4, m)
    e = 10.0 ** math.floor(math.log10(m))
    return float(f"{math.ceil(m / e) * e:.1g}")


def write_golden():
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    models, errs, steps8, atol, rtol = {}, {}, {}, {}, {}
    for arch in G.ARCHES:
        cfg = G.golden_config(arch)
        prompt, cont, ids, extra = G.inputs(cfg)
        tree = convert.random_jax_tree(cfg, G.SEED)
        sha = convert.tree_sha256(tree)
        lm = LM(cfg, device="meta")       # the tree's memory, no copy
        lm.load_state_dict(convert.params_from_jax(cfg, tree), assign=True)
        got = G.port_run(lm, prompt, cont, ids, extra)
        if cfg.cache_dtype == "int8":
            real = tattn._quantize
            tattn._quantize = quantize_other_way
            try:
                moved = G.port_run(lm, prompt, cont, ids, extra)
            finally:
                tattn._quantize = real
            steps8[arch] = round_tol(max(
                float(np.abs(moved[k] - got[k]).max()) for k in got))
            print(f"{arch}: one int8 step on every code moves the logits by "
                  f"up to {steps8[arch]:.3g}", flush=True)
        del lm
        want = jax_run(cfg, tree, prompt, cont, ids, extra)
        del tree
        errs[arch] = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        atol[arch] = rtol[arch] = round_tol(10 * errs[arch])
        if arch in steps8:
            atol[arch] = max(atol[arch], steps8[arch])
        models[arch] = {"ids": ids.tolist(),
                        "weights_sha256": sha,
                        "prompt_sha256": G.inputs_sha256(prompt, cont, extra),
                        **{k: np.round(v, 7).tolist()
                           for k, v in want.items()}}
        print(f"{arch}: port on the CPU vs the reference, max abs err "
              f"{errs[arch]:.3g} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    by_arch = ("yi_34b", "zamba2_1p2b", "dbrx_132b", "llama3p2_vision_11b")
    counts = reference_serve([(a, p) for a in (DEFAULT_ARCH, *by_arch)
                              for p in POLICIES])

    def summary(arch):
        return {p: dict(zip(("ticks", "tokens"), counts[arch, p]))
                for p in POLICIES}

    gold = {
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                   "tests/test_torch_lm.py --write-golden",
        "jax": jax.__version__, "torch": torch.__version__,
        "cpu_seconds": round(time.perf_counter() - t0, 1),
        "run": G.run_record(),
        "description": "each model at its published width in float32, "
                       "cut in depth to run.layers; zamba2_1p2b also has "
                       "its sliding window cut from 4,096 to 64 (run.cuts) "
                       "so that the 128-token prompt masks keys in the "
                       "prefill and the 136 decode steps wrap the 64-slot "
                       "ring twice; dbrx_132b and llama3p2_vision_11b "
                       "decode through float32 caches (run.cuts); yi_34b "
                       "keeps its int8 cache and "
                       "decodes the prompt from empty caches, as do the "
                       "moe, vlm, rwkv and hybrid models; the vlm model "
                       "reads seeded image tokens in its prefill and "
                       "seeded cross caches in its decode; hubert_xlarge, "
                       "an encoder, runs its prefill on seeded frames and "
                       "does not decode",
        "tolerance": {
            "atol": atol, "rtol": rtol,
            "cpu_max_abs_err": errs,
            "int8_step": steps8,
            "how": "per model: the port's float32 run on the CPU (plain "
                   "kernel versions) against this reference run gave the "
                   "largest absolute difference cpu_max_abs_err over "
                   "every logit and logsumexp recorded; atol and rtol are "
                   "ten times it (at least 1e-4), rounded up to one digit, "
                   "for sums taken in another order on the card (TF32 "
                   "off).  For an int8 cache a float32 k or v that "
                   "differs by an ulp between the CPU and the card can "
                   "round to the neighbouring code: int8_step is the "
                   "largest difference the port's CPU run shows when "
                   "every inexact code is rounded to its other neighbour, "
                   "rounded up to one digit, and the model's atol is the "
                   "larger of the two (its rtol stays ten times its CPU "
                   "error)"},
        "models": models,
        "serve": {"args": {"requests": 64, "slots": 16, "gen_len": 8,
                           "pages": 128, "seq": 64},
                  "command": "python -m repro.launch.serve --arch A "
                             "--policy P",
                  "policies": summary(DEFAULT_ARCH),
                  "by_arch": {a: summary(a) for a in by_arch}},
    }
    GOLDEN.write_text(json.dumps(gold) + "\n")


def bf16_drift(arch="rwkv6_3b", layers=(4, 8), batch=2, steps=128):
    """Print how far decoding a prompt token by token drifts from the
    prefill's last logits in bf16, for the reference and the port, on the
    same seeded weights (``convert.random_jax_tree``) at full width with
    ``layers`` layers: the drift that keeps ``chip_smoke.py``'s full-depth
    check of decode against prefill in float32."""
    for n_layers in layers:
        cfg = configs.get(arch).with_(n_layers=n_layers)
        tree = convert.random_jax_tree(cfg, G.SEED)
        tok = tokens(cfg, (batch, steps), seed=7)
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(convert.params_from_jax(cfg, tree))
        with torch.inference_mode():
            t_tok = torch.from_numpy(tok).long()
            want = tsteps.make_prefill_step(lm)({"tokens": t_tok}).float()
            caches = lm.init_caches(batch, steps)
            for t in range(steps):
                got, caches = lm.decode_step(caches, t_tok[:, t:t + 1], t)
        port = float((got.float() - want).abs().max())
        del lm, caches
        params = jax.tree.map(jnp.asarray, tree)
        params = jax.tree.map(lambda a, d: a.astype(d), params,
                              jax.eval_shape(JLM(cfg).init,
                                             jax.random.PRNGKey(0)))
        jwant = jax.jit(jsteps.make_prefill_step(cfg))(
            params, {"tokens": jnp.asarray(tok)})
        step = jax.jit(jsteps.make_serve_step(cfg))
        jc = JLM(cfg).init_caches(batch, steps)
        for t in range(steps):
            jgot, jc = step(params, jc, jnp.asarray(tok[:, t:t + 1]),
                            jnp.int32(t))
        ref_d = float(np.abs(np32(jgot) - np32(jwant)).max())
        print(f"{arch} at full width, {n_layers} layers, bf16, batch "
              f"{batch}, {steps} tokens: decode against prefill, max abs "
              f"diff of the last logits: reference {ref_d:.4g}, port "
              f"{port:.4g} (largest logit {float(want.abs().max()):.3g})",
              flush=True)


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
        print(f"wrote {GOLDEN}")
    elif "--bf16-drift" in sys.argv[1:]:
        bf16_drift()
    else:
        sys.exit("usage: python tests/test_torch_lm.py --write-golden | "
                 "--bf16-drift")
