"""The port's Mixture-of-Experts layer and moe family
(``repro_torch.models.moe``, ``repro_torch.models.lm``) against the JAX
reference (``repro.models.moe``, ``repro.models.lm``), on the CPU.

``moe_apply`` is held in float32 to 1e-5 (absolute and relative; sums
taken in another order) and its load-balance loss to 1e-6, for top_k 1, 2
and 4, with tokens dropped (capacity factor 0.5), the shared expert, an
odd token count, and a router whose experts tie in pairs, so that every
choice rests on the lower-index-first order of ``jax.lax.top_k``.  The
routing itself (which expert, which slot, which token dropped) is held
exactly.  The moe family's prefill and decode against the reference run
in ``tests/test_torch_lm.py`` (dbrx and llama4-maverick smoke configs);
here are the interleaved llama4 layout with its query heads padded, and
the errors the family raises where the reference's does.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")
CASES = ("drop", "shared", "odd", "tie")


def np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def moe_cfg(top_k, case):
    """dbrx's smoke config with 8 experts and ``top_k``, varied by
    ``case``."""
    cfg = configs.get_smoke("dbrx_132b").with_(n_experts=8, top_k=top_k,
                                              **F32)
    if case == "drop":
        cfg = cfg.with_(capacity_factor=0.5)
    if case == "shared":
        cfg = cfg.with_(moe_shared_expert=True)
    return cfg


def moe_pair(cfg, case, seed=0):
    """(the reference's params, the port's MoE with the same weights);
    with ``case == "tie"`` expert 2m + 1's router column is expert 2m's,
    so each token's probabilities tie in pairs."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg,
                      shared_expert=cfg.moe_shared_expert)
    p = jax.tree.map(np.array, p)
    if case == "tie":
        p["router"][:, 1::2] = p["router"][:, 0::2]
    m = tmoe.MoE(cfg, "cpu", shared_expert=cfg.moe_shared_expert)
    flat = {k: v for k, v in p.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in p.get("shared", {}).items()})
    m.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    return jax.tree.map(jnp.asarray, p), m


def tokens_of(cfg, case, seed=1):
    """Tokens ``[B, S, d]``: 21 for "odd", 128 for "drop" (twice the
    tokens an expert takes at capacity factor 0.5, on average), else
    32."""
    shape = {"odd": (3, 7), "drop": (2, 64)}.get(case, (2, 16))
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model), dtype=np.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_apply_matches_reference(top_k, case):
    cfg = moe_cfg(top_k, case)
    p, m = moe_pair(cfg, case)
    x = tokens_of(cfg, case)
    y, aux = tmoe.moe_apply(m, cfg, torch.from_numpy(x))
    jy, jaux = jmoe.moe_apply(p, cfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=1e-5, rtol=1e-5)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    # the routing, exactly: the experts chosen and the tokens dropped
    n = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(n, -1)) @ p["router"], -1)
    _, jexp = jax.lax.top_k(probs, top_k)
    _, texp = tmoe.route(torch.from_numpy(np.array(probs)), top_k)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    c = tmoe.capacity(n, cfg)
    counts = np.bincount(np.asarray(jexp).ravel(), minlength=cfg.n_experts)
    if case == "drop":
        assert (counts > c).any(), "the case must drop tokens"
    if case == "tie":
        assert (np.asarray(jexp) % 2 == 0).all() if top_k == 1 else True
        assert float(np.abs(np.asarray(probs)[:, 0::2]
                            - np.asarray(probs)[:, 1::2]).max()) == 0.0


def test_route_takes_the_lower_index_on_ties():
    """``route`` against ``jax.lax.top_k`` on rows full of equal values
    (every k up to the row length, ties at the cut included)."""
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in range(1, 17):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_capacity_matches_reference():
    for arch in ("dbrx_132b", "llama4_maverick_400b"):
        for cfg in (configs.get(arch), configs.get_smoke(arch)):
            for cf in (0.5, 1.0, 1.25, 2.0):
                c = cfg.with_(capacity_factor=cf)
                for n in (1, 2, 7, 8, 64, 1000, 8192, 32768):
                    assert tmoe.capacity(n, c) == jmoe.capacity(n, c)
                    assert tmoe.capacity(n, c) % 8 == 0


def test_moe_init_matches_reference_spread():
    """The port's own init: the reference's shapes and dtypes (router
    float32), truncated normals at each weight's fan-in, within 5%."""
    cfg = configs.get_smoke("llama4_maverick_400b").with_(
        n_experts=16, d_ff=256)
    m = tmoe.MoE(cfg, "cpu", shared_expert=True)
    m.init(torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda k: jmoe.moe_init(k, cfg, shared_expert=True),
                         jax.random.PRNGKey(0))
    assert m.router.dtype == torch.float32
    for name, t in m.state_dict().items():
        leaf = ref
        for key in name.split("."):
            leaf = leaf[key]
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
    for w, fan in ((m.wi_gate, cfg.d_model), (m.wo, cfg.d_ff),
                   (m.router, cfg.d_model)):
        want = 0.98658 * fan ** -0.5     # std of N(0,1) cut at +-3
        assert abs(float(w.float().std()) / want - 1) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama4_interleave_with_padded_heads_matches_reference(dtype):
    """llama4-maverick's layout at smoke size with its query heads padded
    (4 -> 6 here, as 40 -> 48 at full width) and 4 layers: the
    interleaved dense (``d_ff_dense``) and MoE layers, the shared expert,
    the prefill and decode steps through the interleaved caches, with
    seeded weights (``convert.random_jax_tree``: the padded heads' ``wo``
    rows are not zero, so they count)."""
    cfg = configs.get_smoke("llama4_maverick_400b").with_(
        n_layers=4, pad_q_heads=6)
    # in bf16 every token takes every expert, as in test_torch_lm.py's
    # cfg_of: a near tie flips between the two frameworks' roundings
    cfg = cfg.with_(**F32) if dtype == "float32" else \
        cfg.with_(top_k=cfg.n_experts)
    tree = convert.random_jax_tree(cfg, 5)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(convert.params_from_jax(cfg, tree))
    params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree,
                          jax.eval_shape(JLM(cfg).init,
                                         jax.random.PRNGKey(0)))
    tol = 1e-4 if dtype == "float32" else 3e-2
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
    with torch.inference_mode():
        got = tsteps.make_prefill_step(lm)({"tokens": torch.from_numpy(tok)})
    want = np32(jax.jit(jsteps.make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(tok)}))
    scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale,
                               rtol=tol if dtype == "float32" else 0)
    caches, jcaches = lm.init_caches(2, 8), JLM(cfg).init_caches(2, 8)
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    with torch.inference_mode():
        for t in range(6):
            lg, caches = lm.decode_step(
                caches, torch.from_numpy(tok[:, t:t + 1]), t)
            jlg, jcaches = jstep(params, jcaches, jnp.asarray(tok[:, t:t + 1]),
                                 jnp.int32(t))
            want = np32(jlg)
            scale = 1.0 if dtype == "float32" else \
                max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(lg.float().numpy(), want,
                                       atol=tol * scale,
                                       rtol=tol if dtype == "float32" else 0)
    for a, b in zip(caches, (jcaches.k, jcaches.v, jcaches.pos)):
        np.testing.assert_allclose(a.float().numpy(), np32(b),
                                   atol=tol * 4, rtol=tol)


@pytest.mark.parametrize("arch", ["dbrx_132b", "llama4_maverick_400b"])
def test_moe_prefill_raises_where_the_reference_does(arch):
    """``LM.prefill`` is the dense family's in both packages."""
    cfg = configs.get_smoke(arch)
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tok = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError):
        lm.prefill({"tokens": torch.from_numpy(tok)})
    jlm = JLM(cfg)
    with pytest.raises(NotImplementedError):       # traced, not run
        jax.eval_shape(jlm.prefill,
                       jax.eval_shape(jlm.init, jax.random.PRNGKey(0)),
                       {"tokens": jnp.asarray(tok)})
    with pytest.raises(ValueError, match="moe_every"):
        LM(cfg.with_(moe_every=3), device="cpu")
