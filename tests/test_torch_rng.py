"""The port's threefry twin (``repro_torch.core.rng``) and samplers
against ``jax.random`` and ``repro.core.jaxsim``, bit for bit, over
2,048 keys.

Two properties of the reference decide how the twin computes, and are
held here as tests:

* XLA on the CPU fuses ``uniform``'s ``floats * (max - min) + min`` into
  one multiply-add.  A float32 multiply-then-add rounds twice and
  differs from the reference; one rounding of the exact float64 result
  does not.
* ``jax.random.categorical`` with 0 / -inf logits picks the argmax of
  ``-log(-log(u))`` over the allowed entries, which is the argmax of the
  23 mantissa bits of ``u``: the twin never calls ``log``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import jaxsim  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402

NKEYS = 2048


@pytest.fixture(scope="module")
def keys():
    """2,048 reference keys (uint32[K, 2]) and the port's view of them."""
    k = jax.random.split(jax.random.PRNGKey(20240611), NKEYS)
    k = np.asarray(k)
    return k, torch.from_numpy(k.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def test_prng_key_matches():
    seeds = np.array([0, 1, 7, 12345, 2 ** 31 - 1], np.int32)
    got = rng.PRNGKey(torch.from_numpy(seeds))
    want = np.stack([np.asarray(jax.random.PRNGKey(int(s))) for s in seeds])
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("num", [2, 3, 5, 20])
def test_split_matches(keys, num):
    jk, tk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jk))
    np.testing.assert_array_equal(_u32(rng.split(tk, num)), want)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)])
def test_bits_match(keys, shape):
    jk, tk = keys
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, shape, jnp.uint32))(jk))
    np.testing.assert_array_equal(rng.bits(tk, shape).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (10.0, 20.0), (25.0, 45.0),
                                   (12.5, 37.5), (-3.0, 0.1)])
def test_uniform_matches(keys, lo, hi):
    jk, tk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (16,), minval=lo, maxval=hi))(jk))
    got = rng.uniform(tk, (16,), lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_fma_finding(keys):
    """The reference rounds ``floats * span + min`` once (a fused
    multiply-add); a float32 multiply-then-add differs in some draws,
    the twin's single rounding in none."""
    jk, tk = keys
    lo, hi = 12.5, 37.5
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (64,), minval=lo, maxval=hi))(jk))
    floats = ((rng.bits(tk, (64,)) >> 9) | 0x3F800000).to(torch.int32) \
        .view(torch.float32) - 1.0
    lo32, span32 = np.float32(lo), np.float32(hi) - np.float32(lo)
    twice = np.maximum(lo32, floats.numpy() * span32 + lo32)
    assert (twice != want).sum() > 0
    once = rng.uniform(tk, (64,), lo, hi).numpy()
    assert (once != want).sum() == 0


def test_uniform_tensor_bounds_broadcast(keys):
    """Per-lane bounds as tensors (the engine's batched draw) equal
    one reference call per bound pair."""
    jk, tk = keys
    lo = torch.tensor([[10.0], [25.0], [12.5]])
    hi = torch.tensor([[20.0], [45.0], [37.5]])
    k3 = tk[:NKEYS - NKEYS % 3].reshape(-1, 3, 2)
    got = rng.uniform(k3, (8,), lo, hi).numpy()
    for j in range(3):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (8,), minval=float(lo[j, 0]), maxval=float(hi[j, 0])))(
                jk[:NKEYS - NKEYS % 3].reshape(-1, 3, 2)[:, j]))
        np.testing.assert_array_equal(got[:, j].view(np.uint32),
                                      want.view(np.uint32))


def test_randint_traced_bounds_match(keys):
    jk, tk = keys
    r = np.random.default_rng(5)
    lo = r.integers(0, 50, NKEYS).astype(np.int32)
    hi = (lo + r.integers(-3, 600, NKEYS)).astype(np.int32)  # incl. hi<=lo
    want = np.asarray(jax.vmap(lambda k, a, b: jax.random.randint(
        k, (6,), a, b))(jk, lo, hi))
    got = rng.randint(tk, (6,), torch.from_numpy(lo)[:, None],
                      torch.from_numpy(hi)[:, None])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, 5, 20])
def test_categorical_pick_matches(keys, width):
    """``categorical`` with 0 / -inf logits equals the first argmax of
    the mantissa bits over the allowed entries (no ``log``)."""
    jk, tk = keys
    allowed = np.random.default_rng(width).random((NKEYS, width)) < 0.5
    allowed[:, 0] |= ~allowed.any(1)
    logits = np.where(allowed, 0.0, -np.inf).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(jk, logits))
    got = rng.categorical_pick(tk, torch.from_numpy(allowed))
    np.testing.assert_array_equal(got.numpy(), want)


def _configs(fig):
    """(reference cfg, reference rt, port cfg, port rt) of a figure."""
    jp = JT.paper_figure_params(fig)
    jcfg = jaxsim._cfg(jp, 1000)
    tp = TT.paper_figure_params(fig)
    tcfg = E.make_cfg(tp, "ppcc", max_iters=1000, device="cpu")
    return jcfg, jaxsim.rt_of(jp), tcfg, E.rt_of(tp, 1, "cpu")


@pytest.mark.parametrize("fig", [7, 13])
def test_sample_txn_matches(keys, fig):
    jk, tk = keys
    jcfg, jrt, tcfg, trt = _configs(fig)
    wk, wi = jax.vmap(lambda k: jaxsim.sample_txn(k, jcfg, jrt))(jk)
    gk, gi = E.sample_txn(tk[None], tcfg, trt)
    np.testing.assert_array_equal(gk[0].numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gi[0].numpy(), np.asarray(wi))


@pytest.mark.parametrize("fig", [8, 13])
def test_sample_txns_matches(keys, fig):
    jk, tk = keys
    jcfg, jrt, tcfg, trt = _configs(fig)
    n = 40
    lanes = 64
    wk, wi = jax.vmap(lambda k: jaxsim.sample_txns(k, jcfg, jrt, n))(
        jk[:lanes])
    rt = E.RtParams(*(x.expand(lanes).contiguous() for x in trt))
    gk, gi = E.sample_txns(tk[:lanes], tcfg, rt, n)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
