"""The port's Mamba2 mixer (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``), on the CPU.

The reference's own init (``mamba2_init``) is carried into the port's
``Mamba2`` module, and the same numpy inputs go through both.
Tolerances are ``tests/test_torch_lm.py``'s: float32 1e-4 element by
element, bf16 3e-2 of the largest magnitude (at least 1).  The port
computes the intra-chunk terms of every chunk at once and walks only the
state recurrence in order; the reference scans the chunks, so the sums
are taken in another order.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if tol < 1e-2:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def cfg_of(dtype, **kw):
    """zamba2's smoke mixer (d = 64, 8 heads of 16, state 16, chunk 16)."""
    return configs.get_smoke("zamba2_1p2b").with_(
        param_dtype=dtype, compute_dtype=dtype, **kw)


def pair(cfg, seed=0):
    """(the reference's params, the port's Mamba2 holding them)."""
    params = jssm.mamba2_init(jax.random.PRNGKey(seed), cfg)
    m = ssm.Mamba2(cfg, "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in params.items()})
    return params, m


def xs(cfg, b, s, dtype, seed=1, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model), dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, JDT[dtype])


def cache_pair(cfg, b, dtype, seed=2):
    """A non-zero starting cache, the same in both packages."""
    sp = ssm.spec(cfg)
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, sp.conv - 1, sp.d_inner + 2 * sp.state),
                               dtype=np.float32)
    state = rng.standard_normal((b, sp.n_heads, sp.head_dim, sp.state),
                                dtype=np.float32) * np.float32(0.3)
    return (ssm.SSMCache(torch.from_numpy(conv).to(TDT[dtype]),
                         torch.from_numpy(state)),
            jssm.SSMCache(jnp.asarray(conv, JDT[dtype]), jnp.asarray(state)))


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("s", [16, 64, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, s, with_cache):
    """S of one chunk, of four, and shorter than a chunk (one chunk of
    S); with a starting cache the conv runs through
    ``_conv_with_history`` and the final conv window and state are
    compared too."""
    cfg = cfg_of(dtype)
    params, m = pair(cfg)
    tx, jx = xs(cfg, 2, s, dtype)
    tc, jc = cache_pair(cfg, 2, dtype) if with_cache else (None, None)
    with torch.inference_mode():
        y, nc = ssm.mamba2_forward(m, cfg, tx, tc)
    jy, jnc = jssm.mamba2_forward(params, cfg, jx, jc)
    close(y, jy, TOL[dtype])
    if with_cache:
        close(nc.conv, jnc.conv, TOL[dtype])
        close(nc.state, jnc.state, TOL[dtype])
    else:
        assert nc is None and jnc is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(dtype):
    """``mamba2_decode`` step by step from a non-zero cache: every
    output, conv window and state."""
    cfg = cfg_of(dtype)
    params, m = pair(cfg, seed=3)
    tx, jx = xs(cfg, 2, 6, dtype, seed=4)
    tc, jc = cache_pair(cfg, 2, dtype, seed=5)
    step = jax.jit(lambda c, x: jssm.mamba2_decode(params, cfg, x, c))
    for t in range(6):
        with torch.inference_mode():
            y, tc = ssm.mamba2_decode(m, cfg, tx[:, t:t + 1], tc)
        jy, jc = step(jc, jx[:, t:t + 1])
        close(y, jy, TOL[dtype])
        close(tc.conv, jc.conv, TOL[dtype])
        close(tc.state, jc.state, TOL[dtype])


def test_chunked_forward_equals_token_by_token_decode():
    """The port with itself: the chunked forward over 48 tokens (three
    chunks) from a cache equals decoding them one at a time from the
    same cache, outputs and final cache, in float32 within 1e-5."""
    cfg = cfg_of("float32")
    _, m = pair(cfg, seed=6)
    tx, _ = xs(cfg, 2, 48, "float32", seed=7)
    tc, _ = cache_pair(cfg, 2, "float32", seed=8)
    with torch.inference_mode():
        y, fin = ssm.mamba2_forward(m, cfg, tx, tc)
        c, ys = tc, []
        for t in range(48):
            yt, c = ssm.mamba2_decode(m, cfg, tx[:, t:t + 1], c)
            ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, atol=1e-5, rtol=1e-5)
    # the projections of one token and of 48 are sums taken in
    # another order
    torch.testing.assert_close(c.conv, fin.conv, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(c.state, fin.state, atol=1e-5, rtol=1e-5)


def test_ssd_chunked_matches_a_sequential_scan():
    """``ssd_chunked`` against the recurrence written out token by token
    (h_t = a_t h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t) at chunks 1, 4
    and 16 of S = 16, from a state."""
    g = torch.Generator().manual_seed(9)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = torch.randn((b, s, h, p), generator=g)
    B, C = torch.randn((b, s, n), generator=g), torch.randn((b, s, n),
                                                           generator=g)
    dt = torch.rand((b, s, h), generator=g) * 0.5
    log_a = -dt * torch.rand((h,), generator=g) * 4
    s0 = torch.randn((b, h, p, n), generator=g)
    state, want = s0, []
    for t in range(s):
        state = torch.exp(log_a[:, t, :, None, None]) * state + \
            (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None, :]
        want.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    want = torch.stack(want, 1)
    for chunk in (1, 4, 16):
        y, fin = ssm.ssd_chunked(x, B, C, dt, log_a, chunk, s0)
        torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(fin, state, atol=1e-5, rtol=1e-5)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    cfg = cfg_of("float32")
    _, m = pair(cfg)
    tx, jx = xs(cfg, 1, 24, "float32")
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm.mamba2_forward(m, cfg, tx)
    with pytest.raises(AssertionError):
        jssm.mamba2_forward(pair(cfg)[0], cfg, jx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_shapes_dtypes_and_spreads(dtype):
    """The port's own init: the reference's leaf names, shapes and dtypes
    (``A_log``, ``D``, ``dt_bias`` float32 whatever the parameter dtype),
    its deterministic leaves exactly, and the random ones' spreads."""
    cfg = configs.get("zamba2_1p2b").with_(param_dtype=dtype)
    m = ssm.Mamba2(cfg, "cpu")
    m.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda k: jssm.mamba2_init(k, cfg),
                          jax.random.PRNGKey(0))
    sd = m.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
        assert str(sd[k].dtype).split(".")[-1] == str(v.dtype), k
    ref = jssm.mamba2_init(jax.random.PRNGKey(0), cfg)
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm_g"):
        np.testing.assert_allclose(sd[k].float().numpy(),
                                   np.asarray(ref[k], np.float32),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    d, conv = cfg.d_model, cfg.ssm_conv
    for k, scale in (("wz", d ** -0.5), ("wxs", d ** -0.5),
                     ("out_proj", sd["out_proj"].shape[0] ** -0.5)):
        w = sd[k].float()
        assert abs(float(w.std()) / (0.98658 * scale) - 1) < 0.05, k
        assert float(w.abs().max()) <= 3 * scale * 1.01, k
    assert abs(float(sd["conv_xs"].float().std()) * conv ** 0.5 - 1) < 0.05
