"""The plain version of the port's chunked WKV kernel
(``repro_torch.kernels.ref.wkv_chunked_ref``, what ``kernels.ops.
wkv_chunked`` runs on the CPU) against the JAX package's Pallas kernel in
interpret mode (``repro.kernels.ops.wkv_chunked``, as
``tests/test_kernels.py`` runs it), the sequential oracle ``wkv_ref`` of
both packages, and the model's chunked WKV (``models.rwkv.wkv_chunked``),
on the CPU.

Shapes: ``tests/test_kernels.py``'s, plus S that is not a multiple of 64
(96 in chunks of 32, 48 in chunks of 16), a chunk of 128, heads padded
with zero inputs, and an initial state.  Tolerance: ``test_kernels.py``'s
atol 1e-4, rtol 1e-3 (float32 sums in another order).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

ATOL, RTOL = 1e-4, 1e-3


def inputs(b, h, s, dk, seed=3, dead=0):
    """r, k, v, log_w [B, H, S, D] and u [H, D] as numpy float32, made as
    ``test_kernels.py`` makes them; the last ``dead`` heads are zero."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, dk), dtype=np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, h, s, dk), dtype=np.float32)
                 * 0.5 - 2)
    u = rng.standard_normal((h, dk), dtype=np.float32) * 0.1
    if dead:
        for x in (r, k, v):
            x[:, h - dead:] = 0
    return r, k, v, lw.astype(np.float32), u


def check(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def to_bsd(x):
    b, h, s, d = x.shape
    return np.ascontiguousarray(np.moveaxis(x, 1, 2).reshape(b, s, h * d))


@pytest.mark.parametrize("b,h,s,dk,chunk,dead", [
    (1, 2, 64, 16, 16, 0), (2, 3, 128, 32, 64, 0), (1, 1, 256, 64, 64, 0),
    (2, 2, 96, 16, 32, 0), (1, 3, 48, 32, 16, 0), (1, 2, 256, 64, 128, 0),
    (2, 4, 64, 16, 32, 1),
])
def test_wkv_plain_matches_pallas_and_oracle(b, h, s, dk, chunk, dead):
    r, k, v, lw, u = inputs(b, h, s, dk, dead=dead)
    out, state = ops.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                                 chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (b, h, s, dk)
    check(out, jops.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                                chunk=chunk))
    jout, jstate = jref.wkv_ref(*(jnp.asarray(to_bsd(x))
                                  for x in (r, k, v, lw)),
                                jnp.asarray(u.reshape(-1)), dk)
    check(to_bsd(out.numpy()), jout)
    check(state, jstate)
    tout, tstate = ref.wkv_ref(*(torch.from_numpy(to_bsd(x))
                                 for x in (r, k, v, lw)),
                               torch.from_numpy(u.reshape(-1)), dk)
    check(to_bsd(out.numpy()), tout)
    check(state, tstate)
    if dead:
        assert not out[:, h - dead:].any() and not state[:, h - dead:].any()


def test_wkv_plain_carries_an_initial_state():
    r, k, v, lw, u = inputs(2, 2, 64, 16, seed=4)
    s0 = np.random.default_rng(5).standard_normal((2, 2, 16, 16),
                                                  dtype=np.float32)
    out, state = ops.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                                 chunk=16, state0=torch.from_numpy(s0))
    jout, jstate = jref.wkv_ref(*(jnp.asarray(to_bsd(x))
                                  for x in (r, k, v, lw)),
                                jnp.asarray(u.reshape(-1)), 16,
                                state0=jnp.asarray(s0))
    check(to_bsd(out.numpy()), jout)
    check(state, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_wkv_chunked_matches_reference(dtype):
    """The model's chunked WKV on ``[B, S, H*D]`` tensors (strided
    ``[B, H, S, D]`` views into the kernel's plain version) against the
    reference model's, output and final state, from a given state."""
    b, h, s, dk = 2, 3, 128, 16
    r, k, v, lw, u = inputs(b, h, s, dk, seed=6)
    s0 = np.random.default_rng(7).standard_normal((b, h, dk, dk),
                                                  dtype=np.float32) * 0.1
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    args = [to_bsd(x) for x in (r, k, v)]
    out, state = trwkv.wkv_chunked(
        *(torch.from_numpy(a).to(tdt) for a in args),
        torch.from_numpy(to_bsd(lw)), torch.from_numpy(u.reshape(-1)), dk,
        state0=torch.from_numpy(s0), chunk=32)
    jout, jstate = jrwkv.wkv_chunked(
        *(jnp.asarray(a, jdt) for a in args), jnp.asarray(to_bsd(lw)),
        jnp.asarray(u.reshape(-1)), dk, state0=jnp.asarray(s0), chunk=32)
    assert out.shape == (b, s, h * dk) and out.dtype == torch.float32
    check(out, jout)
    check(state, jstate)
