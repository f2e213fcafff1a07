"""Flash attention's backward on the CPU: the plain version
``kernels.ref.flash_attention_bwd_ref`` (explicit formulas, float32
inside) and ``kernels.ops.flash_attention`` under autograd (the
``torch.autograd.Function`` whose CPU route runs the plain forward and
backward) against ``jax.vjp`` of the reference's
``repro.kernels.ref.flash_attention_ref``.

The same numpy inputs go through both.  Cases: causal, sliding window,
non-causal, cross-attention (Sq != Sk), GQA with g = 1, 2, 4 query heads
a KV head, D = 16, 80, 128, and Sq, Sk off every block size the kernels
use (37, 70, 130).  A query row whose every key is masked (a window in a
cross call with Sq > Sk) has a zero output and zero gradients in the
port; the reference's softmax of an all -inf row is NaN and its vjp
there is NaN, so those rows are checked against zero and the rest
against the reference.  Tolerances: float32 1e-5 of the largest
magnitude (at least 1), absolute, and 1e-5 relative (the explicit
formulas against XLA's autodiff, sums in another order); the one bf16
case 2e-2 of the largest magnitude (the port's plain forward rounds its
output to bf16 before the backward reads it, the reference
differentiates the float32 values).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CASES = [  # b, hq, hkv, sq, sk, d, causal, window
    (2, 4, 4, 37, 37, 16, True, 0),
    (1, 4, 2, 70, 70, 80, True, 0),
    (1, 8, 2, 70, 70, 128, True, 0),
    (2, 2, 1, 37, 37, 16, False, 0),
    (1, 4, 2, 130, 130, 16, True, 16),
    (1, 4, 4, 70, 70, 80, False, 16),
    (2, 4, 2, 37, 70, 16, False, 0),            # cross: Sq < Sk
    (1, 8, 2, 70, 37, 128, False, 0),           # cross: Sq > Sk
    (1, 4, 1, 70, 37, 16, True, 8),             # rows past Sk + 7 masked
    (1, 2, 2, 1, 1, 16, True, 0),
]


def inputs(case, seed, dtype=np.float32):
    b, hq, hkv, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    return q, k, v, g


def reference(q, k, v, g, causal, window, dtype=jnp.float32):
    """(out, (dq, dk, dv), lse) of the reference, float32 numpy."""
    def f(q, k, v):
        return jref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g, dtype))
    d = q.shape[-1]
    s = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64),
                  np.repeat(k, q.shape[1] // k.shape[1], 1)
                  .astype(np.float64)) * d ** -0.5
    return (np.asarray(out, np.float32),
            [np.asarray(x, np.float32) for x in grads], s)


def masked_rows(sq, sk, causal, window):
    """Query rows whose every key is masked."""
    m = ref._flash_mask(sq, sk, causal, window, "cpu")
    return (~m.any(1)).numpy()


def close(got, want, tol, rows=None):
    got = got.float().numpy()
    if rows is not None and rows.any():
        np.testing.assert_array_equal(got[..., rows, :], 0.0)
        got, want = got[..., ~rows, :], want[..., ~rows, :]
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_ref_matches_jax_vjp(case):
    b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v, g = inputs(case, sq * 31 + sk + d)
    out, (dq, dk, dv), _ = reference(q, k, v, g, causal, window)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kw = dict(causal=causal, window=window)
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    rows = masked_rows(sq, sk, causal, window)
    close(o, out, 1e-5)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tg, **kw)
    close(got[0], dq, 1e-5, rows)
    close(got[1], dk, 1e-5)
    close(got[2], dv, 1e-5)
    assert bool(torch.isinf(lse[..., torch.from_numpy(rows)]).all())


@pytest.mark.parametrize("case", CASES)
def test_flash_autograd_function_matches_jax_vjp(case):
    """The Function on CPU tensors given in the model's layout (``[B, H, S,
    D]`` views of ``[B, S, H, D]`` tensors)."""
    b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v, g = inputs(case, sq * 17 + sk + d + 1)
    out, (dq, dk, dv), _ = reference(q, k, v, g, causal, window)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1,
                                                                    3)))
                  .transpose(1, 2).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    rows = masked_rows(sq, sk, causal, window)
    close(o.detach(), out, 1e-5)
    close(got[0], dq, 1e-5, rows)
    close(got[1], dk, 1e-5)
    close(got[2], dv, 1e-5)


def test_flash_autograd_bf16_matches_jax_vjp():
    case = (1, 8, 2, 70, 70, 128, True, 0)
    q, k, v, g = inputs(case, 3)
    out, (dq, dk, dv), _ = reference(q, k, v, g, True, 0, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(o, (tq, tk, tv),
                              torch.from_numpy(g).bfloat16())
    assert all(x.dtype == torch.bfloat16 for x in got)
    close(o.detach(), out, 2e-2)
    for x, w in zip(got, (dq, dk, dv)):
        close(x, w, 2e-2)


def test_flash_without_grad_is_the_plain_forward():
    """No input requires grad (serving): the plain forward, no Function."""
    q, k, v, _ = inputs(CASES[1], 0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv)
    assert o.grad_fn is None
    assert torch.equal(o, ref.flash_attention_ref(tq, tk, tv))
    with torch.no_grad():
        o2 = ops.flash_attention(tq.requires_grad_(), tk, tv)
    assert o2.grad_fn is None and torch.equal(o, o2)
