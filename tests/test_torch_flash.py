"""The plain version of the port's flash-attention kernel
(``repro_torch.kernels.ref.flash_attention_ref``, what ``kernels.ops.
flash_attention`` runs on the CPU) against the JAX package's Pallas
kernel in interpret mode (``repro.kernels.ops.flash_attention``, as
``tests/test_kernels.py`` runs it) and its oracle, on the CPU.

Shapes: ``tests/test_kernels.py``'s (GQA groups 1, 2 and 8, Sq != Sk,
D 64 and 128, causal and not, float32 and bf16, sliding windows), plus
ragged lengths (S not a multiple of the block) and strided
``[B, S, H, D]`` views.  Tolerances are ``test_kernels.py``'s: 2e-5 in
float32, 2e-2 in bf16.  Rows whose every key is masked are 0 in the plain
version and the JAX oracle; the Pallas kernel leaves such rows to its
``-1e30`` arithmetic, so they are compared with the oracle only.
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
from repro_torch.kernels import ops, ref  # noqa: E402

DT = {"float32": (np.float32, torch.float32, jnp.float32, 2e-5),
      "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16, 2e-2)}


def inputs(b, hq, hkv, s, t, d, dtype, seed=0):
    """numpy float32 q/k/v rounded to ``dtype``: (torch, jax) triples."""
    rng = np.random.default_rng(seed)
    _, tdt, jdt, _ = DT[dtype]
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]
    tq = [torch.from_numpy(a).to(tdt) for a in arrs]
    jq = [jnp.asarray(a, jdt) for a in arrs]
    return tq, jq


def check(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,t,d", [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 256, 128),   # GQA group 8, cross seq lens
    (2, 4, 4, 100, 100, 16),    # ragged: S not a multiple of 64
    (1, 6, 3, 70, 130, 32),     # ragged, Sq != Sk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(b, hq, hkv, s, t, d, dtype, causal):
    (q, k, v), (jq, jk, jv) = inputs(b, hq, hkv, s, t, d, dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    blk = 128 if s % 128 == 0 and t % 128 == 0 else max(s, t)
    want = jops.flash_attention(jq, jk, jv, causal=causal,
                                block_q=min(blk, s), block_k=min(blk, t))
    assert got.dtype == q.dtype and got.shape == q.shape
    check(got, want, DT[dtype][3])
    check(got, jref.flash_attention_ref(jq, jk, jv, causal=causal),
          DT[dtype][3])


@pytest.mark.parametrize("window", [32, 128])
def test_flash_plain_sliding_window(window):
    (q, k, v), (jq, jk, jv) = inputs(1, 2, 2, 256, 256, 64, "float32", 1)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64)
    check(got, want, 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_masked_rows_match_oracle(causal):
    """Sq > Sk with a window: queries past Sk + window see no key."""
    (q, k, v), (jq, jk, jv) = inputs(1, 2, 1, 96, 40, 16, "float32", 2)
    got = ops.flash_attention(q, k, v, causal=causal, window=8)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=8)
    check(got, want, 2e-5)
    assert not got[:, :, 48:].any()          # every key masked: 0


def test_flash_plain_reads_strided_views():
    """The model passes ``[B, S, H, D]`` tensors as ``[B, H, S, D]``
    views; the result equals that of contiguous copies."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 48, 12, 32),
                                             dtype=np.float32))
    q, k, v = x[:, :, :8].transpose(1, 2), x[:, :, 8:10].transpose(1, 2), \
        x[:, :, 10:].transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    assert torch.equal(got, want)
    jwant = jref.flash_attention_ref(*(jnp.asarray(t.contiguous().numpy())
                                       for t in (q, k, v)), causal=True)
    check(got, jwant, 2e-5)
