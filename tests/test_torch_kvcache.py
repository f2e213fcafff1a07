"""The port's int8 KV cache and sliding-window ring cache
(``repro_torch.models.attention``, ``repro_torch.models.lm``) against the
JAX reference (``repro.models.attention``, ``repro.models.lm``), on the
CPU.

``_quantize`` and ``_dequant`` are held bit for bit: the same float32 or
bf16 input gives the same int8 codes, float32 scales and dequantised
values.  Attention through an int8 cache and through a windowed cache is
held to ``tests/test_torch_lm.py``'s float32 tolerance, 1e-4; the
int8 codes the two packages write are held equal.  The ring-cache twin
of ``tests/test_runtime_extras.py::
test_ring_buffer_window_decode_matches_full_context`` runs in float32
within 1e-5: a ring and a linear cache hold the same keys in other
slots, so only the order of the softmax's sums differs.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import LM as JLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")


def np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def quant_inputs(dtype):
    """Rows of random values at several magnitudes, an all-zero row, a
    row of exact half-steps (max 127, so the scale rounds to 1 and x /
    scale lands on .5: round half to even), and rows whose values sit
    one float32 step either side of a half-step."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((40, 16)).astype(np.float32)
            * np.float32(10.0) ** rng.integers(-3, 3, (40, 1))]
    rows.append(np.zeros((1, 16), np.float32))
    half = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                     63.5, -63.5, 3.5, 4.5, -3.5, -4.5, 0], np.float32)
    rows.append(half[None])
    rows.append(np.nextafter(half, np.float32(np.inf))[None])
    rows.append(np.nextafter(half, np.float32(-np.inf))[None])
    x = np.concatenate(rows).reshape(4, 11, 16)
    if dtype == "bfloat16":
        tx = torch.from_numpy(x).bfloat16()
        return tx, jnp.asarray(x, jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequant_bit_equal(dtype):
    tx, jx = quant_inputs(dtype)
    q, s = tattn._quantize(tx)
    jq, js = jattn._quantize(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # the half-steps rounded half to even, the zero row to codes 0
    half = q.reshape(-1, 16)[41:42].flatten().tolist()
    assert half[:8] == [127, 0, 2, 2, 0, -2, -2, 126]
    assert not q.reshape(-1, 16)[40].any()
    for cdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = tattn._dequant(q, s, cdt)
        want = jattn._dequant(jq, js, jdt)
        assert got.dtype == cdt
        np.testing.assert_array_equal(got.float().numpy(), np32(want))
    np.testing.assert_array_equal(
        tattn._dequant(tx, None, torch.float32).numpy(),
        np32(jattn._dequant(jx, None, jnp.float32)))


@pytest.mark.parametrize("cache_dtype", ["int8", "bfloat16", "float32"])
def test_init_cache_shapes_and_dtypes(cache_dtype):
    cfg = configs.get_smoke("yi_34b")
    c = tattn.init_cache(cfg, 3, 10, kv_repeat=2, cache_dtype=cache_dtype)
    j = jattn.init_cache(cfg, 3, 10, kv_repeat=2, cache_dtype=cache_dtype)
    assert len(c) == len(j) == 5
    for name, a, b in zip(tattn.KVCache._fields, c, j):
        if b is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        np.testing.assert_array_equal(a.float().numpy(), np32(b))


def attn_pair(cfg, seed=2):
    """(the reference's attention params, the port's Attention)."""
    p = jattn.attn_init(jax.random.PRNGKey(seed), cfg,
                        pad_q_heads=cfg.pad_q_heads)
    att = tattn.Attention(cfg, "cpu", pad_q_heads=cfg.pad_q_heads)
    att.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    return p, att


def decode_both(cfg, p, att, steps, cache_len, cache_dtype, kv_repeat):
    """Decode ``steps`` (position, slot) pairs through both packages from
    empty caches; yields (port out, ref out, port cache, ref cache)."""
    rng = np.random.default_rng(3)
    tc = tattn.init_cache(cfg, 2, cache_len, kv_repeat=kv_repeat,
                          cache_dtype=cache_dtype)
    jc = jattn.init_cache(cfg, 2, cache_len, kv_repeat=kv_repeat,
                          cache_dtype=cache_dtype)
    step = jax.jit(lambda c, x, ps, slot: jattn.attention(
        p, cfg, x, ps, kv_repeat=kv_repeat, cache=c, cache_pos=slot))
    for pos, slot in steps:
        xs = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
        ps = np.asarray([pos], np.int32)
        ty, tc = tattn.attention(att, cfg, torch.from_numpy(xs),
                                 torch.from_numpy(ps), kv_repeat=kv_repeat,
                                 cache=tc, cache_pos=slot)
        jy, jc = step(jc, jnp.asarray(xs), jnp.asarray(ps), jnp.int32(slot))
        yield ty, jy, tc, jc


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_int8_decode_matches_reference(kv_repeat):
    """yi's smoke attention (8 query heads over 2 KV heads) through an
    int8 cache: each step's output within 1e-4, the codes, scales and
    positions written equal, past the cache's end included (the slot
    clamps)."""
    cfg = configs.get_smoke("yi_34b").with_(cache_dtype="int8", **F32)
    p, att = attn_pair(cfg)
    steps = [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (9, 9)]
    for ty, jy, tc, jc in decode_both(cfg, p, att, steps, 6, "int8",
                                      kv_repeat):
        np.testing.assert_allclose(ty.numpy(), np32(jy), atol=1e-4,
                                   rtol=1e-4)
    assert tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale),
                               rtol=1e-6)
    np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale),
                               rtol=1e-6)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_sliding_window_decode_mask_matches_reference(cache_dtype):
    """A window of 4 over a ring of 4 slots and over a linear cache of 12:
    the decode mask drops every slot at or before ``pos - window``, in
    both layouts, against the reference."""
    cfg = configs.get_smoke("qwen3_0p6b").with_(sliding_window=4, **F32)
    p, att = attn_pair(cfg)
    ring = [(t, t % 4) for t in range(11)]
    ring_out = []
    for ty, jy, _, _ in decode_both(cfg, p, att, ring, 4, cache_dtype, 1):
        np.testing.assert_allclose(ty.numpy(), np32(jy), atol=1e-4,
                                   rtol=1e-4)
        ring_out.append(ty)
    lin = [(t, t) for t in range(11)]
    for (ty, jy, _, _), r in zip(decode_both(cfg, p, att, lin, 12,
                                             cache_dtype, 1), ring_out):
        np.testing.assert_allclose(ty.numpy(), np32(jy), atol=1e-4,
                                   rtol=1e-4)
        # the same inputs through the ring and the linear cache agree
        torch.testing.assert_close(ty, r, atol=1e-5, rtol=1e-5)


def test_windowed_full_sequence_matches_masked_sdpa():
    """The full-sequence branch with a window of 8 at S = 40 (flash's
    plain version with ``window``) against the reference's masked
    ``_sdpa``, output and returned cache."""
    cfg = configs.get_smoke("zamba2_1p2b").with_(sliding_window=8, **F32)
    params, att = attn_pair(cfg, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 40, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.arange(40, dtype=np.int32)
    y, c = tattn.attention(att, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos), return_cache=True)
    jy, jc = jattn.attention(params, cfg, jnp.asarray(x), jnp.asarray(pos),
                             return_cache=True)
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=1e-4, rtol=1e-4)
    for a, b in zip(c[:3], (jc.k, jc.v, jc.pos)):
        np.testing.assert_allclose(a.numpy(), np32(b), atol=1e-5, rtol=1e-5)
    assert c.k_scale is None and jc.k_scale is None


def test_ring_buffer_window_decode_matches_full_context():
    """The port's twin of ``tests/test_runtime_extras.py::
    test_ring_buffer_window_decode_matches_full_context``: zamba2's smoke
    config (window 32) decodes 40 tokens with a ring of 32 slots and with
    a linear cache of 40; the logits agree at every step within 1e-5
    (float32, float32 caches).  ``init_caches`` caps a windowed model's
    cache at the window (the reference's test gets a ring of 32 for its
    "big" cache too), so the linear cache of 40 comes from the same
    config without the window."""
    cfg = configs.get_smoke("zamba2_1p2b").with_(cache_dtype="float32", **F32)
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    T = 40
    tok = torch.randint(0, cfg.vocab, (1, T),
                        generator=torch.Generator().manual_seed(1))
    ring = lm.init_caches(1, T)
    big = LM(cfg.with_(sliding_window=0), device="cpu").init_caches(1, T)
    assert ring["shared_attn"].k.shape[2] == 32
    assert big["shared_attn"].k.shape[2] == 40
    with torch.inference_mode():
        for t in range(T):
            out_r, ring = lm.decode_step(ring, tok[:, t:t + 1], t)
            out_b, big = lm.decode_step(big, tok[:, t:t + 1], t)
            torch.testing.assert_close(out_r, out_b, atol=1e-5, rtol=1e-5)
    # the ring wrapped: slot t % 32 holds position t for the last 32
    assert ring["shared_attn"].pos[0].tolist() == \
        [32 + i if i < 8 else i for i in range(32)]


@pytest.mark.parametrize("window", [0, 16])
def test_slot_and_cache_len_match_reference(window):
    """``cache_len`` and ``_slot`` for linear and ring sizes."""
    cfg = configs.get_smoke("zamba2_1p2b").with_(sliding_window=window)
    lm, jlm = LM(cfg, device="meta"), JLM(cfg)
    for seq in (1, 8, 16, 17, 64):
        assert lm.cache_len(seq) == jlm.cache_len(seq)
    for size in (8, 16, 17, 64):
        for pos in (0, 7, 15, 16, 17, 40, 63, 100):
            assert lm._slot(pos, size) == int(jlm._slot(jnp.int32(pos),
                                                         size)), (pos, size)
