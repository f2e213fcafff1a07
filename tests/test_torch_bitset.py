"""The port's packed bitsets (``repro_torch.core.bitset``) against the
JAX reference (``repro.core.bitset``): every function, bit for bit, on
random words that include bit 31, with a lane axis of several lanes
(each lane compared with the reference on that lane alone)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as JB  # noqa: E402
from repro_torch.core import bitset as TB  # noqa: E402

LANES = 3


def _t(a):
    """numpy (uint32 viewed as int32) -> torch."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.numpy()


def _u32(t):
    return t.numpy().view(np.uint32)


def _sets(rng, n, d, p=0.3):
    return rng.random((LANES, n, d)) < p


@pytest.mark.parametrize("n,quantum", [(0, 8), (1, 32), (150, 32),
                                       (160, 32), (500, 32), (7, 20)])
def test_bucket_and_n_words(n, quantum):
    assert TB.bucket(n, quantum) == JB.bucket(n, quantum)
    assert TB.n_words(n + 1) == JB.n_words(n + 1)
    with pytest.raises(ValueError):
        TB.bucket(n, 0)


@pytest.mark.parametrize("d", [1, 31, 32, 33, 100, 500])
def test_pack_unpack_zeros_match_reference(d):
    rng = np.random.default_rng(d)
    sets = _sets(rng, 9, d)
    sets[:, :, min(d, 32) - 1] = True          # bit 31 of word 0 where d>=32
    got = TB.pack(torch.from_numpy(sets))
    for lane in range(LANES):
        want = np.array(JB.pack(jnp.asarray(sets[lane])))
        np.testing.assert_array_equal(_u32(got[lane]), want)
        np.testing.assert_array_equal(
            _np(TB.unpack(got, d)[lane]),
            np.asarray(JB.unpack(jnp.asarray(want), d)))
    # pad bits past d stay zero
    full = TB.unpack(got, got.shape[-1] * 32)
    assert not full[..., d:].any()
    assert tuple(TB.zeros(LANES, 9, d, "cpu").shape) == (LANES,) + \
        tuple(JB.zeros(9, d).shape)
    if d >= 32:
        assert (got[..., 0] < 0).all()           # bit 31 set -> negative int32


def test_wrap32_and_as_u32_round_trip():
    vals = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0x80000001],
                    np.int64)
    w = TB.wrap32(torch.from_numpy(vals))
    assert w.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  vals.astype(np.uint32))
    np.testing.assert_array_equal(TB.as_u32(w).numpy(), vals)


def test_word_bit_get_get_col_item_cols():
    rng = np.random.default_rng(1)
    n, d = 11, 100
    words = np.array(JB.pack(jnp.asarray(_sets(rng, n, d).reshape(-1, d))))
    words = words.reshape(LANES, n, -1)
    words[:, :, 0] |= np.uint32(1 << 31)
    tw = _t(words)
    items = rng.integers(0, d, (LANES, n)).astype(np.int32)
    w, b = TB.word_bit(torch.from_numpy(items))
    jw, jb = JB.word_bit(jnp.asarray(items))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    rows = rng.integers(0, n, LANES).astype(np.int64)
    items1 = np.array([31, 95, 40], np.int32)
    got = TB.get(tw, torch.from_numpy(rows), torch.from_numpy(items1))
    got_col = TB.get_col(tw, torch.from_numpy(items1))
    got_cols = TB.item_cols(tw, torch.from_numpy(items))
    for lane in range(LANES):
        jwords = jnp.asarray(words[lane])
        assert bool(got[lane]) == bool(JB.get(jwords, rows[lane],
                                              items1[lane]))
        np.testing.assert_array_equal(
            got_col[lane].numpy(),
            np.asarray(JB.get_col(jwords, jnp.int32(items1[lane]))))
        np.testing.assert_array_equal(
            got_cols[lane].numpy(),
            np.asarray(JB.item_cols(jwords, jnp.asarray(items[lane]))))


def test_set_bit_or_rowwise_clear_rows():
    rng = np.random.default_rng(2)
    n, d = 10, 64
    words = np.array(JB.pack(jnp.asarray(
        _sets(rng, n, d, 0.1).reshape(-1, d)))).reshape(LANES, n, -1)
    tw = _t(words)
    rows = rng.integers(0, n, LANES)
    items1 = np.array([31, 63, 0], np.int32)           # bit 31 of each word
    on1 = np.array([True, True, False])
    items = rng.integers(0, d, (LANES, n)).astype(np.int32)
    items[:, 0] = 31
    on = rng.random((LANES, n)) < 0.6
    mask = rng.random((LANES, n)) < 0.4
    sb = TB.set_bit(tw, torch.from_numpy(rows), torch.from_numpy(items1),
                    torch.from_numpy(on1))
    orw = TB.or_rowwise(tw, torch.from_numpy(items), torch.from_numpy(on))
    cr = TB.clear_rows(tw, torch.from_numpy(mask))
    for lane in range(LANES):
        jwords = jnp.asarray(words[lane])
        np.testing.assert_array_equal(
            _u32(sb[lane]),
            np.asarray(JB.set_bit(jwords, rows[lane], items1[lane],
                                  jnp.bool_(on1[lane]))))
        np.testing.assert_array_equal(
            _u32(orw[lane]),
            np.asarray(JB.or_rowwise(jwords, jnp.asarray(items[lane]),
                                     jnp.asarray(on[lane]))))
        np.testing.assert_array_equal(
            _u32(cr[lane]),
            np.asarray(JB.clear_rows(jwords, jnp.asarray(mask[lane]))))


@pytest.mark.parametrize("d", [32, 100, 500])
def test_overlaps_popcount_or_reduce(d):
    rng = np.random.default_rng(d + 3)
    n, k = 13, 7
    a = np.array(JB.pack(jnp.asarray(_sets(rng, n, d, 0.05)
                                       .reshape(-1, d)))).reshape(LANES, n, -1)
    b = np.array(JB.pack(jnp.asarray(_sets(rng, k, d, 0.05)
                                       .reshape(-1, d)))).reshape(LANES, k, -1)
    a[:, 0, :] = np.uint32(0xFFFFFFFF)                 # every bit incl. 31
    b[:, 1, -1] |= np.uint32(1 << ((d - 1) % 32))
    ta, tb = _t(a), _t(b)
    ov = TB.any_overlap(ta, tb)
    rows = TB.overlap_rows(ta[:, :k], tb)
    anyb = TB.any_bit(ta)
    pc = TB.popcount(ta)
    orr = TB.or_reduce(ta, axis=1)
    assert pc.dtype == torch.int32
    for lane in range(LANES):
        ja, jb = jnp.asarray(a[lane]), jnp.asarray(b[lane])
        np.testing.assert_array_equal(ov[lane].numpy(),
                                      np.asarray(JB.any_overlap(ja, jb)))
        np.testing.assert_array_equal(rows[lane].numpy(),
                                      np.asarray(JB.overlap_rows(ja[:k], jb)))
        np.testing.assert_array_equal(anyb[lane].numpy(),
                                      np.asarray(JB.any_bit(ja)))
        np.testing.assert_array_equal(pc[lane].numpy(),
                                      np.asarray(JB.popcount(ja)))
        np.testing.assert_array_equal(_u32(orr[lane]),
                                      np.asarray(JB.or_reduce(ja, axis=0)))
    # an empty axis reduces to zero words
    assert not TB.or_reduce(ta[:, :0], axis=1).any()
