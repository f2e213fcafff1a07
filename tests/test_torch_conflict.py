"""The port's plain conflict versions (``repro_torch.kernels.ref``) against
the JAX reference, on the CPU, with exact equality: against the jnp
oracles of ``repro.kernels.ref`` and against the Pallas kernels of
``repro.kernels.ops`` in interpret mode, as the reference's own tests run
them.  The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.sched import workload as W  # noqa: E402

KERNELS = ("conflict_matrix", "conflict_fused", "conflict_fused_full")


def _words(n, d, seed):
    """(uint32 words for JAX, int32 words for the port) of random read
    and write sets; writes are a subset of reads, as in a transaction."""
    rng = np.random.default_rng(seed)
    p = min(0.5, 12 / d)
    read = rng.random((n, d)) < p
    write = read & (rng.random((n, d)) < 0.5)
    rw, ww = W.pack_words(read), W.pack_words(write)
    return ((jnp.asarray(rw), jnp.asarray(ww)),
            (torch.from_numpy(rw.view(np.int32)),
             torch.from_numpy(ww.view(np.int32))))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _assert_equal(got, want, tag):
    got, want = _as_tuple(got), tuple(_as_tuple(want))
    assert len(got) == len(want), tag
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (tag, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} output {k}")


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("n", [1, 33, 64, 256])
@pytest.mark.parametrize("d", [31, 100, 1000])
def test_plain_conflict_matches_reference(name, n, d):
    (jr, jw), (tr, tw) = _words(n, d, seed=n * 1000 + d)
    got = getattr(tref, f"{name}_ref")(tr, tw)
    _assert_equal(got, getattr(jref, f"{name}_ref")(jr, jw), f"ref {name}")
    _assert_equal(got, getattr(jops, name)(jr, jw), f"pallas {name}")
    # the CPU dispatcher takes the plain version
    _assert_equal(getattr(tops, name)(tr, tw), got, f"ops {name}")


@pytest.mark.parametrize("name", KERNELS)
def test_plain_conflict_row_blocks(name, monkeypatch):
    """Row blocks of any size give the same relations: the full-width
    plain version runs in 64-row blocks, a test-sized one in 1."""
    _, (tr, tw) = _words(70, 300, seed=5)
    fn = getattr(tref, f"{name}_ref")
    whole = tuple(x.numpy() for x in _as_tuple(fn(tr, tw)))
    for block_bytes in (1, 70 * 10 * 4 * 3, 1 << 20):
        monkeypatch.setattr(tref, "PLAIN_BLOCK_BYTES", block_bytes)
        _assert_equal(fn(tr, tw), whole, f"{name} block {block_bytes}")


def test_full_width_workload_conflicts():
    """The full-width YCSB batch is high contention: the hottest page is in
    about a third of the transactions, and about a fifth of all ordered
    pairs are RAW conflicts."""
    rw, ww = W.ycsb_batch(n=512)
    read = np.unpackbits(rw.view(np.uint8), axis=1, bitorder="little")
    assert read.sum(1).tolist() == [W.PER_TXN] * 512
    raw = tref.conflict_matrix_ref(torch.from_numpy(rw.view(np.int32)),
                                   torch.from_numpy(ww.view(np.int32)))
    assert 0.1 < raw.float().mean().item() < 0.4


# ---- the gather route's rule (csrc/conflict.cu), modelled in torch ----

FUSED = ("conflict_fused", "conflict_fused_full")


def _bits(words):
    """int32 words [n, W] -> int64 0/1 [n, 32 W], page p at column p."""
    n, w = words.shape
    shifts = torch.arange(32, dtype=torch.int64)
    return ((words.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(
        n, 32 * w)


def _index(words):
    """The page-major bitset of the kernel's index pass: int64 words
    [32 W, ceil(n/32)], bit i % 32 of word i // 32 of page p set when row
    i holds page p; rows past n are empty."""
    n = words.shape[0]
    nw = -(-n // 32)
    cols = torch.nn.functional.pad(_bits(words).T, (0, 32 * nw - n))
    shifts = torch.arange(32, dtype=torch.int64)
    return (cols.reshape(-1, nw, 32) << shifts).sum(-1)


def _or_rows(words, index, n):
    """bool [n, n]: row i the OR of the index rows of row i's set pages,
    one OR per set bit, unpacked."""
    bits = _bits(words)
    out = torch.zeros((n, index.shape[1]), dtype=torch.int64)
    for i in range(n):
        for p in bits[i].nonzero()[:, 0].tolist():
            out[i] |= index[p]
    return _bits(out.to(torch.int32))[:, :n].bool()


def _gather_model(name, read, write):
    """The gather route of entry ``name`` on the CPU: raw and ww from
    ``writers``, cdeg from ``readers``, the degrees as popcounts, the
    diagonals as bit i; and the route count (set bits visited)."""
    n = read.shape[0]
    writers = _index(write)
    raw = _or_rows(read, writers, n)
    ww = _or_rows(write, writers, n)
    rdeg, wdeg = (m.sum(1, dtype=torch.int32) for m in (raw, ww))
    count = int(_bits(read).sum()) + int(_bits(write).sum())
    if name == "conflict_fused":
        return (raw, ww, rdeg, wdeg), count
    cdeg = _or_rows(write, _index(read), n).sum(1, dtype=torch.int32)
    count += int(_bits(write).sum())
    return (raw, ww, rdeg, cdeg, wdeg, raw.diagonal().clone(),
            ww.diagonal().clone()), count


def _edge(kind, n, d, seed):
    """Words with an edge: every other row empty, one row holding every
    page (read and written), or page 7 written by every transaction."""
    rng = np.random.default_rng(seed)
    read = rng.random((n, d)) < min(0.5, 12 / d)
    write = read & (rng.random((n, d)) < 0.5)
    if kind == "zero rows":
        read[::2] = write[::2] = False
    elif kind == "full row":
        read[n // 2] = write[n // 2] = True
    else:
        read[:, 7] = write[:, 7] = True
    return W.pack_words(read), W.pack_words(write)


def _hold_model(name, rw, ww):
    """The model against the port's plain version, the jnp oracle and the
    Pallas kernel in interpret mode, and its count against the set bits of
    the uint32 words."""
    jr, jw = jnp.asarray(rw), jnp.asarray(ww)
    tr = torch.from_numpy(rw.view(np.int32))
    tw = torch.from_numpy(ww.view(np.int32))
    got, count = _gather_model(name, tr, tw)
    _assert_equal(got, getattr(tref, f"{name}_ref")(tr, tw), f"ref {name}")
    _assert_equal(got, getattr(jref, f"{name}_ref")(jr, jw), f"jref {name}")
    _assert_equal(got, getattr(jops, name)(jr, jw), f"pallas {name}")

    def ones(a):
        return int(np.unpackbits(a.view(np.uint8)).sum())
    mult = 2 if name == "conflict_fused_full" else 1
    assert count == ones(rw) + mult * ones(ww)


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("n", [1, 33, 64, 256])
@pytest.mark.parametrize("d", [31, 100, 1000])
def test_gather_model_matches_reference(name, n, d):
    rng = np.random.default_rng(n * 1000 + d)
    p = min(0.5, 12 / d)
    read = rng.random((n, d)) < p
    write = read & (rng.random((n, d)) < 0.5)
    _hold_model(name, W.pack_words(read), W.pack_words(write))


@pytest.mark.parametrize("name", FUSED)
def test_gather_model_on_the_ycsb_batch(name):
    _hold_model(name, *W.ycsb_batch(n=256, d=2048))


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("kind", ["zero rows", "full row", "page by all"])
def test_gather_model_at_the_edges(name, kind):
    _hold_model(name, *_edge(kind, 64, 100, seed=3))
