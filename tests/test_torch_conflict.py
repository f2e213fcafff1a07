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
