"""The port's plain cohort-step relations (``kernels.ref.megastep_ref``)
against the JAX oracle ``repro.kernels.ref.megastep_ref`` and the Pallas
kernel ``repro.kernels.megastep.megastep`` in interpret mode, at the
tile-edge shapes of ``tests/test_megastep.py`` and the main path's
(160, 500); the plain twins of the two scans against
``jaxsim._reserve_cohort`` and the OCC same-iteration validation scan of
``jaxsim._cohort_body``.  Exact equality throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as JB  # noqa: E402
from repro.core import jaxsim  # noqa: E402
from repro.kernels import megastep as JMS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

EDGE_SHAPES = [(12, 30, 8), (33, 100, 32), (7, 31, 32), (40, 64, 16),
               (160, 500, 32)]
NAMES = ("dep", "ww", "writers_at", "readers_at", "deg", "lockhit",
         "dirty_hit")


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _reference_inputs(seed, n, d):
    """One quantum's inputs in the reference's dtypes: read/write/dirty
    words at the engine's densities (lock holders' write rows kept
    disjoint, as wait-to-commit acquisition keeps them), op items and
    kinds, and the active/ready/haslocks flags."""
    rng = np.random.default_rng(seed)

    def words(p):
        return np.array(JB.pack(jnp.asarray(rng.random((n, d)) < p)))
    read, write, dirty = words(min(0.4, 8 / d)), words(min(0.3, 4 / d)), \
        words(0.1)
    haslocks = rng.random(n) < 0.2
    taken = np.zeros_like(write[0])
    for k in np.flatnonzero(haslocks):
        write[k] &= ~taken
        taken |= write[k]
    active = rng.random(n) < 0.8
    item = rng.integers(0, d, n).astype(np.int32)
    is_w = rng.random(n) < 0.4
    ready = (rng.random(n) < 0.6) & active
    return tuple(jnp.asarray(a) for a in (read, write, dirty, item, is_w,
                                          active, ready, haslocks))


def _lanes(args_per_lane):
    """Stack per-lane reference inputs into the port's lane axis."""
    return tuple(torch.stack([_t(a[k]) for a in args_per_lane])
                 for k in range(len(args_per_lane[0])))


@pytest.fixture(scope="module")
def edge_inputs():
    out = {}
    for n, d, block in EDGE_SHAPES:
        out[(n, d)] = [_reference_inputs(n * 7 + d + 101 * lane, n, d)
                       for lane in range(2)]
    return out


@pytest.mark.parametrize("n,d,block", EDGE_SHAPES)
def test_megastep_ref_matches_oracle_and_pallas(edge_inputs, n, d, block):
    per_lane = edge_inputs[(n, d)]
    got = ref.megastep_ref(*_lanes(per_lane))
    for lane, args in enumerate(per_lane):
        for g, w, name in zip(got, JREF.megastep_ref(*args), NAMES):
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w),
                                          err_msg=f"{name} vs oracle")
    pallas = JMS.megastep(*per_lane[0], block=block, interpret=True)
    for g, p, name in zip(got, pallas, NAMES):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(p),
                                      err_msg=f"{name} vs Pallas")
    assert got[4].dtype == torch.int32


@pytest.mark.parametrize("n,d,block", EDGE_SHAPES)
def test_megastep_dep_ww_symmetric(edge_inputs, n, d, block):
    """dep and ww of the plain version are symmetric in (i, j), as both
    predicates are, and equal the JAX oracle's."""
    per_lane = edge_inputs[(n, d)]
    dep, ww = ref.megastep_ref(*_lanes(per_lane))[:2]
    for name, t in (("dep", dep), ("ww", ww)):
        assert torch.equal(t, t.transpose(1, 2)), name
    for lane, args in enumerate(per_lane):
        want = JREF.megastep_ref(*args)
        for g, w, name in zip((dep, ww), want[:2], NAMES):
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w),
                                          err_msg=f"{name} vs oracle")


def test_megastep_relations_dispatch_on_cpu(edge_inputs):
    """On CPU tensors the dispatcher is the plain version and launches
    nothing."""
    args = _lanes(edge_inputs[(33, 100)])
    ops.reset_launches()
    got = ops.megastep_relations(*args)
    want = ref.megastep_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["megastep"] == 0


def _reserve_inputs(seed, lanes, n, nc, nd):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cpu = (rng.random((lanes, nc)) * 50).astype(f32)
    disk = (rng.random((lanes, nd)) * 80).astype(f32)
    cpu[:, nc - 2:] = f32(jaxsim.INF)                  # pool past live size
    cpu[:, 1] = cpu[:, 0]                              # argmin ties
    t = (rng.random((lanes, n)) * 60).astype(f32)
    cd = (rng.random((lanes, n)) * 10 + 10).astype(f32)
    dd = (rng.random((lanes, n)) * 20 + 25).astype(f32)
    cm = rng.random((lanes, n)) < 0.4
    dm = rng.random((lanes, n)) < 0.4
    return cpu, disk, t, cd, dd, cm, dm


@pytest.mark.parametrize("lanes,n,nc,nd", [(3, 12, 4, 8), (2, 33, 16, 32),
                                           (2, 160, 16, 32)])
def test_reserve_cohort_twin_matches_reference_scan(lanes, n, nc, nd):
    args = _reserve_inputs(n + nc, lanes, n, nc, nd)
    got = ref.reserve_cohort_ref(*(torch.from_numpy(a) for a in args))
    for lane in range(lanes):
        want = jaxsim._reserve_cohort(*(jnp.asarray(a[lane]) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[lane].numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32))


def _occ_scan_reference(commit_pre, read_set, dirty, write_set):
    """The reference's ``occ_validate_multi`` scan (``jaxsim._cohort_body``)
    on one lane."""
    def vstep(acc, i):
        fail_i = commit_pre[i] & JB.overlap_rows(read_set[i], dirty[i] | acc)
        acc = acc | jnp.where(commit_pre[i] & ~fail_i, write_set[i],
                              jnp.uint32(0))
        return acc, fail_i
    _, fails = jax.lax.scan(vstep, jnp.zeros(read_set.shape[1], jnp.uint32),
                            jnp.arange(read_set.shape[0]))
    return fails


@pytest.mark.parametrize("lanes,n,d", [(3, 12, 30), (2, 40, 100),
                                       (2, 160, 500)])
def test_occ_validate_twin_matches_reference_scan(lanes, n, d):
    rng = np.random.default_rng(n + d)
    words = [np.array(JB.pack(jnp.asarray(rng.random((lanes * n, d)) < p))
                      ).reshape(lanes, n, -1)
             for p in (min(0.3, 6 / d), min(0.3, 3 / d), min(0.3, 3 / d))]
    commit = rng.random((lanes, n)) < 0.5
    got = ref.occ_validate_ref(torch.from_numpy(commit),
                               *(_t(w) for w in words))
    assert got.any() and (torch.from_numpy(commit) & ~got).any()
    for lane in range(lanes):
        want = _occ_scan_reference(jnp.asarray(commit[lane]),
                                   *(jnp.asarray(w[lane]) for w in words))
        np.testing.assert_array_equal(got[lane].numpy(), np.asarray(want))
