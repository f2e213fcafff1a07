"""The premises of ``csrc/scan.cu``'s two designs, held on the CPU against
the JAX reference scans and the port's plain versions in
``kernels.ref``.  ``reserve_cohort`` against ``jaxsim._reserve_cohort``:

(a) only the masked slots are steps: dropping the unmasked slots from the
    inputs and writing INF at them afterwards gives the same pools and
    done times (the kernel compacts each pool's masked slots by ballot);
(b) the CPU and the disk pools are two independent chains: the CPU outputs
    do not depend on the disk inputs, nor the disk outputs on the CPU
    inputs (the kernel walks them in two warps);
(c) the plain version equals the reference at the kernel's edges: pools
    all 0 (ties everywhere, as at init), INF tails, all or no slots
    masked, one server a pool, pools wider than a warp, n not a multiple
    of 32.

``occ_validate`` against the ``occ_validate_multi`` scan of
``jaxsim._cohort_body``:

(d) only the would-be committers are steps: the scan over them alone,
    with fail = 0 written at the other slots, is the full scan;
(e) the plain version and a twin of the kernel's walk (chunks of slots,
    committers compacted, acc a word at a time) equal the reference at
    the kernel's edges: no committer, every slot a committer, one lane,
    W = 1 and W = 384, n not a multiple of 32.

Every comparison is bit-equal: uint32 views of the float32 outputs, and
the bool fails."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as JB  # noqa: E402
from repro.core import jaxsim  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

INF = np.float32(jaxsim.INF)
F32 = np.float32
MAIN = dict(n=160, nc=16, nd=32)   # the main path's pools and slots
CASES = [("random", 0.4), ("zero", 0.4), ("inf_tail", 0.5), ("zero", 1.0)]


def _inputs(seed, n, nc, nd, pools="random", p=0.4):
    """One lane's (cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m,
    disk_m): pools random, all 0, or 0 with a tail of INF servers (the
    grid's padded pools); masks at rate ``p``; a few requests at time 0
    and tied request times, so that argmin ties come up."""
    rng = np.random.default_rng(seed)
    cpu = (rng.random(nc) * 50).astype(F32)
    disk = (rng.random(nd) * 80).astype(F32)
    if pools != "random":
        cpu[:] = 0
        disk[:] = 0
    if pools == "inf_tail":
        cpu[nc // 2:] = INF
        disk[nd // 3:] = INF
    t = (rng.random(n) * 60).astype(F32)
    t[:4] = 0
    t[4:8] = t[8]
    cd = (rng.random(n) * 10 + 10).astype(F32)
    dd = (rng.random(n) * 20 + 25).astype(F32)
    cm = rng.random(n) < p
    dm = rng.random(n) < p
    return cpu, disk, t, cd, dd, cm, dm


def _reference(args):
    return tuple(np.asarray(x) for x in
                 jaxsim._reserve_cohort(*(jnp.asarray(a) for a in args)))


def _u32(a):
    return np.ascontiguousarray(a, F32).view(np.uint32)


def _assert_bits(got, want):
    for g, w, name in zip(got, want, ("cpu_free", "disk_free", "cpu_done",
                                      "disk_done")):
        np.testing.assert_array_equal(_u32(g), _u32(w), err_msg=name)


@pytest.mark.parametrize("pools,p", CASES)
def test_only_masked_slots_are_steps(pools, p):
    """(a): each pool's scan over its masked slots alone, with INF written
    at the others, is the full scan."""
    args = _inputs(1, **MAIN, pools=pools, p=p)
    cpu, disk, t, cd, dd, cm, dm = args
    cpu_done = np.full_like(t, INF)
    disk_done = np.full_like(t, INF)
    ic, idk = np.flatnonzero(cm), np.flatnonzero(dm)
    none = np.zeros(len(ic), bool)
    cpu2, _, done_c, _ = _reference(
        (cpu, disk, t[ic], cd[ic], dd[ic], ~none, none))
    none = np.zeros(len(idk), bool)
    _, disk2, _, done_d = _reference(
        (cpu, disk, t[idk], cd[idk], dd[idk], none, ~none))
    cpu_done[ic] = done_c
    disk_done[idk] = done_d
    _assert_bits((cpu2, disk2, cpu_done, disk_done), _reference(args))


@pytest.mark.parametrize("pools,p", CASES)
def test_pools_are_independent_chains(pools, p):
    """(b): new disk inputs leave the CPU outputs as they were, and new CPU
    inputs the disk outputs."""
    args = _inputs(2, **MAIN, pools=pools, p=p)
    other = _inputs(3, **MAIN, pools="random", p=0.6)
    base = _reference(args)
    cpu, disk, t, cd, dd, cm, dm = args
    new_disk = _reference((cpu, other[1], t, cd, other[4], cm, other[6]))
    _assert_bits((new_disk[0], new_disk[2]), (base[0], base[2]))
    new_cpu = _reference((other[0], disk, t, other[3], dd, other[5], dm))
    _assert_bits((new_cpu[1], new_cpu[3]), (base[1], base[3]))


@pytest.mark.parametrize("n,nc,nd,pools,p", [
    (160, 16, 32, "zero", 0.4),          # pools all 0
    (160, 16, 32, "inf_tail", 0.4),      # INF tails
    (160, 16, 32, "random", 1.0),        # all slots masked
    (160, 16, 32, "random", 0.0),        # no slot masked
    (64, 1, 1, "random", 0.5),           # nc = nd = 1
    (100, 40, 70, "zero", 0.4),          # wider than a warp
    (77, 16, 32, "random", 0.4),         # n not a multiple of 32
], ids=["zero_pools", "inf_tails", "all_masked", "none_masked", "one_each",
        "wide_pools", "n77"])
def test_plain_version_matches_reference_at_edges(n, nc, nd, pools, p):
    """(c): the port's plain version, lane by lane, against the reference
    scan at the kernel's edges."""
    lanes = [_inputs(10 + lane, n, nc, nd, pools, p) for lane in range(2)]
    got = ref.reserve_cohort_ref(*(torch.from_numpy(np.stack(a))
                                   for a in zip(*lanes)))
    for lane, args in enumerate(lanes):
        _assert_bits([g[lane].numpy() for g in got], _reference(args))


# ---- occ_validate: the premises of its warp-per-lane design

SMEM_MAX = 232_448                 # csrc/scan.cu: kSmemMax


def _occ_reference(commit_pre, read, dirty, write):
    """The reference's ``occ_validate_multi`` scan (``jaxsim._cohort_body``)
    on one lane."""
    def vstep(acc, i):
        fail_i = commit_pre[i] & JB.overlap_rows(read[i], dirty[i] | acc)
        acc = acc | jnp.where(commit_pre[i] & ~fail_i, write[i],
                              jnp.uint32(0))
        return acc, fail_i
    _, fails = jax.lax.scan(vstep, jnp.zeros(read.shape[1], jnp.uint32),
                            jnp.arange(read.shape[0]))
    return np.asarray(fails)


def _occ_inputs(seed, lanes, n, d, p_commit):
    """Read, dirty and write words at the engine's densities (as
    ``tests/test_torch_megastep.py`` draws them) and would-be committers
    at rate ``p_commit``."""
    rng = np.random.default_rng(seed)
    words = [np.array(JB.pack(jnp.asarray(rng.random((lanes * n, d)) < p))
                      ).reshape(lanes, n, -1)
             for p in (min(0.3, 6 / d), min(0.3, 3 / d), min(0.3, 3 / d))]
    return (rng.random((lanes, n)) < p_commit, *words)


def occ_chunk(w):
    """Slots a chunk of the kernel (``occ_chunk`` in csrc/scan.cu): 32
    while two buffers of 32 committers' three rows fit a CTA."""
    return min(32, SMEM_MAX // (2 * 3 * 4 * max(w, 1)))


def occ_warp_twin(commit_pre, read, dirty, write):
    """The kernel's walk of one lane, word for word: chunks of
    ``occ_chunk(W)`` slots, each chunk's committers taken in slot order
    from its ballot, acc updated only by a committer that passed, fail 0
    at every other slot."""
    n, w = read.shape
    fail = np.zeros(n, bool)
    acc = np.zeros(w, np.uint32)
    chunk = occ_chunk(w)
    for c0 in range(0, n, chunk):
        for b in np.flatnonzero(commit_pre[c0:c0 + chunk]):
            i = c0 + b
            f = bool((read[i] & (dirty[i] | acc)).any())
            if not f:
                acc |= write[i]
            fail[i] = f
    return fail


@pytest.mark.parametrize("p_commit", [0.05, 0.3, 0.8])
def test_occ_only_committers_are_steps(p_commit):
    """Dropping the slots whose commit_pre is off from the scan and
    writing fail = 0 there gives the reference's fails."""
    commit, *words = _occ_inputs(5, 2, 160, 500, p_commit)
    for lane in range(2):
        c = commit[lane]
        idx = np.flatnonzero(c)
        fail = np.zeros(len(c), bool)
        if len(idx):
            fail[idx] = _occ_reference(
                jnp.ones(len(idx), bool),
                *(jnp.asarray(x[lane][idx]) for x in words))
        want = _occ_reference(jnp.asarray(c),
                              *(jnp.asarray(x[lane]) for x in words))
        np.testing.assert_array_equal(fail, want)
        np.testing.assert_array_equal(
            occ_warp_twin(c, *(x[lane] for x in words)), want)


@pytest.mark.parametrize("lanes,n,d,p_commit", [
    (2, 160, 500, 0.0),              # no committer
    (2, 160, 500, 1.0),              # every slot a committer
    (1, 160, 500, 0.3),              # one lane
    (2, 77, 20, 0.5),                # W = 1, n not a multiple of 32
    (2, 40, 384 * 32, 0.6),          # W = 384: chunks of 25 slots
    (3, 77, 500, 0.5),               # n not a multiple of 32
], ids=["no_committer", "all_committers", "one_lane", "w1", "w384",
        "n77"])
def test_occ_plain_and_twin_match_reference_at_edges(lanes, n, d, p_commit):
    """The port's plain version and the kernel's walk against the
    reference scan at the kernel's edges."""
    commit, *words = _occ_inputs(n + d, lanes, n, d, p_commit)
    got = ref.occ_validate_ref(torch.from_numpy(commit),
                               *(torch.from_numpy(x.view(np.int32))
                                 for x in words))
    for lane in range(lanes):
        want = _occ_reference(jnp.asarray(commit[lane]),
                              *(jnp.asarray(x[lane]) for x in words))
        np.testing.assert_array_equal(got[lane].numpy(), want)
        np.testing.assert_array_equal(
            occ_warp_twin(commit[lane], *(x[lane] for x in words)), want)
    if 0 < p_commit < 1 and d < 10_000:
        assert got.any() and (torch.from_numpy(commit) & ~got).any()
