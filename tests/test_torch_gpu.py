"""The port's CUDA kernels on the card: each bit-equal to its plain
PyTorch version, and the engine's kernel path equal to its plain path.

Every test here is marked ``gpu`` and skips where no CUDA device is
present.  The file imports only torch and ``repro_torch``, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bitset as TB  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import sweep as TS  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu
NAMES = ("dep", "ww", "writers_at", "readers_at", "deg", "lockhit",
         "dirty_hit")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, shape, p, dev):
    return (torch.rand(shape, generator=gen) < p).to(dev)


def _megastep_args(gen, lanes, n, d, dev):
    words = [TB.pack(_rand(gen, (lanes, n, d), p, "cpu")).to(dev)
             for p in (0.03, 0.02, 0.02)]
    flags = [_rand(gen, (lanes, n), q, dev) for q in (0.3, 0.7, 0.5, 0.2)]
    item = torch.randint(0, d, (lanes, n), generator=gen,
                         dtype=torch.int32).to(dev)
    return (*words, item, *flags)


# tile edges, the main path's n, n at the kernel's row block (96) less
# one, at it and plus one, n off the 16-byte stores, three CTAs a lane,
# and past 8 x 96 slots, where a lane's rows per CTA grow (with 16-byte
# and with byte stores)
@pytest.mark.parametrize("n,d", [(12, 30), (33, 100), (7, 31), (40, 64),
                                 (160, 500), (300, 1000), (95, 300),
                                 (96, 300), (97, 300), (100, 200),
                                 (193, 500), (800, 30), (850, 40)])
def test_megastep_kernel_matches_plain(cuda, n, d):
    from repro_torch.kernels import megastep as kmega
    gen = torch.Generator().manual_seed(n * d)
    args = _megastep_args(gen, 5, n, d, cuda)
    got = kmega.megastep(*args)
    want = ref.megastep_ref(*args)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, NAMES):
        assert torch.equal(g, w), name


def test_megastep_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import megastep as kmega
    words = torch.zeros((2, 8, 1), dtype=torch.int32, device=cuda)
    item = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    flags = torch.zeros((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        kmega.megastep(words.to(torch.int64), words, words, item, flags,
                       flags, flags, flags)
    with pytest.raises(ValueError):
        kmega.megastep(words.cpu(), words, words, item, flags, flags,
                       flags, flags)
    big = torch.zeros((1, 2048, 64), dtype=torch.int32, device=cuda)
    bi = torch.zeros((1, 2048), dtype=torch.int32, device=cuda)
    bf = torch.zeros((1, 2048), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):            # shared memory too small
        kmega.megastep(big, big, big, bi, bf, bf, bf, bf)


@pytest.mark.parametrize("w", [1, 16])
def test_megastep_takes_up_to_its_largest_n(cuda, w):
    from repro_torch.kernels import megastep as kmega
    n = kmega.megastep_max_n(w)
    gen = torch.Generator().manual_seed(n + w)
    args = _megastep_args(gen, 1, n, 32 * w, cuda)
    got = kmega.megastep(*args)
    want = ref.megastep_ref(*args)
    torch.cuda.synchronize()
    for g, x, name in zip(got, want, NAMES):
        assert torch.equal(g, x), name
    more = _megastep_args(gen, 1, n + 1, 32 * w, cuda)
    with pytest.raises(ValueError, match=f"up to {n}"):
        kmega.megastep(*more)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


# (lanes, n, CPUs, disks, pools, mask rate): random pools with ties, the
# main path's shape, pools all 0, INF tails, all or no slots masked, one
# server a pool, pools wider than a warp, n not a multiple of 32
@pytest.mark.parametrize("lanes,n,nc,nd,pools,p", [
    (3, 12, 4, 8, "random", 0.4), (168, 160, 16, 32, "random", 0.4),
    (5, 160, 16, 32, "zero", 0.4), (5, 160, 16, 32, "inf_tail", 0.4),
    (5, 160, 16, 32, "random", 1.0), (5, 160, 16, 32, "random", 0.0),
    (5, 160, 1, 1, "random", 0.4), (5, 100, 40, 70, "zero", 0.4),
    (5, 77, 16, 32, "random", 0.4)])
def test_reserve_cohort_kernel_matches_plain(cuda, lanes, n, nc, nd, pools,
                                             p):
    from repro_torch.kernels import scan as kscan
    gen = torch.Generator().manual_seed(lanes + n)
    cpu = torch.rand((lanes, nc), generator=gen) * 50
    disk = torch.rand((lanes, nd), generator=gen) * 80
    if pools != "random":
        cpu.zero_()
        disk.zero_()
    elif nc > 1:
        cpu[:, 1] = cpu[:, 0]                          # argmin ties
        cpu[:, nc - 1] = E.INF                         # past the live size
    if pools == "inf_tail":
        cpu[:, nc // 2:] = E.INF
        disk[:, nd // 3:] = E.INF
    t = torch.rand((lanes, n), generator=gen) * 60
    cd = torch.rand((lanes, n), generator=gen) * 10 + 10
    dd = torch.rand((lanes, n), generator=gen) * 20 + 25
    args = tuple(a.to(cuda) for a in (cpu, disk, t, cd, dd)) + (
        _rand(gen, (lanes, n), p, cuda), _rand(gen, (lanes, n), p, cuda))
    got = kscan.reserve_cohort(*args)
    want = ref.reserve_cohort_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def test_reserve_cohort_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import scan as kscan
    lanes, n = 2, 8
    times = torch.zeros((lanes, n), device=cuda)
    mask = torch.zeros((lanes, n), dtype=torch.bool, device=cuda)

    def call(nc, nd):
        return kscan.reserve_cohort(
            torch.zeros((lanes, nc), device=cuda),
            torch.zeros((lanes, nd), device=cuda), times, times, times, mask,
            mask)
    call(384, 1)                                # the widest pool it takes
    for nc, nd in ((0, 4), (4, 0), (385, 4), (4, 385)):
        with pytest.raises(ValueError):
            call(nc, nd)
    with pytest.raises(ValueError):
        kscan.reserve_cohort(torch.zeros((lanes, 4)), torch.zeros(
            (lanes, 4)), times.cpu(), times.cpu(), times.cpu(), mask.cpu(),
            mask.cpu())


# the main shape at half and at sparse would-be committers, and the edges:
# no committer, all, one lane, W = 1 (n off 32), W = 3 (4-byte copies),
# W = 303 (chunks of 31 slots) and W = 384 (25), n = 77
@pytest.mark.parametrize("lanes,n,d,p", [
    (3, 12, 30, 0.5), (168, 160, 500, 0.5), (168, 160, 500, 0.03),
    (2, 160, 500, 0.0), (2, 160, 500, 1.0), (1, 160, 500, 0.3),
    (2, 77, 20, 0.5), (2, 100, 90, 0.5), (2, 100, 303 * 32, 0.5),
    (2, 40, 384 * 32, 0.6), (3, 77, 500, 0.5)])
def test_occ_validate_kernel_matches_plain(cuda, lanes, n, d, p):
    from repro_torch.kernels import scan as kscan
    gen = torch.Generator().manual_seed(n + d)
    words = [TB.pack(_rand(gen, (lanes, n, d), q, "cpu")).to(cuda)
             for q in (min(0.3, 6 / d), min(0.3, 3 / d), min(0.3, 3 / d))]
    commit = _rand(gen, (lanes, n), p, cuda)
    got = kscan.occ_validate(commit, *words)
    want = ref.occ_validate_ref(commit, *words)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if 0.3 <= p < 1 and d < 5000:
        assert got.any() and (commit & ~got).any()


def test_occ_validate_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import scan as kscan
    commit = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    kscan.occ_validate(commit, *(torch.zeros((2, 8, 384), dtype=torch.int32,
                                             device=cuda) for _ in range(3)))
    with pytest.raises(ValueError, match="at most 384"):
        kscan.occ_validate(commit, *(torch.zeros(
            (2, 8, 385), dtype=torch.int32, device=cuda) for _ in range(3)))


@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_kernel_path_equals_plain_path(cuda, proto):
    """60 batch iterations through the CUDA kernels leave every lane's
    state equal to the plain versions' run, and each kernel of the
    protocol's path is launched once per iteration."""
    p = TT.grid_cover_params((6, 13)).with_(horizon=2000.0)
    seeds, mpls, rt = TS.grid_lanes((6, 13), (5, 50), (0, 1), cuda)
    finals = []
    for mk in (True, False):
        init, cond, step = E.engine_parts(p, proto, n_slots=64, pool=512,
                                          megakernel=mk, device=cuda)
        s = init(seeds, mpls, rt)
        ops.reset_launches()
        for _ in range(60):
            s = TS._select(cond(s), step(s), s)
        counts = ops.launch_counts()
        if mk:
            assert counts["reserve_cohort"] == 60
            assert counts["megastep"] == (60 if proto == "ppcc" else 0)
            assert counts["occ_validate"] == (60 if proto == "occ" else 0)
        else:
            assert sum(counts.values()) == 0
        finals.append(E.state_to_numpy(s))
    a, b = finals
    for name in E.EngState._fields:
        x, y = getattr(a, name), getattr(b, name)
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        for u, v in pairs:
            np.testing.assert_array_equal(u, v, err_msg=name)


DELTA_TM = dict(delta=True, telemetry=True, trace_every=2, trace_len=8)


@pytest.mark.parametrize("opts", [{}, DELTA_TM, dict(step_mode="event"),
                                  dict(fused=False)],
                         ids=["plain", "delta_tm", "event", "multipass"])
@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_body_never_waits_for_the_device(cuda, proto, opts):
    """A batch iteration queues its work without a host-device sync
    (no ``.item()``, no blocking host-to-device copy), so host and card
    overlap; only ``run_while``'s check every 32 iterations waits.  The
    same holds with delta-maintained relations and telemetry on, for the
    one-event body and for the multipass PPCC chain."""
    p = TT.grid_cover_params((6, 13)).with_(horizon=2000.0)
    seeds, mpls, rt = TS.grid_lanes((6, 13), (5, 50), (0, 1), cuda)
    init, cond, step = E.engine_parts(p, proto, n_slots=64, pool=512,
                                      **opts, device=cuda)
    s = init(seeds, mpls, rt)
    s = TS._select(cond(s), step(s), s)        # kernels built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            s = TS._select(cond(s), step(s), s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_delta_telemetry_kernel_path_equals_plain_path(cuda, proto):
    """With delta (PPCC) and telemetry on, 60 batch iterations through the
    kernels leave every leaf, ``rel`` and ``tm`` included, equal to the
    plain versions' run; the megastep runs once (the init's seeding) and
    the row-slab drain once per PPCC iteration."""
    p = TT.grid_cover_params((6, 13)).with_(horizon=2000.0)
    seeds, mpls, rt = TS.grid_lanes((6, 13), (5, 50), (0, 1), cuda)
    finals = []
    for mk in (True, False):
        ops.reset_launches()
        init, cond, step = E.engine_parts(p, proto, n_slots=64, pool=512,
                                          megakernel=mk, **DELTA_TM,
                                          device=cuda)
        s = init(seeds, mpls, rt)
        for _ in range(60):
            s = TS._select(cond(s), step(s), s)
        counts = ops.launch_counts()
        if mk:
            ppcc = proto == "ppcc"
            assert counts["megastep"] == (1 if ppcc else 0)
            assert counts["rowslab_drain"] == (60 if ppcc else 0)
            assert counts["rowslab"] == 0
            assert step.cfg.delta_k == 16 or not ppcc
        else:
            assert sum(counts.values()) == 0
        finals.append(E.state_to_numpy(s))
    a, b = finals
    assert a.tm.lat_hist.sum() > 0
    for name in E.EngState._fields:
        x, y = getattr(a, name), getattr(b, name)
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        for u, v in pairs:
            np.testing.assert_array_equal(u, v, err_msg=name)


def _rowslab_args(gen, lanes, n, d, k, dev):
    """Random row-slab inputs: lane 0 a random valid slab, lane 1 an
    all-invalid one, lane 2 the top min(k, n) ids; junk ids in [0, n]
    fill the invalid entries."""
    words = [TB.pack(_rand(gen, (lanes, n, d), p, "cpu")).to(dev)
             for p in (0.03, 0.02)]
    tables = [_rand(gen, (lanes, n, n), 0.1, dev) for _ in range(2)]
    item = torch.randint(0, d, (lanes, n), generator=gen,
                         dtype=torch.int32).to(dev)
    flags = [_rand(gen, (lanes, n), q, dev) for q in (0.4, 0.8)]
    m = min(k, n)
    slab = torch.randint(0, n + 1, (lanes, k), generator=gen,
                         dtype=torch.int32)
    valid = torch.zeros((lanes, k), dtype=torch.bool)
    slab[0, :m] = torch.randperm(n, generator=gen)[:m].sort().values
    slab[2, :m] = torch.arange(n - m, n, dtype=torch.int32)
    valid[0, :m] = valid[2, :m] = True
    return (*words, *tables, item, *flags, slab.to(dev), valid.to(dev))


@pytest.mark.parametrize("n,d", [(1, 30), (14, 100), (33, 100), (160, 500),
                                 (300, 1000)])
@pytest.mark.parametrize("k", [1, 4, 40, None])
def test_rowslab_kernel_matches_plain(cuda, n, d, k):
    from repro_torch.kernels import megastep as kmega
    k = n if k is None else k
    gen = torch.Generator().manual_seed(n * 13 + k)
    args = _rowslab_args(gen, 3, n, d, k, cuda)
    got = kmega.rowslab(*args)
    want = ref.rowslab_ref(*args)
    # the carried tables as row-strided views of padded buffers, as the
    # engine's drain passes them
    views = [torch.nn.functional.pad(t, (0, 1, 0, 1))[:, :n, :n]
             for t in args[2:4]]
    strided = kmega.rowslab(*args[:2], *views, *args[4:])
    torch.cuda.synchronize()
    for g, w, v, name in zip(got, want, strided, ("dep", "ww", "wat", "rat")):
        assert g.shape == (3, k, n) and torch.equal(g, w), name
        assert torch.equal(v, w), name
        assert not g[1].any(), name                 # all-invalid slab


def test_rowslab_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import megastep as kmega
    gen = torch.Generator().manual_seed(5)
    args = list(_rowslab_args(gen, 3, 16, 64, 4, cuda))
    bad = list(args)
    bad[7] = args[7].to(torch.int64)                 # slab dtype
    with pytest.raises(ValueError):
        kmega.rowslab(*bad)
    bad = list(args)
    bad[2] = args[2].cpu()                           # a CPU table
    with pytest.raises(ValueError):
        kmega.rowslab(*bad)
    big = _rowslab_args(gen, 3, 1024, 4096, 8, cuda)   # shared memory
    with pytest.raises(ValueError):
        kmega.rowslab(*big)


def _drain_args(gen, lanes, n, d, dev):
    """Random drain inputs: words, carried tables that are not a full
    recompute's, op data, and dirty masks with lane 0 clean, lane 1 one
    dirty slot, lane 2 all n dirty and the rest random."""
    words = [TB.pack(_rand(gen, (lanes, n, d), p, "cpu")).to(dev)
             for p in (0.03, 0.02)]
    tables = [_rand(gen, (lanes, n, n), 0.1, dev) for _ in range(4)]
    item = torch.randint(0, d, (lanes, n), generator=gen,
                         dtype=torch.int32).to(dev)
    flags = [_rand(gen, (lanes, n), q, dev) for q in (0.4, 0.8)]
    dirty = torch.rand((lanes, n), generator=gen) < 0.2
    dirty[0] = False
    dirty[1] = False
    dirty[1, n - 1] = True
    dirty[2] = True
    return (*words, *tables, item, *flags, dirty.to(dev))


@pytest.mark.parametrize("n,d", [(1, 30), (14, 100), (33, 100), (160, 500),
                                 (300, 1000)])
def test_rowslab_drain_matches_plain(cuda, n, d):
    """The drain kernel bit-equal to the chunked plain drain at the row-slab
    edge shapes, with no dirty slot, one, all n (more than any slab) and
    random masks; also on tables whose rows start off a 4-byte boundary
    (the byte path)."""
    from repro_torch.kernels import megastep as kmega
    gen = torch.Generator().manual_seed(n * 17 + d)
    args = _drain_args(gen, 5, n, d, cuda)
    ops.reset_launches()
    got = kmega.rowslab_drain(*args)
    assert ops.launch_counts()["rowslab_drain"] == 1
    for k in (4, 40):
        want = ref.rowslab_drain_ref(*args, k=k)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, NAMES):
            assert g.shape == (5, n, n) and torch.equal(g, w), (name, k)
    for g, t in zip(got, args[2:6]):
        assert torch.equal(g[0], t[0])             # lane 0: a copy
    odd = [torch.empty(t.numel() + 1, dtype=torch.bool, device=cuda)[1:]
           .view(t.shape).copy_(t) for t in args[2:6]]
    shifted = kmega.rowslab_drain(*args[:2], *odd, *args[6:])
    torch.cuda.synchronize()
    for g, w, name in zip(shifted, got, NAMES):
        assert torch.equal(g, w), name


def test_rowslab_drain_leaves_parent_state(cuda):
    """The drain writes new tables: its inputs, the carried state that the
    loop keeps for finished lanes, are unchanged after the call."""
    from repro_torch.kernels import megastep as kmega
    gen = torch.Generator().manual_seed(3)
    args = _drain_args(gen, 6, 160, 500, cuda)
    before = [a.clone() for a in args]
    got = kmega.rowslab_drain(*args)
    torch.cuda.synchronize()
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    for g, t in zip(got, args[2:6]):
        assert g.data_ptr() != t.data_ptr()
    assert any(not torch.equal(g, t) for g, t in zip(got, args[2:6]))


# ---- the batch scheduler's kernels (csrc/conflict.cu, csrc/admit.cu) ----

CONFLICT = ("conflict_matrix", "conflict_fused", "conflict_fused_full")
FUSED = ("conflict_fused", "conflict_fused_full")
ROUTES = (None, "dense", "gather")


def _words(gen, n, w, dev, density=8):
    """Random int32 words, each bit set with probability 1/8 (1/2 with
    ``density=2``), and write words a subset of them, half the bits."""
    def bits():
        return torch.randint(-2 ** 31, 2 ** 31, (n, w), generator=gen,
                             dtype=torch.int64).to(torch.int32)
    read = bits() & bits() & bits() if density == 8 else bits()
    write = read & bits()
    return read.to(dev), write.to(dev)


def _ycsb_words(n, w, dev):
    """The scheduler's YCSB sets (16 Zipf pages a row, each written with
    p = 0.5) over 32 w pages."""
    from repro_torch.sched import workload as W
    rw, ww = W.ycsb_batch(n=n, d=32 * w, seed=n + w)
    return (torch.from_numpy(rw.view(np.int32)).to(dev),
            torch.from_numpy(ww.view(np.int32)).to(dev))


def _edge_words(kind, n, w, dev):
    """YCSB sets with an edge: every other row empty, one row holding every
    page (read and written), or page 37 of the batch written by every
    transaction."""
    read, write = _ycsb_words(n, w, dev)
    if kind == "zero rows":
        read[::2] = 0
        write[::2] = 0
    elif kind == "full row":
        read[n // 2] = -1
        write[n // 2] = -1
    else:
        page = 37 % (32 * w)
        read[:, page // 32] |= 1 << (page % 32)
        write[:, page // 32] |= 1 << (page % 32)
    return read, write


def _boundary_words(name, n, w, extra, seed, dev):
    """Words whose route count is the largest the gather route takes
    (``extra = 0``) or one more (``extra = 1``): random writes at 1/32,
    then read bits at random cells until the count (read bits + write
    bits, twice the write bits for conflict_fused_full) is reached."""
    from repro_torch.kernels import conflict as kconf
    from repro_torch.sched import workload as W
    cost, nw = kconf.gather_cost(), -(-n // 32)
    rhs = 2.0 * n * n * w
    top = int(rhs / (nw * cost))
    while (top + 1) * nw * cost <= rhs:
        top += 1
    while top * nw * cost > rhs:
        top -= 1
    rng = np.random.default_rng(seed)
    write = rng.random((n, 32 * w)) < 1 / 32
    target = top + extra - (2 if name == "conflict_fused_full" else 1) * \
        int(write.sum())
    assert 0 <= target <= n * 32 * w
    read = np.zeros(n * 32 * w, dtype=bool)
    read[rng.choice(n * 32 * w, size=target, replace=False)] = True
    return tuple(torch.from_numpy(W.pack_words(a.reshape(n, 32 * w))
                                  .view(np.int32)).to(dev)
                 for a in (read, write))


def _hold_fused(kconf, name, read, write, want=None):
    """Each route of entry ``name`` bit-equal to the plain version; returns
    the route the card chose."""
    want = want or getattr(ref, f"{name}_ref")(read, write)
    chosen = None
    for route in ROUTES:
        got, flags = kconf.routed(name, read, write, route)
        ran = kconf.route_ran(flags)
        assert route is None or ran == route, (name, route, ran)
        chosen = chosen or ran
        assert len(got) == len(want), name
        for k, (g, x) in enumerate(zip(got, want)):
            assert g.dtype == x.dtype and torch.equal(g, x), (name, route, k)
    return chosen


@pytest.mark.parametrize("n", [1, 33, 255, 300])
@pytest.mark.parametrize("w", [1, 3, 1024])
def test_conflict_kernels_match_plain(cuda, n, w):
    from repro_torch.kernels import conflict as kconf
    gen = torch.Generator().manual_seed(n * 7 + w)
    read, write = _words(gen, n, w, cuda)
    for name in CONFLICT:
        got = getattr(kconf, name)(read, write)
        want = getattr(ref, f"{name}_ref")(read, write)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for k, (g, x) in enumerate(zip(got, want)):
            assert g.dtype == x.dtype and torch.equal(g, x), (name, k)
        if name in FUSED:
            _hold_fused(kconf, name, read, write, want)


@pytest.mark.parametrize("kind", ["ycsb", "random 1/8", "random 1/2"])
@pytest.mark.parametrize("n", [1, 33, 300, 4097])
@pytest.mark.parametrize("w", [1, 3, 1024])
def test_conflict_routes_match_plain(cuda, kind, n, w):
    """Both fused entries on the route the card chooses and on each route
    forced, bit-equal to the plain version; at n = 4,097, W = 1,024 the
    YCSB sets take the gather route and density 1/2 the dense one."""
    from repro_torch.kernels import conflict as kconf
    gen = torch.Generator().manual_seed(n * 11 + w)
    if kind == "ycsb":
        read, write = _ycsb_words(n, w, cuda)
    else:
        read, write = _words(gen, n, w, cuda, density=int(kind[-1]))
    for name in FUSED:
        chosen = _hold_fused(kconf, name, read, write)
        if (n, w) == (4097, 1024) and kind != "random 1/8":
            assert chosen == ("gather" if kind == "ycsb" else "dense")


@pytest.mark.parametrize("kind", ["zero rows", "full row", "page by all"])
@pytest.mark.parametrize("n,w", [(33, 3), (300, 1024)])
def test_conflict_edge_inputs_match_plain(cuda, kind, n, w):
    from repro_torch.kernels import conflict as kconf
    read, write = _edge_words(kind, n, w, cuda)
    for name in FUSED:
        _hold_fused(kconf, name, read, write)


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("n,w", [(300, 3), (1000, 64)])
def test_conflict_route_switch(cuda, name, n, w):
    """At the largest route count the gather route takes, the card chooses
    it; one set bit more, the dense route; both bit-equal."""
    from repro_torch.kernels import conflict as kconf
    for extra, want in ((0, "gather"), (1, "dense")):
        read, write = _boundary_words(name, n, w, extra, n + extra, cuda)
        assert _hold_fused(kconf, name, read, write) == want, (extra, want)


def test_conflict_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import conflict as kconf
    words = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kconf.conflict_fused(words.to(torch.int64), words)
    with pytest.raises(ValueError):
        kconf.conflict_fused(words, words[:, :1].contiguous())
    with pytest.raises(ValueError):
        kconf.conflict_matrix(words.cpu(), words.cpu())
    with pytest.raises(ValueError):
        kconf.routed("conflict_fused", words, words, route="sparse")


def _admit_inputs(gen, n, dev):
    from repro_torch.sched import workload as W
    rng = np.random.default_rng(n)
    rw, ww = W.ycsb_batch(n=n, d=max(64, 8 * n), seed=n)
    read = torch.from_numpy(rw.view(np.int32)).to(dev)
    write = torch.from_numpy(ww.view(np.int32)).to(dev)
    raw, ww_, *_ = ref.conflict_fused_ref(read, write)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    seq = torch.randperm(n, generator=gen).to(torch.int32).to(dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    return raw, ww_, valid, seq, raw & ~eye


@pytest.mark.parametrize("n", [1, 33, 64, 255, 300, 1500, 4096])
def test_admit_kernels_match_plain(cuda, n):
    from repro_torch.kernels import admit as kadm
    gen = torch.Generator().manual_seed(n)
    raw, ww, valid, seq, raw_off = _admit_inputs(gen, n, cuda)
    got = kadm.ppcc_admit(raw_off, valid, seq)
    want = ref.ppcc_admit_ref(raw_off, valid, seq)
    torch.cuda.synchronize()
    for name, g, x in zip(("admitted", "preceding", "preceded", "prec"), got,
                          want):
        assert torch.equal(g, x), name
    for name in ("twopl_admit", "occ_admit"):
        g = getattr(kadm, name)(raw, ww, valid)
        x = getattr(ref, f"{name}_ref")(raw, ww, valid)
        torch.cuda.synchronize()
        assert torch.equal(g, x), name
    if n > 1:
        assert got[0].any() and not got[0].all()


def _ppcc_check(n, raw_off, valid, seq):
    from repro_torch.kernels import admit as kadm
    got = kadm.ppcc_admit(raw_off, valid, seq)
    want = ref.ppcc_admit_ref(raw_off, valid, seq)
    torch.cuda.synchronize()
    for name, g, x in zip(("admitted", "preceding", "preceded", "prec"), got,
                          want):
        assert torch.equal(g, x), f"{name} at n={n}"
    assert want[0].any() and not want[0].all()


# the four-warp route's widths (K = 1, 2, 4 words a thread) on both sides of
# each switch, the switch to the CTA route (16,384 | 16,385) and the CTA
# route's K = 4
@pytest.mark.parametrize("n", [4097, 8192, 8193, 16_384, 16_385, 32_769])
def test_ppcc_admit_routes_match_plain(cuda, n):
    """ppcc_admit on random sparse conflicts (about 3 arcs a row, the
    diagonal cleared) in a random order, on both sides of each width."""
    gen = torch.Generator(cuda).manual_seed(n)
    raw = torch.rand((n, n), generator=gen, device=cuda) < 3.0 / n
    raw.fill_diagonal_(False)
    valid = torch.rand(n, generator=gen, device=cuda) < 0.9
    seq = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
    _ppcc_check(n, raw, valid, seq)


def test_ppcc_admit_rejects_past_its_limit(cuda):
    """Past its largest n the wrapper raises a ValueError that names the
    limit, before it looks at the (here stride-0) tensors."""
    from repro_torch.kernels import admit as kadm
    top = kadm.max_n("ppcc_admit")
    assert top >= 77_482
    n = top + 1
    one = torch.zeros((1, 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match=f"n={n}; it takes at most {top}"):
        kadm.ppcc_admit(one.expand(n, n), one[0].expand(n),
                        torch.zeros(1, dtype=torch.int32,
                                    device=cuda).expand(n))


def _sparse_twopl(n, raw_ij, ww_ij, valid):
    """2PL admission from the set entries of raw and ww (``[m, 2]`` index
    pairs), for n too large for a dense plain version: i is admitted
    unless an admitted j has raw[i, j], raw[j, i] or ww[i, j]."""
    nbr = [[] for _ in range(n)]
    for (i, j) in raw_ij.tolist():
        nbr[i].append(j)
        nbr[j].append(i)
    for (i, j) in ww_ij.tolist():
        nbr[i].append(j)
    adm = [False] * n
    for i, ok in enumerate(valid.tolist()):
        adm[i] = ok and not any(adm[j] for j in nbr[i] if j != i)
    return torch.tensor(adm)


def _sparse_pairs(gen, n, per_row, dev):
    """About ``per_row`` random set entries a row, as index pairs."""
    m = per_row * n
    return torch.stack([torch.randint(0, n, (m,), generator=gen),
                        torch.randint(0, n, (m,), generator=gen)], 1).to(dev)


# the scan's widths (K = 1, 2, 4 words a thread of four warps) on both
# sides of each switch, the switch to the CTA route (16,384 | 16,385) and
# the CTA route's K = 4
@pytest.mark.parametrize("n", [4097, 8192, 8193, 16_384, 16_385, 32_769])
def test_twopl_admit_routes_match_plain(cuda, n):
    """twopl_admit on random sparse raw and ww (3 and 2 entries a row,
    diagonals included) against the plain version and the sparse one."""
    from repro_torch.kernels import admit as kadm
    gen = torch.Generator().manual_seed(n)
    raw_ij, ww_ij = (_sparse_pairs(gen, n, m, cuda) for m in (3, 2))
    raw = torch.zeros((n, n), dtype=torch.bool, device=cuda)
    ww = torch.zeros_like(raw)
    raw[raw_ij[:, 0], raw_ij[:, 1]] = True
    ww[ww_ij[:, 0], ww_ij[:, 1]] = True
    valid = (torch.rand(n, generator=gen) < 0.9).to(cuda)
    got = kadm.twopl_admit(raw, ww, valid)
    want = ref.twopl_admit_ref(raw, ww, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), _sparse_twopl(n, raw_ij.cpu(),
                                                ww_ij.cpu(), valid.cpu()))
    assert want.any() and not want.all()


def test_twopl_admit_at_its_limit(cuda):
    """At its largest n (262,144; raw and ww one 68.7 GB tensor, so that
    both fit the card) twopl_admit equals the sparse version; one more
    raises a ValueError that names the limit, before it looks at the
    (there stride-0) tensors."""
    from repro_torch.kernels import admit as kadm
    top = kadm.max_n("twopl_admit")
    assert top >= 232_448
    one = torch.zeros((1, 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError,
                       match=f"twopl_admit: n={top + 1}; it takes at most "
                             f"{top}"):
        kadm.twopl_admit(one.expand(top + 1, top + 1),
                         one.expand(top + 1, top + 1), one[0].expand(top + 1))
    gen = torch.Generator().manual_seed(1)
    pairs = _sparse_pairs(gen, top, 2, cuda)
    raw = torch.zeros((top, top), dtype=torch.bool, device=cuda)
    raw[pairs[:, 0], pairs[:, 1]] = True
    valid = (torch.rand(top, generator=gen) < 0.9).to(cuda)
    got = kadm.twopl_admit(raw, raw, valid)
    torch.cuda.synchronize()
    del raw
    torch.cuda.empty_cache()
    want = _sparse_twopl(top, pairs.cpu(), pairs.cpu(), valid.cpu())
    assert torch.equal(got.cpu(), want)
    assert want.any() and not want.all()


def _sparse_occ(n, raw_ij, ww_ij, valid):
    """OCC backward validation from the set entries of raw and ww (``[m,
    2]`` index pairs), for n too large for a dense plain version: i
    survives unless a surviving j < i has raw[i, j] or ww[i, j]."""
    earlier = [[] for _ in range(n)]
    for (i, j) in torch.cat([raw_ij, ww_ij]).tolist():
        if j < i:
            earlier[i].append(j)
    surv = [False] * n
    for i, ok in enumerate(valid.tolist()):
        surv[i] = ok and not any(surv[j] for j in earlier[i])
    return torch.tensor(surv)


# the shared scan's widths on both sides of each switch, as for twopl_admit
@pytest.mark.parametrize("n", [4097, 8192, 8193, 16_384, 16_385, 32_769])
def test_occ_admit_routes_match_plain(cuda, n):
    """occ_admit on random sparse raw and ww (3 and 2 entries a row,
    diagonals included) against the plain version and the sparse one."""
    from repro_torch.kernels import admit as kadm
    gen = torch.Generator().manual_seed(n + 1)
    raw_ij, ww_ij = (_sparse_pairs(gen, n, m, cuda) for m in (3, 2))
    raw = torch.zeros((n, n), dtype=torch.bool, device=cuda)
    ww = torch.zeros_like(raw)
    raw[raw_ij[:, 0], raw_ij[:, 1]] = True
    ww[ww_ij[:, 0], ww_ij[:, 1]] = True
    raw.fill_diagonal_(True)
    valid = (torch.rand(n, generator=gen) < 0.9).to(cuda)
    got = kadm.occ_admit(raw, ww, valid)
    want = ref.occ_admit_ref(raw, ww, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), _sparse_occ(n, raw_ij.cpu(), ww_ij.cpu(),
                                              valid.cpu()))
    assert want.any() and not want.all()


def test_occ_admit_at_its_limit(cuda):
    """At its largest n (262,144, the other two scans' too; raw and ww one
    68.7 GB tensor, so that both fit the card) occ_admit equals the sparse
    version; one more raises a ValueError that names the limit, before it
    looks at the (there stride-0) tensors."""
    from repro_torch.kernels import admit as kadm
    top = kadm.max_n("occ_admit")
    assert top == kadm.max_n("twopl_admit") == kadm.max_n("ppcc_admit")
    assert top > 232_448
    one = torch.zeros((1, 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError,
                       match=f"occ_admit: n={top + 1}; it takes at most "
                             f"{top}"):
        kadm.occ_admit(one.expand(top + 1, top + 1),
                       one.expand(top + 1, top + 1), one[0].expand(top + 1))
    gen = torch.Generator().manual_seed(2)
    pairs = _sparse_pairs(gen, top, 2, cuda)
    raw = torch.zeros((top, top), dtype=torch.bool, device=cuda)
    raw[pairs[:, 0], pairs[:, 1]] = True
    valid = (torch.rand(top, generator=gen) < 0.9).to(cuda)
    got = kadm.occ_admit(raw, raw, valid)
    torch.cuda.synchronize()
    del raw
    torch.cuda.empty_cache()
    want = _sparse_occ(top, pairs.cpu(), pairs.cpu(), valid.cpu())
    assert torch.equal(got.cpu(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("mode", ("ppcc", "ppcc_degree", "2pl", "occ"))
def test_tick_kernel_path_equals_plain_path(cuda, mode):
    """Three ticks of the drain loop on the card equal the same drain on
    CPU copies of the words (the plain versions), record for record, and
    each tick on the card launches one conflict kernel and one admission
    scan."""
    from repro_torch.sched import workload as W
    rw, ww = W.ycsb_batch(n=700, d=4096, seed=3)
    read = torch.from_numpy(rw.view(np.int32))
    write = torch.from_numpy(ww.view(np.int32))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        ops.reset_launches()
        steps, repeat = W.drain(read.to(dev), write.to(dev), mode, 3)
        counts = ops.launch_counts()
        recs = [W.tick_record(r.admitted.cpu().numpy(),
                              r.aborted.cpu().numpy(),
                              r.commit_rank.cpu().numpy(), st,
                              r.state.prec.cpu().numpy(),
                              r.state.preceding.cpu().numpy(),
                              r.state.preceded.cpu().numpy())
                for r, st in steps + ([(repeat, None)] if repeat else [])]
        runs.append(recs)
        if dev.type == "cpu":
            assert sum(counts.values()) == 0
            continue
        scan = {"ppcc": "ppcc_admit", "2pl": "twopl_admit",
                "occ": "occ_admit"}[W.MODES[mode][0]]
        assert counts[scan] == len(recs)
        if mode == "ppcc_degree":
            assert counts["conflict_fused_full"] == 3     # repeat: carried
            assert counts["conflict_fused"] == 3          # tick_stats
        else:
            assert counts["conflict_fused"] == 6
    assert runs[0] == runs[1]


def test_carry_hit_launches_nothing(cuda):
    """A degree tick whose words and valid mask equal its carry's launches
    no conflict kernel, only the admission scan, and equals a fresh
    tick."""
    from repro_torch.sched import scheduler as S
    from repro_torch.sched import workload as W
    rw, ww = W.ycsb_batch(n=500, d=2048, seed=4)
    read = torch.from_numpy(rw.view(np.int32)).to(cuda)
    write = torch.from_numpy(ww.view(np.int32)).to(cuda)
    valid = torch.ones(500, dtype=torch.bool, device=cuda)
    fresh, carry = S.tick(read, write, valid, order="degree",
                          return_carry=True)
    ops.reset_launches()
    hit = S.tick(read, write, valid, order="degree", carry=carry)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["conflict_fused_full"] == counts["conflict_fused"] == 0
    assert counts["ppcc_admit"] == 1
    for name in ("admitted", "commit_rank"):
        assert torch.equal(getattr(hit, name), getattr(fresh, name)), name
    assert torch.equal(hit.state.prec, fresh.state.prec)


# ---------------------------------------------------------------------------
# the language model's kernels: flash attention and the chunked WKV, held
# to their plain versions within the tolerances of tests/test_kernels.py
# (float sums in another order, expf against torch's exp)

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(gen, b, hq, hkv, s, t, d, dtype, dev, strided):
    """q/k/v; ``strided``: ``[B, H, S, D]`` views of ``[B, S, H, D]``
    tensors, as the model passes them."""
    def make(h, n):
        x = torch.randn((b, n, h, d), generator=gen).to(dtype).to(dev)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()
    return make(hq, s), make(hkv, t), make(hkv, t)


@pytest.mark.parametrize("b,hq,hkv,s,t,d", [
    (2, 4, 4, 128, 128, 64), (1, 8, 4, 100, 100, 16), (1, 8, 1, 128, 256, 128),
    (2, 6, 3, 70, 130, 32), (1, 2, 2, 1, 1, 256), (1, 4, 2, 300, 200, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32),
                                           (False, 32)])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, s, t, d, dtype, causal,
                                    window):
    from repro_torch.kernels import flash_attention as kflash
    gen = torch.Generator().manual_seed(s * t + d)
    q, k, v = _flash_inputs(gen, b, hq, hkv, s, t, d, dtype, cuda,
                            strided=d != 16)
    got = kflash.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_tensor_core_route(cuda):
    """The dtype picks the route: a bf16 call launches the tensor-core
    kernel only, a float32 call the CUDA-core kernel only, for TMA-ready
    views and for views TMA cannot load (D = 20: 40-byte rows)."""
    from repro_torch.kernels import flash_attention as kflash
    gen = torch.Generator().manual_seed(9)
    for d in (128, 20):
        for dtype, route in ((torch.bfloat16, "flash_attention_tc"),
                             (torch.float32, "flash_attention")):
            q, k, v = _flash_inputs(gen, 1, 4, 2, 100, 90, d, dtype, cuda,
                                    strided=True)
            if dtype == torch.bfloat16:
                assert kflash.tma_strides(q)[1] == (d % 8 == 0)
            ops.reset_launches()
            got = kflash.flash_attention(q, k, v, causal=True, window=0)
            counts = ops.launch_counts()
            assert counts[route] == 1 and sum(
                counts[r] for r in kflash.ROUTES.values()) == 1, counts
            want = ref.flash_attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_head_dim_80(cuda, dtype, causal):
    """D = 80 (hubert-xlarge): on the tensor cores TMA loads each row's
    80 columns as two 64-column blocks, the second read past d = 80,
    where the loads must give zeros (the views are TMA-ready: 160-byte
    rows); Sq and Sk off the tiles."""
    from repro_torch.kernels import flash_attention as kflash
    gen = torch.Generator().manual_seed(80)
    q, k, v = _flash_inputs(gen, 2, 16, 16, 300, 300, 80, dtype, cuda,
                            strided=True)
    if dtype == torch.bfloat16:
        assert all(kflash.tma_strides(t)[1] for t in (q, k, v))
    got = kflash.flash_attention(q, k, v, causal=causal, window=0)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cross_attention_shape(cuda, dtype):
    """The vision model's cross-attention: Sk = 1,601 image tokens (a
    ragged last key tile), Sq = 200 queries, GQA 8 over 4, non-causal,
    no window."""
    from repro_torch.kernels import flash_attention as kflash
    gen = torch.Generator().manual_seed(1601)
    q, k, v = _flash_inputs(gen, 2, 8, 4, 200, 1601, 128, dtype, cuda,
                            strided=True)
    got = kflash.flash_attention(q, k, v, causal=False, window=0)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as kflash
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    with pytest.raises(ValueError):
        kflash.flash_attention(q.cpu(), q.cpu(), q.cpu())
    with pytest.raises(ValueError):                  # Hkv does not divide Hq
        kflash.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError):                  # D above 256
        big = torch.zeros((1, 1, 4, 264), device=cuda)
        kflash.flash_attention(big, big, big)
    with pytest.raises(ValueError):                  # mixed dtypes
        kflash.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):                  # strided last axis
        kflash.flash_attention(q.transpose(2, 3), q, q)


def _wkv_inputs(gen, b, h, s, d, dtype, dev):
    r, k, v = ((torch.randn((b, s, h, d), generator=gen) * 0.5).to(dtype)
               .to(dev).transpose(1, 2) for _ in range(3))
    lw = (-torch.exp(torch.randn((b, s, h, d), generator=gen) * 0.5 - 2)
          ).to(dev).transpose(1, 2)
    u = (torch.randn((h, d), generator=gen) * 0.1).to(dev)
    return r, k, v, lw, u


@pytest.mark.parametrize("b,h,s,d,chunk", [
    (1, 2, 64, 16, 16), (2, 3, 128, 32, 64), (1, 48, 128, 64, 128),
    (2, 48, 1024, 64, 128), (1, 48, 128, 64, 16), (1, 48, 512, 64, 64),
    (1, 4, 96, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_matches_plain(cuda, b, h, s, d, chunk, dtype):
    from repro_torch.kernels import wkv as kwkv
    gen = torch.Generator().manual_seed(b * h * s + chunk)
    args = _wkv_inputs(gen, b, h, s, d, dtype, cuda)
    s0 = (torch.randn((b, h, d, d), generator=gen) * 0.1).to(cuda)
    for state0 in (None, s0):
        got = kwkv.wkv_chunked(*args, chunk=chunk, state0=state0)
        want = ref.wkv_chunked_ref(*args, chunk=chunk, state0=state0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)


# the CPU twin's shapes (tests/test_torch_wkv.py): D, chunk, S = chunk or
# 8 chunk, both dtypes, with and without an initial state
@pytest.mark.parametrize("s_mult", [1, 8])
@pytest.mark.parametrize("chunk", [1, 16, 64, 128])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_matches_plain_at_twin_shapes(cuda, d, chunk, s_mult,
                                                 dtype):
    from repro_torch.kernels import wkv as kwkv
    gen = torch.Generator().manual_seed(d * chunk + s_mult)
    args = _wkv_inputs(gen, 1, 3, chunk * s_mult, d, dtype, cuda)
    s0 = (torch.randn((1, 3, d, d), generator=gen) * 0.1).to(cuda)
    for state0 in (None, s0):
        got = kwkv.wkv_chunked(*args, chunk=chunk, state0=state0)
        want = ref.wkv_chunked_ref(*args, chunk=chunk, state0=state0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)


def test_wkv_kernel_at_the_main_path_layout(cuda):
    """The rwkv6-3b prefill's shape and layout: B = 8, H = 48, S = 1,024,
    D = 64, chunk 128, bf16 r/k/v as [B, H, S, D] views of [B, S, H*D]
    tensors, and one unaligned layout (the scalar loads)."""
    from repro_torch.kernels import wkv as kwkv
    gen = torch.Generator().manual_seed(3)
    args = _wkv_inputs(gen, 8, 48, 1024, 64, torch.bfloat16, cuda)
    got = kwkv.wkv_chunked(*args, chunk=128)
    want = ref.wkv_chunked_ref(*args, chunk=128)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)
    # rows 4 elements off 16 bytes at a stride of 260 elements: the
    # kernel's scalar loads
    def padded(x):
        b, h, s, d = x.shape
        wide = torch.zeros((b, s, h * d + 4), dtype=x.dtype, device=cuda)
        wide[..., 4:] = x.transpose(1, 2).reshape(b, s, h * d)
        return wide[..., 4:].unflatten(-1, (h, d)).transpose(1, 2)
    r, k, v, lw, u = _wkv_inputs(gen, 2, 4, 128, 64, torch.bfloat16, cuda)
    args = tuple(padded(x) for x in (r, k, v, lw)) + (u,)
    assert args[0].stride(2) == 260
    got = kwkv.wkv_chunked(*args, chunk=64)
    want = ref.wkv_chunked_ref(*args, chunk=64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)


def _admit_case(gen, kind, lanes, n, d, m):
    """A reachable PPCC state on the CPU (every slot begun, a first batch
    admitted, a quarter of the slots holding locks) and an op list
    ``[L, m]``: random, or an edge list."""
    from repro_torch.core import ppcc as TP

    def op_list():
        txn = torch.randint(0, n, (lanes, m), generator=gen,
                            dtype=torch.int32)
        item = torch.randint(0, d, (lanes, m), generator=gen,
                             dtype=torch.int32)
        wr = torch.rand((lanes, m), generator=gen) < 0.3
        valid = torch.rand((lanes, m), generator=gen) < 0.9
        return [txn, item, wr, valid]

    s = TP.begin_many(TP.init_state(lanes, n, d, device="cpu"),
                      torch.ones((lanes, n), dtype=torch.bool))
    s = TP.admit_ops(s, *op_list()).state
    s = s._replace(haslocks=torch.rand((lanes, n), generator=gen) < 0.25)
    ops_ = op_list()
    if kind == "one txn":
        ops_[0][:] = 3 % n
    elif kind == "one item":
        ops_[1][:] = 7 % d
    elif kind == "writes only":
        ops_[2][:] = True
    elif kind == "reads only":
        ops_[2][:] = False
    elif kind == "all invalid":
        ops_[3][:] = False
    return s, ops_


@pytest.mark.parametrize("kind", ["random", "one txn", "one item",
                                  "writes only", "reads only", "all invalid"])
@pytest.mark.parametrize("lanes,n,d,m", [(3, 16, 40, 100), (2, 33, 100, 300),
                                         (1, 256, 1024, 512),
                                         (2, 1025, 64, 200),
                                         (1, 160, 500, 0)])
def test_admit_ops_kernel_matches_plain(cuda, kind, lanes, n, d, m):
    """``admit_ops`` on the card: every verdict and state leaf bit-equal
    to ``ref.admit_ops_ref``, one launch per call with ops (none for an
    empty list), the input state left as it was."""
    from repro_torch.kernels import admit_ops as kadm
    gen = torch.Generator().manual_seed(lanes * n + m)
    s, op_list = _admit_case(gen, kind, lanes, n, d, m)
    args = [t.to(cuda).contiguous() for t in (*s, *op_list)]
    before = [t.clone() for t in args]
    ops.reset_launches()
    got = kadm.admit_ops(*args)
    assert ops.launch_counts()["admit_ops"] == (1 if m else 0)
    want = ref.admit_ops_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def test_admit_ops_rejects_what_it_does_not_take(cuda):
    from repro_torch.core import ppcc as TP
    from repro_torch.kernels import admit_ops as kadm
    s = TP.begin_many(TP.init_state(2, 8, 40, device=cuda),
                      torch.ones((2, 8), dtype=torch.bool, device=cuda))
    zi = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    zb = torch.zeros((2, 5), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):                  # txn int64
        kadm.admit_ops(*s, zi.long(), zi, zb, zb)
    with pytest.raises(ValueError):                  # one lane of ops
        kadm.admit_ops(*s, zi[:1], zi[:1], zb[:1], zb[:1])
    with pytest.raises(ValueError):                  # a CPU state
        kadm.admit_ops(*(t.cpu() for t in s), zi, zi, zb, zb)
    with pytest.raises(ValueError):                  # valid txn out of range
        TP.admit_ops(s, zi + 8, zi, zb, ~zb)


def test_wc_acquire_many_exact_rides_twopl_admit(cuda):
    """``wc_acquire_many(exact=True)`` on the card, at the grid's shape
    (n = 160, W = 16): one ``twopl_admit`` launch per lane, bit-equal to
    the plain loop on the CPU."""
    from repro_torch.core import ppcc as TP
    gen = torch.Generator().manual_seed(3)
    lanes, n, d = 8, 160, 500
    s = TP.begin_many(TP.init_state(lanes, n, d, device="cpu"),
                      torch.ones((lanes, n), dtype=torch.bool))
    s = s._replace(
        write_set=TB.pack(torch.rand((lanes, n, d), generator=gen) < 0.01),
        haslocks=torch.rand((lanes, n), generator=gen) < 0.2)
    mask = torch.rand((lanes, n), generator=gen) < 0.5
    want_s, want = TP.wc_acquire_many(s, mask, exact=True)
    ops.reset_launches()
    got_s, got = TP.wc_acquire_many(
        TP.PPCCState(*(t.to(cuda) for t in s)), mask.to(cuda), exact=True)
    assert ops.launch_counts()["twopl_admit"] == lanes
    assert torch.equal(got.cpu(), want) and want.any()
    for a, b in zip(got_s, want_s):
        assert torch.equal(a.cpu(), b)


def test_wkv_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import wkv as kwkv
    gen = torch.Generator().manual_seed(0)
    r, k, v, lw, u = _wkv_inputs(gen, 1, 2, 64, 16, torch.float32, cuda)
    with pytest.raises(ValueError):                  # chunk does not divide S
        kwkv.wkv_chunked(r, k, v, lw, u, chunk=48)
    with pytest.raises(ValueError):                  # chunk above 128
        kwkv.wkv_chunked(r, k, v, lw, u, chunk=256)
    with pytest.raises(ValueError):                  # log_w not float32
        kwkv.wkv_chunked(r, k, v, lw.bfloat16(), u)
    with pytest.raises(ValueError):                  # head size 48
        x = torch.zeros((1, 1, 16, 48), device=cuda)
        kwkv.wkv_chunked(x, x, x, x, torch.zeros((1, 48), device=cuda))


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "llama3p2_1b", "rwkv6_3b",
                                  "zamba2_1p2b", "yi_34b:int8", "dbrx_132b",
                                  "llama4_maverick_400b",
                                  "llama3p2_vision_11b", "hubert_xlarge"])
def test_lm_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model in float32: prefill, backbone and decode through the
    kernels on the card against the plain versions on the CPU.  zamba2's
    64 tokens run its chunked Mamba2 scan over four chunks and its shared
    block (one flash launch a group) with a window of 32, and 40 decode
    steps wrap its ring of 32 slots; yi-34b decodes through an int8 cache,
    where a k or v that differs by an ulp can round to the neighbouring
    code, so its decode is held to 1e-2.  The vision model runs with
    non-zero gates over seeded image tokens (one more flash launch a
    cross block) and decodes against seeded cross caches; hubert's
    encoder runs its prefill on frames and does not decode."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import LM
    name, _, cache = arch.partition(":")
    cfg = configs.get_smoke(name).with_(param_dtype="float32",
                                        compute_dtype="float32")
    if cache:
        cfg = cfg.with_(cache_dtype=cache)
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if cfg.family == "vlm":
        with torch.no_grad():
            for blk in cpu.cross_blocks:
                blk.gate_attn.fill_(0.5)
                blk.gate_mlp.fill_(0.7)
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    batch = {"tokens": tok}
    if cfg.family == "audio":
        batch = {"frames": torch.randn((2, 64, cfg.d_model), generator=gen)}
    if cfg.family == "vlm":
        batch["img"] = torch.randn((2, cfg.n_img_tokens, cfg.d_model),
                                   generator=gen)
    ops.reset_launches()
    got = steps.make_prefill_step(gpu)({k: v.to(cuda)
                                        for k, v in batch.items()})
    kernel = "wkv_chunked" if cfg.family == "rwkv" else "flash_attention"
    count = cfg.n_layers // cfg.hybrid_attn_every \
        if cfg.family == "hybrid" else cfg.n_layers
    assert ops.launch_counts()[kernel] == count
    want = steps.make_prefill_step(cpu)(batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    if cfg.family == "audio":
        return
    steps_n = 40 if cfg.family == "hybrid" else 3
    tol = 1e-2 if cache == "int8" else 1e-4
    cg, cc = gpu.init_caches(2, steps_n), cpu.init_caches(2, steps_n)
    if cfg.family == "vlm":
        for key in ("cross_k", "cross_v"):
            cc[key].copy_(torch.randn(cc[key].shape, generator=gen))
            cg[key].copy_(cc[key])
    for t in range(steps_n):
        lg, cg = gpu.decode_step(cg, tok[:, t:t + 1].to(cuda), t)
        lc, cc = cpu.decode_step(cc, tok[:, t:t + 1], t)
        torch.testing.assert_close(lg.cpu(), lc, atol=tol, rtol=tol)


def _moe_case(dtype, capacity_factor, dev, seed=0):
    """(cfg, MoE on ``dev``, x) at dbrx's smoke width, the weights and
    tokens drawn on the CPU; in bf16 every token takes every expert (a
    near tie would flip between the card's and the CPU's roundings)."""
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models import moe as tmoe
    cfg = configs.get_smoke("dbrx_132b").with_(
        n_experts=8, capacity_factor=capacity_factor,
        param_dtype=dtype, compute_dtype=dtype)
    if dtype == "bfloat16":
        cfg = cfg.with_(top_k=cfg.n_experts)
    m = tmoe.MoE(cfg, "cpu", shared_expert=True)
    m.init(torch.Generator().manual_seed(seed))
    m = m.to(dev)
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed + 1))
    return cfg, m, x.to(layers.dtype_of(dtype)).to(dev)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_on_the_card_matches_the_cpu(cuda, dtype, capacity_factor):
    """``moe_apply`` on the card against its run on the CPU, at the smoke
    width and at a capacity that drops tokens (0.25: a quarter of the
    routed entries fit), within 1e-4 in float32 and 2e-2 of the largest
    magnitude in bf16; the load-balance loss within 1e-5."""
    from repro_torch.models import moe as tmoe
    cfg, m, x = _moe_case(dtype, capacity_factor, cuda)
    y, aux = tmoe.moe_apply(m, cfg, x)
    yc, auxc = tmoe.moe_apply(m.to("cpu"), cfg, x.cpu())
    torch.cuda.synchronize()
    if capacity_factor < 1:
        n = x.shape[0] * x.shape[1]
        assert tmoe.capacity(n, cfg) < n * cfg.top_k / cfg.n_experts
    tol = 1e-4 if dtype == "float32" else 2e-2
    scale = 1.0 if dtype == "float32" else max(1.0, float(yc.abs().max()))
    torch.testing.assert_close(y.float().cpu(), yc.float(), atol=tol * scale,
                               rtol=tol if dtype == "float32" else 0)
    torch.testing.assert_close(aux.cpu(), auxc, atol=1e-5, rtol=1e-5)


def test_moe_on_the_card_is_deterministic(cuda):
    """Two runs of ``moe_apply`` on the card give the same bits: the
    combine adds each token's contributions in one order, with no
    atomics (a drop-forcing capacity, bf16, 4,096 tokens of top 4 of
    16 experts)."""
    from repro_torch import configs
    from repro_torch.models import moe as tmoe
    cfg = configs.get_smoke("dbrx_132b").with_(
        n_experts=16, top_k=4, d_model=256, d_ff=512, capacity_factor=0.5)
    m = tmoe.MoE(cfg, cuda, shared_expert=True)
    m.init(torch.Generator(cuda).manual_seed(2))
    x = torch.randn((8, 512, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    x = x.bfloat16()
    y1, a1 = tmoe.moe_apply(m, cfg, x)
    y2, a2 = tmoe.moe_apply(m, cfg, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
