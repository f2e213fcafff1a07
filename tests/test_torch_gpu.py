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


@pytest.mark.parametrize("n,d", [(12, 30), (33, 100), (7, 31), (40, 64),
                                 (160, 500), (300, 1000)])
def test_megastep_kernel_matches_plain(cuda, n, d):
    from repro_torch.kernels import megastep as kmega
    gen = torch.Generator().manual_seed(n * d)
    lanes = 5
    words = [TB.pack(_rand(gen, (lanes, n, d), p, "cpu")).to(cuda)
             for p in (0.03, 0.02, 0.02)]
    flags = [_rand(gen, (lanes, n), q, cuda) for q in (0.3, 0.7, 0.5, 0.2)]
    item = torch.randint(0, d, (lanes, n), generator=gen,
                         dtype=torch.int32).to(cuda)
    args = (*words, item, *flags)
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


@pytest.mark.parametrize("lanes,n,nc,nd", [(3, 12, 4, 8), (168, 160, 16, 32)])
def test_reserve_cohort_kernel_matches_plain(cuda, lanes, n, nc, nd):
    from repro_torch.kernels import scan as kscan
    gen = torch.Generator().manual_seed(lanes + n)
    cpu = torch.rand((lanes, nc), generator=gen) * 50
    cpu[:, 1] = cpu[:, 0]                              # argmin ties
    cpu[:, nc - 1] = E.INF                             # past the live size
    disk = torch.rand((lanes, nd), generator=gen) * 80
    t = torch.rand((lanes, n), generator=gen) * 60
    cd = torch.rand((lanes, n), generator=gen) * 10 + 10
    dd = torch.rand((lanes, n), generator=gen) * 20 + 25
    args = tuple(a.to(cuda) for a in (cpu, disk, t, cd, dd)) + (
        _rand(gen, (lanes, n), 0.4, cuda), _rand(gen, (lanes, n), 0.4, cuda))
    got = kscan.reserve_cohort(*args)
    want = ref.reserve_cohort_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("lanes,n,d", [(3, 12, 30), (168, 160, 500)])
def test_occ_validate_kernel_matches_plain(cuda, lanes, n, d):
    from repro_torch.kernels import scan as kscan
    gen = torch.Generator().manual_seed(n + d)
    words = [TB.pack(_rand(gen, (lanes, n, d), p, "cpu")).to(cuda)
             for p in (min(0.3, 6 / d), min(0.3, 3 / d), min(0.3, 3 / d))]
    commit = _rand(gen, (lanes, n), 0.5, cuda)
    got = kscan.occ_validate(commit, *words)
    want = ref.occ_validate_ref(commit, *words)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.any() and (commit & ~got).any()


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
        pairs = zip(x, y) if name in ("pstate", "rt") else [(x, y)]
        for u, v in pairs:
            np.testing.assert_array_equal(u, v, err_msg=name)


@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_body_never_waits_for_the_device(cuda, proto):
    """A batch iteration queues its work without a host-device sync
    (no ``.item()``, no blocking host-to-device copy), so host and card
    overlap; only ``run_while``'s check every 32 iterations waits."""
    p = TT.grid_cover_params((6, 13)).with_(horizon=2000.0)
    seeds, mpls, rt = TS.grid_lanes((6, 13), (5, 50), (0, 1), cuda)
    init, cond, step = E.engine_parts(p, proto, n_slots=64, pool=512,
                                      device=cuda)
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
