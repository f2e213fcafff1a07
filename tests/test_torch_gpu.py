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
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        for u, v in pairs:
            np.testing.assert_array_equal(u, v, err_msg=name)


DELTA_TM = dict(delta=True, telemetry=True, trace_every=2, trace_len=8)


@pytest.mark.parametrize("opts", [{}, DELTA_TM], ids=["plain", "delta_tm"])
@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_body_never_waits_for_the_device(cuda, proto, opts):
    """A batch iteration queues its work without a host-device sync
    (no ``.item()``, no blocking host-to-device copy), so host and card
    overlap; only ``run_while``'s check every 32 iterations waits.  The
    same holds with delta-maintained relations and telemetry on."""
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
    the row-slab kernel ceil(n/K) times per PPCC iteration."""
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
            assert counts["rowslab"] == (60 * 64 // 16 if ppcc else 0)
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


# ---- the batch scheduler's kernels (csrc/conflict.cu, csrc/admit.cu) ----

CONFLICT = ("conflict_matrix", "conflict_fused", "conflict_fused_full")


def _words(gen, n, w, dev):
    """Random int32 words, each bit set with probability 1/8, and write
    words a subset of them."""
    def bits():
        return torch.randint(-2 ** 31, 2 ** 31, (n, w), generator=gen,
                             dtype=torch.int64).to(torch.int32)
    read = bits() & bits() & bits()
    write = read & bits()
    return read.to(dev), write.to(dev)


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


def test_conflict_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import conflict as kconf
    words = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kconf.conflict_fused(words.to(torch.int64), words)
    with pytest.raises(ValueError):
        kconf.conflict_fused(words, words[:, :1].contiguous())
    with pytest.raises(ValueError):
        kconf.conflict_matrix(words.cpu(), words.cpu())


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


@pytest.mark.parametrize("n", [1, 33, 255, 300, 1500])
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


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "llama3p2_1b", "rwkv6_3b"])
def test_lm_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model in float32: prefill, backbone and decode through the
    kernels on the card against the plain versions on the CPU."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import LM
    cfg = configs.get_smoke(arch).with_(param_dtype="float32",
                                        compute_dtype="float32")
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    got = steps.make_prefill_step(gpu)({"tokens": tok.to(cuda)})
    kernel = "flash_attention" if cfg.family == "dense" else "wkv_chunked"
    assert ops.launch_counts()[kernel] == cfg.n_layers
    want = steps.make_prefill_step(cpu)({"tokens": tok})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    cg, cc = gpu.init_caches(2, 8), cpu.init_caches(2, 8)
    for t in range(3):
        lg, cg = gpu.decode_step(cg, tok[:, t:t + 1].to(cuda), t)
        lc, cc = cpu.decode_step(cc, tok[:, t:t + 1], t)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
