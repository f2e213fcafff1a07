#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. identify the card (nvidia-smi) and build the CUDA kernels from
     src/repro_torch/csrc, one nvcc per source, in parallel;
  2. hold each kernel bit-equal to its plain PyTorch version on the card:
     the cohort-step megakernel at the main path's shape (168 lanes,
     n = 160, W = 16, inputs captured mid-run) and at tile-edge shapes, the
     row-slab kernel at the delta fleet's shape (K = 40, inputs captured
     mid-run) and at edge shapes (n in {1, 14, 33, 160, 300}, K in {1, 4,
     40, n}, an all-invalid slab, slab ids at the top of the range), and
     both scan kernels at the main path's shape;
  3. the main path: repro_torch.core.sweep.run_grid() with its defaults but
     the horizon — Figs. 5-16 x 7 MPLs x 2 seeds = 168 lanes per protocol,
     n = 160 slots, 500 items, PPCC / 2PL / OCC, to horizon 5,000 (phase 6
     runs the same grid to 10,000) — with every lane's metrics
     equal to the JAX reference's committed golden
     src/repro_torch/golden/run_grid_h5000.json, the megastep launch count
     equal to the PPCC body iterations, and the Theorem-1 invariants on the
     final PPCC states;
  4. kernel times (medians over CUDA events) beside their bounds and
     their plain versions; one batch iteration of each protocol with the
     kernels, with the plain versions and with telemetry on, and of PPCC
     with delta-maintained relations (with and without telemetry); and the
     device-busy share of a PPCC batch iteration, without and with delta:
     device kernel time from torch.profiler over the unprofiled iteration
     time;
  5. the batch scheduler at full width (repro_torch.sched): n = 4,096
     pending YCSB transactions over 32,768 pages (W = 1,024 words), the
     input digest checked against the JAX golden
     src/repro_torch/golden/sched_n4096_w1024.json; 8 ticks of the drain
     loop (tick -> tick_stats -> pending &= ~admitted) in four modes
     (ppcc, ppcc by degree with the carry threaded and one carry repeat,
     2pl, occ) and txstore.apply_tick per policy, every result equal to
     the golden; the conflict and admission launches equal to the ticks
     that reach them; the device's share of a ppcc tick from
     torch.profiler; the three conflict entry points and the three
     admission scans bit-equal to their plain versions at inputs
     captured mid-drain and at edge shapes; their times beside their
     bounds, their plain versions and, for the conflict kernels, one
     library call (a bf16 matmul of the unpacked bits) and the int8
     tensor-core floor of the same function beside the bound of the
     kernel's 32-bit-logic formulation;
  6. the delta-maintained, instrumented fleet: run_grid(delta=True,
     telemetry=True, trace_every=8, trace_len=256) at run_grid's defaults
     but the horizon (10,000), with every lane's metrics equal to the JAX
     reference's golden src/repro_torch/golden/run_grid_h10000.json, every
     lane's telemetry (histograms, cause counts, ring buffer) equal to the
     JAX reference's src/repro_torch/golden/telemetry_h10000.json, the
     megastep launched once (the init's seeding of the relations) and the
     row-slab kernel ceil(n/K) times per PPCC body iteration, the Theorem-1
     invariants on the final PPCC states, and every lane's carried
     relations equal to a full recompute of its final state.

Phase 6 runs right after phase 3, before phase 4's profiler sessions.
The last lines are the kernel table as one JSON object, the card's name
and power limit, and {"ok": true, "device": {...}}.  The script imports
nothing of JAX and nothing of the JAX package.
"""
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = SRC / "repro_torch" / "golden" / "run_grid_h20000.json"
# phases 3 and 6 run run_grid's default grid cut in depth, to horizon
# 5,000 and 10,000, so that the script stays well inside its time limit
PHASE3_GOLDEN = SRC / "repro_torch" / "golden" / "run_grid_h5000.json"
PHASE6_GOLDEN = SRC / "repro_torch" / "golden" / "run_grid_h10000.json"
TM_GOLDEN = SRC / "repro_torch" / "golden" / "telemetry_h10000.json"
SCHED_GOLDEN = SRC / "repro_torch" / "golden" / "sched_n4096_w1024.json"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 tensor cores (data sheet)
# 32-bit integer and logic results per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput)
LOGIC_PER_SM_CLOCK = 64
SCHED_EDGE_N = (1, 33, 255, 300, 4096)
SCHED_EDGE_W = (1, 3, 1024)
EDGE_SHAPES = [(12, 30), (33, 100), (7, 31), (40, 64), (160, 500)]
SLAB_EDGE_N = {1: 30, 14: 100, 33: 100, 160: 500, 300: 1000}   # n: items
SLAB_EDGE_K = (1, 4, 40)         # and K = n
CAPTURE_ITERS = 200              # body iterations before capturing inputs
TM_RUN = dict(delta=True, telemetry=True, trace_every=8, trace_len=256)
LM_GOLDEN = SRC / "repro_torch" / "golden" / "lm_full_width.json"
LM_ARCHES = ("qwen3_0p6b", "rwkv6_3b")
LM_KERNEL = {"dense": "flash_attention", "rwkv": "wkv_chunked"}
PREFILL_B, PREFILL_S = 8, 1024
DECODE_CHECK = {"qwen3_0p6b": 64, "rwkv6_3b": 128}   # prompt tokens decoded
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
# (b, Hq, Hkv, Sq, Sk, D, dtype, causal, window)
FLASH_EDGES = [(2, 8, 8, 128, 128, 64, "bfloat16", True, 0),
               (1, 8, 4, 100, 100, 16, "float32", True, 0),
               (1, 8, 1, 128, 256, 128, "bfloat16", False, 0),
               (1, 4, 2, 200, 130, 64, "float32", True, 32),
               (2, 16, 16, 333, 333, 128, "bfloat16", False, 32),
               (1, 8, 8, 64, 64, 128, "float32", True, 0)]
WKV_EDGE_CHUNKS = (16, 64, 128)  # H = 48, D = 64, S = chunk and 8 chunk


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock from nvidia-smi, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_times(fn, reps: int, torch) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event pairs,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def dev_time(e) -> float:
    """Device microseconds of one torch.profiler key-average entry, for
    device-side (kernel) entries only: a CPU-op entry also carries the
    device time of the kernels it launched, so summing both would count
    that time twice (torch's own table sums the device entries only)."""
    from torch.autograd import DeviceType
    if e.device_type != DeviceType.CUDA or \
            getattr(e, "is_user_annotation", False):
        return 0.0
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def max_abs_err(got, want, torch) -> float:
    """Largest |got - want| over a tuple of outputs; raises unless the
    shapes and dtypes match."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def random_megastep_inputs(lanes, n, d, gen, torch, B, dev):
    """Words at the engine's densities and random op data, on ``dev``."""
    def words(p):
        return B.pack(torch.rand((lanes, n, d), generator=gen) < p)
    flags = [torch.rand((lanes, n), generator=gen) < q
             for q in (0.3, 0.7, 0.5, 0.2)]
    item = torch.randint(0, d, (lanes, n), generator=gen, dtype=torch.int32)
    args = (words(0.02), words(0.01), words(0.01), item, *flags)
    return tuple(a.to(dev).contiguous() for a in args)


def random_rowslab_inputs(n, d, k, gen, torch, B, dev):
    """Three lanes of row-slab inputs on ``dev``: random words, carried
    tables, op data and flags; lane 0 a slab of min(k, n) random valid
    ids, lane 1 an all-invalid slab, lane 2 the top min(k, n) ids.  The
    invalid entries hold junk ids in [0, n]."""
    lanes = 3
    words = [B.pack(torch.rand((lanes, n, d), generator=gen) < p)
             for p in (0.03, 0.02)]
    tables = [torch.rand((lanes, n, n), generator=gen) < 0.1
              for _ in range(2)]
    item = torch.randint(0, d, (lanes, n), generator=gen, dtype=torch.int32)
    flags = [torch.rand((lanes, n), generator=gen) < q for q in (0.4, 0.8)]
    m = min(k, n)
    slab = torch.randint(0, n + 1, (lanes, k), generator=gen,
                         dtype=torch.int32)
    valid = torch.zeros((lanes, k), dtype=torch.bool)
    slab[0, :m] = torch.randperm(n, generator=gen)[:m].sort().values
    slab[2, :m] = torch.arange(n - m, n, dtype=torch.int32)
    valid[0, :m] = valid[2, :m] = True
    args = (*words, *tables, item, *flags, slab, valid)
    return tuple(a.to(dev).contiguous() for a in args)


def capture_rowslab(fn, kmega):
    """The arguments of every row-slab launch that ``fn()`` makes."""
    calls, launch = [], kmega.rowslab

    def spy(*args):
        calls.append(tuple(a.clone() for a in args))
        return launch(*args)

    kmega.rowslab = spy
    try:
        fn()
    finally:
        kmega.rowslab = launch
    return calls


def check_lanes(out, protocols, golden, tag, sweep) -> int:
    """Fail unless every lane's metrics equal the golden's; returns the
    lane-iterations of the run."""
    figs, mpls, seeds = golden["figs"], golden["mpl_grid"], golden["seeds"]
    lane_iters = 0
    for proto in protocols:
        for metric in sweep.METRICS + ("now",):
            mine = [v for f in figs
                    for v in out[f][proto][metric].reshape(-1).tolist()]
            ref_v = golden["lanes"][proto][metric]
            if len(mine) != len(ref_v):
                fail(f"[{tag}] {proto}.{metric}: {len(mine)} lanes, the "
                     f"golden has {len(ref_v)}")
            if metric == "iters":
                lane_iters += sum(mine)
            for lane, (a, b) in enumerate(zip(mine, ref_v)):
                if a != b:
                    m_s = len(mpls) * len(seeds)
                    fail(f"[{tag}] lane {lane} (fig {figs[lane // m_s]}, MPL "
                         f"{mpls[lane % m_s // len(seeds)]}, seed "
                         f"{seeds[lane % len(seeds)]}) {proto}: {metric} "
                         f"{a} on the card, {b} in the golden")
    return lane_iters


def iteration_ms(cond, step, s, sweep, torch, reps=32) -> float:
    """Wall milliseconds of one batch iteration from state ``s``, over
    ``reps`` iterations after one warm-up, synchronised."""
    s = sweep._select(cond(s), step(s), s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        s = sweep._select(cond(s), step(s), s)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def profile_iteration(cond, step, s, sweep, torch, reps=32):
    """(device ms per iteration, kernels per iteration, the five largest
    (device ms per iteration, name) entries) of ``reps`` profiled batch
    iterations from ``s``; zero time if the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(4):
        s = sweep._select(cond(s), step(s), s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            s = sweep._select(cond(s), step(s), s)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_us = sum(dev_time(e) for e in events) / reps
    kernels = sum(e.count for e in events if dev_time(e) > 0) / reps
    top = sorted(((dev_time(e) / reps / 1e3, e.key) for e in events
                  if dev_time(e) > 0), reverse=True)[:5]
    return dev_us / 1e3, kernels, top


def sched_phase(torch, dev, bound, cuda_ms) -> list:
    """Phase 5: the batch scheduler at full width against the JAX golden.
    Returns the kernel-table rows of its six kernels."""
    import numpy as np
    from repro_torch.core import bitset as B
    from repro_torch.kernels import admit as kadm
    from repro_torch.kernels import conflict as kconf
    from repro_torch.kernels import ops, ref
    from repro_torch.sched import scheduler as S
    from repro_torch.sched import txstore as X
    from repro_torch.sched import workload as W

    golden = json.loads(SCHED_GOLDEN.read_text())
    rw, ww = W.ycsb_batch()
    digest = W.digest(rw, ww)
    if digest != golden["input_sha256"]:
        fail(f"the YCSB batch's sha256 {digest} is not the golden's "
             f"{golden['input_sha256']}: the generator differs here")
    n, w = rw.shape
    log(f"[5] YCSB batch: n={n} transactions over {W.N_PAGES} pages "
        f"(W={w} words), {W.PER_TXN} distinct Zipf({W.THETA}) pages each, "
        f"each written with p={W.P_WRITE}; input sha256 {digest[:16]}... "
        f"equals the golden's")
    read = torch.from_numpy(rw.view(np.int32)).to(dev)
    write = torch.from_numpy(ww.view(np.int32)).to(dev)

    def record(res, stats, ppcc_state):
        extra = {}
        if ppcc_state:
            st = res.state
            extra = dict(prec=st.prec[0].cpu().numpy(),
                         preceding=st.preceding[0].cpu().numpy(),
                         preceded=st.preceded[0].cpu().numpy())
        return W.tick_record(res.admitted.cpu().numpy(),
                             res.aborted.cpu().numpy(),
                             res.commit_rank.cpu().numpy(), stats, **extra)

    # ---- the main path: the drain loop in four modes, then the store
    ops.reset_launches()
    torch.cuda.synchronize()
    out, walls = {}, {}
    for mode in W.MODES:
        t = time.perf_counter()
        out[mode] = W.drain(read, write, mode, W.TICKS)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t
    counts = ops.launch_counts()
    ticks = {m: len(out[m][0]) for m in W.MODES}
    for mode in W.MODES:
        steps, repeat = out[mode]
        ppcc_state = W.MODES[mode][0] == "ppcc"
        got = [record(r, st, ppcc_state) for r, st in steps]
        want = golden["modes"][mode]
        if len(got) != len(want):
            fail(f"{mode}: {len(got)} ticks, the golden has {len(want)}")
        for k, (g, x) in enumerate(zip(got, want)):
            if g != x:
                diff = sorted(key for key in set(g["sha256"]) | set(x["sha256"])
                              if g["sha256"].get(key) != x["sha256"].get(key))
                fail(f"{mode} tick {k} differs from the golden: counts "
                     f"{g['admitted']}/{g['aborted']} vs {x['admitted']}/"
                     f"{x['aborted']}, digests {diff}, stats {g.get('stats')}"
                     f" vs {x.get('stats')}")
        if repeat is not None and \
                record(repeat, None, True) != golden["carry_repeat"]:
            fail(f"{mode}: the carry repeat differs from the golden")
        log(f"[5] {mode}: {ticks[mode]} ticks in {walls[mode] * 1e3:.1f} ms "
            f"({walls[mode] / ticks[mode] * 1e3:.2f} ms per tick with "
            f"tick_stats), admitted {[r['admitted'] for r in got]}, "
            f"aborted {[r['aborted'] for r in got]}: every tick and its "
            f"tick_stats equal the golden"
            + ("; the carry repeat too" if repeat is not None else ""))
    want_counts = {
        "conflict_matrix": 0,
        # every tick but the degree ones, and every tick_stats
        "conflict_fused": sum(ticks.values()) + sum(
            t for m, t in ticks.items() if m != "ppcc_degree"),
        # the degree ticks and the repeat, less the one carry hit
        "conflict_fused_full": ticks["ppcc_degree"] + 1 - 1,
        "ppcc_admit": ticks["ppcc"] + ticks["ppcc_degree"] + 1,
        "twopl_admit": ticks["2pl"], "occ_admit": ticks["occ"]}
    got_counts = {k: counts[k] for k in want_counts}
    if got_counts != want_counts:
        fail(f"scheduler launches {got_counts}, expected {want_counts}")
    log(f"[5] launches {got_counts}: one conflict kernel per tick and per "
        f"tick_stats, one scan per tick; the carry repeat (inputs "
        f"unchanged) launched no conflict kernel")

    store_in = W.store_batch()
    if W.digest(*store_in) != golden["store"]["input_sha256"]:
        fail("the page-store batch's sha256 is not the golden's")
    pages, sread, swrite, payload, additive = (torch.from_numpy(a).to(dev)
                                               for a in store_in)
    ops.reset_launches()
    for policy in ("ppcc", "2pl", "occ"):
        batch = X.TxBatch(read_sets=sread, write_sets=swrite,
                          payload=payload, additive=additive,
                          valid=torch.ones(sread.shape[0], dtype=torch.bool,
                                           device=dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, reads, st = X.apply_tick(pages, batch, policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rec = W.store_record(new.cpu().numpy(), reads.cpu().numpy(),
                             st.admitted.cpu().numpy(),
                             st.aborted.cpu().numpy())
        if rec != golden["store"]["policies"][policy]:
            fail(f"txstore.apply_tick({policy}) differs from the golden")
        log(f"[5] txstore.apply_tick({policy}): {rec['n_admitted']} of "
            f"{sread.shape[0]} admitted over {pages.shape[0]} pages of "
            f"{pages.shape[1]} float32, {wall * 1e3:.1f} ms; new pages and "
            f"snapshot reads equal the golden bit for bit")
        del new, reads
    store_counts = ops.launch_counts()
    for k, v in store_counts.items():
        counts[k] += v

    # ---- the device's share of a tick: ppcc tick + tick_stats, first input
    from torch.profiler import ProfilerActivity, profile
    valid = torch.ones(n, dtype=torch.bool, device=dev)

    def one_tick():
        S.tick_stats(read, write, valid, S.tick(read, write, valid))

    one_tick()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(4):
        one_tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t) / 4 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            one_tick()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_ms = sum(dev_time(e) for e in events) / 4 / 1e3
    top = sorted(((dev_time(e) / 4 / 1e3, e.key) for e in events
                  if dev_time(e) > 0), reverse=True)[:4]
    if dev_ms > 0:
        log(f"[5] ppcc tick + tick_stats: {tick_ms:.3f} ms wall unprofiled, "
            f"{dev_ms:.3f} ms device kernel time, device idle "
            f"{100 * (1 - dev_ms / tick_ms):.1f}%; largest: "
            + ", ".join(f"{k[:40]} {v:.3f} ms" for v, k in top))
    else:
        log(f"[5] ppcc tick + tick_stats: {tick_ms:.3f} ms wall; device "
            f"time not measured (profiler saw no device time)")

    # ---- kernels against their plain versions, off the counted path
    errs = {}

    def hold(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max_abs_err(got, want, torch)
        if err or not all(torch.equal(g, x) for g, x in zip(got, want)):
            fail(f"{name} differs from its plain version (max abs err "
                 f"{err})")
        errs[name] = max(errs.get(name, 0.0), err)

    conf = ("conflict_matrix", "conflict_fused", "conflict_fused_full")
    for name in conf:
        hold(name, getattr(kconf, name)(read, write),
             getattr(ref, f"{name}_ref")(read, write))
    # the admission inputs of tick 4 of each mode's drain
    full = kconf.conflict_fused_full(read, write)
    raw, wwm = full[0], full[1]
    raw_off = raw & ~torch.eye(n, dtype=torch.bool, device=dev)
    seq = S.degree_order(full)

    def pending_at(mode, k=4):
        v = torch.ones(n, dtype=torch.bool, device=dev)
        for r, _ in out[mode][0][:k]:
            v &= ~r.admitted
        return v

    v_p, v_2, v_o = (pending_at(m) for m in ("ppcc_degree", "2pl", "occ"))
    adm = {"ppcc_admit": (raw_off, v_p, seq), "twopl_admit": (raw, wwm, v_2),
           "occ_admit": (raw, wwm, v_o)}
    for name, args in adm.items():
        hold(name, getattr(kadm, name)(*args),
             getattr(ref, f"{name}_ref")(*args))
    log(f"[5] the six kernels bit-equal to their plain versions at full "
        f"width (admission inputs of tick 4: {int(v_p.sum())}, "
        f"{int(v_2.sum())}, {int(v_o.sum())} pending)")
    gen = torch.Generator().manual_seed(12)
    for en in SCHED_EDGE_N:
        for ew in SCHED_EDGE_W:
            bits = [torch.randint(-2 ** 31, 2 ** 31, (en, ew), generator=gen,
                                  dtype=torch.int64).to(torch.int32)
                    for _ in range(4)]
            er = (bits[0] & bits[1] & bits[2]).to(dev)
            ewr = er & bits[3].to(dev)
            for name in conf:
                hold(name, getattr(kconf, name)(er, ewr),
                     getattr(ref, f"{name}_ref")(er, ewr))
        if en == n:
            continue                  # the full width is held above
        erw, eww = W.ycsb_batch(n=en, d=max(64, 8 * en), seed=en)
        er = torch.from_numpy(erw.view(np.int32)).to(dev)
        ewr = torch.from_numpy(eww.view(np.int32)).to(dev)
        f7 = ref.conflict_fused_full_ref(er, ewr)
        ev = (torch.rand(en, generator=gen) < 0.9).to(dev)
        eseq = torch.randperm(en, generator=gen).to(torch.int32).to(dev)
        eoff = f7[0] & ~torch.eye(en, dtype=torch.bool, device=dev)
        hold("ppcc_admit", kadm.ppcc_admit(eoff, ev, eseq),
             ref.ppcc_admit_ref(eoff, ev, eseq))
        for name in ("twopl_admit", "occ_admit"):
            hold(name, getattr(kadm, name)(f7[0], f7[1], ev),
                 getattr(ref, f"{name}_ref")(f7[0], f7[1], ev))
    log(f"[5] and at the edge shapes N in {SCHED_EDGE_N}, W in "
        f"{SCHED_EDGE_W}: max abs err {max(errs.values())}")

    # ---- times at the full-width shape
    def library(name):
        """One PyTorch call's worth of the same function: the unpacked
        bits as bf16, a matmul with fp32 accumulation, then > 0 (exact:
        a count is at most W x 32 < 2^24)."""
        r = B.unpack(read, w * 32).to(torch.bfloat16)
        wb = B.unpack(write, w * 32).to(torch.bfloat16)
        raw_l = (r @ wb.T) > 0
        if name == "conflict_matrix":
            return raw_l
        ww_l = (wb @ wb.T) > 0
        rdeg = raw_l.sum(1, dtype=torch.int32)
        wdeg = ww_l.sum(1, dtype=torch.int32)
        if name == "conflict_fused":
            return raw_l, ww_l, rdeg, wdeg
        return (raw_l, ww_l, rdeg, raw_l.sum(0, dtype=torch.int32), wdeg,
                raw_l.diagonal().clone(), ww_l.diagonal().clone())

    rows, floors = [], {}
    for name in conf:
        lib_out, k_out = library(name), getattr(kconf, name)(read, write)
        if isinstance(k_out, tuple):
            same = all(torch.equal(a, b) for a, b in zip(lib_out, k_out))
        else:
            same = torch.equal(lib_out, k_out)
        if not same:
            fail(f"the library call for {name} disagrees with the kernel")
        del lib_out, k_out
        ms = cuda_ms(lambda: getattr(kconf, name)(read, write), 10)
        pms = cuda_ms(lambda: getattr(ref, f"{name}_ref")(read, write), 2)
        lms = cuda_ms(lambda: library(name), 5)
        relations = 1 if name == "conflict_matrix" else 2
        outs = {"conflict_matrix": n * n,
                "conflict_fused": 2 * n * n + 2 * 4 * n,
                "conflict_fused_full": 2 * n * n + 3 * 4 * n + 2 * n}[name]
        # one LOP3 (acc |= a & b) per word pair and relation: the bound of
        # this CUDA-core formulation
        b_ms, b_by = bound(2 * n * w * 4 + outs, relations * n * n * w)
        # the card's floor for the same function: a 0/1 int8 product per
        # relation on the tensor cores, 2 n^2 d operations, then > 0
        floors[name] = max((2 * n * w * 4 + outs) / HBM_BYTES_PER_S,
                           relations * 2 * n * n * 32 * w
                           / INT8_OPS_PER_S) * 1e3
        rows.append((name, "src/repro/kernels/conflict.py:" + {
            "conflict_matrix": "80 (_conflict_kernel, pallas_call at :91)",
            "conflict_fused": "134 (_conflict_fused_kernel, pallas_call at "
                              ":153)",
            "conflict_fused_full": "222 (_conflict_fused_full_kernel, "
                                   "pallas_call at :238)"}[name],
            "src/repro_torch/csrc/conflict.cu", ms, pms, b_ms, b_by, lms))
    for name, args in adm.items():
        ms = cuda_ms(lambda: getattr(kadm, name)(*args), 10)
        pms = cuda_ms(lambda: getattr(ref, f"{name}_ref")(*args), 1)
        if name == "ppcc_admit":   # raw, valid, seq in; flags, prec out
            nbytes, nops = n * n + 5 * n + 3 * n + n * n, 4 * n * n
        elif name == "twopl_admit":   # raw, ww, valid in; admitted out
            nbytes, nops = 2 * n * n + 2 * n, 3 * n * n
        else:                         # only j < i of raw and ww is needed
            nbytes, nops = n * (n - 1) + 2 * n, n * (n - 1)
        b_ms, b_by = bound(nbytes, nops)
        line = {"ppcc_admit": "173-191", "twopl_admit": "223-228",
                "occ_admit": "247-254"}[name]
        rows.append((name, f"src/repro/sched/scheduler.py:{line} (an XLA "
                     f"scan)", "src/repro_torch/csrc/admit.cu", ms, pms,
                     b_ms, b_by, None))
    table = []
    for name, repl, src, ms, pms, b_ms, b_by, lms in rows:
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": counts[name],
                      "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lms})
        if name in floors:
            table[-1]["tensor_core_floor_ms"] = floors[name]
        log(f"[5] {name}: {ms:.4f} ms (plain {pms:.4f} ms, bound "
            f"{b_ms:.5f} ms by {b_by}"
            + (f" of 32-bit logic, int8 tensor-core floor "
               f"{floors[name]:.5f} ms" if name in floors else "")
            + (f", library {lms:.4f} ms" if lms is not None else "")
            + f") at n={n}, W={w}; {counts[name]} launches on the path")
    return table


def lm_phase(torch, dev, smi, cuda_ms):
    """Phase 7: LM serving at full width.  Returns (the kernel-table rows
    of flash_attention and wkv_chunked, a function that takes the
    device's busy share of a decode and a prefill step, to run after
    every wall of the script)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import golden as G
    from repro_torch.launch import serve as srv
    from repro_torch.launch import steps
    from repro_torch.models import LM, convert

    gold = json.loads(LM_GOLDEN.read_text())
    tol = gold["tolerance"]
    if gold["run"] != {"seed": G.SEED, "batch": G.B, "prompt": G.S,
                       "steps": G.STEPS, "ids": G.N_IDS,
                       "layers": G.LAYERS}:
        fail(f"{LM_GOLDEN.name} was written for another run: {gold['run']}")
    t7 = time.perf_counter()

    # ---- (b) full width, 2 layers, float32, against the JAX golden
    for arch in LM_ARCHES:
        cfg = G.golden_config(arch)
        rec = gold["models"][arch]
        prompt, cont, ids = G.inputs(cfg)
        if ids.tolist() != rec["ids"] or hashlib.sha256(
                prompt.tobytes() + cont.tobytes()).hexdigest() != \
                rec["prompt_sha256"]:
            fail(f"[7] {arch}: the golden's tokens differ from this "
                 f"machine's draw")
        tree = convert.random_jax_tree(cfg, G.SEED)
        if convert.tree_sha256(tree) != rec["weights_sha256"]:
            fail(f"[7] {arch}: the seeded weights differ from the golden's "
                 f"(the numpy generator differs here)")
        lm = LM(cfg, device=dev)
        lm.load_state_dict(convert.params_from_jax(cfg, tree))
        del tree
        ops.reset_launches()
        got = G.port_run(lm, prompt, cont, ids)
        torch.cuda.synchronize()
        kernel = LM_KERNEL[cfg.family]
        launched = ops.launch_counts()[kernel]
        if launched != cfg.n_layers:
            fail(f"[7] {arch} golden run: {kernel} launched {launched} "
                 f"times, not once per layer of the prefill")
        worst = 0.0
        for key, val in got.items():
            want = np.asarray(rec[key])
            err = np.abs(val - want)
            bad = err > tol["atol"] + tol["rtol"] * np.abs(want)
            if bad.any():
                fail(f"[7] {arch} {key}: max abs err {err.max():.3g} beyond "
                     f"the golden's atol {tol['atol']}, rtol {tol['rtol']} "
                     f"at {int(bad.sum())} entries")
            worst = max(worst, float(err.max()))
        log(f"[7] {arch} at full width ({cfg.d_model} wide, vocab "
            f"{cfg.vocab}), {cfg.n_layers} layers, float32, seeded weights "
            f"(sha256 equal): prefill of {G.B} x {G.S} and {G.STEPS} decode "
            f"steps equal {LM_GOLDEN.name} at {G.N_IDS} ids and every "
            f"logsumexp, max abs err {worst:.3g} (atol {tol['atol']}, rtol "
            f"{tol['rtol']}; CPU port {tol['cpu_max_abs_err'][arch]:.3g})")
        del lm, got

    # ---- (c) full depth, bf16: the main path, counted
    lms, toks = {}, {}
    for arch in LM_ARCHES:
        cfg = configs.get(arch)
        gen = torch.Generator(dev).manual_seed(0)
        lms[arch] = LM(cfg, device=dev).init(gen)
        toks[arch] = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                   generator=gen, device=dev)
        n_par = sum(p.numel() for p in lms[arch].parameters())
        log(f"[7] {arch}: {cfg.n_layers} layers, d={cfg.d_model}, "
            f"{n_par / 1e9:.3f} G parameters in bf16 from a torch.Generator "
            f"on the card")
    captured = {}
    real = {"flash_attention": kflash.flash_attention,
            "wkv_chunked": kwkv.wkv_chunked}

    def spy(mod, name):
        def call(*args, **kw):
            if name not in captured:
                captured[name] = ([a.clone() for a in args], dict(kw))
            return real[name](*args, **kw)
        setattr(mod, name, call)

    spy(kflash, "flash_attention")
    spy(kwkv, "wkv_chunked")
    main_out = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    try:
        for arch in LM_ARCHES:
            logits = steps.make_prefill_step(lms[arch])({"tokens": toks[arch]})
            main_out[arch, "prefill"] = logits
            for policy in ("ppcc", "2pl", "occ"):
                main_out[arch, policy] = srv.serve(lms[arch], policy=policy)
        torch.cuda.synchronize()
    finally:
        kflash.flash_attention = real["flash_attention"]
        kwkv.wkv_chunked = real["wkv_chunked"]
    lm_counts = ops.launch_counts()
    want = {"flash_attention": configs.get("qwen3_0p6b").n_layers,
            "wkv_chunked": configs.get("rwkv6_3b").n_layers}
    got = {k: lm_counts[k] for k in want}
    if got != want:
        fail(f"[7] launches on the LM main path {got}, expected one per "
             f"layer of each prefill {want}")
    sched = {k: v for k, v in lm_counts.items() if v and k not in want}
    if not sched.get("conflict_fused") or not sched.get("ppcc_admit"):
        fail(f"[7] serve() launched no admission kernels: {sched}")
    log(f"[7] main path (one prefill of {PREFILL_B} x {PREFILL_S} per model, "
        f"serve() under ppcc, 2pl, occ per model): launches {got}, one per "
        f"layer; admission kernels {sched}")
    for arch in LM_ARCHES:
        lg = main_out[arch, "prefill"]
        if lg.shape != (PREFILL_B, configs.get(arch).vocab) or \
                not bool(torch.isfinite(lg.float()).all()):
            fail(f"[7] {arch} prefill logits {tuple(lg.shape)} not finite "
                 f"or of the wrong shape")
        for policy in ("ppcc", "2pl", "occ"):
            out = main_out[arch, policy]
            ref_s = gold["serve"]["policies"][policy]
            if (out["ticks"], out["tokens"]) != (ref_s["ticks"],
                                                 ref_s["tokens"]):
                fail(f"[7] {arch} serve({policy}): ticks {out['ticks']}, "
                     f"tokens {out['tokens']}; the reference's "
                     f"{ref_s['ticks']}, {ref_s['tokens']}")
        log(f"[7] {arch} serve() ticks and tokens equal the reference's "
            f"under every policy: " + ", ".join(
                f"{p} {main_out[arch, p]['ticks']}/"
                f"{main_out[arch, p]['tokens']} in "
                f"{main_out[arch, p]['wall']:.3f} s"
                for p in ("ppcc", "2pl", "occ")))

    # ---- walls: prefill, decode against prefill, serve
    walls, drift = {}, {}

    def decode_prompt(lm, prompt):
        """(last logits of decoding ``prompt`` token by token, seconds per
        step after the first)."""
        caches = lm.init_caches(prompt.shape[0], prompt.shape[1])
        with torch.inference_mode():
            lg, caches = lm.decode_step(caches, prompt[:, :1], 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(1, prompt.shape[1]):
                lg, caches = lm.decode_step(caches, prompt[:, i:i + 1], i)
            torch.cuda.synchronize()
        return lg.float(), (time.perf_counter() - t) / (prompt.shape[1] - 1)

    def against_prefill(lm, prompt):
        """(max |decode - prefill| of the last logits, the prefill's
        largest magnitude, at least 1)."""
        want_l = steps.make_prefill_step(lm)({"tokens": prompt}).float()
        got_l, sec = decode_prompt(lm, prompt)
        return (float((got_l - want_l).abs().max()),
                max(1.0, float(want_l.abs().max())), sec)

    for arch, lm in lms.items():
        prefill = steps.make_prefill_step(lm)
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill({"tokens": toks[arch]})
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t)
        walls[arch, "prefill"] = statistics.median(reps)
        n = DECODE_CHECK[arch]
        err, scale, walls[arch, "decode"] = against_prefill(
            lm, toks[arch][:, :n])
        drift[arch, "bf16"] = (err, scale)
        out = srv.serve(lm, policy="ppcc")
        walls[arch, "serve"] = out["wall"]
        log(f"[7] {arch}: prefill {PREFILL_B} x {PREFILL_S} in "
            f"{walls[arch, 'prefill'] * 1e3:.2f} ms "
            f"({PREFILL_B * PREFILL_S / walls[arch, 'prefill']:.0f} tokens/s); "
            f"decode {walls[arch, 'decode'] * 1e3:.3f} ms per step at batch "
            f"{PREFILL_B}; serve(ppcc) {out['tokens']} tokens in "
            f"{out['wall']:.3f} s ({out['tokens'] / out['wall']:.1f} "
            f"tokens/s) [{smi}]")
    # decode against prefill: the check in float32 (a float32 KV cache,
    # the bf16 weights widened), where it ties the kernels to the
    # recurrent decode; in bf16 the reference's own decode drifts from its
    # prefill beyond 3e-2 with depth (PERF.md, PR 14), so it is reported
    for arch, lm in lms.items():
        n = DECODE_CHECK[arch]
        cfg32 = lm.cfg.with_(param_dtype="float32", compute_dtype="float32",
                             cache_dtype="float32")
        lm32 = LM(cfg32, device=dev)
        lm32.load_state_dict(lm.state_dict())
        err, scale, _ = against_prefill(lm32, toks[arch][:, :n])
        del lm32
        torch.cuda.empty_cache()
        if not err <= 3e-2 * scale:
            fail(f"[7] {arch} float32: decode over {n} prompt tokens differs "
                 f"from the prefill's last logits by {err:.4g} > 3e-2 x "
                 f"{scale:.3g}")
        b_err, b_scale = drift[arch, "bf16"]
        log(f"[7] {arch} at full depth, decode over {n} prompt tokens "
            f"against the prefill's last logits: float32 {err:.4g} "
            f"(within 3e-2 x {scale:.3g}); bf16 {b_err:.4g} (largest logit "
            f"{b_scale:.3g}; reported, not held)")

    # ---- (a) kernels against their plain versions
    errs = {"flash_attention": 0.0, "wkv_chunked": 0.0}

    def hold(name, got, want, atol, rtol, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"[7] {name} at {what}: {g.dtype}{tuple(g.shape)} vs "
                     f"{w.dtype}{tuple(w.shape)}")
            d = (g.double() - w.double()).abs()
            if bool((d > atol + rtol * w.double().abs()).any()):
                fail(f"[7] {name} differs from its plain version at {what}: "
                     f"max abs err {float(d.max()):.4g}")
            errs[name] = max(errs[name], float(d.max()))

    fargs, fkw = captured["flash_attention"]
    wargs, wkw = captured["wkv_chunked"]
    hold("flash_attention", real["flash_attention"](*fargs, **fkw),
         ref.flash_attention_ref(*fargs, **fkw), 2e-2, 2e-2,
         "the qwen3 prefill's layer-0 inputs")
    hold("wkv_chunked", real["wkv_chunked"](*wargs, **wkw),
         ref.wkv_chunked_ref(*wargs, **wkw), 1e-4, 1e-3,
         "the rwkv6 prefill's layer-0 inputs")
    main_err = dict(errs)
    gen = torch.Generator().manual_seed(7)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for b, hq, hkv, sq, sk, d, dt, causal, window in FLASH_EDGES:
        q, k, v = (torch.randn((b, n_, h, d), generator=gen).to(dts[dt])
                   .to(dev).transpose(1, 2)
                   for h, n_ in ((hq, sq), (hkv, sk), (hkv, sk)))
        t_ = 2e-2 if dt == "bfloat16" else 1e-4
        hold("flash_attention",
             real["flash_attention"](q, k, v, causal=causal, window=window),
             ref.flash_attention_ref(q, k, v, causal=causal, window=window),
             t_, t_, f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} {dt} "
             f"causal={causal} window={window}")
    for c in WKV_EDGE_CHUNKS:
        for s_ in (c, 8 * c):
            for dt in ("bfloat16", "float32"):
                r, k, v = ((torch.randn((1, s_, 48, 64), generator=gen) * 0.5)
                           .to(dts[dt]).to(dev).transpose(1, 2)
                           for _ in range(3))
                lw = (-torch.exp(torch.randn((1, s_, 48, 64), generator=gen)
                                 * 0.5 - 2)).to(dev).transpose(1, 2)
                u = (torch.randn((48, 64), generator=gen) * 0.1).to(dev)
                hold("wkv_chunked",
                     real["wkv_chunked"](r, k, v, lw, u, chunk=c),
                     ref.wkv_chunked_ref(r, k, v, lw, u, chunk=c), 1e-4,
                     1e-3, f"H=48 S={s_} chunk={c} {dt}")
    log(f"[7] flash_attention within 2e-2 (bf16) / 1e-4 (float32) of its "
        f"plain version at the main-path inputs (max abs err "
        f"{main_err['flash_attention']:.4g}) and {len(FLASH_EDGES)} edge "
        f"shapes; wkv_chunked within atol 1e-4, rtol 1e-3 at the main-path "
        f"inputs ({main_err['wkv_chunked']:.4g}) and chunks "
        f"{WKV_EDGE_CHUNKS} x S in (chunk, 8 chunk) x (bf16, float32)")

    # ---- kernel times at the main-path shapes
    q, k, v = fargs
    b, hq, s_q, d = q.shape
    hkv = k.shape[1]
    ms_f = cuda_ms(lambda: real["flash_attention"](*fargs, **fkw), 20)
    plain_f = cuda_ms(lambda: ref.flash_attention_ref(*fargs, **fkw), 3)

    def library():
        try:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=hq != hkv)
        except TypeError:                 # a torch without enable_gqa
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    torch.testing.assert_close(library().float(),
                               real["flash_attention"](*fargs, **fkw).float(),
                               atol=2e-2, rtol=2e-2)
    lib_f = cuda_ms(library, 20)
    esz = q.element_size()
    f_bytes = (q.numel() * 2 + k.numel() + v.numel()) * esz
    f_flops = 4 * b * hq * (s_q * (s_q + 1) // 2) * d   # QK^T and PV, i >= j
    f_bound = max(f_bytes / HBM_BYTES_PER_S, f_flops / BF16_OPS_PER_S) * 1e3
    f_by = "bytes" if f_bytes / HBM_BYTES_PER_S >= \
        f_flops / BF16_OPS_PER_S else "operations"
    f_core = f_flops / F32_OPS_PER_S * 1e3
    r, k_, v_, lw, u = wargs
    bw, hw, sw, dw = r.shape
    chunk = wkw["chunk"]
    ms_w = cuda_ms(lambda: real["wkv_chunked"](*wargs, **wkw), 20)
    plain_w = cuda_ms(lambda: ref.wkv_chunked_ref(*wargs, **wkw), 3)
    w_bytes = (3 * r.numel() * r.element_size() + lw.numel() * 4
               + u.numel() * 4 + r.numel() * 4 + bw * hw * dw * dw * 4)
    per_chunk = 2 * chunk * (chunk - 1) * dw + 4 * chunk * dw * dw
    w_flops = bw * hw * (sw // chunk) * per_chunk
    w_bound = max(w_bytes / HBM_BYTES_PER_S, w_flops / F32_OPS_PER_S) * 1e3
    w_by = "bytes" if w_bytes / HBM_BYTES_PER_S >= \
        w_flops / F32_OPS_PER_S else "operations"
    log(f"[7] flash_attention at B={b} Hq={hq} Hkv={hkv} S={s_q} D={d} "
        f"{str(q.dtype)[6:]} causal: {ms_f:.4f} ms (plain {plain_f:.4f} ms, "
        f"SDPA {lib_f:.4f} ms; bound {f_bound:.5f} ms by {f_by}: "
        f"{f_bytes / 1e6:.1f} MB at 3.35 TB/s against {f_flops / 1e9:.2f} "
        f"GFLOP at the bf16 tensor-core 989 TFLOP/s; this float32 "
        f"CUDA-core formulation's floor {f_core:.4f} ms at 67 TFLOP/s) "
        f"[{smi}]")
    log(f"[7] wkv_chunked at B={bw} H={hw} S={sw} D={dw} chunk={chunk} "
        f"{str(r.dtype)[6:]} r/k/v: {ms_w:.4f} ms (plain {plain_w:.4f} ms; "
        f"bound {w_bound:.5f} ms by {w_by}: {w_bytes / 1e6:.1f} MB at 3.35 "
        f"TB/s against {w_flops / 1e9:.2f} GFLOP of float32 chunk products "
        f"at 67 TFLOP/s; library call: none) [{smi}]")
    rows = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83 "
                     "(flash_attention; _flash_kernel at :30, pallas_call "
                     "at :103)",
         "launches": lm_counts["flash_attention"],
         "max_abs_err": errs["flash_attention"], "ms": ms_f,
         "plain_ms": plain_f, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": lib_f, "cuda_core_floor_ms": f_core},
        {"name": "wkv_chunked", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv.cu",
         "replaces": "src/repro/kernels/wkv.py:72 (wkv_chunked; _wkv_kernel "
                     "at :27, pallas_call at :81)",
         "launches": lm_counts["wkv_chunked"],
         "max_abs_err": errs["wkv_chunked"], "ms": ms_w, "plain_ms": plain_w,
         "bound_ms": w_bound, "bound_by": w_by, "library_ms": None}]
    del captured, fargs, wargs, q, k, v, r, k_, v_, lw, u
    log(f"[7] phase 7 walls and checks in {time.perf_counter() - t7:.1f} s")

    def busy_shares():
        """Device kernel time of one decode and one prefill step from
        torch.profiler, over the walls taken above."""
        from torch.profiler import ProfilerActivity, profile
        for arch, lm in lms.items():
            n = DECODE_CHECK[arch]
            caches = lm.init_caches(PREFILL_B, n)
            tok = toks[arch][:, :1]
            prefill = steps.make_prefill_step(lm)
            for label, fn, reps in (
                    ("decode", lambda: lm.decode_step(caches, tok, n // 2), 4),
                    ("prefill", lambda: prefill({"tokens": toks[arch]}), 1)):
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    with torch.inference_mode():
                        for _ in range(reps):
                            fn()
                    torch.cuda.synchronize()
                events = prof.key_averages()
                dev_ms = sum(dev_time(e) for e in events) / reps / 1e3
                wall_ms = walls[arch, label] * 1e3
                top = sorted(((dev_time(e) / reps / 1e3, e.key)
                              for e in events if dev_time(e) > 0),
                             reverse=True)[:3]
                if dev_ms > 0:
                    log(f"[7] {arch} {label} step: {dev_ms:.3f} ms device "
                        f"kernel time (profiled) over {wall_ms:.3f} ms wall "
                        f"(unprofiled): device busy "
                        f"{100 * dev_ms / wall_ms:.1f}%; largest: " + ", ".join(
                            f"{k_[:40]} {v_:.3f} ms" for v_, k_ in top)
                        + f" [{smi}]")
                else:
                    log(f"[7] {arch} {label} step: device time not measured "
                        f"(profiler saw no device time)")

    return rows, busy_shares


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA GPU")
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.exists():
        fail("src/repro_torch is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import bitset as B
    from repro_torch.core import engine as E
    from repro_torch.core import ppcc as P
    from repro_torch.core import sweep
    from repro_torch.core.types import PAPER_PEAKS
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import megastep as kmega
    from repro_torch.kernels import scan as kscan
    from repro_torch.obs import metrics as M

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    t_start = time.perf_counter()
    log(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---------------- phase 1: build ----------------
    t = time.perf_counter()
    logs = build.build_all()
    log(f"[1] built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t:.2f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[1]   {name}: {line.strip()}")

    # ---------------- phase 2: kernels against their plain versions ------
    golden = json.loads(GOLDEN.read_text())
    figs, mpls, seeds = golden["figs"], golden["mpl_grid"], golden["seeds"]
    horizon = golden["horizon"]
    errs = {"megastep": 0.0, "rowslab": 0.0, "reserve_cohort": 0.0,
            "occ_validate": 0.0}

    defaults = {k: v.default for k, v in
                inspect.signature(sweep.run_grid).parameters.items()}
    for k in ("figs", "mpl_grid", "seeds", "protocols"):
        if list(defaults[k]) != list(golden[k]):
            fail(f"run_grid's default {k} {defaults[k]} is not the "
                 f"golden's {golden[k]}")
    if float(defaults["horizon"]) != horizon:
        fail(f"run_grid's default horizon is not the golden's {horizon}")
    golden3 = json.loads(PHASE3_GOLDEN.read_text())
    golden6 = json.loads(PHASE6_GOLDEN.read_text())
    for g_ in (PHASE3_GOLDEN, PHASE6_GOLDEN):
        for k in ("figs", "mpl_grid", "seeds", "protocols"):
            if json.loads(g_.read_text())[k] != golden[k]:
                fail(f"{g_.name}'s {k} is not {GOLDEN.name}'s")
    # main-path states, captured after CAPTURE_ITERS body iterations of
    # each protocol's batch of the default grid
    cover = sweep.grid_cover_params(figs).with_(horizon=horizon)
    fleet = sweep.Fleet(cover, n_slots=sweep.slot_bucket(max(mpls)),
                        device=dev)
    seed_l, mpl_l, rt_l = sweep.grid_lanes(figs, mpls, seeds, dev)
    captured = {}
    for proto in fleet.protocols:
        init, cond, step = fleet.parts[proto]
        s = init(seed_l, mpl_l, rt_l)
        for _ in range(CAPTURE_ITERS):
            s = sweep._select(cond(s), step(s), s)
        captured[proto] = (step.cfg, s)
    cfg_p, s_p = captured["ppcc"]
    margs = tuple(a.contiguous() for a in E.megastep_args(cfg_p, s_p))
    lanes, n, w = margs[0].shape
    log(f"[2] main-path shape: {lanes} lanes x n={n} x W={w}; "
        f"{int(margs[6].sum())} ready ops, {int(s_p.pstate.active.sum())} "
        f"active slots after {CAPTURE_ITERS} iterations")
    got = kmega.megastep(*margs)
    want = ref.megastep_ref(*margs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want, torch)
    if err or not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
        fail(f"megastep differs from megastep_ref at the main-path shape "
             f"(max abs err {err})")
    gen = torch.Generator().manual_seed(11)
    for en, ed in EDGE_SHAPES:
        args = random_megastep_inputs(3, en, ed, gen, torch, B, dev)
        g, w_ = kmega.megastep(*args), ref.megastep_ref(*args)
        torch.cuda.synchronize()
        e = max_abs_err(g, w_, torch)
        if e or not all(torch.equal(x, y) for x, y in zip(g, w_)):
            fail(f"megastep differs from megastep_ref at n={en}, d={ed}")
        errs["megastep"] = max(errs["megastep"], e)
    log(f"[2] megastep bit-equal to megastep_ref at the main-path shape and "
        f"at (n, d) = {EDGE_SHAPES}")

    # the row-slab kernel: the delta fleet's PPCC batch after the same
    # CAPTURE_ITERS iterations, and the launches of its next body
    dfleet = sweep.Fleet(cover, n_slots=fleet.n_slots, delta=True,
                         device=dev)
    dinit, dcond, dstep = dfleet.parts["ppcc"]
    s_d = dinit(seed_l, mpl_l, rt_l)
    for _ in range(CAPTURE_ITERS):
        s_d = sweep._select(dcond(s_d), dstep(s_d), s_d)
    for name, a, b in zip(E.EngState._fields, s_p, s_d):
        if name != "rel" and not all(torch.equal(x, y) for x, y in zip(
                *((a, b) if isinstance(a, tuple) else ((a,), (b,))))):
            fail(f"the delta fleet's {name} differs from the full-recompute "
                 f"fleet's after {CAPTURE_ITERS} iterations")
    chunks = -(-n // dstep.cfg.delta_k)
    slab_calls = capture_rowslab(lambda: dstep(s_d), kmega)
    if len(slab_calls) != chunks:
        fail(f"one delta body launched rowslab {len(slab_calls)} times, "
             f"not ceil(n/K) = {chunks}")
    sargs = slab_calls[0]
    k = sargs[7].shape[1]
    n_valid = sargs[8].sum(1)
    log(f"[2] delta fleet after {CAPTURE_ITERS} iterations: every leaf but "
        f"rel equals the full-recompute fleet's; its next body launches "
        f"rowslab {len(slab_calls)} times at K={k}, the first slab holding "
        f"{int(n_valid.sum())} dirty slots over {lanes} lanes (at most "
        f"{int(n_valid.max())} in a lane)")
    g, w_ = kmega.rowslab(*sargs), ref.rowslab_ref(*sargs)
    torch.cuda.synchronize()
    errs["rowslab"] = max_abs_err(g, w_, torch)
    if errs["rowslab"] or not all(torch.equal(x, y) for x, y in zip(g, w_)):
        fail("rowslab differs from rowslab_ref at the main-path shape")
    slab_edges = []
    for en, ed in SLAB_EDGE_N.items():
        for ek in sorted(set(SLAB_EDGE_K) | {en}):
            args = random_rowslab_inputs(en, ed, ek, gen, torch, B, dev)
            g, w_ = kmega.rowslab(*args), ref.rowslab_ref(*args)
            torch.cuda.synchronize()
            e = max_abs_err(g, w_, torch)
            if e or not all(torch.equal(x, y) for x, y in zip(g, w_)):
                fail(f"rowslab differs from rowslab_ref at n={en}, d={ed}, "
                     f"K={ek}")
            if any(x[1].any() for x in g):
                fail(f"rowslab: the all-invalid slab gave rows at n={en}")
            errs["rowslab"] = max(errs["rowslab"], e)
            slab_edges.append((en, ek))
    log(f"[2] rowslab bit-equal to rowslab_ref at the main-path shape and at "
        f"(n, K) = {slab_edges}, each with a random, an all-invalid and a "
        f"top-of-range slab")

    # reserve_cohort: the captured pools, random cohort requests
    C, K = s_p.cpu_free.shape[1], s_p.disk_free.shape[1]
    c = E._classify(cfg_p, s_p)
    rargs = (s_p.cpu_free, s_p.disk_free, c.te,
             (torch.rand((lanes, n), generator=gen) * 10 + 10).to(dev),
             (torch.rand((lanes, n), generator=gen) * 20 + 25).to(dev),
             (torch.rand((lanes, n), generator=gen) < 0.2).to(dev),
             (torch.rand((lanes, n), generator=gen) < 0.2).to(dev))
    rargs = tuple(a.contiguous() for a in rargs)
    g, w_ = kscan.reserve_cohort(*rargs), ref.reserve_cohort_ref(*rargs)
    torch.cuda.synchronize()
    errs["reserve_cohort"] = max_abs_err(g, w_, torch)
    if not all(torch.equal(x, y) for x, y in zip(g, w_)):
        fail(f"reserve_cohort differs from its plain version (max abs err "
             f"{errs['reserve_cohort']})")
    # occ_validate: the captured OCC words, random would-be committers
    _, s_o = captured["occ"]
    ps_o = s_o.pstate
    oargs = ((torch.rand((lanes, n), generator=gen) < 0.3).to(dev),
             ps_o.read_set, s_o.dirty, ps_o.write_set)
    oargs = tuple(a.contiguous() for a in oargs)
    g, w_ = kscan.occ_validate(*oargs), ref.occ_validate_ref(*oargs)
    torch.cuda.synchronize()
    errs["occ_validate"] = max_abs_err((g,), (w_,), torch)
    if not torch.equal(g, w_):
        fail("occ_validate differs from its plain version")
    log(f"[2] reserve_cohort ({lanes} lanes, n={n}, {C} CPUs, {K} disks) "
        f"and occ_validate ({int(oargs[0].sum())} would-be committers, "
        f"{int(s_o.dirty.ne(0).sum())} dirty words) bit-equal to their "
        f"plain versions")

    # ---------------- phase 3: the main path ----------------
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, grid_fleet = sweep.run_grid(horizon=golden3["horizon"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    body = grid_fleet.body_iters
    protocols = grid_fleet.protocols
    log(f"[3] run_grid(horizon={golden3['horizon']:g}): {len(figs)} figs x "
        f"{len(mpls)} MPLs x {len(seeds)} seeds = "
        f"{len(figs) * len(mpls) * len(seeds)} lanes per protocol, wall "
        f"{wall:.3f} s")
    log(f"[3] body iterations per batch {body}; kernel launches {counts}")
    lane_iters = check_lanes(out, protocols, golden3, "3", sweep)
    log(f"[3] every lane of {protocols} equals {PHASE3_GOLDEN.name} in "
        f"{sweep.METRICS + ('now',)}")
    if counts["megastep"] != body["ppcc"]:
        fail(f"megastep launched {counts['megastep']} times, PPCC ran "
             f"{body['ppcc']} body iterations")
    if counts["rowslab"]:
        fail(f"rowslab launched {counts['rowslab']} times without delta")
    if counts["occ_validate"] != body["occ"]:
        fail(f"occ_validate launched {counts['occ_validate']} times, OCC "
             f"ran {body['occ']} body iterations")
    want_res = sum(body.values()) + len(protocols)   # + one per init
    if counts["reserve_cohort"] != want_res:
        fail(f"reserve_cohort launched {counts['reserve_cohort']} times, "
             f"expected {want_res}")
    fin = grid_fleet.final["ppcc"].pstate
    inv = {name: bool(fn(fin).all()) for name, fn in (
        ("path_length_leq_one", P.path_length_leq_one),
        ("acyclic", P.acyclic), ("classes_consistent", P.classes_consistent))}
    if not all(inv.values()):
        fail(f"Theorem-1 invariants fail on the final PPCC states: {inv}")
    log(f"[3] launches match the body iterations; Theorem-1 invariants hold "
        f"on all final PPCC states {inv}")
    batch_lane_iters = sum(body.values()) * len(seed_l)
    log(f"[3] lane-iterations: {lane_iters} live ({lane_iters / wall:.1f}/s)"
        f", {batch_lane_iters} run on the batches "
        f"({batch_lane_iters / wall:.1f}/s)")
    log(f"[3] peak commits per figure at horizon {golden3['horizon']:g} "
        f"(mean over seeds, max over MPL) beside the paper's peaks at "
        f"100,000:")
    for f in figs:
        peaks = [int(out[f][pr]["commits"].mean(1).max()) for pr in protocols]
        log(f"[3]   fig {f:2d}: " + ", ".join(
            f"{pr} {pk} (paper {pp})" for pr, pk, pp in
            zip(protocols, peaks, PAPER_PEAKS[f])))
    del out, grid_fleet

    # ---------------- phase 6: the delta-maintained, instrumented fleet --
    # (run right after phase 3, before phase 4's profiler sessions, so that
    # the two grids' walls are taken alike)
    tm_gold = json.loads(TM_GOLDEN.read_text())
    for key in ("figs", "mpl_grid", "seeds", "horizon", "protocols"):
        if tm_gold[key] != golden6[key]:
            fail(f"{TM_GOLDEN.name}'s {key} is not {PHASE6_GOLDEN.name}'s")
    if tm_gold["run"] != TM_RUN:
        fail(f"{TM_GOLDEN.name} was written with {tm_gold['run']}")
    digest = sweep.lanes_sha256(seed_l, mpl_l, rt_l)
    if digest != tm_gold["lanes_sha256"]:
        fail("the grid's lane vectors differ from the telemetry golden's")
    import numpy as np
    edges = hashlib.sha256(np.asarray(M.EDGES, "<f4").tobytes()).hexdigest()
    if edges != tm_gold["edges_f32_sha256"]:
        fail("the histogram edges differ from the telemetry golden's")
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out6, fleet6 = sweep.run_grid(horizon=golden6["horizon"], **TM_RUN,
                                  device=dev)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t
    counts6 = ops.launch_counts()
    body6 = fleet6.body_iters
    log(f"[6] run_grid({', '.join(f'{k}={v}' for k, v in TM_RUN.items())}): "
        f"{len(seed_l)} lanes per protocol, horizon {golden6['horizon']:g}, "
        f"wall "
        f"{wall6:.3f} s; body iterations {body6}; kernel launches "
        f"{ {k: v for k, v in counts6.items() if v} }")
    lane_iters6 = check_lanes(out6, protocols, golden6, "6", sweep)
    log(f"[6] every lane of {protocols} equals {PHASE6_GOLDEN.name} in "
        f"{sweep.METRICS + ('now',)}")
    batch6 = sum(body6.values()) * len(seed_l)
    log(f"[6] lane-iterations: {lane_iters6} live "
        f"({lane_iters6 / wall6:.1f}/s), {batch6} run on the batches "
        f"({batch6 / wall6:.1f}/s; phase 3 without delta and telemetry: "
        f"{batch_lane_iters / wall:.1f}/s)")
    for proto in protocols:
        tm = {key: np.concatenate([out6[f][proto]["telemetry"][key]
                                   .reshape((-1,) + out6[f][proto]
                                            ["telemetry"][key].shape[2:])
                                   for f in figs])
              for key in sweep.TELEMETRY}
        want = tm_gold["lanes"][proto]
        for key in sweep.TELEMETRY[:-1]:             # all but the trace
            if tm[key].tolist() != want[key]:
                lane = next(i for i, (a, b) in enumerate(
                    zip(tm[key].tolist(), want[key])) if a != b)
                fail(f"[6] {proto} telemetry {key} of lane {lane} differs "
                     f"from the golden")
        shas = [hashlib.sha256(np.ascontiguousarray(x, "<f4").tobytes())
                .hexdigest() for x in tm["trace"]]
        if shas != want["trace_sha256"]:
            lane = next(i for i, (a, b) in enumerate(
                zip(shas, want["trace_sha256"])) if a != b)
            fail(f"[6] {proto} ring buffer of lane {lane} differs from the "
                 f"golden")
        mid = np.asarray(tm_gold["mid_trace"][proto], np.float32)
        if not np.array_equal(tm["trace"][tm_gold["mid_lane"]], mid):
            fail(f"[6] {proto} mid-lane ring buffer differs from the golden")
        summ = M.summarize(tm)
        log(f"[6] {proto}: every lane's histograms, cause counts and ring "
            f"buffer equal the golden; grid summary: {summ['commits']} "
            f"commits, latency {summ['commit_latency']}, aborts "
            f"{summ['abort_causes']}, blocks {summ['block_causes']}")
    chunks = -(-n // fleet6.parts["ppcc"][2].cfg.delta_k)
    want6 = {"megastep": 1, "rowslab": chunks * body6["ppcc"],
             "reserve_cohort": sum(body6.values()) + len(protocols),
             "occ_validate": body6["occ"]}
    got6 = {key: counts6[key] for key in want6}
    if got6 != want6:
        fail(f"[6] launches {got6}, expected {want6}")
    log(f"[6] launches {got6}: megastep once (the PPCC init's seeding of "
        f"the carried relations), rowslab {chunks} per PPCC body iteration")
    fin6 = fleet6.final["ppcc"]
    inv = {name: bool(fn(fin6.pstate).all()) for name, fn in (
        ("path_length_leq_one", P.path_length_leq_one),
        ("acyclic", P.acyclic), ("classes_consistent", P.classes_consistent))}
    if not all(inv.values()):
        fail(f"[6] Theorem-1 invariants fail on the final PPCC states: {inv}")
    c6 = E._classify(fleet6.parts["ppcc"][2].cfg, fin6)
    full = P.compute_relations(fin6.pstate, c6.cur_item, c6.cur_w)
    for name, a, b in zip(P.Relations._fields, fin6.rel, full):
        if not torch.equal(a, b):
            fail(f"[6] the carried {name} differs from a full recompute of "
                 f"the final state")
    log(f"[6] Theorem-1 invariants hold {inv}; every lane's carried "
        f"relations equal a full recompute of its final state and cursor")
    del out6, fleet6, fin6, full

    # ---------------- phase 7: LM serving (walls before any profiler) ----
    lm_rows, lm_busy = lm_phase(torch, dev, smi, lambda fn, reps: cuda_times(
        fn, reps, torch))

    # ---------------- phase 4: times ----------------
    torch.cuda.synchronize()
    mega_ms = cuda_times(lambda: kmega.megastep(*margs), 50, torch)
    mega_plain = cuda_times(lambda: ref.megastep_ref(*margs), 10, torch)
    slab_ms = cuda_times(lambda: kmega.rowslab(*sargs), 50, torch)
    slab_plain = cuda_times(lambda: ref.rowslab_ref(*sargs), 5, torch)
    res_ms = cuda_times(lambda: kscan.reserve_cohort(*rargs), 50, torch)
    res_plain = cuda_times(lambda: ref.reserve_cohort_ref(*rargs), 5, torch)
    occ_ms = cuda_times(lambda: kscan.occ_validate(*oargs), 50, torch)
    occ_plain = cuda_times(lambda: ref.occ_validate_ref(*oargs), 5, torch)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    logic_per_s = LOGIC_PER_SM_CLOCK * sms * max_sm_clock_hz()
    log(f"[4] logic rate {logic_per_s:.4g} results/s ({LOGIC_PER_SM_CLOCK} "
        f"per SM per clock x {sms} SMs x the max SM clock); memory "
        f"{HBM_BYTES_PER_S:.3g} B/s")

    def bound(nbytes, nops):
        """(ms, what bounds it): bytes at the memory rate against 32-bit
        logic and integer operations at the logic rate."""
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = nops / logic_per_s * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    # bytes: each input read once, each output written once
    m_bytes = (3 * lanes * n * w * 4 + lanes * n * 4 + 4 * lanes * n
               + 4 * lanes * n * n + lanes * n * 4 + 2 * lanes * n)
    pw = -(-n // 32)
    m_ops = lanes * n * n * (pw + w)      # one LOP3 (acc |= a & b) per pair
    # rowslab: words, op data and the slab; of the carried tables, the one
    # row (readers_at or writers_at) each non-slab slot's party needs, as
    # this run's slab holds them; four K x n outputs
    carried = int(((n - n_valid) * n).sum())
    s_bytes = (2 * lanes * n * w * 4 + lanes * n * 6 + lanes * k * 5
               + carried + 4 * lanes * k * n)
    s_ops = lanes * k * n * (pw + w)
    r_bytes = (2 * lanes * (C + K) * 4 + 3 * lanes * n * 4 + 2 * lanes * n
               + 2 * lanes * n * 4)
    r_ops = lanes * n * (C + K + 4)
    o_bytes = lanes * n + 3 * lanes * n * w * 4 + lanes * n
    o_ops = lanes * n * w * 3
    grid_rows = []
    for name, src, repl, ms, pms, (b_ms, b_by) in (
            ("megastep", "src/repro_torch/csrc/megastep.cu",
             "src/repro/kernels/megastep.py:38 (_megastep_kernel, "
             "pallas_call at :287)", mega_ms, mega_plain,
             bound(m_bytes, m_ops)),
            ("rowslab", "src/repro_torch/csrc/rowslab.cu",
             "src/repro/kernels/megastep.py:187 (rowslab; _rowslab_kernel "
             "at :118, pallas_call at :222)", slab_ms, slab_plain,
             bound(s_bytes, s_ops)),
            ("reserve_cohort", "src/repro_torch/csrc/scan.cu",
             "src/repro/core/jaxsim.py:666 (_reserve_cohort, an XLA scan)",
             res_ms, res_plain, bound(r_bytes, r_ops)),
            ("occ_validate", "src/repro_torch/csrc/scan.cu",
             "src/repro/core/jaxsim.py:938 (occ_validate_multi, an XLA "
             "scan)", occ_ms, occ_plain, bound(o_bytes, o_ops))):
        grid_rows.append({"name": name, "route": "cuda", "source": src,
                          "replaces": repl, "max_abs_err": errs[name],
                          "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": None})
        log(f"[4] {name}: {ms:.4f} ms (plain {pms:.4f} ms, bound {b_ms:.5f} "
            f"ms by {b_by}) at the main-path shape")
    log(f"[4] rowslab bound counts {s_bytes} B: {carried} B of carried rows "
        f"for the {lanes * n - int(n_valid.sum())} non-slab slots; library "
        f"call: none, no single PyTorch call computes it")

    # one batch iteration of each protocol from its captured state: the
    # kernels, the plain versions, telemetry on; PPCC with delta too
    plain = sweep.Fleet(cover, n_slots=fleet.n_slots, megakernel=False,
                        device=dev)
    tfleet = sweep.Fleet(cover, n_slots=fleet.n_slots, telemetry=True,
                         trace_every=8, trace_len=256, device=dev)
    dtfleet = sweep.Fleet(cover, n_slots=fleet.n_slots, **TM_RUN,
                          device=dev)

    def with_tm(st):
        return st._replace(tm=M.init_telemetry(lanes, n, 256, dev))

    iter_ms = {}
    for proto in fleet.protocols:
        st = captured[proto][1]
        runs = [("kernels", fleet, st), ("plain versions", plain, st),
                ("telemetry", tfleet, with_tm(st))]
        if proto == "ppcc":
            runs += [("delta", dfleet, s_d),
                     ("delta + telemetry", dtfleet, with_tm(s_d))]
        for label, fl, st0 in runs:
            _, cond, step = fl.parts[proto]
            iter_ms[proto, label] = iteration_ms(cond, step, st0, sweep,
                                                 torch)
        log(f"[4] {proto} batch iteration after {CAPTURE_ITERS}: " + ", ".join(
            f"{label} {iter_ms[proto, label]:.3f} ms" for label, _, _ in runs)
            + " (32 iters each)")

    # one PPCC batch iteration: host wall vs device kernel time, without
    # and with delta
    for label, fl, st0 in (("kernels", fleet, captured["ppcc"][1]),
                           ("delta", dfleet, s_d)):
        _, cond, step = fl.parts["ppcc"]
        dev_ms, kernels, top = profile_iteration(cond, step, st0, sweep,
                                                 torch)
        wall_ms = iter_ms["ppcc", label]
        if dev_ms > 0:
            log(f"[4] PPCC batch iteration ({label}): {dev_ms:.3f} ms device "
                f"kernel time ({kernels:.0f} kernels, profiled, 32 iters); "
                f"{wall_ms:.3f} ms wall unprofiled; device idle "
                f"{100 * (1 - dev_ms / wall_ms):.1f}% of the unprofiled "
                f"iteration; largest: " + ", ".join(
                    f"{k[:48]} {v:.3f} ms" for v, k in top))
        else:
            log(f"[4] PPCC batch iteration ({label}): {wall_ms:.3f} ms wall; "
                f"device time not measured (profiler saw no device time)")
    del captured, s_d, sargs, margs

    # ---------------- phase 5: the batch scheduler ----------------
    sched_rows = sched_phase(torch, dev, bound,
                             lambda fn, reps: cuda_times(fn, reps, torch))

    rows = []
    for row in grid_rows:
        src_counts = counts6 if row["name"] == "rowslab" else counts
        rows.append({**row, "launches": src_counts[row["name"]]})
    rows += sched_rows
    lm_busy()
    rows += lm_rows
    log(f"[done] all seven phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
