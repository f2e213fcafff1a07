#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. identify the card (nvidia-smi) and build the CUDA kernels from
     src/repro_torch/csrc, one nvcc per source, in parallel;
  2. hold each kernel bit-equal to its plain PyTorch version on the card:
     the cohort-step megakernel at the main path's shape (168 lanes,
     n = 160, W = 16, inputs captured mid-run) and at tile-edge shapes, and
     both scan kernels at the main path's shape;
  3. the main path: repro_torch.core.sweep.run_grid() with its defaults —
     Figs. 5-16 x 7 MPLs x 2 seeds = 168 lanes per protocol, n = 160 slots,
     500 items, horizon 20,000, PPCC / 2PL / OCC — with every lane's
     metrics equal to the JAX reference's committed golden, the megastep
     launch count equal to the PPCC body iterations, and the Theorem-1
     invariants on the final PPCC states;
  4. kernel times (medians over CUDA events) beside their bounds and
     their plain versions; one batch iteration of each protocol with the
     kernels and with the plain versions; and the device-busy share of a
     PPCC batch iteration: device kernel time from torch.profiler over
     the unprofiled iteration time;
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
     kernel's 32-bit-logic formulation.

The last lines are the kernel table as one JSON object, the card's name
and power limit, and {"ok": true, "device": {...}}.  The script imports
nothing of JAX and nothing of the JAX package.
"""
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
SCHED_GOLDEN = SRC / "repro_torch" / "golden" / "sched_n4096_w1024.json"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 tensor cores (data sheet)
# 32-bit integer and logic results per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput)
LOGIC_PER_SM_CLOCK = 64
SCHED_EDGE_N = (1, 33, 255, 300, 4096)
SCHED_EDGE_W = (1, 3, 1024)
EDGE_SHAPES = [(12, 30), (33, 100), (7, 31), (40, 64), (160, 500)]
CAPTURE_ITERS = 200              # body iterations before capturing inputs


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
    """Device microseconds of one torch.profiler key-average entry."""
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

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
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
    errs = {"megastep": 0.0, "reserve_cohort": 0.0, "occ_validate": 0.0}

    defaults = {k: v.default for k, v in
                inspect.signature(sweep.run_grid).parameters.items()}
    for k in ("figs", "mpl_grid", "seeds", "protocols"):
        if list(defaults[k]) != list(golden[k]):
            fail(f"run_grid's default {k} {defaults[k]} is not the "
                 f"golden's {golden[k]}")
    if float(defaults["horizon"]) != horizon:
        fail(f"run_grid's default horizon is not the golden's {horizon}")
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
    out, grid_fleet = sweep.run_grid(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    body = grid_fleet.body_iters
    protocols = grid_fleet.protocols
    log(f"[3] run_grid(): {len(figs)} figs x {len(mpls)} MPLs x "
        f"{len(seeds)} seeds = {len(figs) * len(mpls) * len(seeds)} lanes "
        f"per protocol, horizon {horizon:g}, wall {wall:.3f} s")
    log(f"[3] body iterations per batch {body}; kernel launches {counts}")

    mismatch = None
    lane_iters = 0
    for proto in protocols:
        for metric in sweep.METRICS + ("now",):
            mine = [v for f in figs
                    for v in out[f][proto][metric].reshape(-1).tolist()]
            ref_v = golden["lanes"][proto][metric]
            if metric == "iters":
                lane_iters += sum(mine)
            for lane, (a, b) in enumerate(zip(mine, ref_v)):
                if a != b and mismatch is None:
                    mismatch = (proto, metric, lane, a, b)
            if len(mine) != len(ref_v):
                fail(f"{proto}.{metric}: {len(mine)} lanes, golden has "
                     f"{len(ref_v)}")
    if mismatch:
        proto, metric, lane, a, b = mismatch
        m_s = len(mpls) * len(seeds)
        where = (f"fig {figs[lane // m_s]}, MPL {mpls[lane % m_s // len(seeds)]}"
                 f", seed {seeds[lane % len(seeds)]}")
        log(f"[3] lane {lane} ({where}) {proto}: first differing metric "
            f"{metric}: card {a}, golden {b}")
        plain, _ = sweep.run_grid(protocols=(proto,), megakernel=False,
                                  device=dev)
        pv = [v for f in figs
              for v in plain[f][proto][metric].reshape(-1).tolist()][lane]
        log(f"[3] plain versions on the card give {pv} "
            f"({'the same difference' if pv == a else 'no such difference' if pv == b else 'another value'})")
        fail("the card's run differs from the JAX reference's golden")
    log(f"[3] every lane of {protocols} equals the golden in "
        f"{sweep.METRICS + ('now',)}")
    if counts["megastep"] != body["ppcc"]:
        fail(f"megastep launched {counts['megastep']} times, PPCC ran "
             f"{body['ppcc']} body iterations")
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
    log("[3] peak commits per figure at horizon 20,000 (mean over seeds, "
        "max over MPL) beside the paper's peaks at 100,000:")
    for f in figs:
        peaks = [int(out[f][pr]["commits"].mean(1).max()) for pr in protocols]
        log(f"[3]   fig {f:2d}: " + ", ".join(
            f"{pr} {pk} (paper {pp})" for pr, pk, pp in
            zip(protocols, peaks, PAPER_PEAKS[f])))

    # ---------------- phase 4: times ----------------
    torch.cuda.synchronize()
    mega_ms = cuda_times(lambda: kmega.megastep(*margs), 50, torch)
    mega_plain = cuda_times(lambda: ref.megastep_ref(*margs), 10, torch)
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
    r_bytes = (2 * lanes * (C + K) * 4 + 3 * lanes * n * 4 + 2 * lanes * n
               + 2 * lanes * n * 4)
    r_ops = lanes * n * (C + K + 4)
    o_bytes = lanes * n + 3 * lanes * n * w * 4 + lanes * n
    o_ops = lanes * n * w * 3
    rows = []
    for name, src, repl, ms, pms, (b_ms, b_by) in (
            ("megastep", "src/repro_torch/csrc/megastep.cu",
             "src/repro/kernels/megastep.py:38 (_megastep_kernel, "
             "pallas_call at :287)", mega_ms, mega_plain,
             bound(m_bytes, m_ops)),
            ("reserve_cohort", "src/repro_torch/csrc/scan.cu",
             "src/repro/core/jaxsim.py:666 (_reserve_cohort, an XLA scan)",
             res_ms, res_plain, bound(r_bytes, r_ops)),
            ("occ_validate", "src/repro_torch/csrc/scan.cu",
             "src/repro/core/jaxsim.py:938 (occ_validate_multi, an XLA "
             "scan)", occ_ms, occ_plain, bound(o_bytes, o_ops))):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": counts[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        log(f"[4] {name}: {ms:.4f} ms (plain {pms:.4f} ms, bound {b_ms:.5f} "
            f"ms by {b_by}) at the main-path shape, {counts[name]} launches")

    # one batch iteration of each protocol from its captured state: the
    # kernels against the plain versions on the card
    plain = sweep.Fleet(cover, n_slots=fleet.n_slots, megakernel=False,
                        device=dev)
    iter_ms = {}
    for proto in fleet.protocols:
        per = []
        for fl in (fleet, plain):
            _, cond, step = fl.parts[proto]
            s = captured[proto][1]
            s = sweep._select(cond(s), step(s), s)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(32):
                s = sweep._select(cond(s), step(s), s)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t) / 32 * 1e3)
        iter_ms[proto] = per[0]
        log(f"[4] {proto} batch iteration after {CAPTURE_ITERS}: kernels "
            f"{per[0]:.3f} ms, plain versions {per[1]:.3f} ms (32 iters)")

    # one PPCC batch iteration: host wall vs device kernel time
    init, cond, step = fleet.parts["ppcc"]
    s = captured["ppcc"][1]
    for _ in range(4):
        s = sweep._select(cond(s), step(s), s)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(32):
            s = sweep._select(cond(s), step(s), s)
        torch.cuda.synchronize()
        it_wall = (time.perf_counter() - t) / 32
    events = prof.key_averages()
    dev_us = sum(dev_time(e) for e in events) / 32
    launches = sum(e.count for e in events if dev_time(e) > 0) / 32
    if dev_us > 0:
        # the profiler slows the host, so the idle share is taken against
        # the unprofiled iteration time measured above
        log(f"[4] PPCC batch iteration: {dev_us / 1e3:.3f} ms device kernel "
            f"time ({launches:.0f} kernels, profiled, 32 iters); "
            f"{iter_ms['ppcc']:.3f} ms wall unprofiled, {it_wall * 1e3:.3f} "
            f"ms profiled; device idle "
            f"{100 * (1 - dev_us / 1e3 / iter_ms['ppcc']):.1f}% of the "
            f"unprofiled iteration")
    else:
        log(f"[4] PPCC batch iteration: {it_wall * 1e3:.3f} ms wall; device "
            f"time not measured (profiler saw no device time)")

    # ---------------- phase 5: the batch scheduler ----------------
    rows += sched_phase(torch, dev, bound,
                        lambda fn, reps: cuda_times(fn, reps, torch))

    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
