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
  4. kernel times (medians over CUDA events) beside their byte bounds and
     their plain versions; one batch iteration of each protocol with the
     kernels and with the plain versions; and the device-busy share of
     PPCC batch iterations from torch.profiler.

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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM 32-bit rate outside tensor cores
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

    def bound(nbytes, nops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = nops / FP32_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    # bytes: each input read once, each output written once
    m_bytes = (3 * lanes * n * w * 4 + lanes * n * 4 + 4 * lanes * n
               + 4 * lanes * n * n + lanes * n * 4 + 2 * lanes * n)
    pw = -(-n // 32)
    m_ops = lanes * n * n * 2 * (pw + w)          # AND + OR per word pair
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
    def dev_time(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    dev_us = sum(dev_time(e) for e in events) / 32
    launches = sum(e.count for e in events if dev_time(e) > 0) / 32
    if dev_us > 0:
        log(f"[4] PPCC batch iteration: {it_wall * 1e3:.3f} ms wall, "
            f"{dev_us / 1e3:.3f} ms device kernel time "
            f"({launches:.0f} kernels), device idle "
            f"{100 * (1 - dev_us / 1e6 / it_wall):.1f}% (profiled, 32 iters)")
    else:
        log(f"[4] PPCC batch iteration: {it_wall * 1e3:.3f} ms wall; device "
            f"time not measured (profiler saw no device time)")

    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
