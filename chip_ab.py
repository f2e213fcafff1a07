#!/usr/bin/env python3
"""Time two checkouts of the PyTorch/CUDA port on one NVIDIA GPU, in turns.

Usage, from the root of a checkout:

    python3 chip_ab.py OLD_DIR NEW_DIR [--rounds N]

OLD_DIR and NEW_DIR are roots of two checkouts (for example the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists, and ``.``).  Each measurement runs in its own process that
imports only that checkout's ``src/`` and builds its kernels into that
checkout's ``build/kernels/``, in the order old, new, new, old (N rounds
of the pair, mirrored), so that a drift of the host or the card shows
as a difference between the two runs of one checkout.

Every metric is defined once, in the ``chip_smoke.py`` beside this
script, and both checkouts are measured with those same helpers: on the
paper grid's PPCC batch (run_grid's default lanes, n = 160 slots) after
200 body iterations, the wall of one batch iteration (median of 3
``iteration_ms`` windows) with the relations recomputed by the megastep
kernel and with delta-maintained relations; ``megastep`` and
``reserve_cohort`` alone by ``cuda_times`` (after a device sleep and back
to back) at the arguments the next non-delta PPCC body gives them
(captured with ``capture_calls``, the same in both checkouts, whose
kernels are bit-equal); for the non-delta iteration, from
``profile_iteration``, the device kernel time, the kernels and the two
kernels' device time; for the delta iteration, the launches counted by
the port's wrappers and, from ``profile_iteration``, the device kernel
time, the kernels and the row-slab kernels' time; on the
OCC batch after 200 body iterations, ``occ_validate`` alone by
``cuda_times`` (after a device sleep and back to back) at the arguments
the next OCC body gives it (captured with ``capture_calls``), and from
``profile_iteration`` the OCC iteration's device kernel time, kernels
and ``occ_validate``'s device time; on the scheduler's full-width YCSB
batch (n = 4,096, W = 1,024), ``ppcc_admit`` alone by ``cuda_times`` at
the inputs of tick 4 of the ``ppcc_degree`` drain
(``ppcc_admit_inputs``), ``conflict_fused`` and ``conflict_fused_full``
alone at the batch and ``conflict_fused`` at random sets of read density
1/8 (``random_words``), each by ``cuda_times`` after a device sleep and
back to back, and one ``ppcc`` tick with ``tick_stats``, its wall and its
device kernel time (``tick_times``); ``twopl_admit`` alone by
``cuda_times`` at the inputs of tick 4 of the ``2pl`` drain (after a
device sleep and back to back) and one ``2pl`` tick with ``tick_stats``,
its wall and device kernel time; ``occ_admit`` and one ``occ`` tick the
same way, at the inputs of tick 4 of the ``occ`` drain; ``admit_ops``
alone at both of ``chip_smoke.ADMIT_OPS_SHAPES`` (``sched_admit``: n = 256,
d = 1,024, m = 512; the scheduler's scale: n = 4,096, W = 1,024, m =
16,384), each state and list made by ``admit_ops_case`` from one seed, by
``cuda_times`` after a device sleep and back to back; the bf16 prefill
of qwen3-0.6b at full depth on 8 x 1,024 tokens (``median_wall_ms`` of
5, seeded random weights); flash_attention alone on random bf16 inputs
of its main-path shape (B = 8, H = 16, S = 1,024, D = 128, causal) by
``cuda_times``, after a device sleep and back to back; ``wkv_chunked``
alone on random inputs of the rwkv6-3b prefill's shape and layout (B =
8, H = 48, S = 1,024, D = 64, chunk 128, bf16 r/k/v as [B, H, S, D]
views of [B, S, H*D] tensors, log w = -exp(.), float32) the same way,
and the sha256 of its output and final state (the line before the card's
says whether every run of both checkouts gave the same bits);
the bf16 prefill of rwkv6-3b at full depth on 8 x 1,024 tokens;
``wkv_chunked_bwd`` alone at rwkv6-3b's training call (its inputs made by
``wkv_bwd_case`` from one seed, the forward's saved states from the
checkout's own forward) by ``cuda_times``, after a device sleep and back
to back, and the sha256 of its six outputs (the line before the card's
says whether each checkout gave the same bits in all its runs; two
checkouts may differ); the wall of one full-depth rwkv6-3b training step
on 8 x 1,024 tokens (as the qwen3 step below, median of 5 after 2
warm-ups) with its tokens/s and the device time of one profiled step,
freed before anything else runs; flash's
bf16 backward alone at qwen3-0.6b's training call (B = 8, Hq = Hkv = 16
after the model repeats its KV heads, S = 1,024, D = 128, causal), its
inputs made as phase 11 makes them, by ``cuda_times`` after a device
sleep and back to back; and the wall of one full-depth qwen3-0.6b
training step on 8 x 1,024 tokens (``launch.train.build``'s step on one
fixed batch, bf16 with float32 AdamW state, the median of 5 steps after
2 warm-up steps) with its tokens/s and the device time of one profiled
step.  Each run prints one JSON line;
the last lines are the card's name and power limit and a summary of
medians per checkout.  The script imports nothing of JAX and nothing of
the JAX package.
"""
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as smoke

CAPTURE_ITERS = 200


def measure(root: Path) -> dict:
    """One checkout's numbers on this process's card."""
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch import configs
    from repro_torch.core import engine as E
    from repro_torch.core import sweep
    from repro_torch.core import ppcc as P
    from repro_torch.kernels import admit as kadm
    from repro_torch.kernels import admit_ops as kao
    from repro_torch.kernels import conflict as kconf
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import megastep as kmega
    from repro_torch.kernels import ops
    from repro_torch.kernels import scan as kscan
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.data import pipeline
    from repro_torch.launch import steps, train
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeSpec
    from repro_torch.sched import workload as W

    dev = torch.device("cuda")
    out = {"dir": str(root)}
    defaults = {k: v.default for k, v in
                inspect.signature(sweep.run_grid).parameters.items()}
    figs, mpls, seeds = (defaults[k] for k in ("figs", "mpl_grid", "seeds"))
    cover = sweep.grid_cover_params(figs).with_(
        horizon=float(defaults["horizon"]))
    lanes = sweep.grid_lanes(figs, mpls, seeds, dev)
    n_slots = sweep.slot_bucket(max(mpls))

    states = {}
    for label, delta, proto in (("kernels", False, "ppcc"),
                                ("delta", True, "ppcc"),
                                ("occ", False, "occ")):
        fleet = sweep.Fleet(cover, n_slots=n_slots, delta=delta,
                            device=dev)
        init, cond, step = fleet.parts[proto]
        s = init(*lanes)
        for _ in range(CAPTURE_ITERS):
            s = sweep._select(cond(s), step(s), s)
        states[label] = (cond, step, s)
    for label in ("kernels", "delta"):
        cond, step, s = states[label]
        out[f"{label}_iter_ms"] = statistics.median(
            smoke.iteration_ms(cond, step, s, sweep, torch)
            for _ in range(3))
    # the two kernels alone, at the arguments of the next non-delta body
    cond, step, s = states["kernels"]
    margs = tuple(a.contiguous() for a in E.megastep_args(step.cfg, s))
    rargs = tuple(a.contiguous() for a in smoke.capture_calls(
        lambda: step(s), kscan, "reserve_cohort")[0])
    for name, fn in (("megastep", lambda: kmega.megastep(*margs)),
                     ("reserve_cohort",
                      lambda: kscan.reserve_cohort(*rargs))):
        out[f"{name}_ms"] = smoke.cuda_times(fn, 50, torch)
        out[f"{name}_ms_no_sleep"] = smoke.cuda_times(fn, 50, torch,
                                                      sleep=False)
    del margs, rargs
    dev_ms, kernels, per = smoke.profile_iteration(cond, step, s, sweep,
                                                   torch)
    out["kernels_device_ms"] = dev_ms
    out["kernels_kernels_per_iter"] = kernels
    for name in ("megastep", "reserve_cohort"):
        mine = [v for key, v in per.items() if f"{name}_kernel" in key]
        out[f"kernels_{name}_device_ms"] = sum(ms for ms, _ in mine)
        out[f"kernels_{name}_per_iter"] = sum(c for _, c in mine)
    cond, step, s = states["delta"]
    ops.reset_launches()
    sweep._select(cond(s), step(s), s)
    torch.cuda.synchronize()
    out["delta_launches_per_iter"] = {
        k: v for k, v in ops.launch_counts().items() if v}
    dev_ms, kernels, per = smoke.profile_iteration(cond, step, s, sweep,
                                                   torch)
    slab = [v for key, v in per.items() if "rowslab" in key]
    out["delta_device_ms"] = dev_ms
    out["delta_kernels_per_iter"] = kernels
    out["delta_rowslab_device_ms"] = sum(ms for ms, _ in slab)
    out["delta_rowslab_kernels_per_iter"] = sum(c for _, c in slab)
    # occ_validate at the arguments of the next OCC body, and the OCC
    # iteration's device time
    cond, step, s = states["occ"]
    oargs = tuple(a.contiguous() for a in smoke.capture_calls(
        lambda: step(s), kscan, "occ_validate")[0])
    out["occ_validate_ms"] = smoke.cuda_times(
        lambda: kscan.occ_validate(*oargs), 50, torch)
    out["occ_validate_ms_no_sleep"] = smoke.cuda_times(
        lambda: kscan.occ_validate(*oargs), 50, torch, sleep=False)
    del oargs
    dev_ms, kernels, per = smoke.profile_iteration(cond, step, s, sweep,
                                                   torch)
    mine = [v for key, v in per.items() if "occ_validate" in key]
    out["occ_device_ms"] = dev_ms
    out["occ_kernels_per_iter"] = kernels
    out["occ_occ_validate_device_ms"] = sum(ms for ms, _ in mine)
    del states, s

    # the scheduler at full width: ppcc_admit at tick 4 of the ppcc_degree
    # drain, and one ppcc tick with tick_stats
    rw, ww = W.ycsb_batch()
    read = torch.from_numpy(rw.view("int32")).to(dev)
    write = torch.from_numpy(ww.view("int32")).to(dev)
    steps4, _ = W.drain(read, write, "ppcc_degree", 4)
    aargs = smoke.ppcc_admit_inputs(
        read, write, smoke.pending_at(steps4, read.shape[0], dev, torch),
        torch)
    del steps4
    out["ppcc_admit_ms"] = smoke.cuda_times(
        lambda: kadm.ppcc_admit(*aargs), 10, torch)
    out["ppcc_admit_ms_no_sleep"] = smoke.cuda_times(
        lambda: kadm.ppcc_admit(*aargs), 10, torch, sleep=False)
    del aargs
    # the two fused conflict entries alone at the YCSB batch, and
    # conflict_fused at random sets of read density 1/8
    r8 = smoke.random_words(*read.shape, 8,
                            torch.Generator(dev).manual_seed(5), torch, dev)
    for key, name, words in (
            ("conflict_fused", "conflict_fused", (read, write)),
            ("conflict_fused_full", "conflict_fused_full", (read, write)),
            ("conflict_fused_r8", "conflict_fused", r8)):
        def fn():
            getattr(kconf, name)(*words)
        out[f"{key}_ms"] = smoke.cuda_times(fn, 10, torch)
        out[f"{key}_ms_no_sleep"] = smoke.cuda_times(fn, 10, torch,
                                                     sleep=False)
    del r8
    (out["ppcc_tick_wall_ms"], out["ppcc_tick_device_ms"],
     _) = smoke.tick_times(read, write, torch)
    # twopl_admit and occ_admit alone at the inputs of tick 4 of the 2pl
    # and occ drains, and one 2pl and one occ tick with tick_stats
    for key, mode in (("twopl", "2pl"), ("occ", "occ")):
        steps4, _ = W.drain(read, write, mode, 4)
        full = kconf.conflict_fused_full(read, write)
        targs = (full[0], full[1],
                 smoke.pending_at(steps4, read.shape[0], dev, torch))
        del steps4, full
        fn = getattr(kadm, f"{key}_admit")
        out[f"{key}_admit_ms"] = smoke.cuda_times(lambda: fn(*targs), 10,
                                                  torch)
        out[f"{key}_admit_ms_no_sleep"] = smoke.cuda_times(
            lambda: fn(*targs), 10, torch, sleep=False)
        del targs
        (out[f"{key}_tick_wall_ms"], out[f"{key}_tick_device_ms"],
         _) = smoke.tick_times(read, write, torch, mode)
    del read, write
    # admit_ops alone at both of chip_smoke's shapes (sched_admit and the
    # scheduler's scale), the states and lists from the same seed
    gen = torch.Generator().manual_seed(21)
    for label, n, d, m in smoke.ADMIT_OPS_SHAPES:
        s, o = smoke.admit_ops_case(label, n, d, m, gen, torch, P, dev)
        args = [t.contiguous() for t in (*s, *o)]
        key = "admit_ops_" + label.replace(" ", "_").replace("-", "")
        out[f"{key}_ms"] = smoke.cuda_times(lambda: kao.admit_ops(*args), 10,
                                            torch)
        out[f"{key}_ms_no_sleep"] = smoke.cuda_times(
            lambda: kao.admit_ops(*args), 10, torch, sleep=False)
        del s, o, args
    torch.cuda.empty_cache()

    cfg = configs.get("qwen3_0p6b")
    gen = torch.Generator(dev).manual_seed(0)
    lm = LM(cfg, device=dev).init(gen)
    tok = torch.randint(0, cfg.vocab, (8, 1024), generator=gen, device=dev)
    prefill = steps.make_prefill_step(lm)
    out["qwen3_prefill_ms"] = smoke.median_wall_ms(
        lambda: prefill({"tokens": tok}), 5, torch)
    del lm, prefill

    q, k, v = (torch.randn((8, 1024, 16, 128), generator=gen, device=dev)
               .bfloat16().transpose(1, 2) for _ in range(3))

    def flash():
        kflash.flash_attention(q, k, v, causal=True)
    out["flash_bf16_ms"] = smoke.cuda_times(flash, 20, torch)
    out["flash_bf16_ms_no_sleep"] = smoke.cuda_times(flash, 20, torch,
                                                     sleep=False)
    del q, k, v

    # wkv_chunked alone at the rwkv6-3b prefill's shape and layout, then
    # that prefill at full depth
    r, k, v = ((torch.randn((8, 1024, 48, 64), generator=gen, device=dev)
                * 0.5).bfloat16().transpose(1, 2) for _ in range(3))
    lw = (-torch.exp(torch.randn((8, 1024, 48, 64), generator=gen,
                                 device=dev) * 0.5 - 2)).transpose(1, 2)
    u = torch.randn((48, 64), generator=gen, device=dev) * 0.1

    def wkv():
        return kwkv.wkv_chunked(r, k, v, lw, u, chunk=128)
    # the prefill call's output and final state, to the bit
    out["wkv_out_sha256"] = hashlib.sha256(b"".join(
        x.cpu().numpy().tobytes() for x in wkv())).hexdigest()
    out["wkv_ms"] = smoke.cuda_times(wkv, 20, torch)
    out["wkv_ms_no_sleep"] = smoke.cuda_times(wkv, 20, torch, sleep=False)
    del r, k, v, lw, u
    cfg = configs.get("rwkv6_3b")
    lm = LM(cfg, device=dev).init(gen)
    tok = torch.randint(0, cfg.vocab, (8, 1024), generator=gen, device=dev)
    prefill = steps.make_prefill_step(lm)
    out["rwkv6_prefill_ms"] = smoke.median_wall_ms(
        lambda: prefill({"tokens": tok}), 5, torch)
    del lm, prefill, tok
    torch.cuda.empty_cache()

    # wkv_chunked_bwd alone at rwkv6-3b's training call, and the bits of
    # its six outputs
    bgen = torch.Generator(dev).manual_seed(28)
    shape = dict(smoke.WKV_BWD_SHAPES)["rwkv6-3b training"]
    r, k, v, lw, u, _, go, _ = smoke.wkv_bwd_case(shape, torch.bfloat16,
                                                  bgen, torch, dev)
    chunk = shape[4]
    states = kwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk,
                              return_states=True)[2]

    def wkv_bwd():
        return kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go, chunk=chunk)
    out["wkv_bwd_sha256"] = hashlib.sha256(b"".join(
        x.float().cpu().numpy().tobytes() for x in wkv_bwd())).hexdigest()
    out["wkv_bwd_ms"] = smoke.cuda_times(wkv_bwd, 20, torch)
    out["wkv_bwd_ms_no_sleep"] = smoke.cuda_times(wkv_bwd, 20, torch,
                                                  sleep=False)
    del r, k, v, lw, u, go, states
    torch.cuda.empty_cache()
    # one full-depth rwkv6-3b training step on 8 x 1,024 tokens
    out.update(train_step("rwkv6_3b", "rwkv_train", torch, dev, pipeline,
                          train, configs, ShapeSpec))

    # flash's bf16 backward alone at qwen3-0.6b's training call, its inputs
    # made as phase 11 makes them
    b, hq, hkv, sq, sk, d, causal, window = dict(smoke.BWD_SHAPES)[
        "qwen3-0.6b training"]
    bgen = torch.Generator(dev).manual_seed(24)

    def rnd(h, n):
        return torch.randn((b, n, h, d), generator=bgen, device=dev,
                           dtype=torch.float32).bfloat16().transpose(1, 2)
    q, k, v, dout = rnd(hq, sq), rnd(hkv, sk), rnd(hkv, sk), rnd(hq, sq)
    kw = dict(causal=causal, window=window)
    o, lse = kflash.flash_attention(q, k, v, return_lse=True, **kw)

    def bwd():
        kflash.flash_attention_bwd(q, k, v, o, lse, dout, **kw)
    out["flash_bwd_bf16_ms"] = smoke.cuda_times(bwd, 20, torch)
    out["flash_bwd_bf16_ms_no_sleep"] = smoke.cuda_times(bwd, 20, torch,
                                                         sleep=False)
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()

    # one full-depth qwen3-0.6b training step on 8 x 1,024 tokens
    out.update(train_step("qwen3_0p6b", "train", torch, dev, pipeline, train,
                          configs, ShapeSpec))
    return out


def train_step(arch, key, torch, dev, pipeline, train, configs, ShapeSpec):
    """The wall of one full-depth training step of ``arch`` on 8 x 1,024
    tokens (``launch.train.build``'s step on one fixed batch, bf16 with
    float32 AdamW state): ``{key}_step_ms`` (the median of 5 steps after 2
    warm-up steps), ``{key}_tokens_per_s``, ``{key}_step_walls_ms`` and
    ``{key}_step_device_ms``, the device kernel time of one more step
    under torch.profiler (0 where the profiler saw none); everything it
    made is freed."""
    cfg = configs.get(arch)
    loop, _ = train.build(cfg, batch=smoke.TRAIN_B, seq=smoke.TRAIN_S,
                          lr=1e-3, steps=smoke.TRAIN_STEPS, device=dev,
                          ckpt_every=0)
    batch = pipeline.to_device(pipeline.SyntheticLM(
        cfg, ShapeSpec("cli", smoke.TRAIN_S, smoke.TRAIN_B, "train"),
        seed=0).host_batch(step=0), dev)
    state = list(loop.init_state()[:2])
    for _ in range(2):
        state[:] = loop.train_step(*state, batch)[:2]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[:] = loop.train_step(*state, batch)[:2]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev_ms = smoke.device_profile(lambda: loop.train_step(*state, batch), 1,
                                  torch)[0]
    del loop, batch, state
    torch.cuda.empty_cache()
    ms = statistics.median(walls)
    return {f"{key}_step_ms": ms,
            f"{key}_tokens_per_s": smoke.TRAIN_B * smoke.TRAIN_S / ms * 1e3,
            f"{key}_step_walls_ms": walls, f"{key}_step_device_ms": dev_ms}


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        import torch
        if not torch.cuda.is_available():
            print("FAIL: no CUDA GPU", flush=True)
            sys.exit(1)
        print(json.dumps(measure(Path(args[1]).resolve())), flush=True)
        return
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 2:
        print(__doc__)
        sys.exit(2)
    roots = [Path(a).resolve() for a in args]
    for r in roots:
        if not (r / "src" / "repro_torch").is_dir():
            print(f"FAIL: {r} holds no src/repro_torch")
            sys.exit(1)
    order = [0, 1, 1, 0] * rounds
    results = {0: [], 1: []}
    for which in order:
        proc = subprocess.run([sys.executable, __file__, "--measure",
                               str(roots[which])], capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(f"FAIL: the measurement of {roots[which]} exited "
                  f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                  f"{proc.stderr[-4000:]}", flush=True)
            sys.exit(1)
        print(lines[-1], flush=True)
        results[which].append(json.loads(lines[-1]))
    digests = {str(roots[w]): sorted({r["wkv_out_sha256"] for r in
                                      results[w]}) for w in (0, 1)}
    bwd = {str(roots[w]): sorted({r["wkv_bwd_sha256"] for r in results[w]})
           for w in (0, 1)}
    print(json.dumps({"wkv_out_sha256": digests, "bit_equal": len(
        {d for ds in digests.values() for d in ds}) == 1,
        "wkv_bwd_sha256": bwd, "wkv_bwd_bit_equal_within_each": all(
            len(ds) == 1 for ds in bwd.values())}), flush=True)
    print(smoke.smi_line(), flush=True)
    keys = [k for k, v in results[0][0].items()
            if isinstance(v, float) and k in results[1][0]]
    print(json.dumps({str(roots[w]): {k: statistics.median(
        r[k] for r in results[w]) for k in keys} for w in (0, 1)}),
        flush=True)


if __name__ == "__main__":
    main()
