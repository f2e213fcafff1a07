#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. identify the card (nvidia-smi) and build the CUDA kernels from
     src/repro_torch/csrc, one nvcc per source, in parallel;
  2. hold each kernel bit-equal to its plain PyTorch version on the card:
     the cohort-step megakernel at the main path's shape (168 lanes,
     n = 160, W = 16, inputs captured mid-run) and at edge shapes (tile
     edges, n at its row block of 96 less one, at it and plus one, n off
     the 16-byte stores, three CTAs a lane), the
     row-slab drain at the delta fleet's shape (its inputs captured
     mid-run) and at edge shapes (n in {1, 14, 33, 160, 300}, lanes with no
     dirty slot, one, all n and random masks, tables off a 4-byte
     boundary), the row-slab slab entry at the delta fleet's shape (the
     captured dirty slots as a slab of K = 40) and at edge shapes (K in
     {1, 4, 40, n}, an all-invalid slab, slab ids at the top of the range),
     reserve_cohort at the arguments of a PPCC body captured mid-run and
     at random requests, and at edges (pools all 0, INF tails, all or no
     slots masked, one server a pool, 40 CPUs and 70 disks, n = 77), and
     occ_validate at the arguments of an OCC body captured mid-run, at
     random would-be committers (30% of the slots) and at edges (no
     committer, all, one lane, W = 1, 3, 303 and 384, n = 77);
  3. the main path: repro_torch.core.sweep.run_grid() with its defaults but
     the horizon — Figs. 5-16 x 7 MPLs x 2 seeds = 168 lanes per protocol,
     n = 160 slots, 500 items, PPCC / 2PL / OCC, to horizon 5,000 (phase 6
     runs the same grid with delta and telemetry) — with every lane's
     metrics
     equal to the JAX reference's committed golden
     src/repro_torch/golden/run_grid_h5000.json, the megastep launch count
     equal to the PPCC body iterations, and the Theorem-1 invariants on the
     final PPCC states;
  4. kernel times (medians over CUDA-event pairs, each after a 1 ms
     device sleep that hides the host's dispatch; each row also gives the
     pairs back to back, ms_no_sleep, the way earlier versions of this
     script took every time) beside their bounds and their plain versions, the row-slab
     drain's bound from the bytes the captured dirty masks make it move,
     and beside reserve_cohort's and occ_validate's byte bounds the bound
     of the longest chain of dependent steps their captured inputs make
     (each timed at both input sets);
     one batch iteration of each protocol with the kernels, with the
     plain versions and with telemetry on, and of PPCC with
     delta-maintained relations (with and without telemetry); and the
     device-busy share of a PPCC batch iteration, without and with delta,
     and of an OCC batch iteration: device kernel time from
     torch.profiler over the unprofiled iteration time, with the row-slab
     kernels' share of the delta iteration and occ_validate's of OCC's;
  5. the batch scheduler at full width (repro_torch.sched): n = 4,096
     pending YCSB transactions over 32,768 pages (W = 1,024 words), the
     input digest checked against the JAX golden
     src/repro_torch/golden/sched_n4096_w1024.json; 8 ticks of the drain
     loop (tick -> tick_stats -> pending &= ~admitted) in four modes
     (ppcc, ppcc by degree with the carry threaded and one carry repeat,
     2pl, occ) and txstore.apply_tick per policy, every result equal to
     the golden; the conflict and admission launches equal to the ticks
     that reach them; the device's share of a ppcc, a 2pl and an occ tick
     from torch.profiler; the three conflict entry points and the three
     admission scans bit-equal to their plain versions at inputs
     captured mid-drain and at edge shapes, the two fused conflict
     entries also on the route the card chooses and on each route forced
     (gather, dense) at the YCSB batch, random sets of read density 1/8
     and 1/2, three edge batches (every other row empty, a row holding
     every page, a page written by all) and both sides of the route
     switch, the three admission scans also on both sides of their switch
     from four warps to a CTA of 512 threads (n = 16,384 and 16,385),
     twopl_admit and occ_admit also at serve()'s n = 64; their times
     beside their bounds (the fused conflict entries' the byte bound,
     with the dense route's 32-bit-logic bound and int8 tensor-core floor
     beside it, their times also at density 1/8 and 1/2 and a sweep of
     both routes over density; the scans' also beside the bound of their
     chain of dependent steps through the admitted transactions), the
     device kernels per call of the fused conflict entries and the three
     admission scans (twopl_admit's and occ_admit's pack and scan apart),
     their plain versions and, for the conflict kernels, one library call
     (a bf16 matmul of the unpacked bits);
  6. the delta-maintained, instrumented fleet: run_grid(delta=True,
     telemetry=True, trace_every=8, trace_len=256) at run_grid's defaults
     but the horizon (5,000, phase 3's; 10,000 until phase 12 needed the
     time), with every lane's metrics equal to the JAX reference's golden
     src/repro_torch/golden/run_grid_h5000.json, every lane's telemetry
     (histograms, cause counts, ring buffer) equal to the JAX reference's
     src/repro_torch/golden/telemetry_h5000.json, the
     megastep launched once (the init's seeding of the relations) and the
     row-slab drain once per PPCC body iteration, the Theorem-1
     invariants on the final PPCC states, and every lane's carried
     relations equal to a full recompute of its final state;
  7. LM serving: the full-width float32 golden (flash on its CUDA-core
     route), the full-depth bf16 prefill of qwen3-0.6b (flash on its
     tensor-core route, one launch per layer) and rwkv6-3b, decode
     against prefill, serve() under each policy; flash and wkv held to
     their plain versions at the main-path inputs and at edge shapes (wkv
     at D = 16, 32 and 64, both dtypes, with and without an initial
     state); wkv's time beside its CUDA-core and its tensor-core bound,
     and its device kernels per call;
  8. the engine's other modes and the batch admission: the multipass PPCC
     chain (run_grid(fused=False), phase 3's lanes to horizon 1,000, cut
     from 5,000 for phase 13, against the JAX golden
     src/repro_torch/golden/run_grid_h1000.json, no megastep launch,
     reserve_cohort once per body iteration); the one-event
     engine (simulate_sweep(step_mode="event"), 8 seeds as lanes, Fig. 6's
     setting at MPL 25 to horizon 550, cut from 3,000 for the time) and
     simulate() (the same setting to horizon 1,000, cohort mode), each
     protocol, against the JAX goldens
     src/repro_torch/golden/event_h550.json and simulate_h1000.json; the
     admit_ops kernel bit-equal to its plain
     version at the sched_admit shape (n = 256, d = 1,024, m = 512), at
     the scheduler's scale (n = 4,096, W = 1,024, m = 16,384) and at the
     edges (dense arcs, every slot locked, runs on one txn or item, items
     31-33, n = 1, 31, 32, 33, both sides of the shared route's switch,
     n = 32,769, W = 1), admit_ops_blocked in index and degree order against
     admit_ops, its times beside its chain and byte bounds;
     wc_acquire_many(exact=True) through one twopl_admit launch per lane
     at the grid's shape; the device time of one multipass iteration and
     of one event;
  9. the int8 and sliding-window KV caches and the hybrid family: the
     golden's yi-34b (int8 cache, 2 layers) and zamba2-1.2b (13 layers,
     window cut to 64) against lm_full_width.json; zamba2-1.2b at its
     published width and depth (prefill 4 x 8,192, flash with window
     4,096 on its tensor cores, 6 launches) and yi-34b at its width with
     16 of its 60 layers and its int8 cache (LM.prefill 8 x 1,024, 16
     launches), bf16: the main path counted, serve() under each policy
     against the reference's summaries, decode against prefill (held in
     float32, bf16 reported), zamba2's 64-slot ring against a 96-slot
     linear cache, flash against its plain version at both prefills'
     layer-0 inputs with its time, bound and SDPA time; the busy shares
     and what the Mamba2 chunk scan, the Mamba2 decode and the int8
     dequant cost a step;
 10. the moe, vlm and audio families at published width, bf16: the
     golden's dbrx-132b (1 layer), llama-3.2-vision-11b (5 layers) and
     hubert-xlarge (48 layers) against lm_full_width.json; dbrx-132b with
     6 of its 40 layers, llama4-maverick with 2 of its 48 (one dense, one
     MoE), llama-3.2-vision-11b and hubert-xlarge at full depth, each
     built, measured and freed in turn: a prefill of 8 x 1,024 (vision
     over 1,601 image tokens, hubert on frames) with flash launched once
     per attention layer (6, 2, 40 = 32 self + 8 cross, 48), serve() under
     ppcc for dbrx and vision against the reference's counts, the decode
     step at batch 8 over caches of 1,040 slots (vision's cross caches
     projected from its image tokens), flash against its plain version
     at every prefill's first self-attention and vision's first cross
     call (Sk = 1,601) with its time, bound and SDPA, decode against
     prefill in float32 for the three decoders at 2, 2 and 5 layers (the
     capacity factor the expert count, vision's gates non-zero and its
     cross caches filled), the MoE layer's routing and dispatch beside
     its expert products; the busy shares at the end;
 11. training: flash's backward kernel against its plain version in both
     dtypes at qwen3-0.6b's training call (B 8, Hq 16, Hkv 8, S 1,024, D
     128, causal), zamba2's window (S 8,192, window 4,096), hubert's
     non-causal D = 80, vision's cross call (Sk 1,601) and edges (S = 1,
     S off the tiles, g = 1, D = 256), bit-equal between two runs, its
     time beside its bound and SDPA's backward; the float32 train golden
     src/repro_torch/golden/train_full_width.json (qwen3-0.6b full width,
     2 layers, 3 AdamW steps; flash on its CUDA-core route) within 1e-4;
     qwen3-0.6b at full width and depth, bf16, 8 steps of
     launch.train's loop on one fixed batch of 8 x 1,024 with a falling
     loss, 28 flash forwards and 28 backwards a step and no wkv_chunked,
     its step wall, tokens/s and peak memory; the restart check (full
     width, 2 layers, a failure injected at step 4, checkpoints every 3
     steps in a temporary directory it removes) against a clean run; the
     step's busy share and the backward's share at the end;
 12. rwkv training: the WKV backward (csrc/wkv_bwd.cu: four device
     kernels a call) against its plain version in both dtypes at
     rwkv6-3b's training call (B 8, H 48, S 1,024, D 64, chunk 128, r/k/v
     views of [B, S, 3,072]) and edges (D = 16, 32, 64; chunks of 1, 16,
     24, 64, 100, 128; S = chunk, one chunk; B = H = 1, fewer CTAs than
     SMs; an initial state and a final-state gradient; views off 16
     bytes; strong decay), within 1e-4 (float32) or 1e-2 (bf16) of each
     gradient's largest magnitude, bit-equal between two runs, the forward
     bit-equal with and without its saved states; its time beside its
     bound (the function's bytes against three TF32 passes of its
     products) and the float32 CUDA-core floor, the bytes its kernels
     move, each device kernel's CTAs an SM, registers and spills; the
     float32 train golden src/repro_torch/golden/train_rwkv_full_width.json
     (rwkv6-3b full width, 2 layers, 3 AdamW steps) within 1e-4;
     rwkv6-3b at full width and depth, bf16, 8 steps of launch.train's
     loop on one fixed batch of 8 x 1,024 with a falling loss, 64 WKV
     forwards (remat 'full') and 32 backwards a step and no flash, its
     step wall, tokens/s and peak memory; the step's busy share and the
     WKV forward's and backward's shares, and each of the backward's
     device kernels a call (profiled), at the end;
 13. the multi-device modules on a one-rank NCCL mesh (one card: real
     multi-rank sharding is held by the CPU tests on gloo worlds of 2 and
     4): a process group made by sharding.init_distributed and an
     all_reduce through it; the fleet on fleet_mesh(..., pods=True) (Fig.
     7, MPLs 10, 25, 50 x seeds 0, 1, horizon 200; PPCC and OCC, then PPCC
     with delta) bit-equal to the unsharded fleet in the same run, with
     megastep, occ_validate and rowslab_drain launched once per body
     iteration; the float32 train golden through the mesh path (the model
     sharded on a (1, 1) mesh, make_global_batch) within 1e-4;
     qwen3-0.6b at full width and depth, bf16, 3 steps on 8 x 1,024 on
     the mesh bit-equal to the unsharded step in the same run (losses and
     parameters; walls, tokens/s, peak memory, 28 + 28 tensor-core flash
     launches a step); rwkv6-3b at its width cut to 2 layers on the mesh
     through the WKV forward and backward; both models served on the
     mesh through the tensor-parallel code (qwen3-0.6b's LM.prefill of 8
     x 1,024 and 8 decode steps in its caches, rwkv6-3b's prefill and 8
     decode steps from fresh caches) bit-equal to the same model
     unsharded, with their walls; flash and the WKV, forward and
     backward, at each rank's shapes of model = 2, 4 and 16 (qwen3-0.6b's
     training call with its 16 query and 16 effective KV heads split,
     rwkv6-3b's 48 padded heads split) against their plain versions,
     timed beside their bounds, plain versions and SDPA; a sharded
     checkpoint restart equal to a clean run to the bit; the group
     destroyed, two ranks on the card over gloo with CUDA tensors (NCCL
     refuses two ranks on one card): one float32 train step of qwen3-0.6b
     at full width, 2 layers, on a (1, 2) mesh, each rank's loss and
     gradient shards within 1e-5 of the unsharded step.

Phase 6 and phase 8's runs follow phase 3, then phases 10, 11, 12, 13, 7
and 9, all before phase 4's profiler sessions; phase 8's kernel checks and
times come last, then the profiles of phases 7, 9, 10, 11 and 12.
The last lines are the kernel table as one JSON object, the card's name
and power limit, and {"ok": true, "device": {...}}.  The script imports
nothing of JAX and nothing of the JAX package.
"""
import hashlib
import inspect
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = SRC / "repro_torch" / "golden" / "run_grid_h20000.json"
# phases 3 and 6 run run_grid's default grid cut in depth, both to horizon
# 5,000 (phase 6 ran to 10,000 until phase 12 needed the time), so that the
# script stays well inside its time limit
PHASE3_GOLDEN = SRC / "repro_torch" / "golden" / "run_grid_h5000.json"
PHASE6_GOLDEN = PHASE3_GOLDEN
TM_GOLDEN = SRC / "repro_torch" / "golden" / "telemetry_h5000.json"
SCHED_GOLDEN = SRC / "repro_torch" / "golden" / "sched_n4096_w1024.json"
# phase 8: the one-event engine (8 seeds as lanes, Fig. 6's setting at MPL
# 25, horizon 550: cut from 3,000, whose three runs took 298.7 s, then from
# 1,000, where they took 152-188 s, then from 600 (45.7-58.2 s) when the
# script passed 1,000 s on a slow host; at 550 every lane still commits)
# and simulate() (the same setting, horizon 1,000)
EVENT_GOLDEN = SRC / "repro_torch" / "golden" / "event_h550.json"
SIMULATE_GOLDEN = SRC / "repro_torch" / "golden" / "simulate_h1000.json"
PHASE8_FIG, PHASE8_MPL = 6, 25
# phase 8's multipass grid: phase 3's lanes to horizon 1,000 (5,000 until
# phase 13 needed the time)
PHASE8_GRID_GOLDEN = SRC / "repro_torch" / "golden" / "run_grid_h1000.json"
# admit_ops at the reference's sched_admit shape (benchmarks/run.py:380)
# and at the scheduler's phase-5 scale: (label, n, d, m)
ADMIT_OPS_SHAPES = [("sched_admit", 256, 1024, 512),
                    ("phase-5 scale", 4096, 32_768, 16_384)]
ADMIT_OPS_EDGES = ("m = 0", "all invalid", "one txn", "one item",
                   "writes only", "reads only", "dense", "all locked",
                   "runs", "edge items")
# and at the packed design's word and route edges: (label, n, d, m); n =
# 544 and 545 are the two sides of the shared route's switch at W = 32,
# n = 32,769 lies past the earlier design's cap
ADMIT_OPS_EDGE_SHAPES = [("n = 1", 1, 40, 50), ("n = 31", 31, 31, 200),
                         ("n = 32", 32, 32, 200), ("n = 33", 33, 33, 200),
                         ("n = 544", 544, 1024, 400),
                         ("n = 545", 545, 1024, 400),
                         ("n = 32,769", 32_769, 100, 64),
                         ("W = 1", 100, 20, 300)]
# one admit_ops step: the slot tests, the warp OR, the store of the warp's
# word, the barrier, the OR of the warps' words, the verdict, the apply and
# the load of the next op
ADMIT_OPS_STEP_DEPS = 8
# 32-bit logic operations of one step per slot: the two bit tests, the
# owner and arc tests and the class-bit tests
ADMIT_OPS_SLOT_OPS = 10
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 tensor cores (data sheet)
# 32-bit integer and logic results per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput)
LOGIC_PER_SM_CLOCK = 64
SCHED_EDGE_N = (1, 33, 255, 300, 4096)
SCHED_EDGE_W = (1, 3, 1024)
# the fused conflict entries beyond the YCSB batch, at full width: random
# sets with each page read with p = 1/k, half the read pages written
CONFLICT_DENSITIES = (8, 2)
# their route sweep: read density 1/k, both routes forced
ROUTE_SWEEP = (1024, 256, 64, 32, 16, 8, 4, 2)
# the edges of the YCSB batch held in phase 5
CONFLICT_EDGES = ("zero rows", "full row", "page by all")
# the shape of the route-switch holds: the largest route count the gather
# route takes, and one more
ROUTE_SWITCH_NW = (1000, 64)
# megastep's (n, d): tile edges, the main path's n, n at the kernel's row
# block (kRows = 96 in csrc/megastep.cu) less one, at it and plus one, n =
# 100 (4-byte stores: n % 16 != 0), n = 193 (three CTAs a lane), and n past
# 8 x 96, where a lane's rows per CTA grow (16-byte and byte stores)
EDGE_SHAPES = [(12, 30), (33, 100), (7, 31), (40, 64), (160, 500),
               (95, 300), (96, 300), (97, 300), (100, 200), (193, 500),
               (800, 30), (850, 40)]
# reserve_cohort's edges: (label, n, CPUs, disks, mask rate, pools)
RESERVE_EDGES = [("pools all 0", 160, 16, 32, 0.4, "zero"),
                 ("INF tails", 160, 16, 32, 0.4, "inf_tail"),
                 ("all slots masked", 160, 16, 32, 1.0, "random"),
                 ("no slot masked", 160, 16, 32, 0.0, "random"),
                 ("nc = nd = 1", 160, 1, 1, 0.4, "random"),
                 ("nc = 40, nd = 70", 160, 40, 70, 0.4, "zero"),
                 ("n = 77", 77, 16, 32, 0.4, "random")]
# occ_validate's edges: (label, lanes, n, items, would-be committer rate)
OCC_EDGES = [("no committer", 2, 160, 500, 0.0),
             ("every slot a committer", 2, 160, 500, 1.0),
             ("one lane", 1, 160, 500, 0.3),
             ("W = 1, n = 77", 2, 77, 20, 0.5),
             ("W = 3", 2, 100, 90, 0.5),
             ("W = 303 (chunks of 31)", 2, 100, 303 * 32, 0.5),
             ("W = 384 (chunks of 25)", 2, 40, 384 * 32, 0.6),
             ("n = 77", 3, 77, 500, 0.5)]
# the three admission scans on both sides of their switch from four warps
# to a CTA of 512 threads
PPCC_ROUTE_N = (16_384, 16_385)
# twopl_admit and occ_admit at serve()'s n (a YCSB batch of 64 over 512
# pages)
ADMIT_SERVE_N = 64
# the chain bounds of the scans: a dependent integer or float instruction
# issues at least this many SM cycles after the one it waits on (sm_90's
# fixed-latency pipes), and a warp vote or reduction is counted as one
DEP_CYCLES = 4
# occ_validate's step: LOP3 (read & (dirty | acc)), compare, the warp vote,
# select acc
OCC_STEP_DEPS = 4
# one admission step: ppcc_admit's AND of row and column with admitted,
# fold of the precedence tests, compare, OR over the CTA, verdict, pick of
# the first admitted and update; twopl_admit's and occ_admit's AND with
# admitted, OR over the CTA, verdict and store
ADMIT_STEP_DEPS = {"ppcc_admit": 7, "twopl_admit": 4, "occ_admit": 4}
SLAB_EDGE_N = {1: 30, 14: 100, 33: 100, 160: 500, 300: 1000}   # n: items
SLAB_EDGE_K = (1, 4, 40)         # and K = n
CAPTURE_ITERS = 200              # body iterations before capturing inputs
EVENT_CAPTURE = 50               # events before timing one (phase 8)
TM_RUN = dict(delta=True, telemetry=True, trace_every=8, trace_len=256)
LM_GOLDEN = SRC / "repro_torch" / "golden" / "lm_full_width.json"
LM_ARCHES = ("qwen3_0p6b", "rwkv6_3b")
# the float32 golden run's counters (flash's CUDA-core route); the bf16
# main path counts flash on its tensor-core route, flash_attention_tc
LM_KERNEL = {"dense": "flash_attention", "rwkv": "wkv_chunked"}
PREFILL_B, PREFILL_S = 8, 1024
DECODE_CHECK = {"qwen3_0p6b": 64, "rwkv6_3b": 128}   # prompt tokens decoded
# phase 9: zamba2-1.2b at its published width and depth, and yi-34b at its
# published width with its depth cut from 60 to 16 layers (20 GB of bf16
# weights beside the earlier phases' models; 60 layers are ~70 GB)
PHASE9 = ("zamba2_1p2b", "yi_34b")
YI_LAYERS = 16
# (batch, tokens) of each model's prefill: zamba2's is twice its window of
# 4,096, so flash masks keys by the window; yi's is phase 7's
PREFILL9 = {"zamba2_1p2b": (4, 8192), "yi_34b": (8, 1024)}
# prompt tokens decoded; zamba2's cut from 128 to 64 (~9 s of ~67 ms
# decode steps, bf16 and float32) to keep the script within ~120 s of its
# length before phase 9 (on one H100: 781.1 s with 128, 647.8 s before)
DECODE9 = {"zamba2_1p2b": 64, "yi_34b": 64}
RING9 = (64, 96)   # zamba2's ring: the window cut to 64 slots, 96 tokens
# phase 10: the moe, vlm and audio families at published width, bf16, the
# layers each keeps (0: all): dbrx-132b 6 of 40 (41.6 GB; 40 are 264 GB),
# llama4-maverick 2 of 48 (one dense and one MoE layer, 37.4 GB; 48 are
# ~800 GB), llama-3.2-vision-11b all 40 (32 self + 8 cross, 19.6 GB),
# hubert-xlarge all 48 (2.5 GB); each prefill 8 x 1,024, the vision
# model's over 1,601 image tokens, hubert's on frames
PHASE10 = {"dbrx_132b": 6, "llama4_maverick_400b": 2,
           "llama3p2_vision_11b": 0, "hubert_xlarge": 0}
GOLDEN10 = ("dbrx_132b", "llama3p2_vision_11b", "hubert_xlarge")
SERVE10 = ("dbrx_132b", "llama3p2_vision_11b")     # serve() under ppcc
# decode steps timed at batch 8 (the decoders), over caches of the
# prefill's length and these: a step attends over every slot
DECODE10 = 16
# decode against prefill in float32 (the bf16 weights widened, float32
# caches, the capacity factor the expert count, so that the prefill drops
# no token), at the depth that fits the card in float32: dbrx 2 layers
# (31 GB), maverick its 2 (74.8 GB), vision one group of 4 self blocks
# and its cross block (8.6 GB)
CHECK10 = {"dbrx_132b": 2, "llama4_maverick_400b": 2,
           "llama3p2_vision_11b": 5}
POLICIES = ("ppcc", "2pl", "occ")
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
# (b, Hq, Hkv, Sq, Sk, D, dtype, causal, window); the bf16 shapes take the
# tensor-core route, D = 20 with TMA-unaligned rows (staged by the
# kernel's producer), Sq = 300 > Sk = 200 with window 32 rows whose every
# key is masked
FLASH_EDGES = [(2, 8, 8, 128, 128, 64, "bfloat16", True, 0),
               (1, 8, 4, 100, 100, 16, "float32", True, 0),
               (1, 8, 1, 128, 256, 128, "bfloat16", False, 0),
               (1, 4, 2, 200, 130, 64, "float32", True, 32),
               (2, 16, 16, 333, 333, 128, "bfloat16", False, 32),
               (1, 8, 8, 64, 64, 128, "float32", True, 0),
               (1, 4, 2, 300, 200, 128, "bfloat16", True, 32),
               (1, 4, 4, 100, 90, 20, "bfloat16", True, 0),
               (1, 2, 2, 200, 200, 256, "bfloat16", True, 0)]
WKV_EDGE_CHUNKS = (16, 64, 128)  # H = 48, D = 64, S = chunk and 8 chunk
# the WKV kernel's other head sizes and an initial state: (D, chunk, S,
# state0), H = 48, both dtypes
WKV_EDGE_MORE = [(16, 64, 512, False), (16, 1, 8, False),
                 (32, 64, 512, False), (32, 128, 128, False),
                 (64, 128, 1024, True), (32, 16, 128, True)]
TF32_OPS_PER_S = 495e12          # H100 SXM dense TF32 tensor cores
TRAIN_GOLDEN = SRC / "repro_torch" / "golden" / "train_full_width.json"
# phase 11: flash's forward with lse and its backward against their plain
# versions at these calls (B, Hq, Hkv, Sq, Sk, D, causal, window), both
# dtypes; qwen3-0.6b's training call is the main path's: its 8 KV heads
# are repeated to 16 before flash (models/attention.py, kv_repeat = 2).
# bf16 runs the backward on the tensor cores up to D = 128 and on its
# CUDA-core route at D = 256; the BWD_STAGED calls hand q, k, v and dO over
# one element off a 16-byte boundary, which TMA refuses (the producer
# stages them); the cross call with a window and Sq > Sk has rows whose
# every key is masked, whose gradients must be 0, not NaN
BWD_SHAPES = [
    ("qwen3-0.6b training", (8, 16, 16, 1024, 1024, 128, True, 0)),
    ("GQA g=2", (2, 16, 8, 1024, 1024, 128, True, 0)),
    ("zamba2-1.2b window", (1, 32, 32, 8192, 8192, 64, True, 4096)),
    ("hubert-xlarge non-causal D=80", (8, 16, 16, 1024, 1024, 80, False, 0)),
    ("llama-3.2-vision cross", (8, 32, 16, 1024, 1601, 128, False, 0)),
    ("S=1", (2, 4, 2, 1, 1, 128, True, 0)),
    ("S off the tiles", (2, 8, 2, 1000, 1000, 64, True, 0)),
    ("g=1 D=256", (2, 4, 4, 300, 300, 256, True, 0)),
    ("D=256 window", (1, 8, 2, 333, 333, 256, True, 100)),
    ("odd-offset base, producer-staged", (2, 16, 8, 1000, 1000, 128, True,
                                          0)),
    ("cross window Sq > Sk, masked rows", (2, 8, 4, 300, 200, 128, True,
                                           32)),
]
BWD_STAGED = {"odd-offset base, producer-staged"}
# the backward's device kernels by name, on every route (the profile's
# share of a training step)
BWD_KERNELS = ("tc::prep_kernel", "dkdv_tc_kernel", "dq_tc_kernel",
               "delta_kernel", "dkdv_kernel", "dq_kernel")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 8      # the full-depth run
RESTART_B, RESTART_S, RESTART_STEPS = 4, 512, 8  # the restart check
RESTART_EVERY, RESTART_FAIL_AT = 3, 4
RWKV_GOLDEN = SRC / "repro_torch" / "golden" / "train_rwkv_full_width.json"
# phase 12: the WKV backward against its plain version, both dtypes, at
# rwkv6-3b's training call and edges: (B, H, S, D, chunk, initial state
# and final-state gradient, strong decay, r/k/v/log w/dO one element off a
# 16-byte boundary); the model's tensors are [B, H, S, D] views of [B, S,
# H*D] ones.  Strong decay is |log w| near 2.5 a step at a chunk of 64,
# where the reference's centring still keeps every exponential finite
WKV_BWD_SHAPES = [
    ("rwkv6-3b training", (8, 48, 1024, 64, 128, False, False, False)),
    ("D=64 C=128 state, dstate", (2, 48, 512, 64, 128, True, False, False)),
    ("D=32 C=16 state, dstate", (2, 48, 256, 32, 16, True, False, False)),
    ("D=16 C=64", (2, 48, 512, 16, 64, False, False, False)),
    ("C=1", (1, 8, 8, 64, 1, True, False, False)),
    ("S=C=128", (2, 48, 128, 64, 128, True, False, False)),
    ("B=H=1 (fewer CTAs than SMs)", (1, 1, 1024, 64, 128, True, False,
                                     False)),
    ("S=C=16 D=16", (2, 8, 16, 16, 16, True, False, False)),
    ("views off 16 bytes", (2, 48, 256, 64, 128, True, False, True)),
    ("strong decay", (2, 48, 512, 64, 64, True, True, False)),
    ("C=100 (no multiple of 8)", (2, 48, 300, 64, 100, True, False, False)),
    ("S=C=24 D=32 strong decay", (2, 8, 24, 32, 24, True, True, False)),
]
WKV_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # of the largest magnitude
# the WKV kernels' device names (the profile's shares of an rwkv step)
WKV_FWD_KERNELS = ("wkv_kernel",)
WKV_BWD_KERNELS = ("wkv_bwd_pstate", "wkv_bwd_dstate", "wkv_bwd_chunk",
                   "wkv_du_sum")
RWKV_TRAIN_LAYERS = 32           # rwkv6-3b's full depth
SLEEP_CYCLES = 2_000_000         # ~1 ms of device sleep ahead of a timing
# phase 13: the multi-device modules on a one-rank NCCL mesh
MESH_FIG, MESH_MPLS, MESH_SEEDS = 7, (10, 25, 50), (0, 1)
MESH_HORIZON = 200.0
MESH_STEPS = 3                   # qwen3-0.6b and rwkv6-3b steps on the mesh
MESH_RWKV_LAYERS = 2
MESH_RESTART_STEPS, MESH_CKPT_EVERY, MESH_FAIL_AT = 4, 2, 3
MESH_DECODES = 8                 # decode steps after the prefill on the mesh
RANK_MODELS = (2, 4, 16)         # model axes whose per-rank kernel shapes
PROBE_LAYERS, PROBE_B, PROBE_S = 2, 2, 128   # the two-rank gloo probe
PROBE_TIMEOUT_S = 240


def ptxas_usage(log: str, name: str, tag: str):
    """(registers, spill-store bytes) of the device function whose mangled
    name holds ``name`` and ``tag`` in an ``-Xptxas -v`` log, or None."""
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            spill = None
        elif fn and name in fn and tag in fn:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                return int(m.group(1)), spill
    return None


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


def cuda_times(fn, reps: int, torch, sleep: bool = True) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event pairs,
    after two warm-up calls.  With ``sleep``, each pair follows a 1 ms
    device sleep, so that up to 1 ms of the host's dispatch (the
    wrapper's checks, the launch) overlaps the sleep instead of opening a
    gap between the events: the time is the card's.  Without it the
    pairs run back to back, as earlier versions of this script took every
    time, and a short kernel's time also holds the part of the host's
    dispatch that the card does not hide; the kernel rows give both, so
    that a time is compared only with one taken the same way."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def median_wall_ms(fn, reps: int, torch) -> float:
    """Median synchronised wall milliseconds of ``fn()`` over ``reps``
    calls, after one warm-up call."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


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


def random_drain_inputs(n, d, gen, torch, B, dev):
    """Five lanes of drain inputs on ``dev``: random words, carried tables
    that are not a full recompute's, op data and flags, and dirty masks:
    lane 0 none, lane 1 one slot, lane 2 all n, lanes 3-4 random."""
    lanes = 5
    words = [B.pack(torch.rand((lanes, n, d), generator=gen) < p)
             for p in (0.03, 0.02)]
    tables = [torch.rand((lanes, n, n), generator=gen) < 0.1
              for _ in range(4)]
    item = torch.randint(0, d, (lanes, n), generator=gen, dtype=torch.int32)
    flags = [torch.rand((lanes, n), generator=gen) < q for q in (0.4, 0.8)]
    dirty = torch.rand((lanes, n), generator=gen) < 0.2
    dirty[0] = False
    dirty[1] = False
    dirty[1, n - 1] = True
    dirty[2] = True
    args = (*words, *tables, item, *flags, dirty)
    return tuple(a.to(dev).contiguous() for a in args)


def reserve_edge_inputs(label, n, nc, nd, p, pools, gen, torch, dev, inf):
    """Five lanes of reserve_cohort inputs on ``dev`` for one edge of
    ``RESERVE_EDGES``: pools random, all 0 (ties everywhere, as at init),
    or 0 with a tail of INF servers (the grid's padded pools; ties among the
    live ones and among the INF ones); masks at rate ``p``."""
    lanes = 5
    cpu = torch.rand((lanes, nc), generator=gen) * 50
    disk = torch.rand((lanes, nd), generator=gen) * 80
    if pools != "random":
        cpu.zero_()
        disk.zero_()
    if pools == "inf_tail":
        cpu[:, nc // 2:] = inf
        disk[:, nd // 3:] = inf
    t = torch.rand((lanes, n), generator=gen) * 60
    t[0] = 0.0                                  # requests at time 0
    cd = torch.rand((lanes, n), generator=gen) * 10 + 10
    dd = torch.rand((lanes, n), generator=gen) * 20 + 25
    cm = torch.rand((lanes, n), generator=gen) < p
    dm = torch.rand((lanes, n), generator=gen) < p
    return tuple(a.to(dev).contiguous() for a in (cpu, disk, t, cd, dd, cm,
                                                  dm))


def bits_equal(got, want, torch) -> bool:
    """Every output bit-equal: float tensors compared as int32 views."""
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(
        *(x.view(torch.int32) if x.is_floating_point() else x
          for x in (g, w))) for g, w in zip(got, want))


def masked_counts(args) -> dict:
    """Per-lane counts of reserve_cohort's masked slots (its steps), per
    pool: the most in a lane and the mean over lanes."""
    out = {}
    for pool, m in (("cpu", args[5]), ("disk", args[6])):
        per = m.sum(1)
        out[pool] = {"max": int(per.max()), "mean": float(per.float().mean())}
    return out


def reserve_chain_cycles(args) -> int:
    """SM cycles of the longest dependent chain that any reserve_cohort
    must run on these inputs.  Steps of one pool depend on each other and
    the two pools do not, and an unmasked slot is no step, so the chain is
    the most masked slots of one pool of one lane.  A step takes an argmin
    over the pool's P servers, a compare-and-select tree of ceil(log2 P)
    levels of 2 dependent instructions (compare, select), then the max with
    the request time, the add of the duration and the write of the chosen
    server: 2 ceil(log2 P) + 3 dependent instructions of DEP_CYCLES each."""
    cycles = 0
    for m, pool in ((args[5], args[0]), (args[6], args[1])):
        steps = int(m.sum(1).max()) if m.numel() else 0
        deps = 2 * (pool.shape[1] - 1).bit_length() + 3
        cycles = max(cycles, steps * deps * DEP_CYCLES)
    return cycles


def committer_counts(commit) -> dict:
    """Per-lane counts of occ_validate's would-be committers (its steps):
    the most in a lane and the mean over lanes."""
    per = commit.sum(1)
    return {"max": int(per.max()), "mean": float(per.float().mean())}


def occ_chain_cycles(commit) -> int:
    """SM cycles of the longest dependent chain of an occ_validate on these
    would-be committers: lanes are independent and a slot that is no
    committer is no step, so the chain is the most committers of one lane
    x OCC_STEP_DEPS dependent instructions of DEP_CYCLES each."""
    steps = int(commit.sum(1).max()) if commit.numel() else 0
    return steps * OCC_STEP_DEPS * DEP_CYCLES


def admit_chain_cycles(name: str, admitted: int) -> int:
    """SM cycles of the chain of an admission scan on these inputs.  A
    step whose transaction is not admitted changes no state, so the steps
    between two admitted ones depend only on the earlier one and can be
    tested together: the chain runs through the admitted steps, (admitted
    + 1) steps of ADMIT_STEP_DEPS[name] instructions of DEP_CYCLES each."""
    return (admitted + 1) * ADMIT_STEP_DEPS[name] * DEP_CYCLES


def ppcc_admit_inputs(read, write, pending, torch):
    """ppcc_admit's arguments at a ppcc_degree tick over these words: raw
    with its diagonal cleared, the pending mask, the degree order."""
    from repro_torch.kernels import conflict as kconf
    from repro_torch.sched import scheduler as S
    full = kconf.conflict_fused_full(read, write)
    n = read.shape[0]
    raw_off = full[0] & ~torch.eye(n, dtype=torch.bool, device=read.device)
    return raw_off, pending, S.degree_order(full)


def tick_times(read, write, torch, policy="ppcc", reps=4):
    """(wall ms unprofiled, device kernel ms, {kernel: (ms, launches)}) of
    one tick of ``policy`` + tick_stats with every transaction pending: the
    wall over ``reps`` synchronised ticks after one warm-up, then
    ``device_profile`` of ``reps`` more."""
    from repro_torch.sched import scheduler as S
    valid = torch.ones(read.shape[0], dtype=torch.bool, device=read.device)

    def one_tick():
        S.tick_stats(read, write, valid,
                     S.tick(read, write, valid, policy=policy))

    one_tick()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        one_tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / reps * 1e3
    dev_ms, _, per = device_profile(one_tick, reps, torch)
    return wall, dev_ms, per


def random_words(n, w, k, gen, torch, dev):
    """(read, write) int32[n, w] on the card: each of the 32 w pages read
    with p = 1/k, half of the read ones written."""
    from repro_torch.core import bitset as B
    r = torch.rand((n, 32 * w), generator=gen, device=dev) < 1.0 / k
    wr = r & (torch.rand((n, 32 * w), generator=gen, device=dev) < 0.5)
    return B.pack(r), B.pack(wr)


def edge_words(kind, read, write):
    """Copies of (read, write) with an edge: every other row empty, the
    middle row holding every page (read and written), or page 37 written
    by every transaction."""
    read, write = read.clone(), write.clone()
    n, w = read.shape
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


def switch_words(name, n, w, extra, cost, torch, dev):
    """Words whose route count is the largest the gather route takes
    (``extra = 0``) or one more: random writes at 1/32, then read bits at
    random cells up to the count (read bits + write bits, twice the write
    bits for conflict_fused_full)."""
    import numpy as np
    from repro_torch.core import bitset as B
    nw, rhs = -(-n // 32), 2.0 * n * n * w
    top = int(rhs / (nw * cost))
    while (top + 1) * nw * cost <= rhs:
        top += 1
    while top * nw * cost > rhs:
        top -= 1
    rng = np.random.default_rng(n + extra)
    write = rng.random((n, 32 * w)) < 1 / 32
    mult = 2 if name == "conflict_fused_full" else 1
    read = np.zeros(n * 32 * w, dtype=bool)
    read[rng.choice(n * 32 * w, size=top + extra - mult * int(write.sum()),
                    replace=False)] = True
    return tuple(B.pack(torch.from_numpy(a.reshape(n, 32 * w)).to(dev))
                 for a in (read, write))


def visited_bits(read, write, torch, full=False) -> int:
    """The gather route's count: set bits of the read words plus those of
    the write words (twice for conflict_fused_full)."""
    from repro_torch.core import bitset as B

    def bits(x):
        return int(B.unpack(x, x.shape[1] * 32).sum())
    return bits(read) + (2 if full else 1) * bits(write)


def route_sweep(name, n, w, torch, dev, cuda_ms) -> list:
    """Fused entry ``name`` on each route forced, at random sets of read
    density 1/k (k in ROUTE_SWEEP) of shape [n, w]: one dict a density
    with the gather route's count, its share of the switch (1 at the
    largest count the gather route takes), both routes' times after the
    device sleep and the route the card chooses."""
    from repro_torch.kernels import conflict as kconf
    gen = torch.Generator(dev).manual_seed(7)
    cost, nw = kconf.gather_cost(), -(-n // 32)
    out = []
    for k in ROUTE_SWEEP:
        er, ew = random_words(n, w, k, gen, torch, dev)
        visited = visited_bits(er, ew, torch, name == "conflict_fused_full")
        times = {route: cuda_ms(lambda: kconf.routed(name, er, ew, route),
                                5) for route in ("gather", "dense")}
        out.append({"density": f"1/{k}", "visited_bits": visited,
                    "of_switch": visited * nw * cost / (2.0 * n * n * w),
                    "gather_ms": times["gather"],
                    "dense_ms": times["dense"],
                    "chosen": kconf.route_ran(
                        kconf.routed(name, er, ew)[1])})
        del er, ew
    return out


def capture_calls(fn, mod, name):
    """The arguments of every call of ``mod.<name>`` that ``fn()`` makes."""
    calls, launch = [], getattr(mod, name)

    def spy(*args, **kw):
        calls.append(tuple(a.clone() for a in args))
        return launch(*args, **kw)

    setattr(mod, name, spy)
    try:
        fn()
    finally:
        setattr(mod, name, launch)
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


def device_profile(fn, reps: int, torch, tries: int = 3):
    """(device ms, kernels, {kernel: (device ms, launches)}), each per
    call, of ``reps`` calls of ``fn()`` under torch.profiler; a session
    that saw no device time (it happens now and then, one session after
    another) is run again, up to ``tries`` sessions; zero time if none
    saw any."""
    from torch.profiler import ProfilerActivity, profile
    per = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if dev_time(e) > 0:
                ms, count = per.get(e.key, (0.0, 0.0))
                per[e.key] = (ms + dev_time(e) / reps / 1e3,
                              count + e.count / reps)
        if per:
            break
    return (sum(ms for ms, _ in per.values()),
            sum(c for _, c in per.values()), per)


def sleep_timeline(fn, torch, reps: int = 5) -> list:
    """[(kernel, start us, end us)] of ``fn()``'s device kernels after a
    device sleep, from the sleep's end, each the median over ``reps``
    profiled calls: how a call timed the way ``cuda_times`` times it
    splits into kernels and the idle time between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(SLEEP_CYCLES)
            fn()
        torch.cuda.synchronize()
    calls = []
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if "spin_kernel" in e.name:
            calls.append((e.time_range.end, []))
        elif calls:
            t0, kernels = calls[-1]
            kernels.append((e.name, e.time_range.start - t0,
                            e.time_range.end - t0))
    calls = [k for _, k in calls if k]
    if not calls or any(len(k) != len(calls[0]) for k in calls):
        return []
    return [(calls[0][i][0],
             statistics.median(k[i][1] for k in calls),
             statistics.median(k[i][2] for k in calls))
            for i in range(len(calls[0]))]


def largest(per: dict, k: int) -> list:
    """The ``k`` largest (device ms, kernel) of a ``device_profile``."""
    return sorted(((ms, key) for key, (ms, _) in per.items()),
                  reverse=True)[:k]


def profile_iteration(cond, step, s, sweep, torch, reps=32):
    """``device_profile`` of one batch iteration, over ``reps`` batch
    iterations from ``s`` after four unprofiled ones."""
    for _ in range(4):
        s = sweep._select(cond(s), step(s), s)
    torch.cuda.synchronize()
    box = [s]

    def body():
        box[0] = sweep._select(cond(box[0]), step(box[0]), box[0])
    return device_profile(body, reps, torch)


def pending_at(steps, n, dev, torch, k=4):
    """The pending mask after the first ``k`` ticks of a drain."""
    v = torch.ones(n, dtype=torch.bool, device=dev)
    for r, _ in steps[:k]:
        v &= ~r.admitted
    return v


def sched_phase(torch, dev, bound, cuda_ms) -> list:
    """Phase 5: the batch scheduler at full width against the JAX golden.
    Returns the kernel-table rows of its six kernels."""
    import numpy as np
    from repro_torch.core import bitset as B
    from repro_torch.kernels import admit as kadm
    from repro_torch.kernels import conflict as kconf
    from repro_torch.kernels import ops, ref
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

    # ---- the device's share of a tick: a ppcc, a 2pl and an occ tick +
    # tick_stats, first input
    for policy in ("ppcc", "2pl", "occ"):
        tick_ms, dev_ms, per = tick_times(read, write, torch, policy)
        if dev_ms > 0:
            log(f"[5] {policy} tick + tick_stats: {tick_ms:.3f} ms wall "
                f"unprofiled, {dev_ms:.3f} ms device kernel time, device "
                f"idle {100 * (1 - dev_ms / tick_ms):.1f}%; largest: "
                + ", ".join(f"{k[:40]} {v:.3f} ms"
                            for v, k in largest(per, 4)))
        else:
            log(f"[5] {policy} tick + tick_stats: {tick_ms:.3f} ms wall; "
                f"device time not measured (profiler saw no device time)")

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
    fused = conf[1:]
    for name in conf:
        hold(name, getattr(kconf, name)(read, write),
             getattr(ref, f"{name}_ref")(read, write))
    chosen = {}

    def hold_routes(name, er, ew, label):
        """Fused entry ``name`` on the route the card chooses and on each
        route forced, against the plain version; the route chosen."""
        want = getattr(ref, f"{name}_ref")(er, ew)
        for route in (None, "dense", "gather"):
            got, flags = kconf.routed(name, er, ew, route)
            ran = kconf.route_ran(flags)
            if route is not None and ran != route:
                fail(f"{name} forced to the {route} route ran {ran} "
                     f"({label})")
            hold(name, got, want)
            chosen.setdefault((name, label), ran)
        return chosen[(name, label)]

    # the YCSB batch, random sets at read density 1/8 and 1/2, the YCSB
    # batch's edges and, at ROUTE_SWITCH_NW, the route switch
    gen_c = torch.Generator(dev).manual_seed(5)
    dense_in = {k: random_words(n, w, k, gen_c, torch, dev)
                for k in CONFLICT_DENSITIES}
    cases = [("ycsb", read, write)] + [
        (f"random 1/{k}", *x) for k, x in dense_in.items()] + [
        (kind, *edge_words(kind, read, write)) for kind in CONFLICT_EDGES]
    for label, er, ew in cases:
        for name in fused:
            hold_routes(name, er, ew, label)
    del cases
    sn, sw = ROUTE_SWITCH_NW
    for name in fused:
        for extra, side in ((0, "gather"), (1, "dense")):
            er, ew = switch_words(name, sn, sw, extra, kconf.gather_cost(),
                                  torch, dev)
            if hold_routes(name, er, ew, f"switch +{extra}") != side:
                fail(f"{name} at the route switch +{extra} (n={sn}, "
                     f"W={sw}) ran {chosen[(name, f'switch +{extra}')]}, "
                     f"not {side}")
    for name in fused:
        if chosen[(name, "ycsb")] != "gather" or \
                chosen[(name, "random 1/2")] != "dense":
            fail(f"{name} chose {chosen[(name, 'ycsb')]} at the YCSB batch "
                 f"and {chosen[(name, 'random 1/2')]} at density 1/2")
    same = all(chosen[("conflict_fused_full", label)] == ran
               for (nm, label), ran in chosen.items()
               if nm == "conflict_fused")
    log("[5] conflict_fused and conflict_fused_full bit-equal to their "
        "plain versions on the route the card chose and on each route "
        f"forced, at n={n}, W={w} and at the switch (n={sn}, W={sw}); "
        "conflict_fused chose " + ", ".join(
            f"{label} {ran}" for (nm, label), ran in chosen.items()
            if nm == "conflict_fused")
        + (", conflict_fused_full the same" if same else
           f"; conflict_fused_full: {chosen}"))
    # the admission inputs of tick 4 of each mode's drain
    full = kconf.conflict_fused_full(read, write)
    raw, wwm = full[0], full[1]
    v_p, v_2, v_o = (pending_at(out[m][0], n, dev, torch)
                     for m in ("ppcc_degree", "2pl", "occ"))
    adm = {"ppcc_admit": ppcc_admit_inputs(read, write, v_p, torch),
           "twopl_admit": (raw, wwm, v_2), "occ_admit": (raw, wwm, v_o)}
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
            for name in fused:
                hold_routes(name, er, ewr, f"random 1/8 n={en} W={ew}")
        if en == n:
            continue                  # the full width is held above
        erw, eww = W.ycsb_batch(n=en, d=max(64, 8 * en), seed=en)
        er = torch.from_numpy(erw.view(np.int32)).to(dev)
        ewr = torch.from_numpy(eww.view(np.int32)).to(dev)
        for name in fused:
            hold_routes(name, er, ewr, f"ycsb n={en}")
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
    # ppcc_admit at the top of its four-warp route and on the CTA route above
    for en in PPCC_ROUTE_N:
        g_ = torch.Generator(dev).manual_seed(en)
        eraw = torch.rand((en, en), generator=g_, device=dev) < 3.0 / en
        eraw.fill_diagonal_(False)
        ev = torch.rand(en, generator=g_, device=dev) < 0.9
        eseq = torch.randperm(en, generator=g_, device=dev).to(torch.int32)
        got_e = kadm.ppcc_admit(eraw, ev, eseq)
        hold("ppcc_admit", got_e, ref.ppcc_admit_ref(eraw, ev, eseq))
        log(f"[5] ppcc_admit bit-equal to its plain version at n={en} "
            f"({'four warps' if en <= 16_384 else 'a CTA of 512 threads'}; "
            f"random arcs, 3 a row; {int(got_e[0].sum())} admitted)")
        # twopl_admit and occ_admit on the same side: random raw (3 a row)
        # and ww (2 a row), diagonals included
        eww = torch.rand((en, en), generator=g_, device=dev) < 2.0 / en
        eraw |= torch.rand((en, en), generator=g_, device=dev) < 1.0 / en
        for name in ("twopl_admit", "occ_admit"):
            got_t = getattr(kadm, name)(eraw, eww, ev)
            hold(name, got_t, getattr(ref, f"{name}_ref")(eraw, eww, ev))
            log(f"[5] {name} bit-equal to its plain version at n={en} "
                f"({'four warps' if en <= 16_384 else 'a CTA of 512 threads'}"
                f"; {int(got_t.sum())} admitted)")
        del eraw, eww, got_e, got_t
    srw, sww = W.ycsb_batch(n=ADMIT_SERVE_N, d=8 * ADMIT_SERVE_N,
                            seed=ADMIT_SERVE_N)
    sraw, sww_m, *_ = ref.conflict_fused_ref(
        torch.from_numpy(srw.view(np.int32)).to(dev),
        torch.from_numpy(sww.view(np.int32)).to(dev))
    sv = torch.ones(ADMIT_SERVE_N, dtype=torch.bool, device=dev)
    for name in ("twopl_admit", "occ_admit"):
        got_t = getattr(kadm, name)(sraw, sww_m, sv)
        hold(name, got_t, getattr(ref, f"{name}_ref")(sraw, sww_m, sv))
        log(f"[5] {name} bit-equal to its plain version at serve()'s "
            f"n={ADMIT_SERVE_N} (a YCSB batch over {8 * ADMIT_SERVE_N} "
            f"pages, {int(got_t.sum())} admitted)")

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

    rows, floors, extra = [], {}, {}
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
        ms0 = cuda_ms(lambda: getattr(kconf, name)(read, write), 10,
                      sleep=False)
        pms = cuda_ms(lambda: getattr(ref, f"{name}_ref")(read, write), 2)
        lms = cuda_ms(lambda: library(name), 5)
        relations = 1 if name == "conflict_matrix" else 2
        outs = {"conflict_matrix": n * n,
                "conflict_fused": 2 * n * n + 2 * 4 * n,
                "conflict_fused_full": 2 * n * n + 3 * 4 * n + 2 * n}[name]
        nbytes = 2 * n * w * 4 + outs
        # the dense route: one LOP3 (acc |= a & b) per word pair and
        # relation; its floor on the card: a 0/1 int8 product per relation
        # on the tensor cores, 2 n^2 d operations, then > 0
        dense_ms, dense_by = bound(nbytes, relations * n * n * w)
        floors[name] = max(nbytes / HBM_BYTES_PER_S,
                           relations * 2 * n * n * 32 * w
                           / INT8_OPS_PER_S) * 1e3
        if name == "conflict_matrix":
            b_ms, b_by = dense_ms, dense_by
        else:
            # the gather route on these sets: one word OR per index word of
            # each set bit it visits
            visited = visited_bits(read, write, torch,
                                   name == "conflict_fused_full")
            b_ms, b_by = bound(nbytes, visited * -(-n // 32))
            by_input = {"ycsb": {"ms": ms, "ms_no_sleep": ms0,
                                 "route": chosen[(name, "ycsb")]}}
            for k, (er, ew) in dense_in.items():
                by_input[f"random 1/{k}"] = {
                    "ms": cuda_ms(lambda: getattr(kconf, name)(er, ew), 5),
                    "ms_no_sleep": cuda_ms(
                        lambda: getattr(kconf, name)(er, ew), 5,
                        sleep=False),
                    "route": chosen[(name, f"random 1/{k}")]}
            extra[name] = {"visited_bits": visited,
                           "dense_route_bound_ms": dense_ms,
                           "by_input": by_input}
        rows.append((name, "src/repro/kernels/conflict.py:" + {
            "conflict_matrix": "80 (_conflict_kernel, pallas_call at :91)",
            "conflict_fused": "134 (_conflict_fused_kernel, pallas_call at "
                              ":153)",
            "conflict_fused_full": "222 (_conflict_fused_full_kernel, "
                                   "pallas_call at :238)"}[name],
            "src/repro_torch/csrc/conflict.cu", ms, ms0, pms, b_ms, b_by,
            lms))
    del dense_in
    # the route switch's sweep, and the device kernels of one call
    for name in fused:
        extra[name]["route_sweep"] = sweep = route_sweep(name, n, w, torch,
                                                         dev, cuda_ms)
        for r in sweep:
            log(f"[5] {name} route sweep, read density {r['density']}: "
                f"{r['visited_bits']} bits visited ({r['of_switch']:.4f} of "
                f"the switch), gather {r['gather_ms']:.4f} ms, dense "
                f"{r['dense_ms']:.4f} ms; the card chooses {r['chosen']}")
        c_ms, _, c_per = device_profile(
            lambda: getattr(kconf, name)(read, write), 10, torch)
        extra[name]["device_kernels_per_call"] = len(c_per)
        extra[name]["device_ms_by_kernel"] = {
            k[:60]: v for k, (v, _) in c_per.items()}
        log(f"[5] {name} issues {len(c_per)} device operations a call at "
            f"the YCSB batch, {c_ms:.4f} ms of device time (profiled, 10 "
            f"calls): " + ", ".join(f"{k[:48]} {v:.4f} ms"
                                    for v, k in largest(c_per, 5)))
    sm_hz = max_sm_clock_hz()
    chains = {}
    for name, args in adm.items():
        ms = cuda_ms(lambda: getattr(kadm, name)(*args), 10)
        ms0 = cuda_ms(lambda: getattr(kadm, name)(*args), 10, sleep=False)
        pms = cuda_ms(lambda: getattr(ref, f"{name}_ref")(*args), 1)
        out_ = getattr(kadm, name)(*args)
        n_adm = int((out_[0] if isinstance(out_, tuple) else out_).sum())
        chains[name] = (admit_chain_cycles(name, n_adm) / sm_hz * 1e3,
                        n_adm)
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
                     f"scan)", "src/repro_torch/csrc/admit.cu", ms, ms0,
                     pms, b_ms, b_by, None))
    table = []
    for name, repl, src, ms, ms0, pms, b_ms, b_by, lms in rows:
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": counts[name],
                      "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lms,
                      "ms_no_sleep": ms0})
        if name in floors:
            table[-1]["tensor_core_floor_ms"] = floors[name]
        table[-1].update(extra.get(name, {}))
        if name in chains:
            table[-1]["chain_bound_ms"] = chains[name][0]
            table[-1]["admitted"] = chains[name][1]
        log(f"[5] {name}: {ms:.4f} ms ({ms0:.4f} ms back to back; plain "
            f"{pms:.4f} ms, bound "
            f"{b_ms:.5f} ms by {b_by}"
            + (f", chain bound {chains[name][0]:.5f} ms through "
               f"{chains[name][1]} admitted" if name in chains else "")
            + (f" of 32-bit logic, int8 tensor-core floor "
               f"{floors[name]:.5f} ms" if name == "conflict_matrix" else "")
            + (f"; the dense route's bound "
               f"{extra[name]['dense_route_bound_ms']:.5f} ms of 32-bit "
               f"logic, its int8 tensor-core floor {floors[name]:.5f} ms"
               if name in extra else "")
            + (f", library {lms:.4f} ms" if lms is not None else "")
            + f") at n={n}, W={w}; {counts[name]} launches on the path"
            + ("".join(f"; {label}: {t['ms']:.4f} ms ({t['ms_no_sleep']:.4f}"
                       f" back to back, {t['route']} route)"
                       for label, t in extra[name]["by_input"].items())
               if name in extra else ""))
    log(f"[5] the chain bounds take (admitted + 1) steps x "
        f"{ADMIT_STEP_DEPS} dependent instructions x {DEP_CYCLES} cycles at "
        f"{sm_hz / 1e6:.0f} MHz, an OR over the CTA counted as one; all "
        f"{n} steps in order would give " + ", ".join(
            f"{k} {n * d * DEP_CYCLES / sm_hz * 1e3:.5f} ms"
            for k, d in ADMIT_STEP_DEPS.items()))
    # ppcc_admit's device kernels per call (pack, scan, prec): the distinct
    # kernels of 10 profiled calls, each issued once a call
    a_ms, _, a_per = device_profile(
        lambda: kadm.ppcc_admit(*adm["ppcc_admit"]), 10, torch)
    row = next(r for r in table if r["name"] == "ppcc_admit")
    row["device_kernels_per_call"] = len(a_per)
    row["device_ms_by_kernel"] = {k[:60]: v for k, (v, _) in a_per.items()}
    log(f"[5] ppcc_admit issues {len(a_per)} device kernels a call, "
        f"{a_ms:.4f} ms of device time (profiled, 10 calls): " + ", ".join(
            f"{k[:48]} {v:.4f} ms" for v, k in largest(a_per, 4)))
    # twopl_admit's and occ_admit's (pack, scan) at the tick-4 inputs of
    # the 2pl and occ drains, back to back and after a device sleep
    for name in ("twopl_admit", "occ_admit"):
        t_ms, _, t_per = device_profile(
            lambda: getattr(kadm, name)(*adm[name]), 10, torch)
        row = next(r for r in table if r["name"] == name)
        row["device_kernels_per_call"] = len(t_per)
        row["device_ms_by_kernel"] = {k[:60]: v
                                      for k, (v, _) in t_per.items()}
        if t_per:
            log(f"[5] {name} issues {len(t_per)} device operations a call, "
                f"{t_ms:.4f} ms of device time (profiled, 10 calls): "
                + ", ".join(f"{k[:56]} {v:.4f} ms"
                            for v, k in largest(t_per, 4)))
        else:
            log(f"[5] {name}'s device operations: not measured (the "
                "profiler saw no device time)")
        line = sleep_timeline(lambda: getattr(kadm, name)(*adm[name]), torch)
        row["after_sleep_us"] = [[k[:60], a, b] for k, a, b in line]
        log(f"[5] {name} after a device sleep (profiled, median of 5): "
            + ("; ".join(f"{k[:56]} {a:.1f}-{b:.1f} us" for k, a, b in line)
               if line else "not measured (the profiler saw no device "
               "time)"))
    return table


def prefill_kernel(cfg, dtype: str):
    """(counter, launches) of one prefill of ``cfg`` in ``dtype``: flash
    once per attention layer (once per group of the hybrid family, whose
    shared block closes each group), on its tensor cores in bf16 and its
    CUDA-core route in float32; the WKV once per RWKV layer."""
    if cfg.family == "rwkv":
        return "wkv_chunked", cfg.n_layers
    name = "flash_attention_tc" if dtype == "bfloat16" else "flash_attention"
    if cfg.family == "hybrid":
        return name, cfg.n_layers // cfg.hybrid_attn_every
    return name, cfg.n_layers


def lm_golden(arch, gold, dev, torch, tag) -> None:
    """``arch``'s run of ``golden/lm_full_width.json`` (full width, cut in
    depth, float32, seeded weights) on the card, held to the golden within
    the model's tolerance."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import golden as G
    from repro_torch.models import LM, convert
    cfg = G.golden_config(arch)
    rec = gold["models"][arch]
    tol = gold["tolerance"]
    atol, rtol = tol["atol"][arch], tol["rtol"][arch]
    prompt, cont, ids, extra = G.inputs(cfg)
    if ids.tolist() != rec["ids"] or \
            G.inputs_sha256(prompt, cont, extra) != rec["prompt_sha256"]:
        fail(f"{tag} {arch}: the golden's inputs differ from this "
             f"machine's draw")
    tree = convert.random_jax_tree(cfg, G.SEED)
    if convert.tree_sha256(tree) != rec["weights_sha256"]:
        fail(f"{tag} {arch}: the seeded weights differ from the golden's "
             f"(the numpy generator differs here)")
    lm = LM(cfg, device=dev)
    lm.load_state_dict(convert.params_from_jax(cfg, tree))
    del tree
    ops.reset_launches()
    got = G.port_run(lm, prompt, cont, ids, extra)
    torch.cuda.synchronize()
    kernel, want = prefill_kernel(cfg, "float32")
    launched = ops.launch_counts()[kernel]
    if launched != want:
        fail(f"{tag} {arch} golden run: {kernel} launched {launched} "
             f"times, not once per attention application of the prefill "
             f"({want})")
    worst = 0.0
    for key, val in got.items():
        want_v = np.asarray(rec[key])
        err = np.abs(val - want_v)
        bad = err > atol + rtol * np.abs(want_v)
        if bad.any():
            fail(f"{tag} {arch} {key}: max abs err {err.max():.3g} beyond "
                 f"the golden's atol {atol}, rtol {rtol} at "
                 f"{int(bad.sum())} entries")
        worst = max(worst, float(err.max()))
    cuts = G.CUTS.get(arch)
    int8 = tol.get("int8_step", {}).get(arch)
    log(f"{tag} {arch} at full width ({cfg.d_model} wide, vocab "
        f"{cfg.vocab}), {cfg.n_layers} layers"
        + (f", cut {cuts}" if cuts else "")
        + ", float32"
        + (f", {cfg.cache_dtype} cache" if G.decodes(cfg) else "")
        + f", seeded weights (sha256 "
        f"equal): prefill of {G.B} x {G.S} ({kernel} x {launched})"
        + (f" on seeded {', '.join(sorted(extra))}" if extra else "")
        + ((f" and {G.STEPS} decode steps"
            + (" after the prompt decoded from empty caches"
               if G.decodes_prompt(cfg) else ""))
           if G.decodes(cfg) else ", no decode (an encoder)")
        + f" equal {LM_GOLDEN.name} at {G.N_IDS} ids and every logsumexp, "
        f"max abs err {worst:.3g} (atol {atol}, rtol {rtol}; CPU port "
        f"{tol['cpu_max_abs_err'][arch]:.3g}"
        + (f"; one int8 step on every code {int8}" if int8 else "") + ")")
    del lm, got
    torch.cuda.empty_cache()


def fill_cross_caches(lm, caches, img, torch):
    """Write the image tokens' keys and values into the vlm family's
    ``cross_k``/``cross_v`` caches, projected by each cross block as the
    prefill projects them (the reference leaves the caches to its
    caller)."""
    from repro_torch.models import attention as attn_mod
    src = img.to(caches["cross_k"].dtype)
    with torch.inference_mode():
        for g, cross in enumerate(lm.cross_blocks):
            _, k, v = attn_mod._project_qkv(cross.xattn, lm.cfg, src[:, :1],
                                            src, None, lm.cfg.kv_repeat)
            caches["cross_k"][g].copy_(k)
            caches["cross_v"][g].copy_(v)


def decode_prompt(lm, prompt, torch, start=0, img=None):
    """(last logits of decoding ``prompt`` token by token from empty
    caches of ``start`` + its length slots, its first token at position
    ``start``, seconds per step after the first).  A step attends over
    every slot, filled or not, so it costs what it would after a context
    of ``start`` tokens.  The vlm family's cross caches hold ``img``'s
    keys and values."""
    caches = lm.init_caches(prompt.shape[0], start + prompt.shape[1])
    if img is not None:
        fill_cross_caches(lm, caches, img, torch)
    with torch.inference_mode():
        lg, caches = lm.decode_step(caches, prompt[:, :1], start)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(1, prompt.shape[1]):
            lg, caches = lm.decode_step(caches, prompt[:, i:i + 1], start + i)
        torch.cuda.synchronize()
    return lg.float(), (time.perf_counter() - t) / (prompt.shape[1] - 1)


def against_prefill(lm, prompt, torch, img=None):
    """(max |decode - prefill| of the last logits, the prefill's largest
    magnitude, at least 1, seconds per decode step); ``img`` is the vlm
    family's source, in the prefill's batch and the decode's cross
    caches."""
    from repro_torch.launch import steps
    batch = {"tokens": prompt} if img is None else {"tokens": prompt,
                                                    "img": img}
    want_l = steps.make_prefill_step(lm)(batch).float()
    got_l, sec = decode_prompt(lm, prompt, torch, img=img)
    return (float((got_l - want_l).abs().max()),
            max(1.0, float(want_l.abs().max())), sec)


def lm_phase(torch, dev, smi, cuda_ms):
    """Phase 7: LM serving at full width.  Returns (the kernel-table rows
    of flash_attention and wkv_chunked, a function that takes the
    device's busy share of a decode and a prefill step, to run after
    every wall of the script)."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import golden as G
    from repro_torch.launch import serve as srv
    from repro_torch.launch import steps
    from repro_torch.models import LM

    gold = json.loads(LM_GOLDEN.read_text())
    if gold["run"] != G.run_record():
        fail(f"{LM_GOLDEN.name} was written for another run: {gold['run']}")
    t7 = time.perf_counter()

    # ---- (b) full width, 2 layers, float32, against the JAX golden
    for arch in LM_ARCHES:
        lm_golden(arch, gold, dev, torch, "[7]")

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
    want = {"flash_attention_tc": configs.get("qwen3_0p6b").n_layers,
            "flash_attention": 0,
            "wkv_chunked": configs.get("rwkv6_3b").n_layers}
    got = {k: lm_counts[k] for k in want}
    if got != want:
        fail(f"[7] launches on the LM main path {got}, expected one per "
             f"layer of each prefill, bf16 flash on the tensor cores only "
             f"{want}")
    sched = {k: v for k, v in lm_counts.items() if v and k not in want}
    if not sched.get("conflict_fused") or not sched.get("ppcc_admit"):
        fail(f"[7] serve() launched no admission kernels: {sched}")
    log(f"[7] main path (one prefill of {PREFILL_B} x {PREFILL_S} per model, "
        f"serve() under ppcc, 2pl, occ per model): launches {got}, one per "
        f"layer, bf16 flash on its tensor-core route; admission kernels "
        f"{sched}")
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

    for arch, lm in lms.items():
        prefill = steps.make_prefill_step(lm)
        walls[arch, "prefill"] = median_wall_ms(
            lambda: prefill({"tokens": toks[arch]}), 3, torch) / 1e3
        n = DECODE_CHECK[arch]
        err, scale, walls[arch, "decode"] = against_prefill(
            lm, toks[arch][:, :n], torch)
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
        err, scale, _ = against_prefill(lm32, toks[arch][:, :n], torch)
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
    for d_, c, s_, with_state in WKV_EDGE_MORE:
        for dt in ("bfloat16", "float32"):
            r, k, v = ((torch.randn((1, s_, 48, d_), generator=gen) * 0.5)
                       .to(dts[dt]).to(dev).transpose(1, 2) for _ in range(3))
            lw = (-torch.exp(torch.randn((1, s_, 48, d_), generator=gen)
                             * 0.5 - 2)).to(dev).transpose(1, 2)
            u = (torch.randn((48, d_), generator=gen) * 0.1).to(dev)
            s0 = ((torch.randn((1, 48, d_, d_), generator=gen) * 0.1).to(dev)
                  if with_state else None)
            hold("wkv_chunked",
                 real["wkv_chunked"](r, k, v, lw, u, chunk=c, state0=s0),
                 ref.wkv_chunked_ref(r, k, v, lw, u, chunk=c, state0=s0),
                 1e-4, 1e-3, f"H=48 D={d_} S={s_} chunk={c} {dt}"
                 + (" from a state" if with_state else ""))
    log(f"[7] flash_attention within 2e-2 (bf16) / 1e-4 (float32) of its "
        f"plain version at the main-path inputs (max abs err "
        f"{main_err['flash_attention']:.4g}) and {len(FLASH_EDGES)} edge "
        f"shapes; wkv_chunked within atol 1e-4, rtol 1e-3 at the main-path "
        f"inputs ({main_err['wkv_chunked']:.4g}) and chunks "
        f"{WKV_EDGE_CHUNKS} x S in (chunk, 8 chunk) x (bf16, float32), and "
        f"(D, chunk, S, state0) in {WKV_EDGE_MORE} x (bf16, float32)")

    # ---- kernel times at the main-path shapes
    q, k, v = fargs
    b, hq, s_q, d = q.shape
    hkv = k.shape[1]
    ms_f = cuda_ms(lambda: real["flash_attention"](*fargs, **fkw), 20)
    ms0_f = cuda_ms(lambda: real["flash_attention"](*fargs, **fkw), 20,
                    sleep=False)
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
    # the float32 route (CUDA cores) at the same shape, for the record
    q32, k32, v32 = (x.float() for x in (q, k, v))
    ms_f32 = cuda_ms(lambda: real["flash_attention"](q32, k32, v32, **fkw), 5)
    del q32, k32, v32
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
    ms0_w = cuda_ms(lambda: real["wkv_chunked"](*wargs, **wkw), 20,
                    sleep=False)
    plain_w = cuda_ms(lambda: ref.wkv_chunked_ref(*wargs, **wkw), 3)
    w_bytes = (3 * r.numel() * r.element_size() + lw.numel() * 4
               + u.numel() * 4 + r.numel() * 4 + bw * hw * dw * dw * 4)
    per_chunk = 2 * chunk * (chunk - 1) * dw + 4 * chunk * dw * dw
    w_flops = bw * hw * (sw // chunk) * per_chunk
    w_bound = max(w_bytes / HBM_BYTES_PER_S, w_flops / F32_OPS_PER_S) * 1e3
    w_by = "bytes" if w_bytes / HBM_BYTES_PER_S >= \
        w_flops / F32_OPS_PER_S else "operations"
    # the kernel's own formulation: three TF32 passes on the tensor cores
    w_tc = max(w_bytes / HBM_BYTES_PER_S, 3 * w_flops / TF32_OPS_PER_S) * 1e3
    w_tc_by = "bytes" if w_bytes / HBM_BYTES_PER_S >= \
        3 * w_flops / TF32_OPS_PER_S else "operations"
    w_dev, _, w_per = device_profile(
        lambda: real["wkv_chunked"](*wargs, **wkw), 10, torch)
    log(f"[7] flash_attention at B={b} Hq={hq} Hkv={hkv} S={s_q} D={d} "
        f"{str(q.dtype)[6:]} causal: {ms_f:.4f} ms ({ms0_f:.4f} ms back to "
        f"back; plain {plain_f:.4f} ms, "
        f"SDPA {lib_f:.4f} ms; bound {f_bound:.5f} ms by {f_by}: "
        f"{f_bytes / 1e6:.1f} MB at 3.35 TB/s against {f_flops / 1e9:.2f} "
        f"GFLOP at the bf16 tensor-core 989 TFLOP/s; a CUDA-core "
        f"formulation's floor {f_core:.4f} ms at 67 TFLOP/s; the float32 "
        f"route at this shape {ms_f32:.4f} ms); tensor-core route "
        f"{ms_f / lib_f:.2f}x SDPA, {ms_f / f_bound:.2f}x its bound "
        f"[{smi}]")
    log(f"[7] wkv_chunked at B={bw} H={hw} S={sw} D={dw} chunk={chunk} "
        f"{str(r.dtype)[6:]} r/k/v: {ms_w:.4f} ms ({ms0_w:.4f} ms back to "
        f"back; plain {plain_w:.4f} ms; "
        f"bound {w_tc:.5f} ms by {w_tc_by}: {w_bytes / 1e6:.1f} MB at 3.35 "
        f"TB/s against 3 x {w_flops / 1e9:.2f} GFLOP of chunk products at "
        f"the TF32 495 TFLOP/s, {ms_w / w_tc:.2f}x it; the float32 "
        f"CUDA-core floor {w_bound:.5f} ms by {w_by} at 67 TFLOP/s; library "
        f"call: none) [{smi}]")
    log(f"[7] wkv_chunked issues {len(w_per)} device operations a call, "
        f"{w_dev:.4f} ms of device time (profiled, 10 calls): " + ", ".join(
            f"{k_[:48]} {v_:.4f} ms" for v_, k_ in largest(w_per, 4)))
    rows = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83 "
                     "(flash_attention; _flash_kernel at :30, pallas_call "
                     "at :103)",
         "launches": lm_counts["flash_attention_tc"],
         "max_abs_err": errs["flash_attention"], "ms": ms_f,
         "plain_ms": plain_f, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": lib_f, "cuda_core_floor_ms": f_core,
         "routes": {"bfloat16": "flash_attention_tc (wgmma, TMA)",
                    "float32": "flash_attention (CUDA cores)"},
         "launches_by_route": {r: lm_counts[r] for r in
                               ("flash_attention_tc", "flash_attention")},
         "float32_route_ms": ms_f32, "ms_no_sleep": ms0_f},
        {"name": "wkv_chunked", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv.cu",
         "replaces": "src/repro/kernels/wkv.py:72 (wkv_chunked; _wkv_kernel "
                     "at :27, pallas_call at :81)",
         "launches": lm_counts["wkv_chunked"],
         "max_abs_err": errs["wkv_chunked"], "ms": ms_w, "plain_ms": plain_w,
         "bound_ms": w_tc, "bound_by": w_tc_by, "library_ms": None,
         "ms_no_sleep": ms0_w, "bound_note": "bound_ms: the kernel's three "
         "TF32 passes on the tensor cores; cuda_core_bound_ms: float32 "
         "chunk products on the CUDA cores",
         "cuda_core_bound_ms": w_bound, "cuda_core_bound_by": w_by,
         "device_kernels_per_call": len(w_per),
         "device_ms_by_kernel": {k_[:60]: v_ for k_, (v_, _) in
                                 w_per.items()}}]
    del captured, fargs, wargs, q, k, v, r, k_, v_, lw, u
    log(f"[7] phase 7 walls and checks in {time.perf_counter() - t7:.1f} s")

    def busy_shares():
        """Device kernel time of one decode and one prefill step from
        torch.profiler, over the walls taken above."""
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
                with torch.inference_mode():
                    dev_ms, _, per = device_profile(fn, reps, torch)
                wall_ms = walls[arch, label] * 1e3
                top = largest(per, 3)
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


def phase9_config(arch):
    from repro_torch import configs
    cfg = configs.get(arch)
    return cfg.with_(n_layers=YI_LAYERS) if arch == "yi_34b" else cfg


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that flash's mask keeps: key j for query i when
    i >= j (causal) and i - j < window (window > 0)."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_ref_pieces(q, k, v, torch, *, causal=True, window=0, sm_scale=None,
                     return_lse=False, budget=2**30):
    """``ref.flash_attention_ref`` over batch rows and groups of query
    heads, each piece's float32 scores at most ``budget`` bytes: the plain
    version at shapes whose whole score tensor would not fit the card."""
    from repro_torch.kernels import ref
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    per = max(g, (budget // (4 * sq * sk)) // g * g)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    for i in range(b):
        for h0 in range(0, hq, per):
            h1 = min(hq, h0 + per)
            o_, l_ = ref.flash_attention_ref(
                q[i:i + 1, h0:h1], k[i:i + 1, h0 // g:-(-h1 // g)],
                v[i:i + 1, h0 // g:-(-h1 // g)], causal=causal,
                window=window, sm_scale=sm_scale, return_lse=True)
            out[i:i + 1, h0:h1], lse[i:i + 1, h0:h1] = o_, l_
    return (out, lse) if return_lse else out


def flash_at_shape(q, k, v, kw, path, where, launches, torch, smi, cuda_ms,
                   tag) -> dict:
    """Flash at one call's captured inputs: held to its plain version (run
    in pieces) within 2e-2, timed beside its plain version, SDPA (K/V
    expanded to the query heads; a window as a boolean mask) and its
    bound (the bytes of q, k, v and the output against the operations of
    the unmasked (query, key) pairs on the bf16 tensor cores).  Logs one
    line and returns the kernel row's ``at_shapes`` entry."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from repro_torch.kernels import flash_attention as kflash
    flash = kflash.flash_attention
    dev = q.device
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    got = flash(q, k, v, **kw)
    want = flash_ref_pieces(q, k, v, torch, **kw)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    bad = (got.double() - want.double()).abs() > \
        2e-2 + 2e-2 * want.double().abs()
    if bool(bad.any()):
        fail(f"{tag} flash_attention differs from its plain version at "
             f"{where}'s inputs: max abs err {err:.4g}")
    del got, want
    ms = cuda_ms(lambda: flash(q, k, v, **kw), 20)
    plain = cuda_ms(lambda: flash_ref_pieces(q, k, v, torch, **kw), 2)
    pairs = unmasked_pairs(sq, sk, causal, window)
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    flops = 4 * b * hq * d * pairs
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    bound, by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o
                                      else "operations")
    g = hq // hkv
    kx = k.repeat_interleave(g, 1) if g > 1 else k
    vx = v.repeat_interleave(g, 1) if g > 1 else v
    mask = None
    if window:
        i = torch.arange(sq, device=dev)[:, None]
        j = torch.arange(sk, device=dev)[None, :]
        mask = (i - j < window) & ((i >= j) if causal else True)
    lib_causal = causal and mask is None

    def library():
        return F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask, is_causal=lib_causal)

    backend = SDPBackend(torch._fused_sdp_choice(
        q, kx, vx, mask, 0.0, lib_causal)).name
    torch.testing.assert_close(library().float(), flash(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)
    lib = cuda_ms(library, 10)
    label = (f"B={b} Hq={hq} Hkv={hkv} S={sq}"
             + (f" Sk={sk}" if sk != sq else "")
             + f" D={d} {str(q.dtype)[6:]} causal={causal} window={window}")
    log(f"{tag} flash_attention at {label} ({where}; within 2e-2 of its "
        f"plain version, max abs err {err:.4g}): {ms:.4f} ms (plain "
        f"{plain:.4f} ms over pieces; SDPA {lib:.4f} ms, backend {backend}, "
        + ("the window as a boolean mask" if mask is not None else
           f"{'is_causal' if lib_causal else 'no mask'} with K/V expanded "
           f"to {hq} heads")
        + f"; bound {bound:.5f} ms by {by}: {nbytes / 1e6:.1f} MB at "
        f"3.35 TB/s against {flops / 1e9:.2f} GFLOP over the {pairs} "
        f"unmasked (query, key) pairs at 989 TFLOP/s); {ms / lib:.2f}x "
        f"SDPA, {ms / bound:.2f}x its bound [{smi}]")
    return {"path": path, "shape": label, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "library": f"scaled_dot_product_attention ({backend})"}


def flash_bwd_ref_pieces(q, k, v, out, lse, dout, torch, *, causal=True,
                         window=0, budget=2**28):
    """``ref.flash_attention_bwd_ref`` over batch rows and groups of whole
    KV heads (with their query heads), each piece's float32 scores at
    most ``budget`` bytes: the plain backward at shapes whose score
    tensors would not fit the card."""
    from repro_torch.kernels import ref
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    per = max(1, budget // (4 * sq * sk * g))          # KV heads a piece
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    kw = dict(causal=causal, window=window)
    for i in range(b):
        for h0 in range(0, hkv, per):
            h1 = min(hkv, h0 + per)
            qs = slice(h0 * g, h1 * g)
            a, b_, c = ref.flash_attention_bwd_ref(
                q[i:i + 1, qs], k[i:i + 1, h0:h1], v[i:i + 1, h0:h1],
                out[i:i + 1, qs], lse[i:i + 1, qs], dout[i:i + 1, qs], **kw)
            dq[i:i + 1, qs], dk[i:i + 1, h0:h1], dv[i:i + 1, h0:h1] = a, b_, c
    return dq, dk, dv


def fwd_lse_err(got, want, dtype, torch) -> tuple:
    """The largest errors (of out, of lse) of flash's (out, lse) against its
    plain version's; None past the tolerance: out within flash's (float32 1e-4, bf16 2e-2,
    absolute and relative element by element), lse (float32 on both
    routes) within 1e-4 absolute and relative, -inf (a row whose every key
    is masked) on both sides alike."""
    (out, lse), (w_out, w_lse) = got, want
    t_ = 1e-4 if dtype == torch.float32 else 2e-2
    d_o = (out.double() - w_out.double()).abs()
    if bool((d_o > t_ + t_ * w_out.double().abs()).any()):
        return None
    fin = torch.isfinite(w_lse)
    if not torch.equal(fin, torch.isfinite(lse)) or \
            not torch.equal(lse[~fin], w_lse[~fin]):
        return None
    d_l = (lse[fin].double() - w_lse[fin].double()).abs()
    if bool((d_l > 1e-4 + 1e-4 * w_lse[fin].double().abs()).any()):
        return None
    return (float(d_o.max()) if d_o.numel() else 0.0,
            float(d_l.max()) if d_l.numel() else 0.0)


def misaligned(x, torch):
    """The values of ``x`` (a ``[B, H, S, D]`` view of ``[B, S, H, D]``)
    in the same view one element into a buffer: a base off 16 bytes."""
    b, h, s, d = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(b, s, h, d).transpose(1, 2)
    y.copy_(x)
    return y


def bwd_err(got, want, dtype, torch) -> float:
    """The largest error of ``got`` against ``want`` over dq, dk, dv; fails
    past the tolerance: float32 1e-4 absolute and relative element by
    element, bf16 2e-2 of each tensor's largest magnitude (at least 1)."""
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        e = float(diff.max()) if diff.numel() else 0.0
        if dtype == torch.float32:
            ok = not bool((diff > 1e-4 + 1e-4 * w.double().abs()).any())
        else:
            ok = e <= 2e-2 * max(1.0, float(w.abs().max()))
        if not ok:
            return float("inf")
        err = max(err, e)
    return err


def train_phase(torch, dev, smi, cuda_ms):
    """Phase 11: training.  Flash's forward with lse and its backward
    against their plain versions at ``BWD_SHAPES`` in both dtypes, the
    backward's time beside its bound and SDPA's backward at qwen3's
    training call (K/V repeated to 16 heads, as the main path calls it); the float32 train golden
    (2 layers at full width, flash on its CUDA-core route); qwen3-0.6b
    at full width and depth, bf16, 8 steps of ``launch.train``'s loop on
    one fixed batch of 8 x 1,024 (the main path, counted); the restart
    check at full width cut to 2 layers.  Returns (the backward's kernel
    row, flash's forward launches in the training run, a function that
    profiles one full-depth step, to run after every wall)."""
    import shutil
    import tempfile
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.data import pipeline
    from repro_torch.launch import train, train_golden as TG
    from repro_torch.models import convert
    from repro_torch.models.config import ShapeSpec

    t11 = time.perf_counter()
    # ---- (1) the forward's lse and the backward against their plain
    # versions, both dtypes
    gen = torch.Generator(dev).manual_seed(24)
    errs, f_errs, timed, routes, n_masked = {}, {}, {}, {}, {}
    for label, (b, hq, hkv, sq, sk, d, causal, window) in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(h, n):
                return torch.randn((b, n, h, d), generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype) \
                    .transpose(1, 2)
            q, k, v, dout = rnd(hq, sq), rnd(hkv, sk), rnd(hkv, sk), \
                rnd(hq, sq)
            if label in BWD_STAGED:
                q, k, v, dout = (misaligned(x, torch) for x in (q, k, v,
                                                                dout))
                if kflash.tma_strides(dout)[1]:
                    fail(f"[11] {label}: TMA would take dO")
            kw = dict(causal=causal, window=window)
            out, lse = kflash.flash_attention(q, k, v, return_lse=True, **kw)
            e = fwd_lse_err((out, lse), flash_ref_pieces(
                q, k, v, torch, return_lse=True, **kw), dtype, torch)
            if e is None:
                fail(f"[11] flash_attention's out or lse differs from its "
                     f"plain version at {label}, {dtype}")
            f_errs[label, str(dtype)[6:]] = e
            if label == "qwen3-0.6b training" and not torch.equal(
                    out, kflash.flash_attention(q, k, v, **kw)):
                fail(f"[11] flash_attention's output with lse differs from "
                     f"its output without at {label}, {dtype}")
            route = kflash.bwd_route(dtype, d)
            before = ops.launch_counts()
            got = kflash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want = flash_bwd_ref_pieces(q, k, v, out, lse, dout, torch, **kw)
            again = kflash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            ran = {k_: n - before[k_] for k_, n in ops.launch_counts().items()
                   if n != before[k_] and k_.startswith(kflash.BWD)}
            if ran != {route: 2}:
                fail(f"[11] flash_attention_bwd at {label}, {dtype} launched "
                     f"{ran}, expected two on {route}")
            routes[label, str(dtype)[6:]] = route
            e = bwd_err(got, want, dtype, torch)
            if e == float("inf"):
                fail(f"[11] flash_attention_bwd differs from its plain "
                     f"version at {label}, {dtype}")
            masked = ~torch.isfinite(lse)
            if not all(bool(torch.isfinite(x).all()) for x in got) or \
                    bool((got[0][masked] != 0).any()):
                fail(f"[11] flash_attention_bwd at {label}, {dtype}: a "
                     f"gradient is not finite or a wholly masked row's dq "
                     f"is not 0")
            n_masked[label] = int(masked.sum())
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"[11] flash_attention_bwd is not deterministic at "
                     f"{label}, {dtype}")
            if any(x.stride() != y.stride() for x, y in zip(got, (q, k, v))):
                fail(f"[11] flash_attention_bwd's gradients are not in the "
                     f"layouts of q, k, v at {label}")
            errs[label, str(dtype)[6:]] = e
            if label == "qwen3-0.6b training":
                timed[dtype] = (q, k, v, out, lse, dout, kw)
            del got, want, again
    log(f"[11] flash_attention with lse within tolerance of its plain "
        f"version (out: float32 1e-4, bf16 2e-2 per element; lse 1e-4 per "
        f"element, -inf rows alike), its output bit-equal with and without "
        f"lse at qwen3-0.6b's training call, at "
        + "; ".join(f"{lb} {dt} (max abs err out {e[0]:.3g}, lse "
                    f"{e[1]:.3g})" for (lb, dt), e in f_errs.items()))
    log(f"[11] flash_attention_bwd within tolerance of its plain version "
        f"(float32 1e-4 per element, bf16 2e-2 of the largest magnitude) "
        f"and bit-equal between two runs, dq/dk/dv in the layouts of q/k/v, "
        f"every gradient finite and dq 0 on the wholly masked rows "
        f"({ {lb: n for lb, n in n_masked.items() if n} }), at "
        + "; ".join(f"{lb} {dt} on {routes[lb, dt]} (max abs err {e:.3g})"
                    for (lb, dt), e in errs.items()))
    # its time at qwen3's training shape beside its bound and SDPA's
    b, hq, hkv, sq, sk, d, causal, window = dict(BWD_SHAPES)[
        "qwen3-0.6b training"]
    pairs = unmasked_pairs(sq, sk, causal, window)
    flops = 10 * b * hq * pairs * d
    times = {}
    for dtype, (q, k, v, out, lse, dout, kw) in timed.items():
        esz = q.element_size()
        # q, O, dO read and dq written; k, v read and dk, dv written; lse
        nbytes = (4 * b * hq * sq * d + 4 * b * hkv * sk * d) * esz \
            + 4 * b * hq * sq
        # the card's peak for the dtype: bf16 on the tensor cores (its
        # route at D = 128), float32 outside them
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        ms = cuda_ms(lambda: kflash.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw), 10)
        plain = cuda_ms(lambda: flash_bwd_ref_pieces(
            q, k, v, out, lse, dout, torch, **kw), 2)
        qx, kx, vx = (t.detach().clone().requires_grad_()
                      for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qx, kx, vx, is_causal=causal)
        lib = cuda_ms(lambda: torch.autograd.grad(
            sdpa, (qx, kx, vx), dout, retain_graph=True), 10)
        times[dtype] = (ms, plain, lib, max(t_b, t_o) * 1e3,
                        "bytes" if t_b >= t_o else "operations", nbytes)
        log(f"[11] flash_attention_bwd ({kflash.bwd_route(dtype, d)}) at "
            f"B={b} Hq={hq} Hkv={hkv} S={sq} "
            f"D={d} {str(dtype)[6:]} causal: {ms:.4f} ms (plain "
            f"{plain:.4f} ms over pieces; SDPA's backward {lib:.4f} ms, "
            f"is_causal; bound {times[dtype][3]:.5f} ms by "
            f"{times[dtype][4]}: {nbytes / 1e6:.1f} MB at 3.35 TB/s against "
            f"{flops / 1e9:.2f} GFLOP (10 x B x Hq x {pairs} unmasked pairs "
            f"x D) at {peak / 1e12:.0f} TFLOP/s, the card's {str(dtype)[6:]} "
            f"peak); "
            f"{ms / lib:.2f}x SDPA's backward, "
            f"{ms / times[dtype][3]:.2f}x its bound [{smi}]")
    del timed, q, k, v, out, lse, dout, qx, kx, vx, sdpa
    torch.cuda.empty_cache()

    # ---- (2) the float32 train golden: flash on its CUDA-core route
    gold = json.loads(TRAIN_GOLDEN.read_text())
    if gold["run"] != TG.run_record():
        fail(f"{TRAIN_GOLDEN.name} was written for another run")
    t = time.perf_counter()
    tree = convert.random_jax_tree(TG.golden_config(), TG.SEED)
    if convert.tree_sha256(tree) != gold["weights_sha256"]:
        fail("[11] the golden's seeded weights differ on this machine")
    ops.reset_launches()
    got = TG.port_run(dev, tree)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    del tree
    rtol = gold["tolerance"]["rtol"]
    worst = hold_train_golden(got, gold, "[11]")
    n_fwd = TG.LAYERS * (TG.STEPS + 1)
    if counts["flash_attention"] != n_fwd or \
            counts[kflash.BWD] != n_fwd or counts["flash_attention_tc"] or \
            counts[kflash.BWD_TC] or counts[kflash.BWD_WIDE]:
        fail(f"[11] the float32 golden's flash launches {counts}, expected "
             f"{n_fwd} CUDA-core forwards and {n_fwd} CUDA-core backwards")
    log(f"[11] float32 train golden (qwen3-0.6b full width, {TG.LAYERS} "
        f"layers, {TG.B} x {TG.S}, loss and grads then {TG.STEPS} AdamW "
        f"steps) within {rtol} of {TRAIN_GOLDEN.name}: max rel err "
        f"{worst:.3g} (CPU {gold['tolerance']['cpu_max_rel_err']:.3g}); "
        f"losses {[round(x, 5) for x in got['loss']]}; flash "
        f"{counts['flash_attention']} CUDA-core forwards and "
        f"{counts['flash_attention_bwd']} backwards "
        f"({time.perf_counter() - t:.1f} s)")

    # ---- (3) qwen3-0.6b at full width and depth, bf16, the main path
    cfg = configs.get("qwen3_0p6b")
    t = time.perf_counter()
    loop, _ = train.build(cfg, batch=TRAIN_B, seq=TRAIN_S, lr=1e-3,
                          steps=TRAIN_STEPS, device=dev, ckpt_every=0)
    batch = pipeline.to_device(pipeline.SyntheticLM(
        cfg, ShapeSpec("cli", TRAIN_S, TRAIN_B, "train"), seed=0)
        .host_batch(step=0), dev)
    step_fn = loop.train_step
    walls, per_step, seen = [], [], {}

    def timed_step(model, opt, batch):
        seen["lm"] = model
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        per_step.append({k_: after[k_] - before[k_] for k_ in after
                         if after[k_] != before[k_]})
        return out

    loop.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    summary = loop.run(lambda _d: batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [x for _, x in loop.history]
    n_par = sum(p_.numel() for p_ in seen["lm"].parameters())
    L = cfg.n_layers
    want_counts = {"flash_attention_tc": L * TRAIN_STEPS,
                   kflash.BWD_TC: L * TRAIN_STEPS, kflash.BWD: 0,
                   kflash.BWD_WIDE: 0, "flash_attention": 0,
                   "wkv_chunked": 0}
    if {k_: counts[k_] for k_ in want_counts} != want_counts or any(
            s_.get("flash_attention_tc") != L or
            s_.get(kflash.BWD_TC) != L for s_ in per_step):
        fail(f"[11] launches in training {counts} (per step {per_step}), "
             f"expected {want_counts}: {L} tensor-core forwards and {L} "
             f"tensor-core backwards every step, no wkv_chunked")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) or \
            not losses[-1] < losses[0] or summary["bad_steps"]:
        fail(f"[11] qwen3-0.6b training: losses {losses}, summary {summary}: "
             f"expected {TRAIN_STEPS} finite losses that fall")
    med = statistics.median(walls[1:])
    log(f"[11] qwen3-0.6b training at full width and depth ({L} layers, "
        f"d={cfg.d_model}, {n_par / 1e9:.3f} G parameters in bf16, AdamW "
        f"with float32 master weights), "
        f"{TRAIN_STEPS} steps of launch.train's loop on one fixed batch of "
        f"{TRAIN_B} x {TRAIN_S} ({time.perf_counter() - t:.1f} s with the "
        f"init): losses {[round(x, 4) for x in losses]}, falling; launches "
        f"{ {k_: counts[k_] for k_ in want_counts} } ({L} flash forwards and "
        f"{L} backwards on the tensor cores every step, no wkv_chunked); step "
        f"walls {[round(w * 1e3, 1) for w in walls]} ms, median of steps "
        f"1-{TRAIN_STEPS - 1} {med * 1e3:.2f} ms, "
        f"{TRAIN_B * TRAIN_S / med:.0f} tokens/s; peak device memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) [{smi}]")
    del loop, step_fn, seen
    torch.cuda.empty_cache()

    # ---- (4) the restart check at full width, 2 layers
    t = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_restart_"))
    try:
        cfg2 = cfg.with_(n_layers=2)
        runs = {}
        for name, fail_at in (("clean", None), ("faulty", RESTART_FAIL_AT)):
            loop, make_batch = train.build(
                cfg2, batch=RESTART_B, seq=RESTART_S, lr=1e-3,
                steps=RESTART_STEPS, device=dev, ckpt_dir=str(root / name),
                ckpt_every=RESTART_EVERY, inject_failure_at=fail_at)
            summ = loop.run(make_batch, RESTART_STEPS)
            runs[name] = (summ, dict(loop.history), len(loop.history))
            del loop, make_batch
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (c_sum, c_hist, _), (f_sum, f_hist, f_len) = runs["clean"], \
        runs["faulty"]
    diff = max(abs(c_hist[s_] - f_hist[s_]) / abs(c_hist[s_])
               for s_ in c_hist)
    if f_sum["restarts"] != 1 or c_sum["restarts"] or \
            sorted(f_hist) != sorted(c_hist) or diff > 1e-5:
        fail(f"[11] restart check: clean {c_sum} {c_hist}, faulty {f_sum} "
             f"{f_hist}")
    log(f"[11] restart check (qwen3-0.6b full width, 2 layers, bf16, "
        f"{RESTART_B} x {RESTART_S}, checkpoint every {RESTART_EVERY} steps, "
        f"a failure injected at step {RESTART_FAIL_AT}, {RESTART_STEPS} "
        f"steps): restarted once from step "
        f"{RESTART_FAIL_AT // RESTART_EVERY * RESTART_EVERY}'s checkpoint, "
        f"{f_len} steps run; every step's loss equals the clean run's "
        + ("to the bit" if diff == 0 else f"within {diff:.3g} relative")
        + f" (final {f_sum['final_loss']:.6f}); temporary directory removed "
        f"({time.perf_counter() - t:.1f} s)")
    log(f"[11] phase 11 in {time.perf_counter() - t11:.1f} s")

    ms, plain, lib, bound, by, _ = times[torch.bfloat16]
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "kernel_route": f"{kflash.BWD_TC}: bf16 at D <= 128 on the tensor "
                           f"cores (wgmma, TMA); {kflash.BWD_WIDE} (bf16, D > "
                           f"128) and {kflash.BWD} (float32) on the CUDA "
                           f"cores",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "no TPU kernel: XLA autodiff of "
                       "src/repro/models/attention.py:237 (_sdpa) in the "
                       "reference's training",
           "launches": counts[kflash.BWD_TC],
           "launches_by_route": {r: counts[r] for r in (
               kflash.BWD_TC, kflash.BWD_WIDE, kflash.BWD)},
           "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "library_ms": lib,
           "library": "scaled_dot_product_attention backward",
           "shape": "B=8 Hq=16 Hkv=16 (qwen3-0.6b's 8 KV heads repeated) "
                    "S=1024 D=128 bfloat16 causal",
           "float32": dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by"), times[torch.float32][:5])),
           "launches_per_step": L,
           "max_abs_err_by_shape": {f"{lb} {dt}": e for (lb, dt), e in
                                    errs.items()},
           "forward_lse_max_abs_err": max(e[1] for e in f_errs.values())}

    def busy():
        """Device kernel time of one full-depth training step from
        torch.profiler over the unprofiled median wall, the backward
        kernel's share, the largest kernels."""
        loop, _ = train.build(cfg, batch=TRAIN_B, seq=TRAIN_S, lr=1e-3,
                              steps=TRAIN_STEPS, device=dev, ckpt_every=0)
        lm, opt, _ = loop.init_state()
        for _ in range(2):
            lm, opt, _ = loop.train_step(lm, opt, batch)
        torch.cuda.synchronize()
        dev_ms, kernels, per = device_profile(
            lambda: loop.train_step(lm, opt, batch), 1, torch)
        if dev_ms <= 0:
            log("[11] qwen3-0.6b training step: device time not measured "
                "(profiler saw no device time)")
            return
        bwd = sum(v_ for key, (v_, _) in per.items()
                  if any(n_ in key for n_ in BWD_KERNELS))
        if not bwd:
            fail(f"[11] the training step's profile shows none of flash's "
                 f"backward kernels {BWD_KERNELS}")
        # the backward by kernel: ms a step and a launch
        bwd_by = {n_: [sum(x[i] for key, x in per.items() if n_ in key)
                       for i in (0, 1)] for n_ in BWD_KERNELS}
        fwd = sum(v_ for key, (v_, _) in per.items()
                  if "flash_tc_kernel" in key)
        # cuBLAS's products (sm90 xmma / nvjet / cutlass kernels) and the
        # optimizer's foreach passes
        gemm = sum(v_ for key, (v_, _) in per.items()
                   if any(t_ in key for t_ in ("gemm", "nvjet", "xmma",
                                               "cutlass")))
        adam = sum(v_ for key, (v_, _) in per.items()
                   if "multi_tensor_apply" in key)
        log(f"[11] qwen3-0.6b training step ({TRAIN_B} x {TRAIN_S}, bf16, "
            f"{L} layers): {dev_ms:.3f} ms device kernel time (profiled, "
            f"{kernels:.0f} kernels) "
            f"over {med * 1e3:.3f} ms wall (unprofiled median): device busy "
            f"{100 * dev_ms / (med * 1e3):.1f}%; flash's backward "
            f"{bwd:.3f} ms ({100 * bwd / dev_ms:.1f}% of the device time; "
            + ", ".join(f"{n_} {ms_:.3f} ms, {ms_ / c_:.4f} a launch"
                        for n_, (ms_, c_) in bwd_by.items() if c_)
            + "), "
            f"its forward {fwd:.3f} ms, the matrix products {gemm:.3f} ms, "
            f"AdamW's foreach passes {adam:.3f} ms, the rest "
            f"{dev_ms - bwd - fwd - gemm - adam:.3f} ms; largest: "
            + ", ".join(
                f"{k_[:48]} {v_:.3f} ms" for v_, k_ in largest(per, 6))
            + f" [{smi}]")
        del loop, lm, opt
        torch.cuda.empty_cache()

    return row, counts["flash_attention_tc"], busy


def hold_train_golden(got, gold, tag) -> float:
    """The worst relative error of a ``train_golden.port_run`` record
    against the golden's; fails past its rtol."""
    rtol = gold["tolerance"]["rtol"]
    want = gold["record"]
    worst = 0.0
    for key in ("loss0", "ce0", "grad_norm0", "loss", "ce", "grad_norm",
                "leaf_grad_norms"):
        a, w = got[key], want[key]
        if key == "leaf_grad_norms":
            if sorted(a) != sorted(w):
                fail(f"{tag} the golden's gradient leaves differ")
            a, w = [a[x] for x in sorted(w)], [w[x] for x in sorted(w)]
        a, w = (list(x) if isinstance(x, list) else [x] for x in (a, w))
        for x, y in zip(a, w):
            rel = abs(x - y) / max(abs(y), 1e-30)
            worst = max(worst, rel)
            if not rel <= rtol:
                fail(f"{tag} train golden {key}: {x} against {y} (rel "
                     f"{rel:.3g} > {rtol})")
    return worst


def wkv_bwd_case(shape, dtype, gen, torch, dev):
    """The backward's inputs at one of ``WKV_BWD_SHAPES``: r, k, v (in
    ``dtype``), log w and the output's gradient as [B, H, S, D] views of
    [B, S, H*D] tensors (one element off 16 bytes where the shape asks),
    u, and the initial state and the final state's gradient (or None)."""
    b, h, s, d, chunk, extras, strong, off16 = shape

    def rnd(scale):
        return torch.randn((b, s, h * d), generator=gen, device=dev) * scale

    def view(x):
        return x.view(b, s, h, d).transpose(1, 2)
    r, k, v = (view(rnd(0.5).to(dtype)) for _ in range(3))
    lw = view(-2.5 * torch.exp(rnd(0.05)) if strong
              else -torch.exp(rnd(0.5) - 2))
    go = view(rnd(1.0))
    u = torch.randn((h, d), generator=gen, device=dev) * 0.1
    if off16:
        r, k, v, lw, go = (misaligned(x, torch) for x in (r, k, v, lw, go))
    s0 = ds = None
    if extras:
        s0 = torch.randn((b, h, d, d), generator=gen, device=dev) * 0.1
        ds = torch.randn((b, h, d, d), generator=gen, device=dev)
    return r, k, v, lw, u, s0, go, ds


def wkv_bwd_errs(got, want) -> list:
    """Each of the backward's outputs' largest error over the plain
    version's largest magnitude (inf where one is not finite)."""
    out = []
    for g, w in zip(got, want):
        e = float((g.double() - w.double()).abs().max())
        scale = float(w.double().abs().max())
        out.append(e / scale if scale > 0 else e)
    return [x if math.isfinite(x) else float("inf") for x in out]


def rwkv_train_phase(torch, dev, smi, cuda_ms, ptxas_log: str = ""):
    """Phase 12: rwkv training.  The WKV backward kernel against its plain
    version at ``WKV_BWD_SHAPES`` in both dtypes (the forward with and
    without its saved states), its time beside its bounds at rwkv6-3b's
    training call; the float32 golden of rwkv6-3b at full width, 2
    layers; rwkv6-3b at full width and depth, bf16, 8 steps of
    ``launch.train``'s loop on one fixed batch of 8 x 1,024 (the main
    path, counted).  Returns (the backward's kernel row, the WKV
    forward's launches in the training run, a function that profiles one
    full-depth step, to run after every wall).  ``ptxas_log``: the
    compiler's output for ``wkv_bwd`` (``build.build_all``), for the
    kernels' registers and spills."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import train, train_golden as TG
    from repro_torch.models import convert
    from repro_torch.models.config import ShapeSpec

    t12 = time.perf_counter()
    # ---- (a) the backward against its plain version, both dtypes
    gen = torch.Generator(dev).manual_seed(27)
    errs, rels, timed = {}, {}, None
    for label, shape in WKV_BWD_SHAPES:
        chunk = shape[4]
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype)[6:]
            r, k, v, lw, u, s0, go, ds = wkv_bwd_case(shape, dtype, gen,
                                                      torch, dev)
            kw = dict(chunk=chunk, state0=s0)
            out, st = kwkv.wkv_chunked(r, k, v, lw, u, **kw)
            out2, st2, states = kwkv.wkv_chunked(r, k, v, lw, u, **kw,
                                                 return_states=True)
            if not (torch.equal(out, out2) and torch.equal(st, st2)):
                fail(f"[12] wkv_chunked's output or final state differs "
                     f"with and without its saved states at {label}, {dt}")
            want_states = ref.wkv_chunked_ref(r, k, v, lw, u, **kw,
                                              return_states=True)[2]
            if bool(((states - want_states).abs() >
                     1e-4 + 1e-3 * want_states.abs()).any()):
                fail(f"[12] wkv_chunked's saved states differ from the "
                     f"plain version's at {label}, {dt}")
            before = ops.launch_counts()[kwkv.BWD]
            got = kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go, ds,
                                       st2, chunk=chunk)
            again = kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go, ds,
                                         st2, chunk=chunk)
            want = ref.wkv_chunked_bwd_ref(r, k, v, lw, u, states, go, ds,
                                           chunk=chunk)
            torch.cuda.synchronize()
            if ops.launch_counts()[kwkv.BWD] != before + 2:
                fail(f"[12] wkv_chunked_bwd at {label}, {dt} counted "
                     f"{ops.launch_counts()[kwkv.BWD] - before} launches "
                     f"for two calls")
            rel = wkv_bwd_errs(got, want)
            tols = [WKV_BWD_TOL[str(g.dtype)[6:]] for g in got]
            if not all(e <= t for e, t in zip(rel, tols)):
                fail(f"[12] wkv_chunked_bwd differs from its plain version "
                     f"at {label}, {dt}: relative errors (dr, dk, dv, "
                     f"dlog_w, du, dstate0) {rel} against {tols}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"[12] wkv_chunked_bwd is not deterministic at "
                     f"{label}, {dt}")
            if any(x.stride() != y.stride() or x.dtype != y.dtype
                   for x, y in zip(got[:4], (r, k, v, lw))):
                fail(f"[12] wkv_chunked_bwd's dr, dk, dv, dlog_w are not in "
                     f"the layouts and dtypes of r, k, v, log_w at {label}")
            errs[label, dt] = max_abs_err(got, want, torch)
            rels[label, dt] = rel
            if label == WKV_BWD_SHAPES[0][0] and dtype == torch.bfloat16:
                timed = (r, k, v, lw, u, states, go, chunk)
            del r, k, v, lw, u, s0, go, ds, out, st, out2, st2, states, \
                want_states, got, again, want
    log(f"[12] wkv_chunked's output and final state bit-equal with and "
        f"without its saved states (within atol 1e-4, rtol 1e-3 of the "
        f"plain forward's), and wkv_chunked_bwd within {WKV_BWD_TOL} of "
        f"each gradient's largest magnitude (bf16 for dr, dk, dv of bf16 "
        f"inputs) and bit-equal between two runs, in the layouts of r, k, "
        f"v, log w, at "
        + "; ".join(f"{lb} {dt} (relative dr, dk, dv, dlog_w, du, dstate0 "
                    f"{', '.join(f'{x:.2g}' for x in rels[lb, dt])})"
                    for lb, dt in rels))

    # ---- (b) its time at the training call beside its bounds
    r, k, v, lw, u, states, go, chunk = timed
    b, h, s, d = r.shape

    def bwd():
        return kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go, chunk=chunk)
    ms = cuda_ms(bwd, 10)
    ms0 = cuda_ms(bwd, 10, sleep=False)
    plain = cuda_ms(lambda: ref.wkv_chunked_bwd_ref(
        r, k, v, lw, u, states, go, chunk=chunk), 2)
    fwd_states = cuda_ms(lambda: kwkv.wkv_chunked(
        r, k, v, lw, u, chunk=chunk, return_states=True), 10)
    fwd = cuda_ms(lambda: kwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk), 10)
    n, esz = r.numel(), r.element_size()
    # read: r, k, v, log w, dO, the states, u; written: dr, dk, dv,
    # dlog w, du, dstate0
    nbytes = (3 * n * esz + 2 * n * 4 + states.numel() * 4 + h * d * 4
              + 3 * n * esz + n * 4 + h * d * 4 + b * h * d * d * 4)
    # the chunk products: five of C x C x D below the diagonal (A, dA,
    # A^T dO, dA k', dA^T r') and four of C x D x D
    flops = b * h * (s // chunk) * (5 * chunk * (chunk - 1) * d
                                    + 8 * chunk * d * d)
    # the kernels run the products as three TF32 passes on the tensor cores
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_OPS_PER_S
    bound, by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
    # the float32 CUDA-core floor of the same products
    core = max(t_b, flops / F32_OPS_PER_S) * 1e3
    # a note on the design, not a bound: the bytes its four kernels move
    # (kernel 1 reads log w, r, dO and writes each chunk's P into the G
    # scratch; the scan reads P and the states and writes G; the chunk
    # kernel reads r, k, v, log w, dO, the states and G and writes dr, dk,
    # dv, dlog w; the [B, H, S/C, D] scratch written and read once)
    nc = s // chunk
    scratch = states.numel() * 4
    design_bytes = (n * (8 + esz) + scratch           # 1
                    + 3 * scratch                     # scan: P, states, G
                    + n * (6 * esz + 12) + 2 * scratch  # chunks
                    + 2 * 3 * b * h * nc * d * 4      # e^L, gL, du's parts
                    + h * d * 4 + h * d * 4 + b * h * d * d * 4)
    ctas = kwkv.bwd_occupancy(r.dtype, d)
    occ = {k_: {"ctas_per_sm": ctas[k_],
                "registers_spill_bytes": ptxas_usage(
                    ptxas_log, k_, "ILi64E" if k_ == "wkv_bwd_dstate"
                    else "I13__nv_bfloat16Li64E" if k_ != "wkv_du_sum"
                    else "wkv_du_sum") or "not reported (a cached build)"}
           for k_ in WKV_BWD_KERNELS}
    log(f"[12] wkv_chunked_bwd at B={b} H={h} S={s} D={d} chunk={chunk} "
        f"bfloat16 r/k/v ([B, S, {h * d}] views), float32 log w and dO: "
        f"{ms:.4f} ms ({ms0:.4f} ms back to back; plain {plain:.4f} ms; "
        f"library call: none); bound {bound:.5f} ms by {by}: "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s ({t_b * 1e3:.5f} ms) against "
        f"3 x {flops / 1e9:.2f} GFLOP of chunk products at the TF32 495 "
        f"TFLOP/s ({t_o * 1e3:.5f} ms), {ms / bound:.2f}x its bound; the "
        f"float32 CUDA-core floor at 67 TFLOP/s {core:.5f} ms; the four "
        f"kernels move {design_bytes / 1e6:.1f} MB (the G scratch, the "
        f"states and r, log w, dO read twice; {design_bytes / 1e6 / ms:.0f}"
        f" GB/s); occupancy (CTAs an SM, registers and spill bytes, bf16 D=64) "
        f"{occ}; the forward at this call {fwd:.4f} ms, with its saved "
        f"states ({states.numel() * 4 / 1e6:.1f} MB) {fwd_states:.4f} ms "
        f"[{smi}]")
    del timed, r, k, v, lw, u, states, go
    torch.cuda.empty_cache()

    # ---- (c) the float32 golden of rwkv6-3b at full width, 2 layers
    arch = "rwkv6_3b"
    gold = json.loads(RWKV_GOLDEN.read_text())
    if gold["run"] != TG.run_record(arch):
        fail(f"{RWKV_GOLDEN.name} was written for another run")
    t = time.perf_counter()
    tree = convert.random_jax_tree(TG.golden_config(arch), TG.SEED)
    if convert.tree_sha256(tree) != gold["weights_sha256"]:
        fail("[12] the golden's seeded weights differ on this machine")
    ops.reset_launches()
    got = TG.port_run(dev, tree, arch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    del tree
    worst = hold_train_golden(got, gold, "[12]")
    passes = TG.STEPS + 1
    flash = {k_: n_ for k_, n_ in counts.items()
             if k_.startswith("flash") and n_}
    if counts["wkv_chunked"] != 2 * TG.LAYERS * passes or \
            counts[kwkv.BWD] != TG.LAYERS * passes or flash:
        fail(f"[12] the float32 golden's launches {counts}, expected "
             f"{2 * TG.LAYERS * passes} WKV forwards (two a layer under "
             f"remat 'full') and {TG.LAYERS * passes} backwards, no flash")
    log(f"[12] float32 train golden (rwkv6-3b full width, {TG.LAYERS} "
        f"layers, {TG.B} x {TG.S}, loss and grads then {TG.STEPS} AdamW "
        f"steps) within {gold['tolerance']['rtol']} of {RWKV_GOLDEN.name}: "
        f"max rel err {worst:.3g} (CPU "
        f"{gold['tolerance']['cpu_max_rel_err']:.3g}); losses "
        f"{[round(x, 5) for x in got['loss']]}; wkv_chunked "
        f"{counts['wkv_chunked']} forwards and {counts[kwkv.BWD]} backwards "
        f"({time.perf_counter() - t:.1f} s)")

    # ---- (d) rwkv6-3b at full width, bf16, the main path
    cfg = configs.get(arch).with_(n_layers=RWKV_TRAIN_LAYERS)
    t = time.perf_counter()
    loop, _ = train.build(cfg, batch=TRAIN_B, seq=TRAIN_S, lr=1e-3,
                          steps=TRAIN_STEPS, device=dev, ckpt_every=0)
    batch = pipeline.to_device(pipeline.SyntheticLM(
        cfg, ShapeSpec("cli", TRAIN_S, TRAIN_B, "train"), seed=0)
        .host_batch(step=0), dev)
    step_fn = loop.train_step
    walls, per_step, seen = [], [], {}

    def timed_step(model, opt, batch):
        seen["lm"] = model
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        per_step.append({k_: after[k_] - before[k_] for k_ in after
                         if after[k_] != before[k_]})
        return out

    loop.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    summary = loop.run(lambda _d: batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [x for _, x in loop.history]
    n_par = sum(p_.numel() for p_ in seen["lm"].parameters())
    L = cfg.n_layers
    want_counts = {"wkv_chunked": 2 * L * TRAIN_STEPS,
                   kwkv.BWD: L * TRAIN_STEPS, "flash_attention": 0,
                   "flash_attention_tc": 0, kflash.BWD: 0,
                   kflash.BWD_TC: 0, kflash.BWD_WIDE: 0}
    if {k_: counts[k_] for k_ in want_counts} != want_counts or any(
            s_.get("wkv_chunked") != 2 * L or s_.get(kwkv.BWD) != L
            for s_ in per_step):
        fail(f"[12] launches in rwkv training {counts} (per step "
             f"{per_step}), expected {want_counts}: {2 * L} WKV forwards "
             f"(remat 'full' runs each block twice) and {L} backwards every "
             f"step, no flash")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) or \
            not losses[-1] < losses[0] or summary["bad_steps"]:
        fail(f"[12] rwkv6-3b training: losses {losses}, summary {summary}: "
             f"expected {TRAIN_STEPS} finite losses that fall")
    med = statistics.median(walls[1:])
    log(f"[12] rwkv6-3b training at full width ({L} of "
        f"{configs.get(arch).n_layers} layers, d={cfg.d_model}, "
        f"{n_par / 1e9:.3f} G parameters in bf16, AdamW with float32 master "
        f"weights, remat 'full'), {TRAIN_STEPS} steps of launch.train's "
        f"loop on one fixed batch of {TRAIN_B} x {TRAIN_S} "
        f"({time.perf_counter() - t:.1f} s with the init): losses "
        f"{[round(x, 4) for x in losses]}, falling; launches "
        f"{ {k_: counts[k_] for k_ in want_counts} } ({2 * L} WKV forwards "
        f"and {L} backwards every step, no flash); step walls "
        f"{[round(w * 1e3, 1) for w in walls]} ms, median of steps "
        f"1-{TRAIN_STEPS - 1} {med * 1e3:.2f} ms, "
        f"{TRAIN_B * TRAIN_S / med:.0f} tokens/s; peak device memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) [{smi}]")
    del loop, step_fn, seen
    torch.cuda.empty_cache()
    log(f"[12] phase 12 in {time.perf_counter() - t12:.1f} s")

    row = {"name": "wkv_chunked_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/wkv_bwd.cu",
           "replaces": "no TPU kernel: XLA autodiff of "
                       "src/repro/models/rwkv.py:131 (wkv_chunked, the "
                       "chunk scan) in the reference's training",
           "launches": counts[kwkv.BWD],
           "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "library": "none: no single PyTorch call computes it",
           "shape": f"B={b} H={h} S={s} D={d} chunk={chunk} bfloat16 "
                    f"r/k/v ([B, S, {h * d}] views), float32 log w and dO",
           "ms_no_sleep": ms0, "bytes": nbytes, "flops": flops,
           "bound_note": "bound_ms: the function's bytes against three "
           "TF32 passes of its products on the tensor cores; "
           "cuda_core_bound_ms: the products in float32 on the CUDA cores; "
           "design_bytes: what the four device kernels move",
           "cuda_core_bound_ms": core, "design_bytes": design_bytes,
           "occupancy": occ,
           "launches_per_step": L,
           "forward_ms": fwd, "forward_with_states_ms": fwd_states,
           "max_rel_err_by_shape": {f"{lb} {dt}": max(e) for (lb, dt), e in
                                    rels.items()}}

    def by_kernel_ms():
        """Each of the WKV backward's device kernels a call at the training
        call (three calls profiled, up to five sessions), into the kernel
        row."""
        g2 = torch.Generator(dev).manual_seed(27)
        r, k, v, lw, u, _, go, _ = wkv_bwd_case(WKV_BWD_SHAPES[0][1],
                                                torch.bfloat16, g2, torch,
                                                dev)
        states = kwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk,
                                  return_states=True)[2]
        kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go, chunk=chunk)
        dev_ms, _, per = device_profile(lambda: kwkv.wkv_chunked_bwd(
            r, k, v, lw, u, states, go, chunk=chunk), 3, torch, tries=5)
        del r, k, v, lw, u, go, states
        torch.cuda.empty_cache()
        if dev_ms <= 0:
            log("[12] wkv_chunked_bwd's device kernels: not measured (the "
                "profiler saw no device time)")
            return
        ms_by = {k_: round(sum(x[0] for key, x in per.items() if k_ in key),
                           5) for k_ in WKV_BWD_KERNELS}
        if not all(ms_by.values()):
            fail(f"[12] one call of wkv_chunked_bwd did not run its device "
                 f"kernels {WKV_BWD_KERNELS}: {per}")
        row["device_ms_by_kernel"] = ms_by
        log(f"[12] wkv_chunked_bwd at the training call, each device "
            f"kernel a call (profiled): {ms_by} ms, {dev_ms:.4f} ms in all "
            f"[{smi}]")

    def busy():
        """Device kernel time of one rwkv6-3b training step from
        torch.profiler over the unprofiled median wall, the WKV forward's
        and backward's shares, the largest kernels; ``by_kernel_ms``
        first."""
        by_kernel_ms()
        loop, _ = train.build(cfg, batch=TRAIN_B, seq=TRAIN_S, lr=1e-3,
                              steps=TRAIN_STEPS, device=dev, ckpt_every=0)
        lm, opt, _ = loop.init_state()
        for _ in range(2):
            lm, opt, _ = loop.train_step(lm, opt, batch)
        torch.cuda.synchronize()
        dev_ms, kernels, per = device_profile(
            lambda: loop.train_step(lm, opt, batch), 1, torch)
        if dev_ms <= 0:
            log("[12] rwkv6-3b training step: device time not measured "
                "(profiler saw no device time)")
            return

        def share(names):
            return [sum(x[i] for key, x in per.items()
                        if any(n_ in key for n_ in names)) for i in (0, 1)]
        (f_ms, f_n), (b_ms, b_n) = share(WKV_FWD_KERNELS), \
            share(WKV_BWD_KERNELS)
        if not f_ms or not b_ms:
            fail(f"[12] the rwkv training step's profile lacks the WKV "
                 f"kernels {WKV_FWD_KERNELS + WKV_BWD_KERNELS}")
        gemm = share(("gemm", "nvjet", "xmma", "cutlass"))[0]
        adam = share(("multi_tensor_apply",))[0]
        log(f"[12] rwkv6-3b training step ({TRAIN_B} x {TRAIN_S}, bf16, {L} "
            f"layers): {dev_ms:.3f} ms device kernel time (profiled, "
            f"{kernels:.0f} kernels) over {med * 1e3:.3f} ms wall "
            f"(unprofiled median): device busy "
            f"{100 * dev_ms / (med * 1e3):.1f}%; the WKV forward {f_ms:.3f} "
            f"ms ({100 * f_ms / dev_ms:.1f}%, {f_n:.0f} launches, "
            f"{f_ms / f_n:.4f} a launch), its backward {b_ms:.3f} ms "
            f"({100 * b_ms / dev_ms:.1f}%, {b_n:.0f} device kernels); the "
            f"matrix products {gemm:.3f} ms, AdamW's foreach passes "
            f"{adam:.3f} ms, the rest {dev_ms - f_ms - b_ms - gemm - adam:.3f}"
            f" ms; largest: " + ", ".join(
                f"{k_[:48]} {v_:.3f} ms" for v_, k_ in largest(per, 6))
            + f" [{smi}]")
        del loop, lm, opt
        torch.cuda.empty_cache()

    return row, counts["wkv_chunked"], busy


def serve_bits(lm, prompt, steps_mod, sharding, ops, torch):
    """One prefill of ``prompt`` and ``MESH_DECODES`` decode steps after it,
    counted: ``LM.prefill`` for the dense family (the decode continues in
    caches of ``S + MESH_DECODES`` slots holding the prefill's keys and
    values), ``make_prefill_step`` and fresh caches for the others.
    Returns (the prefill's logits, the decode steps' logits, the final
    caches' leaves, all whole tensors; the launches of the prefill; the
    prefill's wall and the decode steps' walls in seconds)."""
    b, s = prompt.shape
    whole = (lambda x: x.full_tensor() if sharding.is_sharded(x) else x)
    dense = lm.cfg.family == "dense"
    with torch.inference_mode():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if dense:
            logits, pre = lm.prefill({"tokens": prompt})
        else:
            logits = steps_mod.make_prefill_step(lm)({"tokens": prompt})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        out = [whole(logits).clone()]
        caches = lm.init_caches(b, s + MESH_DECODES)
        start = 0
        if dense:                # k, v [L, B, S, H, D] and pos [L, S]
            for a, w in zip(caches[:3], pre[:3]):
                a = sharding.local(a)
                a.narrow(2 if a.dim() == 5 else 1, 0, s).copy_(
                    sharding.local(w))
            start = s
            del pre
        walls = []
        for t in range(MESH_DECODES):
            tok = prompt[:, t:t + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = lm.decode_step(caches, tok, start + t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            out.append(whole(lg).clone())
        leaves = [whole(a).clone() for a in caches if a is not None]
    return out, leaves, counts, wall, walls


def flash_bwd_at_shape(q, k, v, kw, torch, smi, cuda_ms, tag) -> dict:
    """Flash's backward at one call: held to its plain version (in pieces;
    bf16 within 2e-2 of each gradient's largest magnitude, float32 1e-4
    per element), timed beside its plain version, SDPA's backward and its
    bound (phase 11's: the bytes of q, k, v, O, dO, lse and the gradients
    against ten products over the unmasked pairs).  Logs one line and
    returns the row's entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kflash
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    gen = torch.Generator(q.device).manual_seed(31)
    dout = torch.randn(q.shape, generator=gen, device=q.device,
                       dtype=torch.float32).to(q.dtype)
    out, lse = kflash.flash_attention(q, k, v, return_lse=True, **kw)
    got = kflash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = flash_bwd_ref_pieces(q, k, v, out, lse, dout, torch, **kw)
    torch.cuda.synchronize()
    err = bwd_err(got, want, q.dtype, torch)
    if err == float("inf"):
        fail(f"{tag} flash_attention_bwd differs from its plain version at "
             f"B={b} Hq={hq} Hkv={hkv} S={sq} D={d} {q.dtype}")
    del got, want
    ms = cuda_ms(lambda: kflash.flash_attention_bwd(
        q, k, v, out, lse, dout, **kw), 10)
    plain = cuda_ms(lambda: flash_bwd_ref_pieces(
        q, k, v, out, lse, dout, torch, **kw), 2)
    g = hq // hkv
    qx, kx, vx = (t.detach().clone().requires_grad_() for t in (
        q, k.repeat_interleave(g, 1) if g > 1 else k,
        v.repeat_interleave(g, 1) if g > 1 else v))
    sdpa = F.scaled_dot_product_attention(qx, kx, vx,
                                          is_causal=kw.get("causal", True))
    lib = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qx, kx, vx), dout, retain_graph=True), 10)
    pairs = unmasked_pairs(sq, sk, kw.get("causal", True),
                           kw.get("window", 0))
    flops = 10 * b * hq * pairs * d
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * sk * d) * \
        q.element_size() + 4 * b * hq * sq
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    bound, by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
    label = (f"B={b} Hq={hq} Hkv={hkv} S={sq} D={d} {str(q.dtype)[6:]} "
             f"causal={kw.get('causal', True)}")
    log(f"{tag} flash_attention_bwd ({kflash.bwd_route(q.dtype, d)}) at "
        f"{label}: {ms:.4f} ms (plain {plain:.4f} ms over pieces; SDPA's "
        f"backward {lib:.4f} ms; bound {bound:.5f} ms by {by}); max abs err "
        f"{err:.3g}; {ms / lib:.2f}x SDPA's backward, {ms / bound:.2f}x its "
        f"bound [{smi}]")
    return {"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "library": "scaled_dot_product_attention's backward"}


def wkv_at_shape(b, h, s, d, chunk, torch, dev, smi, cuda_ms, tag):
    """The WKV forward and backward at ``[B, H, S, D]`` (bf16 r/k/v as views
    of ``[B, S, H*D]``, float32 log w, u and dO): each held to its plain
    version (the forward within atol 1e-4, rtol 1e-3; the backward within
    ``WKV_BWD_TOL`` of each gradient's largest magnitude), timed beside its
    plain version and its bound (phases 7 and 12's: the bytes against
    three TF32 passes of the chunk products).  Returns the two rows'
    entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv as kwkv
    gen = torch.Generator(dev).manual_seed(32)
    r, k, v, lw, u, _, go, _ = wkv_bwd_case(
        (b, h, s, d, chunk, False, False, False), torch.bfloat16, gen,
        torch, dev)
    out, st, states = kwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk,
                                       return_states=True)
    want = ref.wkv_chunked_ref(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    f_err = 0.0
    for g_, w_ in zip((out, st), want):
        diff = (g_.double() - w_.double()).abs()
        if bool((diff > 1e-4 + 1e-3 * w_.double().abs()).any()):
            fail(f"{tag} wkv_chunked differs from its plain version at B={b} "
                 f"H={h} S={s} D={d}: max abs err {float(diff.max()):.4g}")
        f_err = max(f_err, float(diff.max()))
    got = kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go, chunk=chunk)
    want_b = ref.wkv_chunked_bwd_ref(r, k, v, lw, u, states, go, chunk=chunk)
    torch.cuda.synchronize()
    rel = wkv_bwd_errs(got, want_b)
    if not all(e <= WKV_BWD_TOL[str(g_.dtype)[6:]] for e, g_ in
               zip(rel, got) if g_ is not None):
        fail(f"{tag} wkv_chunked_bwd differs from its plain version at B={b} "
             f"H={h} S={s} D={d}: relative errors {rel}")
    b_err = max_abs_err(got, want_b, torch)
    del got, want, want_b
    f_ms = cuda_ms(lambda: kwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk), 10)
    f_plain = cuda_ms(lambda: ref.wkv_chunked_ref(r, k, v, lw, u,
                                                  chunk=chunk), 2)
    b_ms = cuda_ms(lambda: kwkv.wkv_chunked_bwd(r, k, v, lw, u, states, go,
                                                chunk=chunk), 10)
    b_plain = cuda_ms(lambda: ref.wkv_chunked_bwd_ref(
        r, k, v, lw, u, states, go, chunk=chunk), 2)
    n, esz = r.numel(), r.element_size()
    nc = s // chunk
    f_bytes = 3 * n * esz + n * 4 + h * d * 4 + n * 4 + b * h * d * d * 4
    f_flops = b * h * nc * (2 * chunk * (chunk - 1) * d + 4 * chunk * d * d)
    b_bytes = (3 * n * esz + 2 * n * 4 + states.numel() * 4 + h * d * 4
               + 3 * n * esz + n * 4 + h * d * 4 + b * h * d * d * 4)
    b_flops = b * h * nc * (5 * chunk * (chunk - 1) * d + 8 * chunk * d * d)
    rows = []
    label = f"B={b} H={h} S={s} D={d} chunk={chunk} bfloat16 r/k/v"
    for name, ms, plain, nbytes, flops, e in (
            ("wkv_chunked", f_ms, f_plain, f_bytes, f_flops, f_err),
            ("wkv_chunked_bwd", b_ms, b_plain, b_bytes, b_flops, b_err)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_OPS_PER_S
        bound = max(t_b, t_o) * 1e3
        by = "bytes" if t_b >= t_o else "operations"
        log(f"{tag} {name} at {label}: {ms:.4f} ms (plain {plain:.4f} ms; "
            f"library call: none; bound {bound:.5f} ms by {by}, three TF32 "
            f"passes of {flops / 1e9:.2f} GFLOP against {nbytes / 1e6:.1f} "
            f"MB); max abs err {e:.3g}; {ms / bound:.2f}x its bound [{smi}]")
        rows.append({"shape": label, "max_abs_err": e, "ms": ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": None})
    return rows


def gloo_probe_worker(rank, n, store, out):
    """One rank of the two-rank probe on one card: a ``gloo`` group (NCCL
    refuses two ranks on one card) whose mesh holds CUDA tensors, and one
    float32 train step of qwen3-0.6b at full width cut to
    ``PROBE_LAYERS`` layers on the (1, 2) mesh against the unsharded step
    from the same weights.  Writes ``{rank}.json``: the loss, the largest
    gradient error over the largest magnitude of each leaf, the
    launches; or the error it raised."""
    sys.path.insert(0, str(SRC))
    res = {}
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch import configs
        from repro_torch.data import pipeline
        from repro_torch.kernels import ops
        from repro_torch.launch import steps
        from repro_torch.models import LM, layers
        from repro_torch.models.config import ShapeSpec
        from repro_torch.parallel import sharding
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=n, rank=rank)
        mesh = DeviceMesh("cuda", torch.arange(n).reshape(1, n),
                          mesh_dim_names=("data", "model"))
        cfg = configs.get("qwen3_0p6b").with_(
            n_layers=PROBE_LAYERS, param_dtype="float32",
            compute_dtype="float32", cache_dtype="float32")
        dev = torch.device("cuda", 0)
        lm = layers.trainable(LM(cfg, device=dev)).init(
            torch.Generator(dev).manual_seed(0))
        batch = pipeline.to_device(pipeline.SyntheticLM(
            cfg, ShapeSpec("probe", PROBE_S, PROBE_B, "train"), seed=0)
            .host_batch(0), dev)
        loss0, _, grads0 = steps.loss_and_grads(lm, batch)
        sharding.shard_params(cfg, lm, mesh)
        ops.reset_launches()
        loss, _, grads = steps.loss_and_grads(lm, batch)
        torch.cuda.synchronize()
        res["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
        res["loss"], res["loss0"] = float(loss), float(loss0)
        worst = 0.0
        for name, g in grads.items():
            want = grads0[name]
            pl = g.placements[1]
            if isinstance(pl, sharding.Shard):
                step = want.shape[pl.dim] // n
                want = want.narrow(pl.dim, rank * step, step)
            scale = max(float(want.abs().max()), 1e-30)
            worst = max(worst, float((sharding.local(g) - want).abs().max())
                        / scale)
        res["grad_rel_err"] = worst
        dist.destroy_process_group()
    except Exception as exc:                 # reported by the parent
        res["error"] = f"{type(exc).__name__}: {exc}"
    Path(out, f"{rank}.json").write_text(json.dumps(res))


def gloo_probe(root: Path, torch):
    """Run ``gloo_probe_worker`` on two spawned ranks (killed past
    ``PROBE_TIMEOUT_S``); their results by rank."""
    import torch.multiprocessing as mp
    out = root / "probe"
    out.mkdir()
    ctx = mp.start_processes(gloo_probe_worker, args=(
        2, str(root / "probe_store"), str(out)), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.monotonic() + PROBE_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            fail(f"[13] the two-rank gloo probe ran past {PROBE_TIMEOUT_S} s")
    return [json.loads((out / f"{r}.json").read_text()) for r in range(2)]


def mesh_phase(torch, dev, smi, cuda_ms):
    """Phase 13: the multi-device modules on a one-rank NCCL mesh.  The
    fleet on ``fleet_mesh(..., pods=True)`` (PPCC and OCC, and PPCC with
    delta) against the unsharded fleet, bit for bit, its launches equal to
    the body iterations; the float32 train golden through the mesh path;
    qwen3-0.6b at full width and depth against the unsharded step; rwkv6-3b
    at its width, 2 layers; both models served (prefill and decode) on the
    mesh against the unsharded model, to the bit; flash and the WKV,
    forward and backward, at each rank's shapes of ``RANK_MODELS``; a
    sharded checkpoint restart; then, the group destroyed, a train step on
    a (1, 2) mesh of two ranks on the card over ``gloo`` against the
    unsharded step.  Returns (``{path: {kernel: launches}}``, ``{kernel
    row: [entries at the per-rank shapes]}``)."""
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import sweep
    from repro_torch.core.types import paper_figure_params
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train, train_golden as TG
    from repro_torch.models import convert
    from repro_torch.parallel import sharding

    t13 = time.perf_counter()
    if dist.is_initialized():
        fail("[13] a process group exists before phase 13")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    paths, rank_rows = {}, {}
    try:
        t = time.perf_counter()
        if not sharding.init_distributed(f"file://{root}/store", 1, 0,
                                         device=dev):
            fail("[13] init_distributed made no group")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"[13] group {dist.get_backend()} of "
                 f"{dist.get_world_size()}, expected nccl of 1")
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        log(f"[13] process group: nccl, world 1, rank 0 on cuda:"
            f"{torch.cuda.current_device()}, an all_reduce through it "
            f"({time.perf_counter() - t:.1f} s)")

        # ---- (1) the fleet on the pod mesh against the unsharded fleet
        t = time.perf_counter()
        mpls, seeds = MESH_MPLS, MESH_SEEDS
        p = paper_figure_params(MESH_FIG).with_(horizon=MESH_HORIZON)
        mesh = sweep.fleet_mesh(len(mpls) * len(seeds), pods=True)
        if mesh is None or dict(zip(mesh.mesh_dim_names, mesh.shape)) != \
                {"pod": 1, "data": 1, "model": 1}:
            fail(f"[13] fleet_mesh(pods=True) gave {mesh}")
        for label, protos, kw in (("fused", ("ppcc", "occ"), {}),
                                  ("delta", ("ppcc",), {"delta": True})):
            common = dict(protocols=protos, n_slots=sweep.slot_bucket(
                max(mpls)), device=dev, **kw)
            plain = sweep.Fleet(p, **common)(mpls, seeds)
            fleet = sweep.Fleet(p, mesh=mesh, **common)
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fleet(mpls, seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            for proto in protos:
                for k, v in plain[proto].items():
                    if got[proto][k].dtype != v.dtype or \
                            not np.array_equal(got[proto][k], v):
                        fail(f"[13] {label} fleet on the pod mesh: {proto} "
                             f"{k} {got[proto][k].tolist()} differs from the "
                             f"unsharded fleet's {v.tolist()}")
            body = fleet.body_iters
            if label == "fused":
                want = {"megastep": body["ppcc"],
                        "occ_validate": body["occ"],
                        "reserve_cohort": sum(body.values()) + len(protos),
                        "rowslab_drain": 0, "rowslab": 0}
            else:
                want = {"megastep": 1, "rowslab_drain": body["ppcc"],
                        "reserve_cohort": body["ppcc"] + 1, "rowslab": 0,
                        "occ_validate": 0}
            have = {k: counts[k] for k in want}
            if have != want:
                fail(f"[13] {label} fleet on the pod mesh launched {have}, "
                     f"expected {want} (body iterations {body})")
            paths[f"{label} fleet on the pod mesh"] = {
                k: v for k, v in have.items() if v}
            log(f"[13] {label} fleet on fleet_mesh(pods=True) (pod 1 x data "
                f"1 x model 1; Fig. {MESH_FIG}, MPLs {list(mpls)} x seeds "
                f"{list(seeds)}, horizon {MESH_HORIZON:g}, {protos}): every "
                f"lane equals the unsharded fleet's in "
                f"{sorted(plain[protos[0]])}, bit for bit; body iterations "
                f"{body}, launches {have} ({wall:.2f} s of wall)")
        log(f"[13] fleets in {time.perf_counter() - t:.1f} s")

        mesh11 = mesh_mod.make_mesh((1, 1), ("data", "model"))

        # ---- (2) the float32 train golden through the mesh path
        t = time.perf_counter()
        gold = json.loads(TRAIN_GOLDEN.read_text())
        if gold["run"] != TG.run_record():
            fail(f"{TRAIN_GOLDEN.name} was written for another run")
        tree = convert.random_jax_tree(TG.golden_config(), TG.SEED)
        if convert.tree_sha256(tree) != gold["weights_sha256"]:
            fail("[13] the golden's seeded weights differ on this machine")
        ops.reset_launches()
        got = TG.port_run(dev, tree, mesh=mesh11)
        torch.cuda.synchronize()
        del tree
        counts = ops.launch_counts()
        worst = hold_train_golden(got, gold, "[13]")
        n_fwd = TG.LAYERS * (TG.STEPS + 1)
        if counts["flash_attention"] != n_fwd or counts[kflash.BWD] != n_fwd:
            fail(f"[13] the float32 golden on the mesh launched {counts}, "
                 f"expected {n_fwd} CUDA-core forwards and backwards")
        paths["float32 train golden on the (1, 1) mesh"] = {
            "flash_attention": n_fwd, kflash.BWD: n_fwd}
        log(f"[13] float32 train golden through the mesh path (the model "
            f"sharded on the (1, 1) mesh, make_global_batch) within "
            f"{gold['tolerance']['rtol']} of {TRAIN_GOLDEN.name}: max rel "
            f"err {worst:.3g}; flash {n_fwd} CUDA-core forwards and "
            f"{n_fwd} backwards ({time.perf_counter() - t:.1f} s)")
        torch.cuda.empty_cache()

        # ---- (3) qwen3-0.6b, full width and depth, bf16: the mesh step
        # against the unsharded step on one fixed batch
        cfg = configs.get("qwen3_0p6b")
        runs = {}
        for name, m in (("unsharded", None), ("mesh (1, 1)", mesh11)):
            t = time.perf_counter()
            loop, make_batch = train.build(
                cfg, batch=TRAIN_B, seq=TRAIN_S, lr=1e-3,
                steps=MESH_STEPS, device=dev, ckpt_every=0, mesh=m)
            lm, opt, data = loop.init_state()
            batch = make_batch(data)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            walls, losses, per_step = [], [], []
            for _ in range(MESH_STEPS):
                before = ops.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lm, opt, met = loop.train_step(lm, opt, batch)
                losses.append(float(met["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                after = ops.launch_counts()
                per_step.append({k: after[k] - before[k] for k in after
                                 if after[k] != before[k]})
            h = hashlib.sha256()
            for k, p_ in lm.named_parameters():
                h.update(sharding.local(p_).detach().contiguous()
                         .view(torch.uint8).cpu().numpy().tobytes())
            sharded = all(sharding.is_sharded(p_) for p_ in lm.parameters())
            runs[name] = dict(losses=losses, walls=walls, digest=h.hexdigest(),
                              peak=torch.cuda.max_memory_allocated(),
                              per_step=per_step, sharded=sharded,
                              seconds=time.perf_counter() - t)
            del loop, lm, opt, data, batch, make_batch
            torch.cuda.empty_cache()
        a, b = runs["unsharded"], runs["mesh (1, 1)"]
        L = cfg.n_layers
        if not b["sharded"] or a["sharded"]:
            fail("[13] the mesh run's parameters are not all DTensors")
        if any(s_.get("flash_attention_tc") != L or
               s_.get(kflash.BWD_TC) != L for s_ in b["per_step"]):
            fail(f"[13] qwen3 on the mesh launched {b['per_step']} a step, "
                 f"expected {L} tensor-core flash forwards and backwards")
        rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                      a["losses"]))
        if not all(map(math.isfinite, b["losses"])) or rel > 1e-4:
            fail(f"[13] qwen3 on the mesh: losses {b['losses']}, unsharded "
                 f"{a['losses']}")
        bits = b["losses"] == a["losses"] and b["digest"] == a["digest"]
        if not bits:
            fail(f"[13] qwen3 on the (1, 1) mesh is not the unsharded step's "
                 f"bits: losses {b['losses']} against {a['losses']}, "
                 f"parameter digests {b['digest']} and {a['digest']}")
        med = {k: statistics.median(r["walls"][1:]) for k, r in runs.items()}
        paths["qwen3_0p6b training on the (1, 1) mesh, 3 steps"] = {
            "flash_attention_tc": L * MESH_STEPS, kflash.BWD_TC: L * MESH_STEPS}
        log(f"[13] qwen3-0.6b at full width and depth ({L} layers, bf16), "
            f"{MESH_STEPS} steps of launch.train's loop on one fixed batch of "
            f"{TRAIN_B} x {TRAIN_S}, sharded on the (1, 1) mesh (every "
            f"parameter and AdamW leaf a DTensor, make_global_batch) against "
            f"the unsharded step in this run: bits match {bits} (losses "
            f"{b['losses']} against {a['losses']}, max rel diff {rel:.3g}; "
            f"parameter digests {'equal' if b['digest'] == a['digest'] else 'differ'}"
            f"); step walls mesh {[round(w * 1e3, 1) for w in b['walls']]} ms, "
            f"unsharded {[round(w * 1e3, 1) for w in a['walls']]} ms; median "
            f"of steps 1-{MESH_STEPS - 1} {med['mesh (1, 1)'] * 1e3:.2f} ms "
            f"({TRAIN_B * TRAIN_S / med['mesh (1, 1)']:.0f} tokens/s) against "
            f"{med['unsharded'] * 1e3:.2f} ms "
            f"({TRAIN_B * TRAIN_S / med['unsharded']:.0f} tokens/s); peak "
            f"device memory {b['peak'] / 1e9:.2f} GB against "
            f"{a['peak'] / 1e9:.2f} GB; {L} flash forwards and {L} backwards "
            f"a step on the tensor cores ({b['seconds']:.1f} + "
            f"{a['seconds']:.1f} s with the inits) [{smi}]")

        # ---- (4) rwkv6-3b at its width, 2 layers, on the mesh
        t = time.perf_counter()
        rcfg = configs.get("rwkv6_3b").with_(n_layers=MESH_RWKV_LAYERS)
        loop, make_batch = train.build(
            rcfg, batch=TRAIN_B, seq=TRAIN_S, lr=1e-3, steps=MESH_STEPS,
            device=dev, ckpt_every=0, mesh=mesh11)
        lm, opt, data = loop.init_state()
        batch = make_batch(data)
        ops.reset_launches()
        losses = []
        for _ in range(MESH_STEPS):
            lm, opt, met = loop.train_step(lm, opt, batch)
            losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {"wkv_chunked": 2 * MESH_RWKV_LAYERS * MESH_STEPS,
                kwkv.BWD: MESH_RWKV_LAYERS * MESH_STEPS}
        if {k: counts[k] for k in want} != want or \
                not all(map(math.isfinite, losses)):
            fail(f"[13] rwkv6-3b on the mesh: launches {counts}, expected "
                 f"{want}; losses {losses}")
        paths[f"rwkv6_3b training, {MESH_RWKV_LAYERS} layers, on the (1, 1) "
              f"mesh, 3 steps"] = want
        log(f"[13] rwkv6-3b at its width ({MESH_RWKV_LAYERS} of 32 layers, "
            f"bf16) on the (1, 1) mesh, {MESH_STEPS} steps on {TRAIN_B} x "
            f"{TRAIN_S}: losses {[round(x, 4) for x in losses]}; launches "
            f"{want} (the WKV forward twice a layer under remat 'full', its "
            f"backward once) ({time.perf_counter() - t:.1f} s)")
        del loop, lm, opt, data, batch, make_batch
        torch.cuda.empty_cache()

        # ---- (5) serving on the mesh: qwen3-0.6b at full width and depth
        # (LM.prefill of 8 x 1,024, then decode steps in its caches) and
        # rwkv6-3b at its width, 2 layers (make_prefill_step, decode from
        # fresh caches), each against the same model unsharded, to the bit
        from repro_torch.launch import steps as steps_mod
        from repro_torch.models import LM
        for arch, n_layers in (("qwen3_0p6b", None),
                               ("rwkv6_3b", MESH_RWKV_LAYERS)):
            t = time.perf_counter()
            scfg = configs.get(arch)
            if n_layers:
                scfg = scfg.with_(n_layers=n_layers)
            lm = LM(scfg, device=dev).init(torch.Generator(dev).manual_seed(0))
            prompt = torch.randint(0, scfg.vocab, (TRAIN_B, TRAIN_S),
                                   generator=torch.Generator(dev)
                                   .manual_seed(1), device=dev)
            plain = serve_bits(lm, prompt, steps_mod, sharding, ops, torch)
            sharding.shard_params(scfg, lm, mesh11)
            meshed = serve_bits(lm, prompt, steps_mod, sharding, ops, torch)
            same = len(plain[0]) == len(meshed[0]) and all(
                torch.equal(a, b) for a, b in zip(plain[0], meshed[0])) and \
                all(torch.equal(a, b) for a, b in zip(plain[1], meshed[1]))
            kernel = "flash_attention_tc" if scfg.family == "dense" \
                else "wkv_chunked"
            n_k = scfg.n_layers
            if not same or meshed[2] != {kernel: n_k} or plain[2] != meshed[2]:
                fail(f"[13] {arch} serving on the (1, 1) mesh: bits match "
                     f"{same}; prefill launches {meshed[2]} (unsharded "
                     f"{plain[2]}), expected {{{kernel!r}: {n_k}}}")
            paths[f"{arch} prefill of {TRAIN_B} x {TRAIN_S}"
                  + (f", {n_layers} layers" if n_layers else "")
                  + " on the (1, 1) mesh"] = {kernel: n_k}
            med = {k: statistics.median(r[4]) * 1e3 for k, r in
                   (("mesh", meshed), ("unsharded", plain))}
            log(f"[13] {arch} at its width"
                + (f", {n_layers} layers" if n_layers else
                   f" and depth ({n_k} layers)")
                + f", bf16, served on the (1, 1) mesh through the TP code "
                f"(DTensor parameters and caches) against the same model "
                f"unsharded: "
                + ("LM.prefill" if scfg.family == "dense"
                   else "make_prefill_step")
                + f" of {TRAIN_B} x {TRAIN_S} and {MESH_DECODES} decode steps"
                + (" in its caches" if scfg.family == "dense"
                   else " from fresh caches")
                + f": logits and caches bit-equal; {n_k} {kernel} launches; "
                f"prefill wall {meshed[3] * 1e3:.2f} ms (unsharded "
                f"{plain[3] * 1e3:.2f} ms), median decode step "
                f"{med['mesh']:.2f} ms (unsharded {med['unsharded']:.2f} ms) "
                f"({time.perf_counter() - t:.1f} s) [{smi}]")
            del lm, plain, meshed
            torch.cuda.empty_cache()

        # ---- (6) flash and the WKV, forward and backward, at each rank's
        # shapes of model = 2, 4, 16 (qwen3-0.6b's training call, its 16
        # query and 16 effective KV heads split; rwkv6-3b's 48 padded
        # heads split)
        t = time.perf_counter()
        qcfg, rcfg = configs.get("qwen3_0p6b"), configs.get("rwkv6_3b")
        hq, he = qcfg.n_heads, qcfg.n_kv_heads * qcfg.kv_repeat
        hw = rcfg.rwkv_pad_heads
        gen = torch.Generator(dev).manual_seed(30)
        for m in RANK_MODELS:
            def rnd(h, d):
                return torch.randn((TRAIN_B, TRAIN_S, h, d), generator=gen,
                                   device=dev).to(torch.bfloat16) \
                    .transpose(1, 2)
            q, k, v = rnd(hq // m, qcfg.head_dim), \
                rnd(he // m, qcfg.head_dim), rnd(he // m, qcfg.head_dim)
            where = f"qwen3-0.6b's training call at model = {m}"
            e = flash_at_shape(q, k, v, dict(causal=True), where, where, None,
                               torch, smi, cuda_ms, "[13]")
            e.pop("launches")
            rank_rows.setdefault("flash_attention", []).append(e)
            e = flash_bwd_at_shape(q, k, v, dict(causal=True), torch, smi,
                                   cuda_ms, "[13]")
            rank_rows.setdefault("flash_attention_bwd", []).append(
                {"path": where, **e})
            del q, k, v
            where = f"rwkv6-3b's training call at model = {m}"
            for name, e in zip(("wkv_chunked", "wkv_chunked_bwd"),
                               wkv_at_shape(TRAIN_B, hw // m, TRAIN_S,
                                            rcfg.rwkv_head_dim, 128, torch,
                                            dev, smi, cuda_ms, "[13]")):
                rank_rows.setdefault(name, []).append({"path": where, **e})
            torch.cuda.empty_cache()
        log(f"[13] flash and the WKV, forward and backward, at each rank's "
            f"shapes of model = {list(RANK_MODELS)}: held to their plain "
            f"versions and timed ({time.perf_counter() - t:.1f} s)")

        # ---- (7) the sharded checkpoint restart
        t = time.perf_counter()
        cfg2 = cfg.with_(n_layers=2)
        hist = {}
        for name, fail_at in (("clean", None), ("faulty", MESH_FAIL_AT)):
            loop, make_batch = train.build(
                cfg2, batch=RESTART_B, seq=RESTART_S, lr=1e-3,
                steps=MESH_RESTART_STEPS, device=dev,
                ckpt_dir=str(root / name), ckpt_every=MESH_CKPT_EVERY,
                inject_failure_at=fail_at, mesh=mesh11)
            summ = loop.run(make_batch, MESH_RESTART_STEPS)
            hist[name] = (summ["restarts"], list(loop.history))
            del loop, make_batch
            torch.cuda.empty_cache()
        (rc, clean), (rf, faulty) = hist["clean"], hist["faulty"]
        if rc or rf != 1 or dict(faulty) != dict(clean):
            fail(f"[13] sharded restart: clean {hist['clean']}, faulty "
                 f"{hist['faulty']}")
        manifest = json.loads(
            (root / "clean" / f"step_{MESH_RESTART_STEPS:08d}" /
             "manifest.json").read_text())
        n_sharded = sum(1 for e in manifest["leaves"]
                        if e["shards"][0]["index"] is not None)
        log(f"[13] sharded checkpoint restart (qwen3-0.6b full width, 2 "
            f"layers, on the (1, 1) mesh, {RESTART_B} x {RESTART_S}, a "
            f"checkpoint every {MESH_CKPT_EVERY} steps, a failure at step "
            f"{MESH_FAIL_AT}): restarted once, {len(faulty)} steps run, every "
            f"step's loss equals the clean run's to the bit (final "
            f"{faulty[-1][1]:.6f}); {n_sharded} of "
            f"{len(manifest['leaves'])} leaves saved as indexed shards "
            f"({time.perf_counter() - t:.1f} s)")
        if dist.is_initialized():
            dist.destroy_process_group()

        # ---- (8) two ranks on the card over gloo: a (1, 2) train step
        t = time.perf_counter()
        torch.cuda.empty_cache()
        probe = gloo_probe(root, torch)
        bad = [r_ for r_ in probe if "error" in r_ or
               not abs(r_["loss"] - r_["loss0"]) <= 1e-5 * abs(r_["loss0"])
               or not r_["grad_rel_err"] <= 1e-5]
        if bad:
            fail(f"[13] the two-rank gloo probe: {probe}")
        paths["qwen3_0p6b float32 train step, 2 layers, on a (1, 2) gloo "
              "mesh of two ranks on the card (per rank)"] = \
            probe[0]["launches"]
        log(f"[13] two ranks on the card over gloo (CUDA tensors; NCCL "
            f"refuses two ranks on one card): qwen3-0.6b at full width, "
            f"{PROBE_LAYERS} layers, float32, one train step on "
            f"{PROBE_B} x {PROBE_S} on the (1, 2) mesh (8 query and 8 KV "
            f"heads a rank, half the FFN columns and the vocabulary) against "
            f"the unsharded step: losses {[r_['loss'] for r_ in probe]} "
            f"against {probe[0]['loss0']}; each rank's gradient shards "
            f"within {max(r_['grad_rel_err'] for r_ in probe):.3g} of the "
            f"largest magnitude (held to 1e-5); launches a rank "
            f"{probe[0]['launches']} ({time.perf_counter() - t:.1f} s)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[13] process group destroyed; phase 13 in "
        f"{time.perf_counter() - t13:.1f} s")
    return paths, rank_rows


def hybrid_int8_phase(torch, dev, smi, cuda_ms):
    """Phase 9: the int8 and sliding-window KV caches and the hybrid
    family.  The golden's yi-34b and zamba2-1.2b runs; zamba2-1.2b at its
    published width and depth and yi-34b at its width with 16 layers, in
    bf16: the main path counted (one prefill and ``serve()`` under each
    policy), decode against prefill, zamba2's ring against a linear cache,
    flash against its plain version at both prefills' layer-0 inputs, its
    times beside its bound and SDPA.  Returns (flash's entries at the two
    shapes, flash's launches on each prefill, a function that takes the
    device's busy shares, to run after every wall of the script)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.launch import golden as G
    from repro_torch.launch import serve as srv
    from repro_torch.launch import steps
    from repro_torch.models import LM
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod

    t9 = time.perf_counter()
    gold = json.loads(LM_GOLDEN.read_text())
    if gold["run"] != G.run_record():
        fail(f"{LM_GOLDEN.name} was written for another run: {gold['run']}")
    for arch in PHASE9:
        lm_golden(arch, gold, dev, torch, "[9]")
    log(f"[9] goldens in {time.perf_counter() - t9:.1f} s")

    # ---- the main path of each model, counted
    lms, toks, prefills, outs, launches = {}, {}, {}, {}, {}
    captured = {}
    real_flash, real_ssd = kflash.flash_attention, ssm_mod.ssd_chunked

    def spy(mod, name, fn, key, store):
        """Replace ``mod.name`` by ``fn`` that keeps copies of its first
        call's arguments in ``store[key]``."""
        def call(*args, **kw):
            if key not in store:
                store[key] = ([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw))
            return fn(*args, **kw)
        setattr(mod, name, call)

    for arch in PHASE9:
        cfg = phase9_config(arch)
        gen = torch.Generator(dev).manual_seed(0)
        lm = LM(cfg, device=dev).init(gen)
        b, s_ = PREFILL9[arch]
        tok = torch.randint(0, cfg.vocab, (b, s_), generator=gen, device=dev)
        lms[arch], toks[arch] = lm, tok
        if cfg.family == "dense":
            def prefill(batch, lm=lm):
                with torch.inference_mode():
                    return lm.prefill(batch)[0]
        else:
            prefill = steps.make_prefill_step(lm)
        prefills[arch] = prefill
        n_par = sum(p_.numel() for p_ in lm.parameters())
        log(f"[9] {arch}: {cfg.n_layers} layers"
            + (f" (cut from 60 for the card's memory)"
               if arch == "yi_34b" else "")
            + f", d={cfg.d_model}, {cfg.n_heads} query heads"
            + (f" padded to {cfg.pad_q_heads}" if cfg.pad_q_heads else "")
            + f" over {cfg.n_kv_heads * cfg.kv_repeat} KV heads of "
            f"{cfg.head_dim}, window {cfg.sliding_window}, {cfg.cache_dtype} "
            f"cache; {n_par / 1e9:.3f} G parameters in bf16 from a "
            f"torch.Generator on the card; prefill {b} x {s_}")
        spy(kflash, "flash_attention", real_flash, (arch, "flash"), captured)
        spy(ssm_mod, "ssd_chunked", real_ssd, (arch, "ssd"), captured)
        ops.reset_launches()
        torch.cuda.synchronize()
        try:
            outs[arch, "prefill"] = prefill({"tokens": tok})
            for policy in POLICIES:
                outs[arch, policy] = srv.serve(lm, policy=policy)
            torch.cuda.synchronize()
        finally:
            kflash.flash_attention = real_flash
            ssm_mod.ssd_chunked = real_ssd
        counts = ops.launch_counts()
        kernel, n_attn = prefill_kernel(cfg, "bfloat16")
        want = {"flash_attention_tc": n_attn, "flash_attention": 0}
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"[9] {arch}: flash launches on the main path {got}, "
                 f"expected one per attention application of the prefill "
                 f"on the tensor cores {want}")
        launches[arch] = got["flash_attention_tc"]
        sched = {k: v_ for k, v_ in counts.items() if v_ and k not in want}
        if not sched.get("conflict_fused") or not sched.get("ppcc_admit"):
            fail(f"[9] {arch}: serve() launched no admission kernels: "
                 f"{sched}")
        lg = outs[arch, "prefill"]
        if lg.shape != (b, cfg.vocab) or \
                not bool(torch.isfinite(lg.float()).all()):
            fail(f"[9] {arch} prefill logits {tuple(lg.shape)} not finite "
                 f"or of the wrong shape")
        ref_s = gold["serve"]["by_arch"][arch]
        for policy in POLICIES:
            o = outs[arch, policy]
            if (o["ticks"], o["tokens"]) != (ref_s[policy]["ticks"],
                                             ref_s[policy]["tokens"]):
                fail(f"[9] {arch} serve({policy}): ticks {o['ticks']}, "
                     f"tokens {o['tokens']}; the reference's "
                     f"{ref_s[policy]}")
        log(f"[9] {arch} main path (one prefill, serve() under ppcc, 2pl, "
            f"occ): flash launches {got}, one per attention application, "
            f"on its tensor-core route; admission kernels {sched}; serve() "
            f"ticks and tokens equal the reference's (python -m "
            f"repro.launch.serve --arch {arch}) under every policy: "
            + ", ".join(f"{p_} {outs[arch, p_]['ticks']}/"
                        f"{outs[arch, p_]['tokens']}" for p_ in POLICIES))
        del outs[arch, "prefill"]

    # ---- walls: prefill, decode step, serve
    walls = {}
    for arch, lm in lms.items():
        b, s_ = PREFILL9[arch]
        tok = toks[arch]
        walls[arch, "prefill"] = median_wall_ms(
            lambda: prefills[arch]({"tokens": tok}), 3, torch) / 1e3
        err, scale, walls[arch, "decode"] = against_prefill(
            lm, tok[:, :DECODE9[arch]], torch)
        walls[arch, "drift"] = (err, scale)
        out = srv.serve(lm, policy="ppcc")
        walls[arch, "serve"] = out
        log(f"[9] {arch}: prefill {b} x {s_} in "
            f"{walls[arch, 'prefill'] * 1e3:.2f} ms "
            f"({b * s_ / walls[arch, 'prefill']:.0f} tokens/s); decode "
            f"{walls[arch, 'decode'] * 1e3:.3f} ms per step at batch {b}; "
            f"serve(ppcc) {out['tokens']} tokens in {out['wall']:.3f} s "
            f"({out['tokens'] / out['wall']:.1f} tokens/s) [{smi}]")

    # ---- decode against prefill, held in float32 (weights widened; the
    # hybrid model's caches float32, yi's cache int8), bf16 reported
    for arch, lm in lms.items():
        n = DECODE9[arch]
        kw = dict(param_dtype="float32", compute_dtype="float32")
        if lm.cfg.cache_dtype != "int8":
            kw["cache_dtype"] = "float32"
        torch.cuda.empty_cache()
        lm32 = LM(lm.cfg.with_(**kw), device=dev)
        lm32.load_state_dict(lm.state_dict())
        err, scale, _ = against_prefill(lm32, toks[arch][:, :n], torch)
        del lm32
        torch.cuda.empty_cache()
        if not err <= 3e-2 * scale:
            fail(f"[9] {arch} float32: decode over {n} prompt tokens "
                 f"differs from the prefill's last logits by {err:.4g} > "
                 f"3e-2 x {scale:.3g}")
        b_err, b_scale = walls[arch, "drift"]
        empty = "empty int8" if lm.cfg.cache_dtype == "int8" else "empty"
        log(f"[9] {arch} decode over {n} prompt tokens from {empty} "
            f"caches against the prefill's last logits: float32 "
            f"{err:.4g} (within 3e-2 x {scale:.3g}); bf16 {b_err:.4g} "
            f"(largest logit {b_scale:.3g}; reported, not held)")

    # ---- zamba2's ring on the card: window cut to 64, a ring of 64 slots
    # against a linear cache of 96, the same weights
    lm = lms["zamba2_1p2b"]
    window, n = RING9
    lm_r = LM(lm.cfg.with_(sliding_window=window), device="meta")
    lm_r.load_state_dict(lm.state_dict(), assign=True)
    lin = LM(lm.cfg.with_(sliding_window=0), device="meta")
    lin.load_state_dict(lm.state_dict(), assign=True)
    prompt = toks["zamba2_1p2b"][:, :n]
    ring = lm_r.init_caches(prompt.shape[0], n)
    big = lin.init_caches(prompt.shape[0], n)
    if (ring["shared_attn"].k.shape[2], big["shared_attn"].k.shape[2]) != \
            (window, n):
        fail(f"[9] zamba2 ring check: caches of "
             f"{ring['shared_attn'].k.shape[2]} and "
             f"{big['shared_attn'].k.shape[2]} slots")
    worst, top = 0.0, 1.0
    with torch.inference_mode():
        for t in range(n):
            lr, ring = lm_r.decode_step(ring, prompt[:, t:t + 1], t)
            lb, big = lm_r.decode_step(big, prompt[:, t:t + 1], t)
            worst = max(worst, float((lr.float() - lb.float()).abs().max()))
            top = max(top, float(lb.float().abs().max()))
    if not worst <= 3e-2 * top:
        fail(f"[9] zamba2 ring of {window} slots against a linear cache of "
             f"{n}: logits differ by {worst:.4g} > 3e-2 x {top:.3g}")
    log(f"[9] zamba2_1p2b at full depth and width, bf16, window cut to "
        f"{window}: {n} decode steps through a ring of {window} slots (it "
        f"wraps at step {window}) and a linear cache of {n} agree at every "
        f"step within 3e-2 x {top:.3g} (max abs diff {worst:.4g})")
    del lm_r, lin, ring, big

    # ---- flash against its plain version, times, bound, SDPA
    shapes = []
    for arch in PHASE9:
        (q, k, v), kw = captured[arch, "flash"]
        shapes.append(flash_at_shape(q, k, v, kw, f"{arch} prefill",
                                     f"{arch}'s prefill, layer 0",
                                     launches[arch], torch, smi, cuda_ms,
                                     "[9]"))
    ssd_args = captured["zamba2_1p2b", "ssd"]
    del captured
    torch.cuda.empty_cache()
    log(f"[9] phase 9 walls and checks in {time.perf_counter() - t9:.1f} s")

    def busy_shares():
        """Device kernel time of one decode and one prefill step of each
        model from torch.profiler, over the walls taken above; and what
        the Mamba2 chunk scan (``ssd_chunked``) costs zamba2's prefill,
        the Mamba2 decode its decode step and the int8 dequant yi's."""
        for arch, lm in lms.items():
            cfg = lm.cfg
            b, _ = PREFILL9[arch]
            n = DECODE9[arch]
            caches = lm.init_caches(b, n)
            tok = toks[arch][:, :1]
            for label, fn, reps in (
                    ("decode", lambda: lm.decode_step(caches, tok, n // 2),
                     4),
                    ("prefill", lambda: prefills[arch](
                        {"tokens": toks[arch]}), 1)):
                with torch.inference_mode():
                    fn()
                    torch.cuda.synchronize()
                    dev_ms, kernels, per = device_profile(fn, reps, torch)
                wall_ms = walls[arch, label] * 1e3
                if dev_ms > 0:
                    log(f"[9] {arch} {label} step: {dev_ms:.3f} ms device "
                        f"kernel time ({kernels:.0f} kernels, profiled) over "
                        f"{wall_ms:.3f} ms wall (unprofiled): device busy "
                        f"{100 * dev_ms / wall_ms:.1f}%; largest: "
                        + ", ".join(f"{k_[:40]} {v_:.3f} ms"
                                    for v_, k_ in largest(per, 3))
                        + f" [{smi}]")
                else:
                    log(f"[9] {arch} {label} step: device time not measured "
                        f"(profiler saw no device time)")
                walls[arch, label, "device"] = dev_ms
        # the parts, each profiled alone at inputs of the main path
        part = {}
        real_dec, real_deq = ssm_mod.mamba2_decode, attn_mod._dequant
        for arch, name, mod, real in (
                ("zamba2_1p2b", "mamba2_decode", ssm_mod, real_dec),
                ("yi_34b", "_dequant", attn_mod, real_deq)):
            lm = lms[arch]
            caches = lm.init_caches(PREFILL9[arch][0], DECODE9[arch])
            spy(mod, name, real, (arch, name), part)
            try:
                with torch.inference_mode():
                    lm.decode_step(caches, toks[arch][:, :1], 0)
            finally:
                setattr(mod, name, real)
        del caches
        (a, kw) = ssd_args
        with torch.inference_mode():
            ssd_ms, _, _ = device_profile(lambda: real_ssd(*a, **kw), 2, torch)
        n_mamba = lms["zamba2_1p2b"].cfg.n_layers
        pre = walls["zamba2_1p2b", "prefill", "device"]
        if ssd_ms > 0 and pre > 0:
            log(f"[9] zamba2_1p2b prefill: the Mamba2 chunk scan "
                f"(ssd_chunked, profiled alone at layer 0's inputs) "
                f"{ssd_ms:.3f} ms a layer, x {n_mamba} layers = "
                f"{ssd_ms * n_mamba:.3f} ms of the step's {pre:.3f} ms of "
                f"device time ({100 * ssd_ms * n_mamba / pre:.1f}%)")
        (a, kw) = part["zamba2_1p2b", "mamba2_decode"]
        with torch.inference_mode():
            dec_ms, dec_k, _ = device_profile(lambda: real_dec(*a, **kw), 4,
                                              torch)
        step = walls["zamba2_1p2b", "decode", "device"]
        if dec_ms > 0 and step > 0:
            log(f"[9] zamba2_1p2b decode step: the Mamba2 decode "
                f"(mamba2_decode, profiled alone at a step's layer-0 "
                f"inputs) {dec_ms:.4f} ms and {dec_k:.0f} kernels a layer, "
                f"x {n_mamba} = {dec_ms * n_mamba:.3f} ms of the step's "
                f"{step:.3f} ms of device time "
                f"({100 * dec_ms * n_mamba / step:.1f}%)")
        (a, kw) = part["yi_34b", "_dequant"]
        with torch.inference_mode():
            dq_ms, _, _ = device_profile(lambda: real_deq(*a, **kw), 4,
                                         torch)
        n_yi = 2 * lms["yi_34b"].cfg.n_layers
        step = walls["yi_34b", "decode", "device"]
        if dq_ms > 0 and step > 0:
            log(f"[9] yi_34b decode step: the int8 dequant of one cache "
                f"tensor {tuple(a[0].shape)} (_dequant, profiled alone) "
                f"{dq_ms:.4f} ms, x {n_yi} (k and v of {n_yi // 2} layers) "
                f"= {dq_ms * n_yi:.3f} ms of the step's {step:.3f} ms of "
                f"device time ({100 * dq_ms * n_yi / step:.1f}%)")

    return shapes, launches, busy_shares


def phase10_config(arch):
    from repro_torch import configs
    cfg = configs.get(arch)
    return cfg.with_(n_layers=PHASE10[arch]) if PHASE10[arch] else cfg


def phase10_batch(cfg, gen, dev, torch) -> dict:
    """The prefill's batch, drawn on the card: tokens [8, 1,024], the
    vision model's image tokens [8, 1,601, d] beside them, hubert's
    frames [8, 1,024, d] in their place (bf16, standard normal)."""
    b, s_ = PREFILL_B, PREFILL_S
    if cfg.family == "audio":
        return {"frames": torch.randn((b, s_, cfg.d_model), generator=gen,
                                      device=dev).bfloat16()}
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s_), generator=gen,
                                     device=dev)}
    if cfg.family == "vlm":
        batch["img"] = torch.randn((b, cfg.n_img_tokens, cfg.d_model),
                                   generator=gen, device=dev).bfloat16()
    return batch


def phase10_model(arch, dev, torch):
    """(model, batch) of ``arch`` in phase 10, from seed 0 on the card."""
    from repro_torch.models import LM
    cfg = phase10_config(arch)
    gen = torch.Generator(dev).manual_seed(0)
    lm = LM(cfg, device=dev).init(gen)
    return lm, phase10_batch(cfg, gen, dev, torch)


def check10_config(arch):
    """The float32 config of ``arch``'s decode-against-prefill check."""
    cfg = phase10_config(arch)
    kw = dict(n_layers=CHECK10[arch], param_dtype="float32",
              compute_dtype="float32", cache_dtype="float32")
    if cfg.family == "moe":
        kw["capacity_factor"] = float(cfg.n_experts)
    return cfg.with_(**kw)


def check10_leaves(lm, arch) -> dict:
    """Host copies of the bf16 leaves of ``lm`` that the check's cut
    model keeps (the first layers, the embeddings and the head)."""
    from repro_torch.models import LM
    keep = LM(check10_config(arch), device="meta").state_dict().keys()
    return {k: v.cpu() for k, v in lm.state_dict().items() if k in keep}


def phase10_float32_check(arch, host, prompt, img, dev, torch):
    """Decode ``prompt`` token by token against the prefill's last logits
    in float32 at ``CHECK10[arch]`` layers (``check10_config``), the
    weights the bf16 model's (``host``, emptied as each leaf is widened
    on the host and moved to the card); the vlm family's gates set to
    0.6 and -0.4 (0 at init, where a cross block passes its input
    through), its cross caches filled from ``img``.
    Returns (max abs difference, the prefill's largest magnitude, GB of
    float32 weights, GB left free on the card beside them)."""
    from repro_torch.models import LM
    lm32 = LM(check10_config(arch), device="meta")
    sd = {k: host.pop(k).float().to(dev) for k in list(host)}
    lm32.load_state_dict(sd, assign=True)
    del sd
    gb = sum(p_.numel() * 4 for p_ in lm32.parameters()) / 1e9
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    if lm32.cfg.family == "vlm":
        with torch.no_grad():
            for cross in lm32.cross_blocks:
                cross.gate_attn.fill_(0.6)
                cross.gate_mlp.fill_(-0.4)
    err, scale, _ = against_prefill(
        lm32, prompt, torch, img=None if img is None else img.float())
    del lm32
    torch.cuda.empty_cache()
    return err, scale, gb, free_gb


def moe_split(p, cfg, x, torch, cuda_ms) -> dict:
    """Device ms of one ``moe_apply`` at its captured inputs, of its
    expert products alone (``moe.experts``, the function ``moe_apply``
    calls, on an ``[E, C, d]`` block) and of its shared expert alone;
    the rest is the router, the top-k, the sort, the dispatch gather and
    the combine."""
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_mod
    n, d = x.shape[0] * x.shape[1], x.shape[-1]
    c = moe_mod.capacity(n, cfg)
    xe = torch.randn((cfg.n_experts, c, d), device=x.device).to(x.dtype)
    out = {"tokens": n, "capacity": c,
           "total": cuda_ms(lambda: moe_mod.moe_apply(p, cfg, x), 5),
           "experts": cuda_ms(lambda: moe_mod.experts(p, xe), 5),
           "shared": cuda_ms(lambda: layers.mlp_apply(
               p.shared, x.reshape(n, d)), 5) if hasattr(p, "shared")
           else 0.0}
    out["rest"] = out["total"] - out["experts"] - out["shared"]
    return out


def moe_vlm_audio_phase(torch, dev, smi, cuda_ms):
    """Phase 10: the moe, vlm and audio families at published width.
    The golden's dbrx-132b (1 layer), llama-3.2-vision-11b (5 layers)
    and hubert-xlarge (48 layers) runs; then each model of ``PHASE10`` in
    bf16, one at a time, freed before the next: the main path counted
    (one prefill, and ``serve()`` under ppcc for dbrx and vision against
    the reference's counts), the prefill's wall, the decoders' decode
    step at batch 8 after the prefill's length, flash against its plain
    version at each prefill's first self-attention call (hubert's D =
    80, non-causal) and at the vision model's first cross call (Sk =
    1,601), with its time, bound and SDPA; the decoders' decode against
    prefill in float32 at ``CHECK10``'s depths; what the MoE layer's
    routing, dispatch and combine cost beside its expert products.
    Returns (flash's entries at the five shapes, flash's
    launches on each prefill, a function that takes the device's busy
    shares, to run after every wall of the script)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.launch import golden as G
    from repro_torch.launch import serve as srv
    from repro_torch.launch import steps
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import vlm_layout

    t10 = time.perf_counter()
    gold = json.loads(LM_GOLDEN.read_text())
    if gold["run"] != G.run_record():
        fail(f"{LM_GOLDEN.name} was written for another run: {gold['run']}")
    for arch in GOLDEN10:
        lm_golden(arch, gold, dev, torch, "[10]")
    log(f"[10] goldens in {time.perf_counter() - t10:.1f} s")

    real_flash, real_moe = kflash.flash_attention, moe_mod.moe_apply
    walls, shapes, launches, parts = {}, [], {}, {}
    for arch in PHASE10:
        t = time.perf_counter()
        lm, batch = phase10_model(arch, dev, torch)
        cfg = lm.cfg
        n_cross = vlm_layout(cfg)[0] if cfg.family == "vlm" else 0
        n_par = sum(p_.numel() for p_ in lm.parameters())
        cut = configs.get(arch).n_layers
        log(f"[10] {arch}: {cfg.n_layers} layers"
            + (f" (cut from {cut} for the card's memory)"
               if cut != cfg.n_layers else "")
            + f", d={cfg.d_model}, {cfg.n_heads} query heads"
            + (f" padded to {cfg.pad_q_heads}" if cfg.pad_q_heads else "")
            + f" over {cfg.n_kv_heads * cfg.kv_repeat} KV heads of "
            f"{cfg.head_dim}"
            + (f", {cfg.n_experts} experts of d_ff {cfg.d_ff}, top "
               f"{cfg.top_k}, MoE every {cfg.moe_every} layer(s)"
               + (", a shared expert" if cfg.moe_shared_expert else "")
               if cfg.family == "moe" else "")
            + (f", a gated cross block every {cfg.cross_attn_every} over "
               f"{cfg.n_img_tokens} image tokens"
               if cfg.family == "vlm" else "")
            + (", non-causal encoder on frames" if cfg.family == "audio"
               else "")
            + f"; {n_par / 1e9:.3f} G parameters in bf16 from a "
            f"torch.Generator on the card ({time.perf_counter() - t:.1f} s); "
            f"prefill {PREFILL_B} x {PREFILL_S}")
        captured = {}

        def flash_spy(q, k, v, **kw):
            key = "cross" if q.shape[2] != k.shape[2] else "self"
            if key not in captured:
                captured[key] = ((q.clone(), k.clone(), v.clone()), dict(kw))
            return real_flash(q, k, v, **kw)

        def moe_spy(p, c, x):
            # the prefill's and the timed decode's (batch 8), not serve()'s
            key = "prefill" if x.shape[1] > 1 else "decode"
            if key not in captured and x.shape[0] == PREFILL_B:
                captured[key] = (p, c, x.clone())
            return real_moe(p, c, x)

        prefill = steps.make_prefill_step(lm)
        kflash.flash_attention, moe_mod.moe_apply = flash_spy, moe_spy
        ops.reset_launches()
        torch.cuda.synchronize()
        try:
            logits = prefill(batch)
            served = srv.serve(lm, policy="ppcc") if arch in SERVE10 \
                else None
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            # walls (spies pass straight through after their first call)
            walls[arch, "prefill"] = median_wall_ms(
                lambda: prefill(batch), 3, torch) / 1e3
            if cfg.family != "audio":
                lg, walls[arch, "decode"] = decode_prompt(
                    lm, batch["tokens"][:, :DECODE10], torch,
                    start=PREFILL_S, img=batch.get("img"))
                if lg.shape != (PREFILL_B, cfg.vocab) or \
                        not bool(torch.isfinite(lg).all()):
                    fail(f"[10] {arch} decode logits {tuple(lg.shape)} not "
                         f"finite or of the wrong shape")
        finally:
            kflash.flash_attention, moe_mod.moe_apply = real_flash, real_moe
        want = {"flash_attention_tc": cfg.n_layers, "flash_attention": 0}
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"[10] {arch}: flash launches on the main path {got}, "
                 f"expected one per attention layer of the prefill on the "
                 f"tensor cores {want}")
        launches[arch] = got["flash_attention_tc"]
        sched = {k: v_ for k, v_ in counts.items() if v_ and k not in want}
        if logits.shape != (PREFILL_B, cfg.vocab) or \
                not bool(torch.isfinite(logits.float()).all()):
            fail(f"[10] {arch} prefill logits {tuple(logits.shape)} not "
                 f"finite or of the wrong shape")
        line = (f"[10] {arch} main path (one prefill"
                + (", serve() under ppcc" if served else "")
                + f"): flash launches {got}, one per attention layer"
                + (" ({1} self, {0} cross)".format(
                    n_cross, cfg.n_layers - n_cross)
                   if cfg.family == "vlm" else "")
                + ", on its tensor-core route")
        if served:
            if not sched.get("conflict_fused") or \
                    not sched.get("ppcc_admit"):
                fail(f"[10] {arch}: serve() launched no admission kernels: "
                     f"{sched}")
            ref_s = gold["serve"]["by_arch"][arch]["ppcc"]
            if (served["ticks"], served["tokens"]) != (ref_s["ticks"],
                                                       ref_s["tokens"]):
                fail(f"[10] {arch} serve(ppcc): ticks {served['ticks']}, "
                     f"tokens {served['tokens']}; the reference's {ref_s}")
            line += (f"; admission kernels {sched}; serve(ppcc) ticks and "
                     f"tokens {served['ticks']}/{served['tokens']} equal the "
                     f"reference's (python -m repro.launch.serve --arch "
                     f"{arch}); {served['tokens']} tokens in "
                     f"{served['wall']:.3f} s "
                     f"({served['tokens'] / served['wall']:.1f} tokens/s)")
        log(line)
        pre = walls[arch, "prefill"]
        log(f"[10] {arch}: prefill {PREFILL_B} x {PREFILL_S} in "
            f"{pre * 1e3:.2f} ms ({PREFILL_B * PREFILL_S / pre:.0f} "
            f"tokens/s)"
            + (f"; decode {walls[arch, 'decode'] * 1e3:.3f} ms per step at "
               f"batch {PREFILL_B} (over {DECODE10} prompt tokens at "
               f"positions {PREFILL_S}.., caches of "
               f"{PREFILL_S + DECODE10} slots"
               + (", cross caches of the image tokens"
                  if cfg.family == "vlm" else "") + ")"
               if (arch, "decode") in walls else "; no decode (an encoder)")
            + f" [{smi}]")
        del logits
        if cfg.family == "moe":
            n_moe = cfg.n_layers // cfg.moe_every
            for step in ("prefill", "decode"):
                # popped: a MoE module left referenced here would keep a
                # layer's experts on the card through the float32 check
                sp = moe_split(*captured.pop(step), torch, cuda_ms)
                parts[arch, step] = sp
                wall = walls[arch, step] * 1e3
                log(f"[10] {arch} {step}: one MoE layer at its inputs "
                    f"({sp['tokens']} tokens, capacity {sp['capacity']} a "
                    f"expert) {sp['total']:.4f} ms: expert products "
                    f"{sp['experts']:.4f} ms"
                    + (f", shared expert {sp['shared']:.4f} ms"
                       if sp["shared"] else "")
                    + f", routing, sort, dispatch and combine "
                    f"{sp['rest']:.4f} ms; x {n_moe} MoE layers = "
                    f"{sp['rest'] * n_moe:.3f} ms of routing and dispatch, "
                    f"{100 * sp['rest'] * n_moe / wall:.1f}% of the "
                    f"{step}'s {wall:.3f} ms wall [{smi}]")
        for key, label in (("self", "layer 0"), ("cross", "first cross")):
            if key in captured:
                (q, k, v), kw = captured.pop(key)
                shapes.append(flash_at_shape(
                    q, k, v, kw, f"{arch} prefill", f"{arch}'s prefill, "
                    f"{label}", launches[arch], torch, smi, cuda_ms, "[10]"))
                del q, k, v
        if arch in CHECK10:
            host = check10_leaves(lm, arch)
            prompt = batch["tokens"][:, :DECODE10].clone()
            img = batch.get("img")
        del lm, batch, captured, prefill
        torch.cuda.empty_cache()
        if arch in CHECK10:
            t = time.perf_counter()
            err, scale, gb, free_gb = phase10_float32_check(
                arch, host, prompt, img, dev, torch)
            del host, prompt, img
            if not err <= 3e-2 * scale:
                fail(f"[10] {arch} float32, {CHECK10[arch]} layers: decode "
                     f"over {DECODE10} prompt tokens differs from the "
                     f"prefill's last logits by {err:.4g} > 3e-2 x "
                     f"{scale:.3g}")
            log(f"[10] {arch} float32, the bf16 weights widened, "
                f"{CHECK10[arch]} layers ({gb:.1f} GB, {free_gb:.1f} GB of "
                f"the card left free)"
                + (f", capacity factor {phase10_config(arch).n_experts} "
                   f"(no token dropped)" if cfg.family == "moe" else "")
                + (", gates 0.6 and -0.4, cross caches projected from the "
                   "image tokens" if cfg.family == "vlm" else "")
                + f": decode over {DECODE10} prompt tokens from empty caches "
                f"against the prefill's last logits {err:.4g} (within 3e-2 x "
                f"{scale:.3g}; {time.perf_counter() - t:.1f} s)")
    log(f"[10] phase 10 walls and checks in "
        f"{time.perf_counter() - t10:.1f} s")

    def busy_shares():
        """Device kernel time of one prefill and one decode step of each
        model from torch.profiler, over the walls taken above; each model
        built again from its seed, one at a time."""
        for arch in PHASE10:
            lm, batch = phase10_model(arch, dev, torch)
            prefill = steps.make_prefill_step(lm)
            runs = [("prefill", lambda: prefill(batch), 1)]
            if lm.cfg.family != "audio":
                caches = lm.init_caches(PREFILL_B, PREFILL_S + DECODE10)
                tok = batch["tokens"][:, :1]
                runs.append(("decode", lambda: lm.decode_step(
                    caches, tok, PREFILL_S + DECODE10 // 2), 4))
            for label, fn, reps in runs:
                with torch.inference_mode():
                    fn()
                    torch.cuda.synchronize()
                    dev_ms, kernels, per = device_profile(fn, reps, torch)
                wall_ms = walls[arch, label] * 1e3
                if dev_ms > 0:
                    log(f"[10] {arch} {label} step: {dev_ms:.3f} ms device "
                        f"kernel time ({kernels:.0f} kernels, profiled) over "
                        f"{wall_ms:.3f} ms wall (unprofiled): device busy "
                        f"{100 * dev_ms / wall_ms:.1f}%; largest: "
                        + ", ".join(f"{k_[:40]} {v_:.3f} ms"
                                    for v_, k_ in largest(per, 4))
                        + f" [{smi}]")
                else:
                    log(f"[10] {arch} {label} step: device time not "
                        f"measured (profiler saw no device time)")
            del lm, batch, prefill, runs
            torch.cuda.empty_cache()

    return shapes, launches, busy_shares


def admit_ops_case(label, n, d, m, gen, torch, P, dev):
    """A PPCC state on ``dev`` with every slot begun, a first batch of m
    ops admitted and a quarter of the slots holding locks, and an op list
    [1, m] (random, or the edge ``label``), all drawn from ``gen``."""
    def op_list(mm):
        return [torch.randint(0, n, (1, mm), generator=gen,
                              dtype=torch.int32).to(dev),
                torch.randint(0, d, (1, mm), generator=gen,
                              dtype=torch.int32).to(dev),
                (torch.rand((1, mm), generator=gen) < 0.3).to(dev),
                (torch.rand((1, mm), generator=gen) < 0.9).to(dev)]

    s = P.begin_many(P.init_state(1, n, d, device=dev),
                     torch.ones((1, n), dtype=torch.bool, device=dev))
    s = P.admit_ops(s, *op_list(m)).state
    s = s._replace(haslocks=(torch.rand((1, n), generator=gen)
                             < 0.25).to(dev))
    ops_ = op_list(0 if label == "m = 0" else m)
    if label == "all invalid":
        ops_[3][:] = False
    elif label == "one txn":
        ops_[0][:] = 5
    elif label == "one item":
        ops_[1][:] = 17
    elif label == "writes only":
        ops_[2][:] = True
    elif label == "reads only":
        ops_[2][:] = False
    elif label == "dense":
        # arcs and class bits at density 1/2 (no slot precedes itself)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        s = s._replace(
            prec=(torch.rand((1, n, n), generator=gen) < 0.5).to(dev) & ~eye,
            preceding=(torch.rand((1, n), generator=gen) < 0.5).to(dev),
            preceded=(torch.rand((1, n), generator=gen) < 0.5).to(dev))
    elif label == "all locked":
        s = s._replace(haslocks=torch.ones_like(s.haslocks))
    elif label == "runs":
        # runs of 4 ops on one txn, then (the second half) on one item
        ops_[0] = ops_[0][:, ::4].repeat_interleave(4, 1)[:, :m]
        half = m // 2
        ops_[1][:, half:] = ops_[1][:, half::4].repeat_interleave(
            4, 1)[:, :m - half]
    elif label == "edge items":
        ops_[1] = (torch.tensor([31, 32, 33], dtype=torch.int32, device=dev)
                   .repeat(1, -(-m // 3))[:, :m] % (32 * s.words))
    return s, ops_


def phase8_runs(torch, dev, sweep, E, P, ops, golden8) -> dict:
    """Phase 8, its runs: the multipass PPCC grid (phase 3's lanes to
    ``golden8``'s horizon), the one-event engine and simulate(), each
    against its JAX golden, each with its launches."""
    import numpy as np
    from repro_torch.core.types import SimParams, paper_figure_params
    info = {}
    # the multipass PPCC chain on the grid of phase 3
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, fl = sweep.run_grid(
        figs=golden8["figs"], mpl_grid=golden8["mpl_grid"],
        seeds=golden8["seeds"], horizon=golden8["horizon"],
        protocols=("ppcc",), fused=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    body = fl.body_iters["ppcc"]
    lanes = len(golden8["figs"]) * len(golden8["mpl_grid"]) * \
        len(golden8["seeds"])
    log(f"[8] multipass: run_grid(horizon={golden8['horizon']:g}, "
        f"protocols=('ppcc',), fused=False): {lanes} lanes, {body} body "
        f"iterations, wall {wall:.3f} s ({wall / body * 1e3:.3f} ms an "
        f"iteration); kernel launches "
        f"{({k: v for k, v in counts.items() if v})}")
    check_lanes(out, ("ppcc",), golden8, "8", sweep)
    want = {"megastep": 0, "rowslab": 0, "rowslab_drain": 0,
            "reserve_cohort": body + 1, "occ_validate": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"[8] multipass launches {got}, expected {want}")
    fin = fl.final["ppcc"].pstate
    inv = {name: bool(fn(fin).all()) for name, fn in (
        ("path_length_leq_one", P.path_length_leq_one),
        ("acyclic", P.acyclic), ("classes_consistent", P.classes_consistent))}
    if not all(inv.values()):
        fail(f"[8] Theorem-1 invariants fail on the multipass states: {inv}")
    log(f"[8] multipass: every PPCC lane equals {PHASE8_GRID_GOLDEN.name} "
        f"(the fused grid's golden at horizon {golden8['horizon']:g}, cut "
        f"from phase 3's 5,000 for phase 13's time) in "
        f"{sweep.METRICS + ('now',)}; megastep "
        f"launched 0 times, reserve_cohort once per body iteration and once "
        f"for the init; Theorem-1 invariants hold {inv}")
    info["multipass"] = {"wall_s": wall, "iterations": body,
                         "wall_ms_per_iteration": wall / body * 1e3,
                         "launches": got}
    info["multipass_parts"] = fl.parts["ppcc"]
    del out, fl, fin

    # the one-event engine, eight seeds as lanes, each protocol
    gold = json.loads(EVENT_GOLDEN.read_text())
    p = SimParams(**gold["params"])
    if gold["step_mode"] != "event" or p != paper_figure_params(
            PHASE8_FIG).with_(mpl=PHASE8_MPL, horizon=p.horizon):
        fail(f"{EVENT_GOLDEN.name} does not hold phase 8's event runs")
    info["event"] = {}
    for proto in gold["protocols"]:
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = E.simulate_sweep(p, proto, gold["seeds"], step_mode="event",
                               device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        for k, want_v in gold["lanes"][proto].items():
            mine = res[k].tolist()
            if k == "now":
                want_v = np.asarray(want_v, np.float32).tolist()
            if mine != want_v:
                lane = next(i for i, (a, b) in enumerate(zip(mine, want_v))
                            if a != b)
                fail(f"[8] event {proto} lane {lane} (seed "
                     f"{gold['seeds'][lane]}): {k} {mine[lane]} on the card, "
                     f"{want_v[lane]} in the golden")
        if {k: v for k, v in counts.items() if v} != {"reserve_cohort": 1}:
            fail(f"[8] the event engine launched {counts}; only the init's "
                 f"reserve_cohort was expected")
        events = int(res["iters"].sum())
        most = int(res["iters"].max())
        info["event"][proto] = {"wall_s": wall, "lane_events": events,
                                "events_per_s": events / wall,
                                "wall_ms_per_event": wall / most * 1e3}
        log(f"[8] event {proto}: simulate_sweep(step_mode='event') over "
            f"seeds {gold['seeds']} at horizon {p.horizon:g}, MPL {p.mpl}: "
            f"every lane equals {EVENT_GOLDEN.name} in "
            f"{list(gold['lanes'][proto])}; "
            f"{events} lane-events (at most {most} in a lane, one batch "
            f"iteration each) in {wall:.3f} s, {events / wall:.1f} events/s, "
            f"{wall / most * 1e3:.3f} ms of wall an iteration; launches "
            f"{({k: v for k, v in counts.items() if v})} (the init's FCFS "
            f"reservation)")
    total = sum(v["wall_s"] for v in info["event"].values())
    log(f"[8] event engine: the three protocols took {total:.1f} s at the "
        f"golden's horizon {p.horizon:g} (cut from 3,000, where they took "
        f"298.7 s, from 1,000, 152-188 s, and from 600, 45.7-58.2 s)"
        + (", over the 100 s the phase plans for them" if total > 100
           else ""))
    info["event_params"] = p

    # simulate(): one lane, cohort mode, each protocol
    gold = json.loads(SIMULATE_GOLDEN.read_text())
    p1 = SimParams(**gold["params"])
    if gold["step_mode"] != "cohort" or p1 != paper_figure_params(
            PHASE8_FIG).with_(mpl=PHASE8_MPL, horizon=p1.horizon):
        fail(f"{SIMULATE_GOLDEN.name} does not hold phase 8's single runs")
    for proto in gold["protocols"]:
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = E.simulate(p1, proto, device=dev)
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        for k, v in gold["results"][proto].items():
            if getattr(res, k) != v:
                fail(f"[8] simulate {proto}: {k} {getattr(res, k)} on the "
                     f"card, {v} in the golden")
        body = counts["reserve_cohort"] - 1
        want = {"megastep": body if proto == "ppcc" else 0,
                "occ_validate": body if proto == "occ" else 0}
        if body < 1 or {k: counts[k] for k in want} != want:
            fail(f"[8] simulate {proto} launched {counts}")
        log(f"[8] simulate({proto}) at horizon {p1.horizon:g}: "
            f"{sim_line(res)} equal {SIMULATE_GOLDEN.name}; "
            f"{body} body iterations in {wall:.3f} s; launches "
            f"{({k: v for k, v in counts.items() if v})}")
    return info


def sim_line(res) -> str:
    return (f"commits {res.commits}, aborts {res.aborts}, blocks "
            f"{res.blocks}, ops {res.ops_executed}, time {res.sim_time:g}")


def phase8_kernels(torch, dev, sweep, E, P, ops, ref, bound, info) -> dict:
    """Phase 8, its kernels: admit_ops against its plain version at both
    shapes and the edges, through the entry points, timed beside its
    bounds; wc_acquire_many(exact=True) through twopl_admit; the device
    time of one multipass iteration and of one event.  Returns the
    admit_ops row of the kernel table."""
    from repro_torch.core import bitset as B
    from repro_torch.kernels import admit_ops as kao
    gen = torch.Generator().manual_seed(21)
    cases = {label: admit_ops_case(label, n, d, m, gen, torch, P, dev)
             for label, n, d, m in ADMIT_OPS_SHAPES}
    a_label = ADMIT_OPS_SHAPES[0][0]
    # each edge's state is made for its check and dropped after it
    checks = [(label, lambda c=c: c) for label, c in cases.items()]
    checks += [(label, lambda label=label: admit_ops_case(
        label, *ADMIT_OPS_SHAPES[0][1:], gen, torch, P, dev))
        for label in ADMIT_OPS_EDGES]
    checks += [(label, lambda n=n, d=d, m=m: admit_ops_case(
        "random", n, d, m, gen, torch, P, dev))
        for label, n, d, m in ADMIT_OPS_EDGE_SHAPES]
    err = 0.0
    plain_wall = {}
    routes = {}
    for label, make in checks:
        s, o = make()
        args = [t.contiguous() for t in (*s, *o)]
        routes[label] = kao.route(s.n, s.words)
        got = kao.admit_ops(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = ref.admit_ops_ref(*args)
        torch.cuda.synchronize()
        plain_wall[label] = time.perf_counter() - t
        e = max_abs_err(got, want, torch)
        if e or not bits_equal(got, want, torch):
            fail(f"[8] admit_ops differs from admit_ops_ref at {label} "
                 f"({routes[label]} route)")
        err = max(err, e)
        del s, o, args, got, want
    log(f"[8] admit_ops bit-equal to admit_ops_ref (verdicts and every "
        f"state leaf) at {[(lb, n, d, m) for lb, n, d, m in ADMIT_OPS_SHAPES]}"
        f" (label, n, d, m; every slot begun, a first batch admitted, a "
        f"quarter of the slots holding locks), at the edges "
        f"{list(ADMIT_OPS_EDGES)} of the first and at "
        f"{[(lb, n, d, m) for lb, n, d, m in ADMIT_OPS_EDGE_SHAPES]}; "
        f"routes {routes}")
    # the entry points, counts from 0: admit_ops and admit_ops_blocked
    ops.reset_launches()
    res = {}
    for label, (s, o) in cases.items():
        res[label] = P.admit_ops(s, *o)
        if label == a_label:
            by_index = P.admit_ops_blocked(s, *o, order="index")
            by_degree = P.admit_ops_blocked(s, *o, order="degree")
    torch.cuda.synchronize()
    launches = ops.launch_counts()["admit_ops"]
    if launches != len(cases) + 2:
        fail(f"[8] the admission entry points launched admit_ops "
             f"{launches} times, not {len(cases) + 2}")
    s, o = cases[a_label]
    for f in ("admitted", "blocked", "aborted"):
        if not torch.equal(getattr(by_index, f), getattr(res[a_label], f)):
            fail(f"[8] admit_ops_blocked(order='index') {f} differs")
    if not all(torch.equal(x, y) for x, y in zip(by_index.state,
                                                 res[a_label].state)):
        fail("[8] admit_ops_blocked(order='index') state differs")
    perm = P.admit_order_degree(s, *o).long()
    on_perm = P.admit_ops(s, *(t.gather(1, perm) for t in o))
    for f in ("admitted", "blocked", "aborted"):
        if not torch.equal(getattr(by_degree, f).gather(1, perm),
                           getattr(on_perm, f)):
            fail(f"[8] admit_ops_blocked(order='degree') {f} differs")
    if not all(torch.equal(x, y) for x, y in zip(by_degree.state,
                                                 on_perm.state)):
        fail("[8] admit_ops_blocked(order='degree') state differs")
    log(f"[8] admission entry points: admit_ops at both shapes and "
        f"admit_ops_blocked (index and degree order) at {a_label} launched "
        f"admit_ops {launches} times; order='index' equals admit_ops on the "
        f"list, order='degree' admit_ops on the admit_order_degree "
        f"permutation")
    # times and bounds
    sm_hz = max_sm_clock_hz()
    row = {"name": "admit_ops", "route": "cuda",
           "source": "src/repro_torch/csrc/admit_ops.cu",
           "replaces": "src/repro/core/ppcc.py:273-295 (an XLA scan)",
           "launches": launches, "max_abs_err": err, "library_ms": None,
           "entry": "core.ppcc.admit_ops / admit_ops_blocked"}
    for label, (s, o) in cases.items():
        args = [t.contiguous() for t in (*s, *o)]
        lanes, n, w = s.read_set.shape
        m = o[0].shape[1]
        steps = int(o[3].sum())
        ms = cuda_times(lambda: kao.admit_ops(*args), 10, torch)
        ms0 = cuda_times(lambda: kao.admit_ops(*args), 10, torch, False)
        # bytes: the state read and the new state written, the ops read,
        # the verdicts written; operations: the slot tests of every step
        state_b = lanes * (2 * n * w * 4 + n * n + 4 * n)
        nbytes = 2 * state_b + lanes * m * 10 + 3 * lanes * m
        b_ms, b_by = bound(nbytes, steps * n * ADMIT_OPS_SLOT_OPS)
        chain_ms = steps * ADMIT_OPS_STEP_DEPS * DEP_CYCLES / sm_hz * 1e3
        walk = kao.route(n, w)
        ns_step = ms * 1e6 / max(steps, 1)
        if label == a_label:
            pms = cuda_times(lambda: ref.admit_ops_ref(*args), 1, torch)
            row.update(ms=ms, ms_no_sleep=ms0, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, chain_bound_ms=chain_ms,
                       shape={"n": n, "W": w, "m": m, "valid": steps,
                              "walk_route": walk, "ns_per_step": ns_step})
        else:
            pms = plain_wall[label] * 1e3
            row["at_scale"] = {"n": n, "W": w, "m": m, "valid": steps,
                               "walk_route": walk, "ns_per_step": ns_step,
                               "ms": ms, "ms_no_sleep": ms0,
                               "plain_wall_ms": pms, "bound_ms": b_ms,
                               "bound_by": b_by, "chain_bound_ms": chain_ms}
        log(f"[8] admit_ops at {label} (n={n}, W={w}, m={m}, {steps} valid, "
            f"{walk} route): {ms:.4f} ms ({ms0:.4f} ms back to back), "
            f"{ns_step:.1f} ns per valid step; plain "
            f"{pms:.1f} ms{'' if label == a_label else ' (one call, wall)'}; "
            f"bound {b_ms:.5f} ms by {b_by} ({nbytes} B); chain bound "
            f"{chain_ms:.5f} ms ({steps} valid steps x {ADMIT_OPS_STEP_DEPS} "
            f"dependent instructions x {DEP_CYCLES} cycles at "
            f"{sm_hz / 1e6:.0f} MHz, "
            f"{chain_ms * 1e6 / max(steps, 1):.1f} ns a step); library: none")

    # wc_acquire_many(exact=True) through twopl_admit at the grid's shape
    init, cond, step = info["multipass_parts"]
    cfg = step.cfg
    figs = json.loads(PHASE3_GOLDEN.read_text())
    seed_l, mpl_l, rt_l = sweep.grid_lanes(figs["figs"], figs["mpl_grid"],
                                           figs["seeds"], dev)
    st = init(seed_l, mpl_l, rt_l)
    for _ in range(CAPTURE_ITERS):
        st = sweep._select(cond(st), step(st), st)
    c = E._classify(cfg, st)
    lanes, n = c.wc_m.shape
    # the captured state (its slots' write sets rarely meet) and random
    # write sets that do: 5 of 500 items a slot, a fifth holding locks
    wc_sets = {
        "captured": (st.pstate, c.wc_m | (st.pstate.active & (torch.rand(
            c.wc_m.shape, generator=gen) < 0.3).to(dev))),
        "random": (st.pstate._replace(
            write_set=B.pack(torch.rand((lanes, n, cfg.d), generator=gen)
                             < 0.01).to(dev),
            haslocks=(torch.rand((lanes, n), generator=gen) < 0.2).to(dev)),
            (torch.rand((lanes, n), generator=gen) < 0.5).to(dev))}
    for label, (ps, mask) in wc_sets.items():
        ops.reset_launches()
        got_s, got = P.wc_acquire_many(ps, mask, exact=True)
        torch.cuda.synchronize()
        n_launch = ops.launch_counts()["twopl_admit"]
        want_s, want = P.wc_acquire_many(
            P.PPCCState(*(t.cpu() for t in ps)), mask.cpu(), exact=True)
        if not torch.equal(got.cpu(), want) or not all(
                torch.equal(a.cpu(), b) for a, b in zip(got_s, want_s)):
            fail(f"[8] wc_acquire_many(exact=True) on the card differs "
                 f"from its plain loop at the {label} inputs")
        if n_launch != lanes:
            fail(f"[8] wc_acquire_many(exact=True) launched twopl_admit "
                 f"{n_launch} times for {lanes} lanes")
        wc_ms = cuda_times(lambda: P.wc_acquire_many(ps, mask, True), 5,
                           torch)
        log(f"[8] wc_acquire_many(exact=True) at the grid's shape, "
            f"{label} inputs ({lanes} lanes x n={n}, W={ps.words}; "
            f"{int(mask.sum())} masked slots, {int(got.sum())} winners) "
            f"bit-equal to its plain loop; {n_launch} twopl_admit launches "
            f"(one per lane), {wc_ms:.3f} ms a call")
    row["wc_acquire_many"] = {"twopl_admit_launches": n_launch,
                              "ms": wc_ms, "lanes": lanes}

    # device time of one multipass iteration and of one event
    m_wall = iteration_ms(cond, step, st, sweep, torch)
    dev_ms, kernels, per = profile_iteration(cond, step, st, sweep, torch)
    info["multipass"].update(iteration_wall_ms=m_wall,
                             iteration_device_ms=dev_ms,
                             iteration_kernels=kernels)
    log(f"[8] multipass PPCC batch iteration after {CAPTURE_ITERS}: "
        f"{m_wall:.3f} ms wall (32 iters), " + (
            f"{dev_ms:.3f} ms device kernel time ({kernels:.0f} kernels, "
            f"profiled), device idle {100 * (1 - dev_ms / m_wall):.1f}%"
            if dev_ms > 0 else "device time not measured (the profiler saw "
            "no device time)"))
    # one PPCC event (the three protocols' events cost alike: 3,839-3,981
    # kernels each in the first run of this phase)
    e_init, e_cond, e_step = E.engine_parts(info["event_params"], "ppcc",
                                            step_mode="event", device=dev)
    se = e_init(torch.arange(8, dtype=torch.int32, device=dev))
    for _ in range(EVENT_CAPTURE):
        se = sweep._select(e_cond(se), e_step(se), se)
    e_wall = iteration_ms(e_cond, e_step, se, sweep, torch, reps=8)
    e_dev, e_k, _ = profile_iteration(e_cond, e_step, se, sweep, torch,
                                      reps=4)
    info["event"]["ppcc"].update(iteration_wall_ms=e_wall,
                                 iteration_device_ms=e_dev,
                                 iteration_kernels=e_k)
    log(f"[8] one event (ppcc, 8 lanes) after {EVENT_CAPTURE}: "
        f"{e_wall:.3f} ms wall (8 iters), " + (
            f"{e_dev:.3f} ms device kernel time ({e_k:.0f} kernels, "
            f"profiled), device idle {100 * (1 - e_dev / e_wall):.1f}%"
            if e_dev > 0 else "device time not measured (the profiler saw "
            "no device time)"))
    row["phase8"] = {k: v for k, v in info.items()
                     if k in ("multipass", "event")}
    return row


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
    laps, t_lap = [], [t_start]

    def lap(label):
        """Seconds since the last lap, under ``label``, for the summary."""
        now = time.perf_counter()
        laps.append((label, round(now - t_lap[0], 1)))
        t_lap[0] = now
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

    lap("1 build")

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
    for g_ in (PHASE3_GOLDEN, PHASE6_GOLDEN, PHASE8_GRID_GOLDEN):
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
        f"at (n, d) = {EDGE_SHAPES}; largest n it takes at W = 1, 16, 64: "
        f"{[kmega.megastep_max_n(mw) for mw in (1, 16, 64)]}")

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
    drain_calls = capture_calls(lambda: dstep(s_d), kmega, "rowslab_drain")
    if len(drain_calls) != 1:
        fail(f"one delta body launched rowslab_drain {len(drain_calls)} "
             f"times, not once")
    dargs = drain_calls[0]
    dirty_m = dargs[9]
    m_lane = dirty_m.sum(1)
    log(f"[2] delta fleet after {CAPTURE_ITERS} iterations: every leaf but "
        f"rel equals the full-recompute fleet's; its next body launches "
        f"rowslab_drain once, for {int(m_lane.sum())} dirty slots over "
        f"{lanes} lanes (at most {int(m_lane.max())} in a lane, "
        f"{int((m_lane == 0).sum())} lanes with none)")
    before = [a.clone() for a in dargs]
    g = kmega.rowslab_drain(*dargs)
    w_ = ref.rowslab_drain_ref(*dargs, k=dstep.cfg.delta_k)
    torch.cuda.synchronize()
    errs["rowslab"] = max_abs_err(g, w_, torch)
    if errs["rowslab"] or not all(torch.equal(x, y) for x, y in zip(g, w_)):
        fail("rowslab_drain differs from rowslab_drain_ref at the main-path "
             "shape")
    if not all(torch.equal(a, b) for a, b in zip(dargs, before)):
        fail("rowslab_drain changed its inputs (the parent state) at the "
             "main-path shape")
    del before
    drain_edges = []
    for en, ed in SLAB_EDGE_N.items():
        args = random_drain_inputs(en, ed, gen, torch, B, dev)
        before = [a.clone() for a in args]
        g = kmega.rowslab_drain(*args)
        w_ = ref.rowslab_drain_ref(*args, k=min(SLAB_EDGE_K[-1], en))
        # the same tables off a 4-byte boundary: the kernel's byte path
        odd = [torch.empty(t.numel() + 1, dtype=torch.bool, device=dev)[1:]
               .view(t.shape).copy_(t) for t in args[2:6]]
        g_odd = kmega.rowslab_drain(*args[:2], *odd, *args[6:])
        torch.cuda.synchronize()
        e = max_abs_err(g, w_, torch)
        if e or not all(torch.equal(x, y) for x, y in zip(g, w_)) or \
                not all(torch.equal(x, y) for x, y in zip(g_odd, w_)):
            fail(f"rowslab_drain differs from rowslab_drain_ref at n={en}, "
                 f"d={ed}")
        if not all(torch.equal(a, b) for a, b in zip(args, before)):
            fail(f"rowslab_drain changed its inputs at n={en}")
        errs["rowslab"] = max(errs["rowslab"], e)
        drain_edges.append(en)
    log(f"[2] rowslab_drain bit-equal to rowslab_drain_ref at the main-path "
        f"shape and at n = {drain_edges} (lanes with no dirty slot, one, "
        f"all n and random masks; aligned tables and tables off a 4-byte "
        f"boundary), its inputs unchanged")
    # the slab entry at the delta fleet's shape: the captured dirty slots
    # as a slab of K = delta_k
    k = dstep.cfg.delta_k
    slab, valid, _ = P.dirty_slab(dirty_m, k)
    sargs = (*dargs[:2], *dargs[4:9], slab.contiguous(),
             valid.contiguous())
    g, w_ = kmega.rowslab(*sargs), ref.rowslab_ref(*sargs)
    torch.cuda.synchronize()
    errs["rowslab"] = max(errs["rowslab"], max_abs_err(g, w_, torch))
    if errs["rowslab"] or not all(torch.equal(x, y) for x, y in zip(g, w_)):
        fail("rowslab differs from rowslab_ref at the main-path shape")
    n_valid = valid.sum(1)
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
    log(f"[2] rowslab (the slab entry) bit-equal to rowslab_ref at K={k} on "
        f"the captured dirty slots ({int(n_valid.sum())} valid) and at "
        f"(n, K) = {slab_edges}, each with a random, an all-invalid and a "
        f"top-of-range slab")

    # reserve_cohort: the arguments of the next PPCC body's call (captured
    # as the drain's are), and the captured pools with random requests (20%
    # of the slots of each pool)
    C, K = s_p.cpu_free.shape[1], s_p.disk_free.shape[1]
    res_calls = capture_calls(lambda: fleet.parts["ppcc"][2](s_p), kscan,
                              "reserve_cohort")
    if len(res_calls) != 1:
        fail(f"one PPCC body called reserve_cohort {len(res_calls)} times, "
             f"not once")
    rreal = tuple(a.contiguous() for a in res_calls[0])
    c = E._classify(cfg_p, s_p)
    rargs = (s_p.cpu_free, s_p.disk_free, c.te,
             (torch.rand((lanes, n), generator=gen) * 10 + 10).to(dev),
             (torch.rand((lanes, n), generator=gen) * 20 + 25).to(dev),
             (torch.rand((lanes, n), generator=gen) < 0.2).to(dev),
             (torch.rand((lanes, n), generator=gen) < 0.2).to(dev))
    rargs = tuple(a.contiguous() for a in rargs)
    res_sets = {"captured": rreal, "random 20%": rargs}
    for label, a in res_sets.items():
        g, want = kscan.reserve_cohort(*a), ref.reserve_cohort_ref(*a)
        torch.cuda.synchronize()
        errs["reserve_cohort"] = max(errs["reserve_cohort"],
                                     max_abs_err(g, want, torch))
        if not bits_equal(g, want, torch):
            fail(f"reserve_cohort differs from its plain version at the "
                 f"{label} inputs (max abs err {errs['reserve_cohort']})")
        log(f"[2] reserve_cohort inputs '{label}': masked slots per lane "
            f"{masked_counts(a)}")
    for edge in RESERVE_EDGES:
        a = reserve_edge_inputs(*edge, gen, torch, dev, ref.INF)
        g, want = kscan.reserve_cohort(*a), ref.reserve_cohort_ref(*a)
        torch.cuda.synchronize()
        if not bits_equal(g, want, torch):
            fail(f"reserve_cohort differs from its plain version at the "
                 f"edge '{edge[0]}'")
    log(f"[2] reserve_cohort ({lanes} lanes, n={n}, {C} CPUs, {K} disks) "
        f"bit-equal to its plain version at the captured and random inputs "
        f"and at the edges "
        f"{[e[0] for e in RESERVE_EDGES]}")
    # occ_validate: the arguments of the next OCC body's call (captured as
    # reserve_cohort's are), and the captured OCC words with random
    # would-be committers (30% of the slots, as earlier versions timed it)
    _, s_o = captured["occ"]
    occ_calls = capture_calls(lambda: fleet.parts["occ"][2](s_o), kscan,
                              "occ_validate")
    if len(occ_calls) != 1:
        fail(f"one OCC body called occ_validate {len(occ_calls)} times, not "
             f"once")
    oreal = tuple(a.contiguous() for a in occ_calls[0])
    ps_o = s_o.pstate
    orand = ((torch.rand((lanes, n), generator=gen) < 0.3).to(dev),
             ps_o.read_set, s_o.dirty, ps_o.write_set)
    orand = tuple(a.contiguous() for a in orand)
    occ_sets = {"captured": oreal, "random 30%": orand}
    for label, a in occ_sets.items():
        g, w_ = kscan.occ_validate(*a), ref.occ_validate_ref(*a)
        torch.cuda.synchronize()
        errs["occ_validate"] = max(errs["occ_validate"],
                                   max_abs_err((g,), (w_,), torch))
        if not torch.equal(g, w_):
            fail(f"occ_validate differs from its plain version at the "
                 f"{label} inputs")
        log(f"[2] occ_validate inputs '{label}': would-be committers per "
            f"lane {committer_counts(a[0])}, {int(g.sum())} fail, "
            f"{int(a[2].ne(0).sum())} dirty words")
    for label, el, en, ed, ep in OCC_EDGES:
        words = [B.pack(torch.rand((el, en, ed), generator=gen) < q).to(dev)
                 for q in (min(0.3, 6 / ed), min(0.3, 3 / ed),
                           min(0.3, 3 / ed))]
        commit = (torch.rand((el, en), generator=gen) < ep).to(dev)
        g, w_ = (kscan.occ_validate(commit, *words),
                 ref.occ_validate_ref(commit, *words))
        torch.cuda.synchronize()
        if not torch.equal(g, w_):
            fail(f"occ_validate differs from its plain version at the edge "
                 f"'{label}'")
    log(f"[2] occ_validate ({lanes} lanes, n={n}, W={w}) bit-equal to its "
        f"plain version at the captured and random inputs and at the edges "
        f"{[e[0] for e in OCC_EDGES]}")

    lap("2 kernels")

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
    if counts["rowslab"] or counts["rowslab_drain"]:
        fail(f"rowslab launched {counts['rowslab']} times and rowslab_drain "
             f"{counts['rowslab_drain']} without delta")
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

    lap("3 grid")

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
    want6 = {"megastep": 1, "rowslab_drain": body6["ppcc"], "rowslab": 0,
             "reserve_cohort": sum(body6.values()) + len(protocols),
             "occ_validate": body6["occ"]}
    got6 = {key: counts6[key] for key in want6}
    if got6 != want6:
        fail(f"[6] launches {got6}, expected {want6}")
    log(f"[6] launches {got6}: megastep once (the PPCC init's seeding of "
        f"the carried relations), rowslab_drain once per PPCC body "
        f"iteration")
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

    lap("6 delta grid")

    # ---------------- phase 8, its runs (walls before any profiler) -------
    t8 = time.perf_counter()
    p8 = phase8_runs(torch, dev, sweep, E, P, ops,
                     json.loads(PHASE8_GRID_GOLDEN.read_text()))
    t8 = time.perf_counter() - t8

    lap("8 runs")

    # ---------------- phase 10: the moe, vlm and audio families ----------
    # (first of the LM phases, while the card holds no model: each of its
    # models is built, measured and freed in turn)
    p10_shapes, p10_launches, p10_busy = moe_vlm_audio_phase(
        torch, dev, smi, lambda fn, reps, sleep=True:
        cuda_times(fn, reps, torch, sleep))

    lap("10 moe, vlm, audio")

    # ---------------- phase 11: training (walls before any profiler) ------
    # (after phase 10 has freed its models: the full-depth run holds ~30 GB)
    bwd_row, p11_launches, p11_busy = train_phase(
        torch, dev, smi, lambda fn, reps, sleep=True:
        cuda_times(fn, reps, torch, sleep))

    lap("11 training")

    # ---------------- phase 12: rwkv training (walls before any profiler) -
    # (after phase 11 has freed its model: the full-depth run holds ~60 GB)
    wkv_bwd_row, p12_launches, p12_busy = rwkv_train_phase(
        torch, dev, smi, lambda fn, reps, sleep=True:
        cuda_times(fn, reps, torch, sleep), logs.get("wkv_bwd", ""))

    lap("12 rwkv training")

    # ---------------- phase 13: the multi-device modules -----------------
    # (after phase 12 has freed its model; walls before any profiler)
    p13_paths, p13_ranks = mesh_phase(
        torch, dev, smi, lambda fn, reps, sleep=True:
        cuda_times(fn, reps, torch, sleep))

    lap("13 mesh")

    # ---------------- phase 7: LM serving (walls before any profiler) ----
    lm_rows, lm_busy = lm_phase(torch, dev, smi, lambda fn, reps, sleep=True:
                               cuda_times(fn, reps, torch, sleep))

    lap("7 serving")

    # ---------------- phase 9: int8 and ring caches, the hybrid family ----
    p9_shapes, p9_launches, p9_busy = hybrid_int8_phase(
        torch, dev, smi, lambda fn, reps, sleep=True:
        cuda_times(fn, reps, torch, sleep))

    lap("9 caches, hybrid")

    # ---------------- phase 4: times ----------------
    torch.cuda.synchronize()
    mega_ms = cuda_times(lambda: kmega.megastep(*margs), 50, torch)
    mega0 = cuda_times(lambda: kmega.megastep(*margs), 50, torch, False)
    mega_plain = cuda_times(lambda: ref.megastep_ref(*margs), 10, torch)
    slab_ms = cuda_times(lambda: kmega.rowslab(*sargs), 50, torch)
    slab_plain = cuda_times(lambda: ref.rowslab_ref(*sargs), 5, torch)
    drain_ms = cuda_times(lambda: kmega.rowslab_drain(*dargs), 50, torch)
    drain0 = cuda_times(lambda: kmega.rowslab_drain(*dargs), 50, torch,
                        False)
    drain_plain = cuda_times(lambda: ref.rowslab_drain_ref(
        *dargs, k=dstep.cfg.delta_k), 5, torch)
    # reserve_cohort at the captured arguments (the row's times) and at the
    # random requests
    res_t = {label: [cuda_times(lambda: kscan.reserve_cohort(*a), 50, torch,
                                sleep) for sleep in (True, False)]
             for label, a in res_sets.items()}
    res_ms, res0 = res_t["captured"]
    res_plain = cuda_times(lambda: ref.reserve_cohort_ref(*rreal), 5, torch)
    # occ_validate at the captured arguments (the row's times) and at the
    # random would-be committers
    occ_t = {label: [cuda_times(lambda: kscan.occ_validate(*a), 50, torch,
                                sleep) for sleep in (True, False)]
             for label, a in occ_sets.items()}
    occ_ms, occ0 = occ_t["captured"]
    occ_plain = cuda_times(lambda: ref.occ_validate_ref(*oreal), 5, torch)

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
    # rowslab (the slab entry): words, op data and the slab; of the carried
    # tables, the one row (readers_at or writers_at) each non-slab slot's
    # party needs, as this slab holds them; four K x n outputs
    carried = int(((n - n_valid) * n).sum())
    s_bytes = (2 * lanes * n * w * 4 + lanes * n * 6 + lanes * k * 5
               + carried + 4 * lanes * k * n)
    s_ops = lanes * k * n * (pw + w)
    # rowslab_drain: the four tables written; of the carried ones, what the
    # copy keeps (a clean row's writers_at and readers_at rows and its dep
    # and ww entries at clean columns), which includes every row a clean
    # slot's party reads; the words of the lanes with a dirty slot; op
    # data and the dirty mask (4 + 3 B a slot)
    m_l = m_lane.to(torch.int64)
    kept = int(((n - m_l) * (2 * n + 2 * (n - m_l))).sum())
    d_words = int((m_l > 0).sum()) * 2 * n * w * 4
    d_bytes = 4 * lanes * n * n + kept + d_words + lanes * n * 7
    d_ops = int((m_l * n * (pw + w)).sum())
    r_bytes = (2 * lanes * (C + K) * 4 + 3 * lanes * n * 4 + 2 * lanes * n
               + 2 * lanes * n * 4)
    r_ops = lanes * n * (C + K + 4)
    # reserve_cohort's chain bound (reserve_chain_cycles at the max SM
    # clock), logged beside the row's bytes-and-operations bound
    sm_hz = max_sm_clock_hz()
    r_chain = {label: reserve_chain_cycles(a) / sm_hz * 1e3
               for label, a in res_sets.items()}
    # occ_validate: commit_pre read and fail written, and the three rows of
    # each would-be committer (the only slots that are steps); a LOP3 and
    # an OR a word of each
    o_commit = int(oreal[0].sum())
    o_bytes = 2 * lanes * n + o_commit * 3 * w * 4
    o_ops = o_commit * w * 2
    o_chain = {label: occ_chain_cycles(a[0]) / sm_hz * 1e3
               for label, a in occ_sets.items()}
    grid_rows = []
    for name, src, repl, ms, ms0, pms, (b_ms, b_by) in (
            ("megastep", "src/repro_torch/csrc/megastep.cu",
             "src/repro/kernels/megastep.py:38 (_megastep_kernel, "
             "pallas_call at :287)", mega_ms, mega0, mega_plain,
             bound(m_bytes, m_ops)),
            ("rowslab", "src/repro_torch/csrc/rowslab.cu",
             "src/repro/kernels/megastep.py:187 (rowslab; _rowslab_kernel "
             "at :118, pallas_call at :222)", drain_ms, drain0, drain_plain,
             bound(d_bytes, d_ops)),
            ("reserve_cohort", "src/repro_torch/csrc/scan.cu",
             "src/repro/core/jaxsim.py:666 (_reserve_cohort, an XLA scan)",
             res_ms, res0, res_plain, bound(r_bytes, r_ops)),
            ("occ_validate", "src/repro_torch/csrc/scan.cu",
             "src/repro/core/jaxsim.py:938 (occ_validate_multi, an XLA "
             "scan)", occ_ms, occ0, occ_plain, bound(o_bytes, o_ops))):
        grid_rows.append({"name": name, "route": "cuda", "source": src,
                          "replaces": repl, "max_abs_err": errs[name],
                          "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": None,
                          "ms_no_sleep": ms0})
        log(f"[4] {name}{' (the drain)' if name == 'rowslab' else ''}: "
            f"{ms:.4f} ms ({ms0:.4f} ms back to back; plain {pms:.4f} ms, "
            f"bound {b_ms:.5f} ms by "
            f"{b_by}) at the main-path shape")
    rb_ms, rb_by = bound(r_bytes, r_ops)
    grid_rows[2].update(
        inputs="the arguments of one PPCC body's call after "
               f"{CAPTURE_ITERS} iterations",
        chain_bound_ms=r_chain["captured"],
        masked=masked_counts(rreal),
        random={"masked": masked_counts(rargs),
                "ms": res_t["random 20%"][0],
                "ms_no_sleep": res_t["random 20%"][1]})
    log("[4] reserve_cohort: " + "; ".join(
        f"{label} inputs ({masked_counts(a)}): {res_t[label][0]:.4f} ms "
        f"({res_t[label][1]:.4f} back to back), chain bound "
        f"{r_chain[label]:.5f} ms" for label, a in res_sets.items())
        + f"; byte bound {rb_ms:.5f} ms ({rb_by}); the chain bound takes "
        f"the most masked slots of one pool of one lane x (2 ceil(log2 P) "
        f"+ 3) dependent instructions x {DEP_CYCLES} cycles at "
        f"{sm_hz / 1e6:.0f} MHz")
    ob_ms, ob_by = bound(o_bytes, o_ops)
    grid_rows[3].update(
        inputs="the arguments of one OCC body's call after "
               f"{CAPTURE_ITERS} iterations",
        chain_bound_ms=o_chain["captured"],
        committers=committer_counts(oreal[0]),
        random={"committers": committer_counts(orand[0]),
                "ms": occ_t["random 30%"][0],
                "ms_no_sleep": occ_t["random 30%"][1],
                "chain_bound_ms": o_chain["random 30%"]})
    log("[4] occ_validate: " + "; ".join(
        f"{label} inputs (would-be committers per lane "
        f"{committer_counts(a[0])}): {occ_t[label][0]:.4f} ms "
        f"({occ_t[label][1]:.4f} back to back), chain bound "
        f"{o_chain[label]:.5f} ms" for label, a in occ_sets.items())
        + f"; byte bound {ob_ms:.5f} ms ({ob_by}, {o_bytes} B at the "
        f"captured inputs); the chain bound takes the most would-be "
        f"committers of one lane x {OCC_STEP_DEPS} dependent instructions x "
        f"{DEP_CYCLES} cycles at {sm_hz / 1e6:.0f} MHz")
    sb_ms, sb_by = bound(s_bytes, s_ops)
    grid_rows[1].update(
        entry="rowslab_drain (csrc/rowslab.cu rowslab_drain_launch), once "
              "per PPCC iteration; the slab entry rowslab_launch is the "
              "reference's rowslab(..., slab, valid) API",
        drain_bytes=d_bytes, slab_ms=slab_ms, slab_plain_ms=slab_plain,
        slab_bound_ms=sb_ms, slab_bound_by=sb_by, slab_k=k)
    log(f"[4] rowslab_drain bound counts {d_bytes} B: the four {lanes} x "
        f"{n} x {n} tables written, {kept} B of carried entries kept, "
        f"{d_words} B of words for the {int((m_l > 0).sum())} lanes with a "
        f"dirty slot; the slab entry at K={k} on the same dirty slots: "
        f"{slab_ms:.4f} ms (plain {slab_plain:.4f} ms, bound {sb_ms:.5f} ms "
        f"by {sb_by}, {s_bytes} B with {carried} B of carried rows); library "
        f"call: none, no single PyTorch call computes either")

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
        dev_ms, kernels, per = profile_iteration(cond, step, st0, sweep,
                                                 torch)
        wall_ms = iter_ms["ppcc", label]
        slab = [v for key, v in per.items() if "rowslab" in key]
        if dev_ms > 0:
            log(f"[4] PPCC batch iteration ({label}): {dev_ms:.3f} ms device "
                f"kernel time ({kernels:.0f} kernels, profiled, 32 iters); "
                f"{wall_ms:.3f} ms wall unprofiled; device idle "
                f"{100 * (1 - dev_ms / wall_ms):.1f}% of the unprofiled "
                f"iteration; largest: " + ", ".join(
                    f"{k[:48]} {v:.3f} ms" for v, k in largest(per, 5))
                + (f"; row-slab kernels {sum(ms for ms, _ in slab):.4f} ms "
                   f"in {sum(c for _, c in slab):.0f} launches"
                   if label == "delta" else ""))
        else:
            log(f"[4] PPCC batch iteration ({label}): {wall_ms:.3f} ms wall; "
                f"device time not measured (profiler saw no device time)")
    _, cond, step = fleet.parts["occ"]
    dev_ms, kernels, per = profile_iteration(cond, step, captured["occ"][1],
                                             sweep, torch)
    wall_ms = iter_ms["occ", "kernels"]
    mine = [v for key, v in per.items() if "occ_validate" in key]
    if dev_ms > 0:
        log(f"[4] OCC batch iteration (kernels): {dev_ms:.3f} ms device "
            f"kernel time ({kernels:.0f} kernels, profiled, 32 iters); "
            f"{wall_ms:.3f} ms wall unprofiled; device idle "
            f"{100 * (1 - dev_ms / wall_ms):.1f}% of the unprofiled "
            f"iteration; occ_validate {sum(ms for ms, _ in mine):.4f} ms in "
            f"{sum(c for _, c in mine):.0f} launches; largest: " + ", ".join(
                f"{k[:48]} {v:.3f} ms" for v, k in largest(per, 5)))
    else:
        log(f"[4] OCC batch iteration (kernels): {wall_ms:.3f} ms wall; "
            f"device time not measured (profiler saw no device time)")
    del captured, s_d, sargs, margs, dargs

    lap("4 times, profiles")

    # ---------------- phase 5: the batch scheduler ----------------
    sched_rows = sched_phase(torch, dev, bound,
                             lambda fn, reps, sleep=True:
                             cuda_times(fn, reps, torch, sleep))

    lap("5 scheduler")

    # ---------------- phase 8, its kernels ----------------
    t = time.perf_counter()
    admit_row = phase8_kernels(torch, dev, sweep, E, P, ops, ref, bound, p8)
    log(f"[8] phase 8 in {t8 + time.perf_counter() - t:.1f} s ({t8:.1f} s "
        f"of runs, {time.perf_counter() - t:.1f} s of kernels and times)")

    lap("8 kernels")
    rows = []
    for row in grid_rows:
        if row["name"] == "rowslab":      # the drain, phase 6's path
            row = {**row, "launches": counts6["rowslab_drain"],
                   "slab_launches": counts6["rowslab"]}
        else:
            row = {**row, "launches": counts[row["name"]]}
        rows.append(row)
    rows += sched_rows
    lm_busy()
    p9_busy()
    del lm_busy, p9_busy               # their models: room for phase 10's
    torch.cuda.empty_cache()
    p10_busy()
    torch.cuda.empty_cache()
    p11_busy()
    torch.cuda.empty_cache()
    p12_busy()
    for row in lm_rows:
        if row["name"] == "flash_attention":
            row["launches_by_path"] = {
                "qwen3_0p6b prefill (phase 7)": row["launches"],
                **{f"{a} prefill (phase 9)": n for a, n in
                   p9_launches.items()},
                **{f"{a} prefill (phase 10)": n for a, n in
                   p10_launches.items()},
                "qwen3_0p6b training, 8 steps, with lse (phase 11)":
                    p11_launches}
            row["at_shapes"] = p9_shapes + p10_shapes
        if row["name"] == "wkv_chunked":
            row["launches_by_path"] = {
                "rwkv6_3b prefill (phase 7)": row["launches"],
                "rwkv6_3b training, 8 steps, with the saved states "
                "(phase 12)": p12_launches}
    rows += lm_rows
    rows.append(bwd_row)
    rows.append(wkv_bwd_row)
    rows.append(admit_row)
    # phase 13's launches, by the row each counter belongs to
    row_of = {"rowslab_drain": "rowslab", "flash_attention_tc":
              "flash_attention", "flash_attention_bwd_tc":
              "flash_attention_bwd"}
    for path, per in p13_paths.items():
        for counter, n_ in per.items():
            for row in rows:
                if row["name"] == row_of.get(counter, counter):
                    row.setdefault("launches_by_path", {})[
                        f"{path} (phase 13, {counter})"] = n_
    for row in rows:                      # phase 13's per-rank shapes
        if row["name"] in p13_ranks:
            row["at_rank_shapes"] = p13_ranks[row["name"]]
    lap("profiles of 7, 9, 10, 11, 12")
    log(f"[done] seconds by phase, in the order run: {dict(laps)}")
    log(f"[done] all thirteen phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
