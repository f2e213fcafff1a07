"""Serving launcher: continuous batching with PPCC-scheduled admission.

The port of ``repro/launch/serve.py``, line for line.  A request queue
feeds a fixed-size decode batch; per tick the scheduler
(``repro_torch.sched.scheduler.tick``: the conflict kernel and the
policy's admission scan on the card) admits a serializable subset of the
queued requests, which contend for shared KV-page slots (shared prefixes
read-shared, per-request pages written); admitted requests take free
slots, every occupied slot runs one batched ``decode_step``, and
finished requests free their slots for queued ones.  The decode caches
are whatever ``lm.init_caches`` gives the model's family: an int8 or
bf16 KV cache (dense, moe), a sliding-window ring (``seq`` beyond the
window), the vlm family's self-attention caches beside its cross caches
(zeros, as the reference serves them), the RWKV state or the hybrid
family's Mamba2 and shared-attention caches.  The audio encoder has no
decode caches: ``serve`` raises the reference's ``ValueError``.

``serve(lm, ...)`` runs the loop on the model's device and returns
``{ticks, tokens, wall}``; ``main()`` keeps the reference's flags, its
smoke-size model and its printed line, and adds ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0p6b \\
        --requests 64 --slots 16 --policy ppcc [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..models.lm import LM
from ..sched import scheduler
from . import steps as steps_mod


def request_sets(requests: int, pages: int):
    """The reference's request metadata from ``default_rng(0)``: page
    read and write sets (a shared prefix plus one own page each)."""
    rng = np.random.default_rng(0)
    n = requests
    read_sets = rng.random((n, pages)) < 0.06
    own = np.zeros((n, pages), bool)
    own[np.arange(n), rng.integers(0, pages, n)] = True
    read_sets |= own
    write_sets = own | (read_sets & (rng.random((n, pages)) < 0.25))
    return read_sets, write_sets


def serve(lm: LM, *, requests: int = 64, slots: int = 16, gen_len: int = 8,
          pages: int = 128, policy: str = "ppcc", seq: int = 64) -> dict:
    """Serve ``requests`` requests of ``gen_len`` tokens with ``slots``
    concurrent sequences; returns ``{"ticks", "tokens", "wall"}`` (wall
    in seconds, the device synchronised)."""
    dev = lm.device
    serve_step = steps_mod.make_serve_step(lm)
    caches = lm.init_caches(slots, seq)
    read_np, write_np = request_sets(requests, pages)
    read_sets = torch.from_numpy(read_np).to(dev)
    write_sets = torch.from_numpy(write_np).to(dev)
    n = requests

    state = np.full(n, -1)              # -1 queued, >=0 slot, -2 done
    remaining = np.full(n, gen_len)
    tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    free_slots = list(range(slots))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ticks = 0
    total_tokens = 0
    while (state != -2).any() and ticks < 10_000:
        ticks += 1
        # admission among queued requests for free slots
        queued = state == -1
        if queued.any() and free_slots:
            res = scheduler.tick(read_sets, write_sets,
                                 torch.from_numpy(queued).to(dev),
                                 policy=policy)
            for i in np.where(res.admitted.cpu().numpy())[0]:
                if not free_slots:
                    break
                state[i] = free_slots.pop()
        # one decode step for all occupied slots
        occupied = state >= 0
        if occupied.any():
            pos = min(ticks, seq - 1)
            logits, caches = serve_step(caches, tokens, pos)
            tokens = logits.argmax(-1)[:, None].to(torch.int32)
            total_tokens += int(occupied.sum())
            remaining[occupied] -= 1
            for i in np.where(occupied & (remaining <= 0))[0]:
                free_slots.append(int(state[i]))
                state[i] = -2
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"ticks": ticks, "tokens": total_tokens,
            "wall": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=16,
                    help="decode batch size (concurrent sequences)")
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--policy", default="ppcc",
                    choices=["ppcc", "2pl", "occ"])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = configs.get_smoke(args.arch)
    lm = LM(cfg, device=args.device)
    lm.init(torch.Generator(lm.device).manual_seed(0))
    out = serve(lm, requests=args.requests, slots=args.slots,
                gen_len=args.gen_len, pages=args.pages, policy=args.policy,
                seq=args.seq)
    n, dt = args.requests, out["wall"]
    print(f"policy={args.policy} requests={n} slots={args.slots} "
          f"ticks={out['ticks']} tokens={out['tokens']} "
          f"tok/s={out['tokens'] / max(dt, 1e-9):.0f} wall={dt:.1f}s")


if __name__ == "__main__":
    main()
