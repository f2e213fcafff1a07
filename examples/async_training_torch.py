"""Async elastic training with PPCC-scheduled commits, on the PyTorch
port: the twin of ``examples/async_training.py``.

K data-parallel replicas with heterogeneous step times (stragglers) push
delayed gradients to pages of a shared parameter store; each push is a
transaction over the pages it touches, and per tick the port's scheduler
(``repro_torch.sched.txstore.apply_tick``: the conflict and admission
kernels on the card, their plain versions on the CPU) admits a
serializable subset:

    PYTHONPATH=src python examples/async_training_torch.py --policy ppcc
    PYTHONPATH=src python examples/async_training_torch.py --device cpu

Reported: the ticks to finish N updates and the final loss of a tiny
quadratic model, as the reference prints them; the same seed gives the
reference's numbers.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.sched import txstore
from repro_torch.sched.txstore import TxBatch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="ppcc",
                    choices=["ppcc", "2pl", "occ"])
    ap.add_argument("--replicas", type=int, default=16)
    ap.add_argument("--pages", type=int, default=32)
    ap.add_argument("--updates", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve(args.device)

    rng = np.random.default_rng(0)
    k, pages, width = args.replicas, args.pages, 8
    # target: pages should converge to `target`
    target = torch.tensor(rng.standard_normal((pages, width)),
                          dtype=torch.float32, device=dev)
    store = torch.zeros((pages, width), device=dev)
    lr = 0.2

    # straggler model: replica i finishes a step every `period[i]` ticks
    period = rng.integers(1, 4, k)
    ready_at = period.copy()
    done = 0
    tick = 0
    aborted_work = 0
    while done < args.updates and tick < 10_000:
        tick += 1
        ready = ready_at <= tick
        if not ready.any():
            continue
        # each ready replica reads `r` pages and pushes grads to them
        reads = np.zeros((k, pages), bool)
        for i in np.where(ready)[0]:
            reads[i, rng.choice(pages, 4, replace=False)] = True
        writes = reads.copy()
        grads = np.zeros((k, pages, width), np.float32)
        err = (target - store).cpu().numpy()
        for i in np.where(ready)[0]:
            grads[i][reads[i]] = lr * err[reads[i]] / 1.0
        batch = TxBatch(read_sets=torch.tensor(reads, device=dev),
                        write_sets=torch.tensor(writes, device=dev),
                        payload=torch.tensor(grads, device=dev),
                        additive=torch.ones(k, dtype=torch.bool, device=dev),
                        valid=torch.tensor(ready, device=dev))
        store, _, stats = txstore.apply_tick(store, batch, args.policy)
        admitted = stats.admitted.cpu().numpy()
        aborted = stats.aborted.cpu().numpy()
        aborted_work += int(aborted.sum())
        done += int(admitted.sum())
        # admitted (and occ-aborted) replicas start their next step
        for i in np.where(ready)[0]:
            if admitted[i] or bool(aborted[i]):
                ready_at[i] = tick + period[i]
    loss = float(torch.mean((store - target) ** 2))
    print(f"policy={args.policy} updates={done} ticks={tick} "
          f"aborted_work={aborted_work} final_mse={loss:.4f}")


if __name__ == "__main__":
    main()
