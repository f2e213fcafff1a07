"""Training launcher: the port of ``repro/launch/train.py``.

A real training loop (sharded parameters, AdamW, the deterministic data
pipeline, async checkpoints, restart on failure) for any ``--arch``, on
the card by default:

    python -m repro_torch.launch.train --arch qwen3_0p6b --steps 8
    python -m repro_torch.launch.train --arch qwen3_0p6b --smoke --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2

The reference's flags, plus ``--device`` (``cuda`` unless asked) and
``--mesh DATAxMODEL`` (``1x1`` by default): the parameters and the AdamW
state are DTensors placed by the sharding rules on that mesh, and each
step reads ``make_global_batch``.  Under ``torchrun`` the world is its
processes (``env://``; on the card rank r uses ``cuda:LOCAL_RANK``, one
card a rank); otherwise one process makes a world of one.  The mesh must
hold every rank.  The published configuration trains at its full width
and depth; ``--smoke`` takes the reduced same-family one.  Rank 0 prints
the reference's two summary lines.  Every family trains, on the card
through the flash and WKV kernels (forward and backward), on the CPU
through their plain versions.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import configs
from ..data import pipeline
from ..device import resolve
from ..models import layers
from ..models.config import ModelConfig, ShapeSpec
from ..models.lm import LM
from ..optim import adamw
from ..parallel import sharding
from ..runtime import fault
from . import mesh as mesh_mod
from . import steps as steps_mod


def build(cfg: ModelConfig, *, batch: int = 8, seq: int = 128,
          lr: float = 1e-3, steps: int = 50, accum: int = 1, device=None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          inject_failure_at: Optional[int] = None, mesh=None):
    """(the ``ResilientLoop``, its ``make_batch``) of the launcher: one
    ``LM`` on ``device`` made trainable, re-initialised from seed 0 (the
    reference's ``PRNGKey(0)``) by every (re)start before a restore;
    AdamW with 5 warmup steps and a cosine to ``steps``; ``SyntheticLM``
    batches of ``batch`` x ``seq``; a checkpoint every ``ckpt_every`` steps
    (none if <= 0).  With a ``mesh`` every (re)start builds the model
    whole, initialises it and shards it by the rules
    (``sharding.shard_params``), and the batches are
    ``make_global_batch``'s."""
    dev = resolve(device)
    shape = ShapeSpec("cli", seq, batch, "train")
    lm = layers.trainable(LM(cfg, device="meta" if mesh else dev))
    opt_cfg = adamw.AdamWConfig(peak_lr=lr, warmup_steps=5,
                                total_steps=steps)
    step_fn = steps_mod.make_train_step(lm, opt_cfg, accum=accum)

    def init_state():
        gen = torch.Generator(dev).manual_seed(0)
        if mesh is None:
            model = lm.init(gen)
        else:
            model = sharding.shard_params(
                cfg, layers.trainable(LM(cfg, device=dev)).init(gen), mesh)
        return (model, adamw.init(dict(model.named_parameters())),
                pipeline.SyntheticLM(cfg, shape, seed=0))

    def make_batch(data: pipeline.SyntheticLM):
        if mesh is not None:
            return data.make_global_batch(mesh)
        return pipeline.to_device(data.host_batch(), dev)

    injector = fault.FailureInjector(
        [inject_failure_at] if inject_failure_at else [])
    loop = fault.ResilientLoop(
        fault.LoopConfig(ckpt_dir=ckpt_dir or default_ckpt_dir(),
                         ckpt_every=ckpt_every),
        step_fn, init_state, injector)
    return loop, make_batch


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: the mesh over every rank")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    resolve(args.device)                 # no card: raise before any group
    shape = tuple(int(a) for a in args.mesh.lower().split("x"))
    store = None
    if "RANK" in os.environ:                     # torchrun
        made = sharding.init_distributed(device=args.device)
    else:
        store = tempfile.mkdtemp(prefix="repro_torch_train_")
        made = sharding.init_distributed(f"file://{store}/store", 1, 0,
                                         device=args.device)
    lead = sharding.rank() == 0
    try:
        if shape[0] * shape[1] != sharding.world_size():
            raise ValueError(f"--mesh {args.mesh} holds {shape[0] * shape[1]}"
                             f" ranks, the world {sharding.world_size()}")
        mesh = mesh_mod.make_mesh(shape, ("data", "model"))
        loop, make_batch = build(
            cfg, batch=args.batch, seq=args.seq, lr=args.lr,
            steps=args.steps, accum=args.accum, device=args.device,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            inject_failure_at=args.inject_failure_at, mesh=mesh)
        t0 = time.time()
        summary = loop.run(make_batch, args.steps)
        dt = time.time() - t0
    finally:
        if made:
            dist.destroy_process_group()
        if store:
            shutil.rmtree(store, ignore_errors=True)
    if lead:
        print(f"arch={cfg.name} steps={summary['steps']} "
              f"restarts={summary['restarts']} "
              f"final_loss={summary['final_loss']:.4f} wall={dt:.1f}s")
        if loop.history:
            first = loop.history[0][1]
            last = loop.history[-1][1]
            print(f"loss {first:.4f} -> {last:.4f} "
                  f"({'improved' if last < first else 'NOT improved'})")
    return summary


if __name__ == "__main__":
    main()
