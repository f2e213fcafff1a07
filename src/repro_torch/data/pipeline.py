"""Deterministic, shardable, checkpointable synthetic token pipeline:
the port of ``repro/data/pipeline.py``, numpy as the reference's host
side, so the streams are the reference's to the bit.

Each row of the global batch at a step is drawn from its own seed
``(seed, step, row)``, so the stream needs no coordination, survives
restarts (its state is the step counter) and re-partitions on a new
mesh.  ``make_global_batch`` has each rank generate only its own rows
and returns DTensors sharded over the mesh's data axes.  ``Prefetcher``
keeps ``depth`` batches in flight on a background thread and exposes a
deadline (``get(timeout)`` raises ``queue.Empty``), the straggler hook
of the async trainer.  ``to_device`` moves a host batch to the model's
device (token ids as int64).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..models.config import ModelConfig, ShapeSpec


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(step=int(d["step"]))


def _tokens_for(cfg: ModelConfig, seed: int, step: int, lo: int, hi: int,
                seq: int) -> np.ndarray:
    """Rows [lo, hi) of the global batch at ``step``, each seeded on its
    own, so any shard of the batch sees the same data."""
    rows = []
    for r in range(lo, hi):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, r]))
        rows.append(rng.integers(0, cfg.vocab, (seq + 1,), dtype=np.int32))
    return np.stack(rows)


class SyntheticLM:
    """Deterministic LM batch stream (tokens + shifted labels; the vlm
    family's image tokens and the audio family's frames in place of
    tokens, as the reference's)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 state: Optional[PipelineState] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.state = state or PipelineState()

    def host_batch(self, step: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """The whole global batch at ``step`` (default: the stream's)."""
        step = self.state.step if step is None else step
        raw = _tokens_for(self.cfg, self.seed, step, 0,
                          self.shape.global_batch, self.shape.seq_len)
        out = {"tokens": raw[:, :-1], "labels": raw[:, 1:]}
        if self.cfg.family == "vlm":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 7]))
            out["img"] = rng.standard_normal(
                (self.shape.global_batch, self.cfg.n_img_tokens,
                 self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "audio":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 9]))
            out["frames"] = rng.standard_normal(
                (self.shape.global_batch, self.shape.seq_len,
                 self.cfg.d_model)).astype(np.float32)
            del out["tokens"]
        return out

    def make_global_batch(self, mesh, step: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """``host_batch``'s tensors as DTensors on ``mesh`` (token ids as
        int64, floats as float32): rows ``Shard(0)`` over its data axes
        (pod-major), replicated over ``model``.  Each rank draws only its
        rows of ``tokens`` and ``labels`` (``_tokens_for(lo, hi)``); the
        vlm family's ``img`` and the audio family's ``frames``, one draw
        for the whole batch, are cut to its rows.  The reference's
        returns ``tokens`` and ``labels`` only."""
        from torch.distributed.tensor import DTensor
        from ..parallel import sharding
        step = self.state.step if step is None else step
        b, s = self.shape.global_batch, self.shape.seq_len
        k, n = sharding.data_shard(mesh)
        if b % n:
            raise ValueError(f"global batch {b} does not split over {n} "
                             f"data shards")
        lo, hi = k * b // n, (k + 1) * b // n
        raw = _tokens_for(self.cfg, self.seed, step, lo, hi, s)
        rows = {"tokens": raw[:, :-1], "labels": raw[:, 1:]}
        if self.cfg.family in ("vlm", "audio"):
            whole = self.host_batch(step)
            rows.update({key: v[lo:hi] for key, v in whole.items()
                         if key not in rows})
            if "tokens" not in whole:
                del rows["tokens"]
        placements = sharding.to_placements(
            sharding.P(sharding.data_axes(mesh)), mesh)
        out = {}
        for key, loc in to_device(rows, mesh.device_type).items():
            loc = loc.contiguous()
            shape = (b, *loc.shape[1:])
            out[key] = DTensor.from_local(
                loc, mesh, placements, run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        return out

    def advance(self) -> None:
        self.state.step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.host_batch()
            self.advance()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: integer arrays (token ids,
    labels) as int64, float arrays as float32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.int64 if v.dtype.kind in "iu" else torch.float32)
        for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch with bounded depth; ``None`` after the
    iterator ends."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Blocks up to ``timeout``; raises ``queue.Empty`` on the
        deadline, so a caller may skip the step."""
        return self.q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
