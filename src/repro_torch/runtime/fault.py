"""Fault tolerance: the checkpoint/restart driver with failure injection,
the port of ``repro/runtime/fault.py`` for one device.

``ResilientLoop`` wraps a train step with:

* periodic async checkpoints (``ckpt.AsyncSaver``; ``ckpt_every`` <= 0
  writes none),
* restart from the latest checkpoint on any exception from the step, up
  to ``max_restarts`` times,
* a failure injector for tests (``FailureInjector``),
* a bad-step guard: a non-finite loss counts toward ``bad_step_limit``
  and its update is not applied.  The reference drops the params and
  state such a step returned; the port's train step updates in place, so
  it applies nothing when its loss is not finite (``launch.steps``) and
  the loop keeps what it holds.

``init_state() -> (params, opt_state, data)`` and ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``.  ``params`` is an
``nn.Module`` (its ``named_parameters`` are what a checkpoint holds, and
a restore copies into them in place) or a dict of tensors.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint import ckpt


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 10
    max_restarts: int = 3
    bad_step_limit: int = 5


class FailureInjector:
    """Deterministic fault injection for tests: raises once at each step
    of ``fail_at``."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def _tree(params):
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def _put(params, restored):
    """``restored`` (a tree like ``_tree(params)``) into ``params``."""
    if isinstance(params, torch.nn.Module):
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(restored[name])
        return params
    return restored


class ResilientLoop:
    def __init__(self, cfg: LoopConfig, train_step: Callable,
                 init_state: Callable[[], Any],
                 injector: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.init_state = init_state
        self.injector = injector or FailureInjector()
        self.saver = ckpt.AsyncSaver()
        self.restarts = 0
        self.history: list = []

    def _state(self, params, opt_state, data_state) -> dict:
        return {"params": _tree(params), "opt": opt_state,
                "data_step": np.asarray(data_state.state.step, np.int64)}

    def _restore_or_init(self):
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        params, opt_state, data_state = self.init_state()
        if last is None:
            return params, opt_state, data_state, 0
        restored = ckpt.restore(self.cfg.ckpt_dir, last,
                                self._state(params, opt_state, data_state))
        data_state.state.step = int(restored["data_step"])
        return (_put(params, restored["params"]), restored["opt"],
                data_state, last)

    def run(self, make_batch: Callable[[Any], Dict], n_steps: int) -> Dict:
        """Runs to ``n_steps`` with restart-on-failure; returns a summary
        (``steps``, ``restarts``, ``bad_steps``, ``final_loss``)."""
        bad_steps = 0
        while True:
            try:
                params, opt_state, data_state, step = \
                    self._restore_or_init()
                while step < n_steps:
                    self.injector.maybe_fail(step)
                    batch = make_batch(data_state)
                    new_p, new_o, metrics = self.train_step(
                        params, opt_state, batch)
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        bad_steps += 1          # the step applied nothing
                        if bad_steps > self.cfg.bad_step_limit:
                            raise RuntimeError("too many non-finite steps")
                    else:
                        params, opt_state = new_p, new_o
                        self.history.append((step, loss))
                    data_state.advance()
                    step += 1
                    if self.cfg.ckpt_every > 0 and \
                            step % self.cfg.ckpt_every == 0:
                        self.saver.save_async(
                            self.cfg.ckpt_dir, step,
                            self._state(params, opt_state, data_state))
                self.saver.wait()
                return {"steps": step, "restarts": self.restarts,
                        "bad_steps": bad_steps,
                        "final_loss": self.history[-1][1]
                        if self.history else None}
            except Exception:                    # noqa: BLE001
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.saver.wait()                # flush pending save
