"""Event-heap discrete-event simulator — the faithful oracle for the paper;
the port's numpy copy of ``repro/core/pysim.py``.

Implements the paper's simulation model (Section 3, after Agrawal-Carey-
Livny [1]): a closed system with a constant multiprogramming level (MPL),
FCFS CPU and disk resource pools, and three pluggable concurrency-control
protocols:

* ``ppcc``  — the paper's Prudent-Precedence protocol (Section 2),
* ``2pl``   — strict two-phase locking with timeout-based deadlock
              resolution (the paper's baseline),
* ``occ``   — Kung-Robinson backward-validation optimistic CC with
              restart (the paper's second baseline).

This module is intentionally *pure Python* and event-driven: it is the
semantics oracle that the tensorised engine (``core.engine``) and the
batch scheduler (``sched``) are validated against.

Transaction lifecycle (strict protocols, paper Section 2.3):

    read phase:  [CPU burst -> op][CPU burst -> op]...   (reads pay a disk
                 access; writes go to the private workspace)
    wait-to-commit (PPCC only): lock write set, wait for predecessors
    commit phase: flush written items to disk, release everything

A transaction whose operation is refused blocks; each block episode is
bounded by ``params.block_timeout`` after which the transaction aborts
and restarts (same operations) after a randomised restart delay.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .types import Op, OpKind, SimParams, SimResult
from . import workload
from ..obs import metrics as obs_metrics

PROCEED, BLOCK, ABORT = "proceed", "block", "abort"


class Txn:
    """One incarnation of a transaction (a restart creates a new epoch but
    reuses the object; ``epoch`` invalidates stale heap events)."""

    __slots__ = (
        "slot", "ops", "ip", "read_set", "write_set", "state", "epoch",
        "block_epoch", "first_start", "start_ts", "preceding", "preceded",
        "pred", "succ", "flush_left", "restarts", "block_started",
        "inc_id", "timeout_block_epoch", "wait_acc",
    )

    def __init__(self, slot: int, ops: List[Op], now: float):
        self.slot = slot
        self.ops = ops
        self.restarts = 0
        self.wait_acc = 0.0        # accumulated wait, persists restarts
        self.first_start = now
        self.epoch = 0
        self.reset(now)

    def reset(self, now: float) -> None:
        self.ip = 0
        self.read_set: Set[int] = set()
        self.write_set: Set[int] = set()
        self.state = "start"
        self.epoch += 1
        self.block_epoch = 0
        self.start_ts = now
        self.preceding = False          # PPCC class bit: has preceded someone
        self.preceded = False           # PPCC class bit: has been preceded
        self.pred: Set["Txn"] = set()   # j -> self  (j precedes self)
        self.succ: Set["Txn"] = set()   # self -> j  (self precedes j)
        self.flush_left = 0
        self.block_started = 0.0

    @property
    def cur_op(self) -> Op:
        return self.ops[self.ip]

    def __repr__(self) -> str:
        return f"T{self.slot}.{self.epoch}[{self.state}@{self.ip}]"


class _Pool:
    """FCFS multi-server resource pool (CPUs or disks)."""

    def __init__(self, n: int):
        self.free = n
        self.queue: deque = deque()

    def request(self, engine: "Engine", txn: Txn, dur: float, tag: str) -> None:
        if self.free > 0:
            self.free -= 1
            engine.schedule(engine.now + dur, tag, txn)
        else:
            self.queue.append((txn, txn.epoch, dur, tag))

    def release(self, engine: "Engine") -> None:
        self.free += 1
        while self.queue:
            txn, epoch, dur, tag = self.queue.popleft()
            if txn.epoch != epoch:      # stale (txn aborted while queued)
                continue
            self.free -= 1
            engine.schedule(engine.now + dur, tag, txn)
            break


# --------------------------------------------------------------------------
# Protocols
# --------------------------------------------------------------------------

class Protocol:
    """Uniform protocol interface used by the engine."""

    name = "base"

    def __init__(self, engine: "Engine"):
        self.e = engine

    # read-phase operation admission -------------------------------------
    def try_op(self, t: Txn, op: Op) -> str:
        raise NotImplementedError

    # called when the read phase finished; returns "flush" to start the
    # commit flush immediately, or "wait" if the protocol parked the txn.
    def on_read_done(self, t: Txn) -> str:
        raise NotImplementedError

    # commit finalisation (after flush I/O completed)
    def on_commit(self, t: Txn) -> None:
        raise NotImplementedError

    def on_abort(self, t: Txn) -> None:
        raise NotImplementedError


class PPCC(Protocol):
    """The paper's Prudent-Precedence protocol (Section 2.2-2.3)."""

    name = "ppcc"

    def __init__(self, engine: "Engine"):
        super().__init__(engine)
        self.readers: Dict[int, Set[Txn]] = {}   # item -> active readers
        self.writers: Dict[int, Set[Txn]] = {}   # item -> active ws writers
        self.locks: Dict[int, Txn] = {}          # wait-to-commit locks
        self.wc_lock_wait: List[Txn] = []        # txns waiting for wc locks
        self.wc_prec_wait: List[Txn] = []        # txns waiting for preds

    # -- precedence helpers ----------------------------------------------
    @staticmethod
    def _add_arc(a: Txn, b: Txn) -> None:
        """a -> b : a precedes b."""
        a.succ.add(b)
        b.pred.add(a)
        a.preceding = True
        b.preceded = True

    def _drop_txn_arcs(self, t: Txn) -> None:
        for j in t.succ:
            j.pred.discard(t)
        for j in t.pred:
            j.succ.discard(t)
        t.succ.clear()
        t.pred.clear()

    # -- rule ---------------------------------------------------------------
    def try_op(self, t: Txn, op: Op) -> str:
        x = op.item
        # Fig. 3: accessing an item exclusively locked by a wait-to-commit
        # transaction.
        owner = self.locks.get(x)
        if owner is not None and owner is not t:
            if owner in t.succ:          # t precedes the lock holder
                return ABORT             # avoid circular wait (paper Fig. 3)
            self.e._block_reason = "lock"
            return BLOCK                 # blocked until unlocked
        if op.kind == OpKind.READ:
            ws = self.writers.get(x)
            new_writers = [j for j in (ws or ()) if j is not t and j not in t.succ]
            if new_writers:
                # Prudent Precedence Rule: t (reader) precedes each writer.
                self.e._block_reason = "rule"
                if t.preceded:
                    return BLOCK         # (i) a preceded txn cannot precede
                if any(j.preceding for j in new_writers):
                    return BLOCK         # (ii) a preceding txn cannot be preceded
                for j in new_writers:
                    self._add_arc(t, j)
            t.read_set.add(x)
            self.readers.setdefault(x, set()).add(t)
            return PROCEED
        else:
            rs = self.readers.get(x)
            new_readers = [j for j in (rs or ()) if j is not t and j not in t.pred]
            if new_readers:
                # each reader j precedes t (writer)
                self.e._block_reason = "rule"
                if t.preceding:
                    return BLOCK
                if any(j.preceded for j in new_readers):
                    return BLOCK
                for j in new_readers:
                    self._add_arc(j, t)
            t.write_set.add(x)
            self.writers.setdefault(x, set()).add(t)
            return PROCEED

    # -- wait-to-commit phase (Section 2.3.2) -----------------------------
    def on_read_done(self, t: Txn) -> str:
        return self._try_wc_locks(t)

    def _try_wc_locks(self, t: Txn) -> str:
        # atomic all-or-nothing acquisition of exclusive locks on the write
        # set; avoids deadlocks between wait-to-commit transactions.
        if all(self.locks.get(x) is None or self.locks[x] is t
               for x in t.write_set):
            for x in t.write_set:
                self.locks[x] = t
            return self._try_commit(t)
        if t not in self.wc_lock_wait:
            self.wc_lock_wait.append(t)
        t.state = "wc_lock_wait"
        return "wait"

    def _try_commit(self, t: Txn) -> str:
        if t.pred:                        # some predecessor still active
            if t not in self.wc_prec_wait:
                self.wc_prec_wait.append(t)
            t.state = "wc_prec_wait"
            return "wait"
        if t in self.wc_prec_wait:
            self.wc_prec_wait.remove(t)
        return "flush"

    # -- leave events ------------------------------------------------------
    def _cleanup(self, t: Txn) -> None:
        for x in t.read_set:
            self.readers.get(x, set()).discard(t)
        for x in t.write_set:
            self.writers.get(x, set()).discard(t)
            if self.locks.get(x) is t:
                del self.locks[x]
        self._drop_txn_arcs(t)
        if t in self.wc_lock_wait:
            self.wc_lock_wait.remove(t)
        if t in self.wc_prec_wait:
            self.wc_prec_wait.remove(t)

    def _wake_waiters(self) -> None:
        # wait-to-commit lock waiters first (FCFS), then predecessors-
        # cleared transactions, then rule-blocked read-phase transactions.
        for t in list(self.wc_lock_wait):
            if t.state != "wc_lock_wait":
                self.wc_lock_wait.remove(t)
                continue
            if all(self.locks.get(x) is None or self.locks[x] is t
                   for x in t.write_set):
                self.wc_lock_wait.remove(t)
                if self._try_wc_locks(t) == "flush":
                    self.e.start_flush(t)
        for t in list(self.wc_prec_wait):
            if t.state != "wc_prec_wait":
                self.wc_prec_wait.remove(t)
                continue
            if not t.pred:
                self.wc_prec_wait.remove(t)
                self.e.start_flush(t)
        self.e.retry_blocked()

    def on_commit(self, t: Txn) -> None:
        self._cleanup(t)
        self._wake_waiters()

    def on_abort(self, t: Txn) -> None:
        self._cleanup(t)
        self._wake_waiters()


class TwoPL(Protocol):
    """Strict 2PL with shared/exclusive locks, lock upgrades and timeout-
    based deadlock resolution (blocked txns abort after the quantum)."""

    name = "2pl"

    def __init__(self, engine: "Engine"):
        super().__init__(engine)
        self.s_holders: Dict[int, Set[Txn]] = {}
        self.x_holder: Dict[int, Txn] = {}

    def try_op(self, t: Txn, op: Op) -> str:
        x = op.item
        self.e._block_reason = "lock"     # every 2PL block is a lock wait
        xh = self.x_holder.get(x)
        if op.kind == OpKind.READ:
            if xh is not None and xh is not t:
                return BLOCK
            self.s_holders.setdefault(x, set()).add(t)
            t.read_set.add(x)
            return PROCEED
        else:
            sh = self.s_holders.get(x, set())
            if xh is not None and xh is not t:
                return BLOCK
            if any(j is not t for j in sh):
                return BLOCK              # upgrade blocked by other readers
            self.x_holder[x] = t
            t.write_set.add(x)
            return PROCEED

    def on_read_done(self, t: Txn) -> str:
        return "flush"                    # strict 2PL: flush then release

    def _release(self, t: Txn) -> None:
        for x in t.read_set:
            self.s_holders.get(x, set()).discard(t)
        for x in t.write_set:
            if self.x_holder.get(x) is t:
                del self.x_holder[x]

    def on_commit(self, t: Txn) -> None:
        self._release(t)
        self.e.retry_blocked()

    def on_abort(self, t: Txn) -> None:
        self._release(t)
        self.e.retry_blocked()


class OCC(Protocol):
    """Kung-Robinson backward validation with overlapping write phases.

    A validating transaction T must check its read set against the write
    set of every transaction U that validated before T and whose write
    (flush) phase had not finished before T started — including those
    still flushing ("pending").  With the paper's read-before-write
    workload this condition is sufficient for serializability.
    """

    name = "occ"

    class _Entry:
        __slots__ = ("wset", "commit_time")

        def __init__(self, wset: Set[int]):
            self.wset = wset
            self.commit_time: Optional[float] = None   # None while flushing

    def __init__(self, engine: "Engine"):
        super().__init__(engine)
        self.log: List["OCC._Entry"] = []
        self._by_txn: Dict[int, "OCC._Entry"] = {}     # txn slot -> entry

    def try_op(self, t: Txn, op: Op) -> str:
        if op.kind == OpKind.READ:
            t.read_set.add(op.item)
        else:
            t.write_set.add(op.item)
        return PROCEED

    def on_read_done(self, t: Txn) -> str:
        for e in self.log:
            if e.commit_time is not None and e.commit_time <= t.start_ts:
                continue                        # finished before t started
            if e.wset & t.read_set:
                return "validate_fail"
        if t.write_set:
            entry = OCC._Entry(set(t.write_set))
            self.log.append(entry)
            self._by_txn[t.slot] = entry
        return "flush"

    def on_commit(self, t: Txn) -> None:
        e = self._by_txn.pop(t.slot, None)
        if e is not None:
            e.commit_time = self.e.now
        # prune entries that finished before the oldest active txn started
        oldest = min((x.start_ts for x in self.e.txns), default=self.e.now)
        self.log = [e for e in self.log
                    if e.commit_time is None or e.commit_time > oldest]

    def on_abort(self, t: Txn) -> None:
        # aborts only happen at validation failure, before logging
        pass


PROTOCOLS = {"ppcc": PPCC, "2pl": TwoPL, "occ": OCC}


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

class Engine:
    """Closed-loop event-driven engine around a Protocol."""

    def __init__(self, params: SimParams, protocol: str,
                 record_history: bool = False):
        self.p = params
        self.rng = np.random.default_rng(params.seed)
        self.now = 0.0
        self.heap: List[Tuple[float, int, str, Txn, int]] = []
        self._seq = itertools.count()
        self.cpu = _Pool(params.num_cpus)
        self.disk = _Pool(params.num_disks)
        self.proto: Protocol = PROTOCOLS[protocol](self)
        self.res = SimResult(protocol=protocol, params=params)
        self.blocked: deque = deque()     # rule/lock blocked read-phase txns
        self._in_retry = False
        self._retry_again = False
        # telemetry mirror of the compiled engine's obs layer: raw
        # per-commit samples (binned via obs.metrics in ``simulate``)
        # plus the abort/block cause taxonomies.  Pure accounting — no
        # RNG draws, so event order and results are unchanged.
        self.latencies: List[float] = []
        self.waits: List[float] = []
        self.restart_counts: List[int] = []
        self.abort_causes = {c: 0 for c in obs_metrics.ABORT_CAUSES}
        self.block_causes = {c: 0 for c in obs_metrics.BLOCK_CAUSES}
        self._block_reason = "lock"       # set by Protocol.try_op on BLOCK
        self.record_history = record_history
        # committed-history log of
        # (txn_slot, incarnation_id, kind, item, time, causal_seq)
        self.history: List[Tuple[int, int, int, int, float, int]] = []
        self._staged: Dict[int, List[Tuple[int, int, int, float, int]]] = {}
        self._opseq = itertools.count()   # causal tie-break for same-time ops
        self._incarnation = itertools.count()
        self.txns: List[Txn] = []
        for slot in range(params.mpl):
            t = Txn(slot, workload.sample_txn_ops(self.rng, params), 0.0)
            self.txns.append(t)
            self._begin(t)

    # -- plumbing -----------------------------------------------------------
    def schedule(self, when: float, tag: str, txn: Txn) -> None:
        heapq.heappush(self.heap, (when, next(self._seq), tag, txn, txn.epoch))

    def _begin(self, t: Txn) -> None:
        t.state = "read"
        if self.record_history:
            self._staged[t.slot] = []
            t.inc_id = next(self._incarnation)  # type: ignore[attr-defined]
        self._next_op(t)

    def _next_op(self, t: Txn) -> None:
        if t.ip >= len(t.ops):
            self._read_phase_done(t)
            return
        self.cpu.request(self, t, workload.cpu_burst(self.rng, self.p), "cpu")

    # -- events --------------------------------------------------------------
    def run(self) -> SimResult:
        horizon = self.p.horizon
        while self.heap:
            when, _, tag, txn, epoch = heapq.heappop(self.heap)
            if when > horizon:
                break
            self.now = when
            if txn.epoch != epoch:
                # stale event from a previous incarnation; resource events
                # must still free their server.
                if tag in ("cpu", "flush_io"):
                    (self.cpu if tag == "cpu" else self.disk).release(self)
                elif tag == "disk":
                    self.disk.release(self)
                continue
            getattr(self, f"_ev_{tag}")(txn)
        self.res.sim_time = min(self.now, horizon)
        return self.res

    def _ev_cpu(self, t: Txn) -> None:
        self.cpu.release(self)
        self._attempt_op(t)

    def _attempt_op(self, t: Txn) -> None:
        op = t.cur_op
        verdict = self.proto.try_op(t, op)
        if verdict == PROCEED:
            self.res.ops_executed += 1
            if self.record_history:
                self._staged[t.slot].append(
                    (t.inc_id, int(op.kind), op.item, self.now,  # type: ignore[attr-defined]
                     next(self._opseq)))
            t.ip += 1
            if op.kind == OpKind.READ:
                t.state = "disk"
                self.disk.request(self, t, workload.io_time(self.rng, self.p),
                                  "disk")
            else:
                self._next_op(t)          # workspace write: no disk
        elif verdict == BLOCK:
            self._block(t)
        else:
            self._abort(t, "precedence")

    def _ev_disk(self, t: Txn) -> None:
        self.disk.release(self)
        self._next_op(t)

    def _block(self, t: Txn) -> None:
        t.state = "blocked"
        t.block_epoch += 1
        t.block_started = self.now
        self.res.blocks += 1
        self.block_causes[self._block_reason] += 1
        self.blocked.append(t)
        self.schedule(self.now + self.p.block_timeout, "timeout", t)
        t.timeout_block_epoch = t.block_epoch  # type: ignore[attr-defined]

    def _ev_timeout(self, t: Txn) -> None:
        if t.state in ("blocked", "wc_lock_wait") and \
                getattr(t, "timeout_block_epoch", -1) == t.block_epoch:
            self._abort(t, "block_timeout" if t.state == "blocked"
                        else "wc_timeout")

    def retry_blocked(self) -> None:
        """Re-attempt every rule/lock-blocked read-phase transaction.

        Re-entrant calls (an abort during a retry wakes more waiters) are
        flattened into another pass of the outer loop.
        """
        if self._in_retry:
            self._retry_again = True
            return
        self._in_retry = True
        try:
            self._retry_again = True
            while self._retry_again:
                self._retry_again = False
                self._retry_pass()
        finally:
            self._in_retry = False

    def _retry_pass(self) -> None:
        for _ in range(len(self.blocked)):
            if not self.blocked:
                break
            t = self.blocked.popleft()
            if t.state != "blocked":
                continue
            op = t.cur_op
            verdict = self.proto.try_op(t, op)
            if verdict == PROCEED:
                t.wait_acc += self.now - t.block_started
                t.state = "read"
                t.block_epoch += 1        # invalidate the pending timeout
                self.res.ops_executed += 1
                if self.record_history:
                    self._staged[t.slot].append(
                        (t.inc_id, int(op.kind), op.item, self.now,  # type: ignore[attr-defined]
                         next(self._opseq)))
                t.ip += 1
                if op.kind == OpKind.READ:
                    t.state = "disk"
                    self.disk.request(self, t,
                                      workload.io_time(self.rng, self.p),
                                      "disk")
                else:
                    self._next_op(t)
            elif verdict == BLOCK:
                self.blocked.append(t)    # keep original timeout running
            else:
                self._abort(t, "precedence")

    # -- read phase end / commit ---------------------------------------------
    def _read_phase_done(self, t: Txn) -> None:
        t.state = "wc"
        outcome = self.proto.on_read_done(t)
        if outcome == "flush":
            self.start_flush(t)
        elif outcome == "validate_fail":
            self._abort(t, "validate_read")
        elif outcome == "wait":
            t.block_epoch += 1
            t.block_started = self.now
            if t.state == "wc_lock_wait":
                self.block_causes["wc_lock"] += 1
                self.schedule(self.now + self.p.block_timeout, "timeout", t)
                t.timeout_block_epoch = t.block_epoch  # type: ignore[attr-defined]
        # "wait": parked by the protocol; woken via protocol wake hooks

    def start_flush(self, t: Txn) -> None:
        if t.state in ("wc_lock_wait", "wc_prec_wait"):
            t.wait_acc += self.now - t.block_started
        t.state = "flush"
        t.block_epoch += 1
        t.flush_left = len(t.write_set)
        if t.flush_left == 0:
            self._commit(t)
        else:
            self.disk.request(self, t, workload.io_time(self.rng, self.p),
                              "flush_io")

    def _ev_flush_io(self, t: Txn) -> None:
        self.disk.release(self)
        t.flush_left -= 1
        if t.flush_left > 0:
            self.disk.request(self, t, workload.io_time(self.rng, self.p),
                              "flush_io")
        else:
            self._commit(t)

    def _commit(self, t: Txn) -> None:
        t.state = "committed"
        self.res.commits += 1
        self.res.sum_response_time += self.now - t.first_start
        self.latencies.append(self.now - t.first_start)
        self.waits.append(t.wait_acc)
        self.restart_counts.append(t.restarts)
        if self.record_history:
            for inc_id, kind, item, ts, seq in self._staged.pop(t.slot, []):
                # reads at read time; writes become visible at commit time
                # (fresh causal seq: the flush happens-before any wake-ups
                # triggered by this commit)
                if kind == int(OpKind.WRITE):
                    at, seq = self.now, next(self._opseq)
                else:
                    at = ts
                self.history.append((t.slot, inc_id, kind, item, at, seq))
        self.proto.on_commit(t)
        # closed loop: replace with a fresh transaction in the same slot
        t.ops = workload.sample_txn_ops(self.rng, self.p)
        t.reset(self.now)
        t.first_start = self.now
        t.restarts = 0
        t.wait_acc = 0.0
        self._begin(t)

    def _abort(self, t: Txn, cause: str) -> None:
        if t.state in ("blocked", "wc_lock_wait", "wc_prec_wait"):
            t.wait_acc += self.now - t.block_started
        self.abort_causes[cause] += 1
        t.state = "aborted"
        self.res.aborts += 1
        if self.record_history:
            self._staged[t.slot] = []
        self.proto.on_abort(t)
        ops = t.ops                        # restart the same transaction
        t.reset(self.now)
        t.ops = ops
        t.restarts += 1
        self.res.restarts += 1
        self.schedule(self.now + workload.restart_delay(self.rng, self.p),
                      "restart", t)

    def _ev_restart(self, t: Txn) -> None:
        self._begin(t)


def simulate(params: SimParams, protocol: str,
             record_history: bool = False) -> SimResult:
    eng = Engine(params, protocol, record_history=record_history)
    res = eng.run()
    if record_history:
        res.history = eng.history  # type: ignore[attr-defined]

    def hist(vals, nbins):
        return np.bincount(obs_metrics.value_bin(np.asarray(vals)),
                           minlength=nbins)[:nbins] if len(vals) \
            else np.zeros(nbins, np.int64)

    res.telemetry = {
        "latencies": eng.latencies,
        "waits": eng.waits,
        "restart_counts": eng.restart_counts,
        "lat_hist": hist(eng.latencies, obs_metrics.NBINS),
        "wait_hist": hist(eng.waits, obs_metrics.NBINS),
        "restart_hist": np.bincount(
            np.minimum(eng.restart_counts, obs_metrics.RBINS - 1),
            minlength=obs_metrics.RBINS)[:obs_metrics.RBINS]
        if eng.restart_counts else np.zeros(obs_metrics.RBINS, np.int64),
        "abort_causes": dict(eng.abort_causes),
        "block_causes": dict(eng.block_causes),
    }
    return res


def serialization_graph(history) -> Dict[int, Set[int]]:
    """Build the serialization graph of a committed history.

    ``history`` is a list of (slot, incarnation, kind, item, time, seq)
    for committed transactions only.  Edge u -> v iff an op of u precedes
    and conflicts with an op of v (paper Section 2.4).  Ties in time are
    broken by the causal sequence number.
    """
    by_item: Dict[int, List[Tuple[float, int, int, int]]] = {}
    for _, inc, kind, item, at, seq in history:
        by_item.setdefault(item, []).append((at, seq, kind, inc))
    g: Dict[int, Set[int]] = {}
    for ops in by_item.values():
        ops.sort()
        for i, (t1, _, k1, u) in enumerate(ops):
            for t2, _, k2, v in ops[i + 1:]:
                if u != v and (k1 == int(OpKind.WRITE) or
                               k2 == int(OpKind.WRITE)):
                    g.setdefault(u, set()).add(v)
                    g.setdefault(v, set())
    return g


def is_acyclic(g: Dict[int, Set[int]]) -> bool:
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {u: WHITE for u in g}
    def visit(u: int) -> bool:
        stack = [(u, iter(g.get(u, ())))]
        color[u] = GRAY
        while stack:
            node, it = stack[-1]
            for v in it:
                c = color.get(v, WHITE)
                if c == GRAY:
                    return False
                if c == WHITE:
                    color[v] = GRAY
                    stack.append((v, iter(g.get(v, ()))))
                    break
            else:
                color[node] = BLACK
                stack.pop()
        return True
    for u in list(g):
        if color[u] == WHITE:
            if not visit(u):
                return False
    return True
