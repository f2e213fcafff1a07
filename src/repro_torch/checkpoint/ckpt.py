"""Sharded, atomic, async checkpointing (numpy files and a JSON manifest):
the port of ``repro/checkpoint/ckpt.py``.

Layout of a checkpoint directory::

    <root>/step_000123/
        manifest.json      leaf ids, shapes, dtypes, the shard map
        <leaf-id>.s<k>.npy one file per (leaf, distinct shard)

* **atomic**: written into ``<root>/.tmp_step_000123``, then renamed;
  ``latest_step`` ignores a directory without its manifest (a crash
  mid-write).
* **async**: ``AsyncSaver.save_async`` copies every tensor (a DTensor's
  local shard) to host memory at once (the consistency point: the train
  step updates its tensors in place afterwards) and writes the files on
  a thread.
* **sharded**: in a tree that holds DTensors every rank writes the
  shards it holds, each distinct shard once (by the rank at coordinate 0
  of the mesh dims that replicate it), with the reference's ``index``
  (``[[start, stop], ...]`` per dim); after a barrier rank 0 writes the
  manifest and renames.  The rest of such a tree is rank 0's to write.
  Each rank's files go out on its thread, and the barrier, manifest and
  rename wait for ``AsyncSaver.wait`` on the caller's thread, so no
  collective runs beside the caller's.  ``restore`` fills each target
  DTensor's local shard from the saved shards that overlap it, whatever
  mesh saved them: the elastic path (``runtime/elastic.py``).
* **bf16** has no numpy dtype: its raw 16 bits are stored as int16 and
  the manifest keeps the dtype, so a restore gives the same bits.

A tree is nested dicts (keys in sorted order, as JAX flattens them),
NamedTuples, lists and tuples whose leaves are tensors or numpy arrays;
``restore`` fills the structure of a target tree, each tensor on its
target leaf's device (a DTensor on its mesh and placements) and each
numpy leaf as numpy.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in flattening order; ``None`` is no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in _leaves(v, path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (str(i),))]
    if tree is None:
        return []
    return [(path, tree)]


def _rebuild(tree: Any, it) -> Any:
    """``tree``'s structure with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        out = {k: None for k in tree}
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], it)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if tree is None:
        return None
    return next(it)


def _leaf_ids(tree: Any) -> List[str]:
    ids = ["_".join(p).replace("/", "_") or "leaf" for p, _ in _leaves(tree)]
    seen: dict = {}
    uniq = []
    for n in ids:
        k = seen.get(n, 0)
        seen[n] = k + 1
        uniq.append(f"{n}.{k}" if k else n)
    return uniq


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy, the dtype's name): bf16 as its raw int16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        name = _dtype_name(t)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    a = np.array(leaf, copy=True)
    return a, a.dtype.name


# --------------------------------------------------------------------------
# shards of a DTensor
# --------------------------------------------------------------------------

def _shard_index(shape, mesh_shape, placements, coord) -> List[List[int]]:
    """``[[start, stop], ...]`` of the shard at mesh coordinate ``coord``:
    a dim sharded by several mesh dims splits over them in mesh order."""
    index = []
    for d, dim in enumerate(shape):
        k, n = 0, 1
        for m, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == d:
                k, n = k * mesh_shape[m] + coord[m], n * mesh_shape[m]
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {n} shards")
        index.append([k * dim // n, (k + 1) * dim // n])
    return index


def _shard_number(mesh_shape, placements, coord) -> int:
    """The shard's number: its coordinate over the sharding mesh dims."""
    k = 0
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            k = k * mesh_shape[m] + coord[m]
    return k


def _shards(x: DTensor) -> List[Tuple[int, List[List[int]]]]:
    """Every distinct shard of ``x``: (number, index), by number."""
    mesh_shape = tuple(x.device_mesh.shape)
    out = {}
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        coord = tuple(c if isinstance(p, Shard) else 0
                      for c, p in zip(coord, x.placements))
        k = _shard_number(mesh_shape, x.placements, coord)
        out.setdefault(k, _shard_index(x.shape, mesh_shape, x.placements,
                                       coord))
    return sorted(out.items())


def _mine(x: DTensor) -> Tuple[int, List[List[int]], bool]:
    """(number, index, whether this rank writes it) of this rank's shard:
    the rank at coordinate 0 of every replicating mesh dim writes."""
    mesh_shape = tuple(x.device_mesh.shape)
    coord = x.device_mesh.get_coordinate()
    writer = all(c == 0 for c, p in zip(coord, x.placements)
                 if not isinstance(p, Shard))
    return (_shard_number(mesh_shape, x.placements, coord),
            _shard_index(x.shape, mesh_shape, x.placements, coord), writer)


def _is_sharded(tree) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in _leaves(tree))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------

class _Pending:
    """A save whose files are (being) written: ``entries`` is the
    manifest's leaves, ``files`` the (name, array) pairs this rank
    writes."""

    def __init__(self, root, step: int, sharded: bool):
        self.root = Path(root)
        self.step = step
        self.sharded = sharded
        self.final = self.root / f"step_{step:08d}"
        self.tmp = self.root / f".tmp_step_{step:08d}"
        self.entries: list = []
        self.files: list = []

    def write_files(self) -> None:
        for fn, arr in self.files:
            np.save(self.tmp / fn, arr)

    def finish(self) -> Path:
        """The manifest and the rename (rank 0), between barriers when
        sharded."""
        if self.sharded:
            dist.barrier()
        if not self.sharded or _rank() == 0:
            manifest = {"step": self.step, "leaves": self.entries}
            (self.tmp / "manifest.json").write_text(json.dumps(manifest))
            if self.final.exists():
                shutil.rmtree(self.final)
            self.tmp.rename(self.final)
        if self.sharded:
            dist.barrier()
        return self.final


def _snapshot(root, step: int, tree) -> _Pending:
    """Host copies of what this rank writes, the manifest's entries, and
    a fresh temporary directory (every rank past a barrier when
    sharded)."""
    sharded = _is_sharded(tree)
    job = _Pending(root, step, sharded)
    lead = not sharded or _rank() == 0
    if lead:
        if job.tmp.exists():
            shutil.rmtree(job.tmp)
        job.tmp.mkdir(parents=True)
    if sharded:
        dist.barrier()
    for lid, (_, leaf) in zip(_leaf_ids(tree), _leaves(tree)):
        kind = "torch" if torch.is_tensor(leaf) else "numpy"
        if isinstance(leaf, DTensor):
            k, _, writer = _mine(leaf)
            if writer:
                arr, _ = _to_host(leaf.to_local())
                job.files.append((f"{lid}.s{k}.npy", arr))
            job.entries.append({
                "id": lid, "shape": list(leaf.shape),
                "dtype": _dtype_name(leaf), "kind": kind,
                "shards": [{"file": f"{lid}.s{n}.npy", "index": index}
                           for n, index in _shards(leaf)]})
            continue
        arr, dtype = _to_host(leaf) if lead else (None, None)
        if lead:
            job.files.append((f"{lid}.s0.npy", arr))
        job.entries.append({"id": lid, "shape": list(np.shape(leaf)),
                            "dtype": dtype, "kind": kind,
                            "shards": [{"file": f"{lid}.s0.npy",
                                        "index": None}]})
    return job


def save(root: os.PathLike, step: int, tree: Any) -> Path:
    """Synchronous save; returns the final directory.  Every rank calls
    it for a tree with DTensors."""
    job = _snapshot(root, step, tree)
    job.write_files()
    return job.finish()


class AsyncSaver:
    """Snapshot to host, then write on a thread; one save outstanding.
    ``wait`` completes the outstanding save (on every rank together, for
    a sharded tree)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._job: Optional[_Pending] = None
        self.last_path: Optional[Path] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._job is not None:
            job, self._job = self._job, None
            self.last_path = job.finish()

    def save_async(self, root: os.PathLike, step: int, tree: Any) -> None:
        self.wait()
        self._job = _snapshot(root, step, tree)       # consistency point
        self._thread = threading.Thread(target=self._job.write_files,
                                        daemon=True)
        self._thread.start()


def latest_step(root: os.PathLike) -> Optional[int]:
    """The newest complete checkpoint's step (``None`` if none)."""
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in root.iterdir()
             if d.name.startswith("step_") and (d / "manifest.json").exists()]
    return max(steps) if steps else None


# --------------------------------------------------------------------------
# restore
# --------------------------------------------------------------------------

def _read(root: Path, entry: dict, want: List[List[int]]) -> np.ndarray:
    """The region ``want`` (``[[start, stop], ...]``) of a saved leaf, from
    every saved shard that overlaps it (bf16 as its int16 bits)."""
    out = None
    for s in entry["shards"]:
        data = np.load(root / s["file"], mmap_mode="r")
        have = s["index"] or [[0, n] for n in data.shape]
        lo = [max(a, w0) for (a, _), (w0, _) in zip(have, want)]
        hi = [min(b, w1) for (_, b), (_, w1) in zip(have, want)]
        if any(a >= b for a, b in zip(lo, hi)) and want:
            continue
        if out is None:
            out = np.empty([w1 - w0 for w0, w1 in want], data.dtype)
        src = tuple(slice(a - h0, b - h0) for a, b, (h0, _) in
                    zip(lo, hi, have))
        dst = tuple(slice(a - w0, b - w0) for a, b, (w0, _) in
                    zip(lo, hi, want))
        out[dst] = data[src]
    return out


def _tensor(arr: np.ndarray, entry: dict) -> torch.Tensor:
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    if entry["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def restore(root: os.PathLike, step: int, target_tree: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``target_tree``: each
    tensor leaf restored to its target's device (its saved dtype, raising
    if it differs from the target's), a DTensor target's local shard read
    from the saved shards that overlap it and placed as the target is,
    each numpy leaf as numpy."""
    root = Path(root) / f"step_{step:08d}"
    manifest = json.loads((root / "manifest.json").read_text())
    by_id = {e["id"]: e for e in manifest["leaves"]}
    out = []
    for lid, (_, leaf) in zip(_leaf_ids(target_tree), _leaves(target_tree)):
        e = by_id[lid]
        if tuple(e["shape"]) != tuple(leaf.shape):
            raise ValueError(f"{lid}: saved shape {tuple(e['shape'])}, "
                             f"target {tuple(leaf.shape)}")
        if torch.is_tensor(leaf) and (e.get("kind") != "torch" or
                                      e["dtype"] != _dtype_name(leaf)):
            raise ValueError(f"{lid}: saved {e['dtype']}, target "
                             f"{leaf.dtype}")
        if isinstance(leaf, DTensor):
            _, index, _ = _mine(leaf)
            loc = _tensor(_read(root, e, index), e).to(leaf.device)
            val = DTensor.from_local(loc, leaf.device_mesh, leaf.placements,
                                     run_check=False, shape=leaf.shape,
                                     stride=leaf.stride())
        else:
            arr = _read(root, e, [[0, n] for n in e["shape"]])
            val = _tensor(arr, e).to(leaf.device) \
                if torch.is_tensor(leaf) else np.asarray(arr)
        out.append(val)
    return _rebuild(target_tree, iter(out))
