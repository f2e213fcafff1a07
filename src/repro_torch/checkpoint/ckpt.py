"""Atomic, async checkpointing (numpy files and a JSON manifest): the port
of ``repro/checkpoint/ckpt.py`` for one device.

Layout of a checkpoint directory::

    <root>/step_000123/
        manifest.json      leaf ids, shapes, dtypes, files
        <leaf-id>.s0.npy   one file per leaf (one device: one shard)

* **atomic**: written into ``<root>/.tmp_step_000123``, then renamed;
  ``latest_step`` ignores a directory without its manifest (a crash
  mid-write).
* **async**: ``AsyncSaver.save_async`` copies every tensor to host
  memory at once (the consistency point: the train step updates its
  tensors in place afterwards) and writes the files on a thread.
* **bf16** has no numpy dtype: its raw 16 bits are stored as int16 and
  the manifest keeps the dtype, so a restore gives the same bits.

A tree is nested dicts (keys in sorted order, as JAX flattens them),
NamedTuples, lists and tuples whose leaves are tensors or numpy arrays;
``restore`` fills the structure of a target tree, each tensor on its
target leaf's device and each numpy leaf as numpy.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

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


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy, the dtype's name): bf16 as its raw int16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    a = np.array(leaf, copy=True)
    return a, a.dtype.name


def _write(root, step: int, ids, host) -> Path:
    root = Path(root)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for lid, (arr, dtype, kind) in zip(ids, host):
        fn = f"{lid}.s0.npy"
        np.save(tmp / fn, arr)
        manifest["leaves"].append({"id": lid, "shape": list(arr.shape),
                                   "dtype": dtype, "kind": kind,
                                   "shards": [{"file": fn, "index": None}]})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _snapshot(tree):
    return [(*_to_host(leaf), "torch" if torch.is_tensor(leaf) else "numpy")
            for _, leaf in _leaves(tree)]


def save(root: os.PathLike, step: int, tree: Any) -> Path:
    """Synchronous save; returns the final directory."""
    return _write(root, step, _leaf_ids(tree), _snapshot(tree))


class AsyncSaver:
    """Snapshot to host, then write on a thread; one save outstanding."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[Path] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, root: os.PathLike, step: int, tree: Any) -> None:
        self.wait()
        ids, host = _leaf_ids(tree), _snapshot(tree)   # consistency point

        def work():
            self.last_path = _write(root, step, ids, host)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


def latest_step(root: os.PathLike) -> Optional[int]:
    """The newest complete checkpoint's step (``None`` if none)."""
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in root.iterdir()
             if d.name.startswith("step_") and (d / "manifest.json").exists()]
    return max(steps) if steps else None


def _load(path: Path, entry: dict):
    arr = np.load(path)
    if entry.get("kind") != "torch":
        return arr
    t = torch.from_numpy(arr)
    if entry["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def restore(root: os.PathLike, step: int, target_tree: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``target_tree``: each
    tensor leaf restored to its target's device (its saved dtype, raising
    if it differs from the target's), each numpy leaf as numpy."""
    root = Path(root) / f"step_{step:08d}"
    manifest = json.loads((root / "manifest.json").read_text())
    by_id = {e["id"]: e for e in manifest["leaves"]}
    out = []
    for lid, (_, leaf) in zip(_leaf_ids(target_tree), _leaves(target_tree)):
        e = by_id[lid]
        val = _load(root / e["shards"][0]["file"], e)
        if tuple(val.shape) != tuple(leaf.shape):
            raise ValueError(f"{lid}: saved shape {tuple(val.shape)}, "
                             f"target {tuple(leaf.shape)}")
        if torch.is_tensor(leaf):
            if not torch.is_tensor(val) or val.dtype != leaf.dtype:
                raise ValueError(f"{lid}: saved {e['dtype']}, target "
                                 f"{leaf.dtype}")
            val = val.to(leaf.device)
        out.append(val)
    return _rebuild(target_tree, iter(out))
