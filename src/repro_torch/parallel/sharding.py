"""Process groups, device meshes and the sharding rules on
``torch.distributed``: the port of ``repro/parallel/sharding.py``.

The production mesh is ``(data=16, model=16)`` per pod, with an optional
leading ``pod`` axis (multi-pod).  The rules are the reference's:

* batch shards over ``(pod, data)``; when the global batch does not
  divide by them (the long_500k cell) the sequence shards over ``data``,
* TP: head, FFN and vocab output dims shard over ``model``, and the
  matching input dims of the following product over ``model`` too,
* FSDP (``cfg.fsdp``): the non-TP dim of every large weight also shards
  over ``(pod, data)``,
* MoE experts shard over ``model`` (EP),
* a dim that its axes do not divide replicates instead (``_fits``), such
  as hubert's 504-way head at ``model`` = 16.

A spec (``P``) is a tuple with one entry per tensor dim: ``None``, an
axis name, or a tuple of names, as a ``jax.sharding.PartitionSpec``.  The
rules are pure functions of the axis sizes, so ``param_specs``,
``batch_specs`` and ``cache_specs`` take a ``DeviceMesh``, an
``AbstractMesh`` or a dict such as ``{"data": 16, "model": 16}`` and
need no world.  ``param_specs`` keys them by the port's parameter names;
a per-block tensor has no stack dims, so its spec is the reference's
without the leading ``None``s.

Torch runs one process per device where JAX runs one process over all of
a host's devices: "the host's devices" are the world's ranks here, and a
rank on the card uses ``cuda:LOCAL_RANK``.  ``to_placements`` turns a
spec into DTensor placements: a dim over ``("pod", "data")`` is
``Shard(d)`` on both mesh dims, pod-major, the order of a
``PartitionSpec``.

Compute gathers on use (``gathered``): a module's DTensor parameters are
all-gathered to full local tensors just before it runs and dropped
after, as FSDP does, so the kernels' ``autograd.Function``s get plain
tensors.  The gradient of a gathered tensor is summed over the data
axes and cut back to the parameter's shards in the backward.  The pins
(``constrain_act``, ``pin``) return their input without an ambient mesh
(``use_mesh``), as the reference's do; under one they redistribute a
DTensor to the pinned placements and return a local tensor as it is:
they never change a value.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from ..device import resolve
from ..models.config import ModelConfig, ShapeSpec

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of names; a tuple of one name is that name, as in a
    ``PartitionSpec``).  A tuple, so it compares equal to one, and a leaf
    of every tree walk here."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, an ``AbstractMesh`` (this
    module's, or any object with ``axis_names`` and ``shape`` or
    ``axis_sizes``) or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is None:
        return dict(mesh.shape)
    return dict(zip(mesh.axis_names, sizes))


# --------------------------------------------------------------------------
# the ambient mesh (``with mesh:`` / ``get_abstract_mesh``)
# --------------------------------------------------------------------------

_AMBIENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` (a ``DeviceMesh`` or axis sizes) the ambient mesh of
    this thread inside the block."""
    stack = _AMBIENT.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def get_mesh():
    """The ambient mesh as it was given, or ``None``."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def get_abstract_mesh() -> Optional[AbstractMesh]:
    """The ambient mesh's axis names and sizes, or ``None`` when no mesh
    is ambient."""
    mesh = get_mesh()
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    if not sizes:
        return None
    return AbstractMesh(tuple(sizes), tuple(sizes.values()))


def data_axes(mesh) -> Tuple[str, ...]:
    return DATA_AXES if "pod" in axis_sizes(mesh) else ("data",)


# --------------------------------------------------------------------------
# the process group and the meshes
# --------------------------------------------------------------------------

def init_distributed(init_method: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None
                     ) -> bool:
    """Idempotent ``init_process_group``: a no-op returning ``False`` when
    a group exists; ``True`` when this call made it.

    The backend is ``nccl`` for the card (the default device) and
    ``gloo`` for the CPU.  ``init_method`` is a URL (``file://...``,
    ``tcp://...``), ``host:port`` (as the reference's coordinator
    address), or ``None`` for ``env://`` under ``torchrun``.  A single
    process passes ``num_processes=1, process_id=0``.  On the card the
    rank's device is ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return False
    dev = resolve(device)
    if init_method is None:
        init_method = "env://"
    elif "://" not in init_method:
        init_method = f"tcp://{init_method}"
    kw = {}
    if num_processes is not None:
        kw = {"world_size": num_processes,
              "rank": 0 if process_id is None else process_id}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, **kw)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it),
    else the whole world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_of_ranks(ranks, axes: Sequence[str]) -> DeviceMesh:
    """A ``DeviceMesh`` over ``ranks`` (an int array whose shape is the
    mesh's).  Every rank of the world must call it together; a rank
    outside it gets ``get_coordinate() is None``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "sharding.init_distributed first")
    ranks = torch.as_tensor(np.asarray(ranks), dtype=torch.int64)
    if ranks.numel() > world_size():
        raise ValueError(f"a mesh of {ranks.numel()} ranks in a world of "
                         f"{world_size()}")
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def host_mesh(n_data: Optional[int] = None) -> Optional[DeviceMesh]:
    """The ``("data", "model")`` mesh over the world's ranks, everything
    on the data axis (the shape fleet sweeps shard lanes over).  ``n_data``
    caps the data axis; ``None`` for a world of one (callers run
    unsharded)."""
    n = world_size()
    nd = n if n_data is None else min(n_data, n)
    if nd <= 1:
        return None
    return mesh_of_ranks(np.arange(nd).reshape(nd, 1), ("data", MODEL_AXIS))


def pod_mesh(n_data: Optional[int] = None) -> Optional[DeviceMesh]:
    """``("pod", "data", "model")`` over every rank: the pod axis the
    hosts (``world // LOCAL_WORLD_SIZE``), the data axis each host's
    ranks, so lanes over ``("pod", "data")`` split across hosts first.
    ``n_data`` caps the per-host data axis.  ``None`` when the mesh would
    be one rank, except with an explicit ``n_data``: then the trivial
    pod-1 mesh, so the pod path runs on one rank."""
    n = world_size()
    per = local_world_size()
    pods = n // per
    nd = per if n_data is None else min(n_data, per)
    if nd < 1:
        return None
    if pods * nd <= 1 and n_data is None:
        return None
    grid = np.arange(pods * per).reshape(pods, per)[:, :nd]
    return mesh_of_ranks(grid.reshape(pods, nd, 1),
                         ("pod", "data", MODEL_AXIS))


def coordinate(mesh: DeviceMesh) -> Optional[Dict[str, int]]:
    """This rank's ``{axis: index}`` on ``mesh`` (``None`` outside it)."""
    c = mesh.get_coordinate()
    return None if c is None else dict(zip(mesh.mesh_dim_names, c))


def data_shard(mesh: DeviceMesh) -> Optional[Tuple[int, int]]:
    """(this rank's index over the data axes, pod-major; their size), or
    ``None`` outside the mesh."""
    c = coordinate(mesh)
    if c is None:
        return None
    sizes = axis_sizes(mesh)
    k, n = 0, 1
    for a in data_axes(mesh):
        k = k * sizes[a] + c[a]
        n *= sizes[a]
    return k, n


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------

def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def _spec(mesh, shape: Tuple[int, ...], *axes) -> P:
    """A spec, dropping any axis the dim does not divide by."""
    return P(*(ax if (ax is not None and _fits(dim, mesh, ax)) else None
               for dim, ax in zip(shape, axes)))


def _param_rule(path: str, shape: Tuple[int, ...], mesh,
                cfg: ModelConfig) -> P:
    """The rule for one parameter, by its reference path
    (``blocks/attn/wq``, ``moe_blocks/moe/wi_gate``, ...).  Leading stack
    dims, where a shape has them, replicate."""
    fsdp = data_axes(mesh) if cfg.fsdp else None
    name = path.split("/")[-1]
    # routed-expert weights only; the llama4 shared expert is a plain MLP
    is_moe = ("/moe/" in path or path.startswith("moe/")) \
        and "/shared/" not in path
    in_chan_mix = "/chan/" in path        # rwkv channel mixing

    def rule2(a0, a1):
        return _spec(mesh, shape, *([None] * (len(shape) - 2)), a0, a1)

    def rule1(a0):
        return _spec(mesh, shape, *([None] * (len(shape) - 1)), a0)

    # embeddings and heads
    if name == "embed":
        return _spec(mesh, shape, MODEL_AXIS, fsdp)
    if name == "lm_head":
        return _spec(mesh, shape, fsdp, MODEL_AXIS)
    if name == "in_proj":                      # audio frontend adapter
        return _spec(mesh, shape, None, MODEL_AXIS)
    # MoE expert weights [E, d, f] / [E, f, d]: EP over model
    if is_moe and name in ("wi_gate", "wi_up"):
        return _spec(mesh, shape, *([None] * (len(shape) - 3)), MODEL_AXIS,
                     fsdp, None)
    if is_moe and name == "wo":
        return _spec(mesh, shape, *([None] * (len(shape) - 3)), MODEL_AXIS,
                     None, fsdp)
    if name == "router":
        return rule2(None, None)
    # attention
    if in_chan_mix and name == "wv":       # rwkv channel-mix down-proj [f, d]
        return rule2(MODEL_AXIS, fsdp)
    if name in ("wq", "wk", "wv"):
        return rule2(fsdp, MODEL_AXIS)
    if name == "wo":                           # attn / mlp / rwkv out
        return rule2(MODEL_AXIS, fsdp)
    if name in ("wi_gate", "wi_up"):           # dense mlp
        return rule2(fsdp, MODEL_AXIS)
    # rwkv
    if name in ("wr", "wg"):
        return rule2(fsdp, MODEL_AXIS)
    if name == "wB":
        return rule2(None, MODEL_AXIS)
    if name in ("w0", "u", "ln_g"):
        return rule1(MODEL_AXIS)
    if name in ("wA", "mix_A", "mix_B", "mu_x", "mu_rkvwg", "mu_k", "mu_r"):
        return P(*([None] * len(shape)))
    # mamba2
    if name in ("wz", "wxs"):
        return rule2(fsdp, MODEL_AXIS)
    if name == "wdt":
        return rule2(None, MODEL_AXIS)
    if name == "out_proj":
        return rule2(MODEL_AXIS, fsdp)
    if name == "conv_xs":
        return rule2(None, MODEL_AXIS)
    if name in ("A_log", "D", "dt_bias", "norm_g"):
        return rule1(MODEL_AXIS)
    # everything else (norms, biases, gates, conv_BC, wBC)
    return P(*([None] * len(shape)))


def _named_shapes(lm) -> Dict[str, Tuple[int, ...]]:
    if isinstance(lm, torch.nn.Module):
        return {k: tuple(p.shape) for k, p in lm.named_parameters()}
    return {k: tuple(getattr(v, "shape", v)) for k, v in lm.items()}


def param_specs(cfg: ModelConfig, lm, mesh) -> Dict[str, P]:
    """``{parameter name: spec}`` for an ``LM`` (or a dict of its
    parameters' tensors or shapes) on ``mesh``; the rule takes the
    reference's path of each name (``models.convert._jax_path``)."""
    from ..models.convert import _jax_path
    return {name: _param_rule("/".join(_jax_path(name)[0]), shape, mesh, cfg)
            for name, shape in _named_shapes(lm).items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the port of ``jax.sharding.NamedSharding``."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that shards tensor dim ``d``, ``Replicate`` elsewhere."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        dims = [names.index(a) for a in ((ax,) if isinstance(ax, str)
                                         else ax)]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: dim {d} over {ax} is not in the "
                             f"mesh's axis order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def param_shardings(cfg: ModelConfig, lm, mesh: DeviceMesh
                    ) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, s)
            for k, s in param_specs(cfg, lm, mesh).items()}


def _tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over dicts, NamedTuples, lists and tuples (a
    ``P`` is a leaf); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in
                tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def to_shardings(mesh: DeviceMesh, specs) -> Any:
    """A tree of specs as a tree of ``NamedSharding``s on ``mesh``."""
    return _tree_map(lambda _, s: NamedSharding(mesh, s), specs)


def batch_specs(cfg: ModelConfig, shape_spec: ShapeSpec, mesh,
                batch_shapes) -> Any:
    """The input batch's specs (leaves: anything with ``.shape``): the
    batch dim over ``(pod, data)`` where it divides; otherwise (the
    long_500k single sequence) the sequence dim over them."""
    dax = data_axes(mesh)
    seq_sharded = not _fits(shape_spec.global_batch, mesh, dax)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        if seq_sharded:
            if len(shape) >= 2 and shape[1] % _axis_size(mesh, dax) == 0:
                return P(None, dax, *([None] * (len(shape) - 2)))
            return P(*([None] * len(shape)))
        return _spec(mesh, shape, dax, *([None] * (len(shape) - 1)))

    return _tree_map(rule, batch_shapes)


def cache_specs(cfg: ModelConfig, shape_spec: ShapeSpec, mesh,
                cache_shapes) -> Any:
    """The decode caches' specs (``LM.init_caches``' tree): KV caches
    ``[..., B, S, H, Dh]`` batch over ``(pod, data)`` and heads over
    ``model``, or the sequence over ``data`` when the batch does not
    divide; SSM and RWKV states ``[..., B, H, p, n]`` heads over
    ``model``; the conv and shift windows ``[..., B, w, C]`` channels
    over ``model``."""
    dax = data_axes(mesh)
    batch_ok = _fits(shape_spec.global_batch, mesh, dax)
    b_ax = dax if batch_ok else None

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name, nd = path[-1], len(shape)
        if name in ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v"):
            return _spec(mesh, shape, *([None] * (nd - 4)), b_ax,
                         None if batch_ok else dax, MODEL_AXIS, None)
        if name == "state":
            return _spec(mesh, shape, *([None] * (nd - 4)), b_ax,
                         MODEL_AXIS, None, None)
        if name in ("conv", "shift_t", "shift_c"):
            return _spec(mesh, shape, *([None] * (nd - 3)), b_ax, None,
                         MODEL_AXIS)
        return P(*([None] * nd))

    return _tree_map(rule, cache_shapes)


# --------------------------------------------------------------------------
# distributed tensors
# --------------------------------------------------------------------------

def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


def local(x):
    """A DTensor's local shard (sharing its storage), anything else as it
    is."""
    return x.to_local() if isinstance(x, DTensor) else x


def from_local(x: torch.Tensor, like: DTensor) -> DTensor:
    """``x`` (a local shard shaped as ``like``'s) as a DTensor with
    ``like``'s mesh, placements and global shape."""
    return DTensor.from_local(x, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


_SRC_RANK = "src_data_rank" in inspect.signature(distribute_tensor).parameters


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` placed by ``sharding``.  A DTensor on another mesh is first
    gathered whole; a full tensor must hold the same values on every
    rank (each keeps its own slices, nothing is sent)."""
    mesh, placements = sharding.mesh, sharding.placements
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    x = x.detach().to(mesh.device_type)
    kw = {"src_data_rank": None} if _SRC_RANK else {}
    dt = distribute_tensor(x, mesh, placements, **kw)
    loc = dt.to_local()
    if loc.numel() < x.numel():          # keep the shard, not x's storage
        dt = from_local(loc.clone(), dt)
    return dt


def _owner(module: torch.nn.Module, name: str):
    *path, attr = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, attr


def shard_params(cfg: ModelConfig, lm: torch.nn.Module, mesh: DeviceMesh,
                 specs: Optional[Dict[str, P]] = None) -> torch.nn.Module:
    """Store every parameter of ``lm`` as a DTensor placed by its rule on
    ``mesh`` (``param_specs``, or ``specs``), in place; returns ``lm``.
    A rank keeps only its shards."""
    specs = specs or param_specs(cfg, lm, mesh)
    for name, p in list(lm.named_parameters()):
        mod, attr = _owner(lm, name)
        dt = distribute(p.detach(), NamedSharding(mesh, specs[name]))
        mod._parameters[attr] = torch.nn.Parameter(
            dt, requires_grad=p.requires_grad)
    return lm


def mesh_of(tensors) -> Optional[DeviceMesh]:
    """The mesh of the first DTensor among ``tensors`` (``None`` if none
    is one)."""
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def gather(p: DTensor) -> torch.Tensor:
    """``p`` whole on this rank, differentiably: its gradient is summed
    over the mesh's data axes (each data rank saw other rows) and cut
    back to ``p``'s shards in the backward."""
    mesh = p.device_mesh
    full = p.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = [Partial() if a in DATA_AXES else Replicate()
            for a in mesh.mesh_dim_names]
    return full.to_local(grad_placements=grad)


@contextlib.contextmanager
def gathered(*modules: torch.nn.Module, recurse: bool = True):
    """Inside the block, the DTensor parameters of ``modules`` (and of
    their submodules, unless ``recurse=False``) read as whole local
    tensors (``gather``); a module with none is left alone."""
    swaps = []
    for m in modules:
        for mod in (m.modules() if recurse else (m,)):
            for name, p in mod._parameters.items():
                if isinstance(p, DTensor):
                    swaps.append((mod, name, p))
    for mod, name, p in swaps:
        mod._parameters[name] = gather(p)
    try:
        yield
    finally:
        for mod, name, p in swaps:
            mod._parameters[name] = p


def local_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a batch tensor: a DTensor's local shard, or
    the data axes' contiguous block of a whole tensor's rows."""
    if isinstance(x, DTensor):
        return x.to_local()
    k, n = data_shard(mesh)
    b = x.shape[0] // n
    return x[k * b:(k + 1) * b]


def data_sum(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``t`` summed over the mesh's data axes (a new tensor; ranks along
    ``model`` hold the same value and are not summed)."""
    t = t.detach().clone()
    for a in data_axes(mesh):
        if a in mesh.mesh_dim_names and axis_sizes(mesh)[a] > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


def sharded_sums(values: torch.Tensor, like: Sequence[DTensor]
                 ) -> torch.Tensor:
    """``values[i]``, a sum over ``like[i]``'s local shard, summed over the
    mesh dims that shard it, so that each element counts once."""
    mesh = like[0].device_mesh
    out = values.clone()
    for m, a in enumerate(mesh.mesh_dim_names):
        if mesh.shape[m] == 1:
            continue
        mask = torch.tensor([isinstance(t.placements[m], Shard)
                             for t in like], device=values.device)
        part = torch.where(mask, out, torch.zeros_like(out))
        dist.all_reduce(part, group=mesh.get_group(a))
        out = torch.where(mask, part, out)
    return out


# --------------------------------------------------------------------------
# activation pins
# --------------------------------------------------------------------------

def pin_to(x, spec) -> Any:
    """A DTensor redistributed to ``spec`` on its own mesh (axes its mesh
    lacks replicate); a local tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    kept = []
    for ax in spec:
        axes = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
        kept.append(tuple(a for a in axes if a in names) or None)
    return x.redistribute(x.device_mesh,
                          to_placements(P(*kept), x.device_mesh))


def pin(x, axes) -> Any:
    """Pin ``x`` to ``axes`` (one entry per dim) under the ambient mesh,
    dropping an axis the mesh lacks or the dim does not divide by; without
    an ambient mesh with a ``model`` axis, ``x`` as it is."""
    am = get_abstract_mesh()
    if am is None or MODEL_AXIS not in am.axis_names:
        return x
    sizes = am.shape
    spec = []
    for dim, ax in zip(x.shape, axes):
        names = () if ax is None else (ax if isinstance(ax, tuple)
                                       else (ax,))
        if names and all(a in sizes for a in names) and \
                dim % _axis_size(sizes, names) == 0:
            spec.append(ax)
        else:
            spec.append(None)
    return pin_to(x, P(*spec))


def dax() -> Optional[Tuple[str, ...]]:
    """The ambient mesh's data axes (``None`` without a mesh)."""
    am = get_abstract_mesh()
    names = am.axis_names if am is not None else ()
    return tuple(a for a in DATA_AXES if a in names) or None


def constrain_act(x, *, last_model: bool = False) -> Any:
    """Pin an activation's canonical layout: the batch over ``(pod,
    data)``, and with ``last_model`` the trailing feature dim over
    ``model``.  ``x`` as it is without an ambient mesh."""
    am = get_abstract_mesh()
    if am is None or MODEL_AXIS not in am.axis_names:
        return x
    sizes = am.shape
    d = tuple(a for a in DATA_AXES if a in sizes)
    spec = [None] * x.dim()
    if x.shape[0] % _axis_size(sizes, d) == 0 and x.shape[0] > 0:
        spec[0] = d
    if last_model and x.shape[-1] % sizes[MODEL_AXIS] == 0:
        spec[-1] = MODEL_AXIS
    return pin_to(x, P(*spec))
