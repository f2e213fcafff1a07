"""Sharded training on ``torch.distributed``: ``make_global_batch``, the
parameters and AdamW state as DTensors (``sharding.shard_params``), the
train step on a mesh, the sharded checkpoint and its re-sharded restore,
``elastic.reshard_params`` and ``ResilientLoop`` on a mesh, in a spawned
``gloo`` world of 2 as ``(2, 1)`` and ``(1, 2)``, and in a world of one
(this process), float32, smoke configs of qwen3 and rwkv6.

Held, against the unsharded single-process step computed here:
* ``make_global_batch`` put back together is ``host_batch``;
* each rank's shard of each parameter has the shape its spec divides it
  to;
* two steps' losses and gradients within 1e-5 of the largest magnitude
  of each (the sum over data ranks rounds otherwise), each step against
  the unsharded step from the same parameters (AdamW's first update is
  about ``lr * sign(g)``, so a gradient element near 0 whose rounding
  flips its sign moves its weight by up to ``2 lr``), and bit-equal on a
  mesh of one rank over both steps;
* a checkpoint saved on ``(2, 1)`` restores on ``(1, 2)``, on a world of
  one with a ``(1, 1)`` mesh and unsharded, bit for bit; a model moved
  between the two meshes by ``reshard_params`` likewise;
* ``ResilientLoop`` with a failure injected equals a clean run on the
  mesh, bit for bit.
"""
import contextlib
import pickle
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

ARCHES = ("qwen3_0p6b", "rwkv6_3b")
SHAPES = ((2, 1), (1, 2))
SPEC = ShapeSpec("t", 32, 4, "train")
OPT = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 2
TOL = 1e-5
WORLD_TIMEOUT_S = 200


def _cfg(arch):
    return configs.get_smoke(arch).with_(param_dtype="float32",
                                         compute_dtype="float32")


def _model(arch, mesh=None):
    cfg = _cfg(arch)
    lm = layers.trainable(LM(cfg, device="cpu")).init(
        torch.Generator().manual_seed(0))
    return sharding.shard_params(cfg, lm, mesh) if mesh else lm


def _full(x):
    return x.full_tensor() if sharding.is_sharded(x) else x.detach()


def _train(lm, batches, before=None):
    """STEPS of loss_and_grads + AdamW: (losses, grads, state); each
    step's parameters, gathered, appended to ``before``."""
    opt = adamw.init(dict(lm.named_parameters()))
    losses, grads = [], []
    for b in batches:
        if before is not None:
            before.append({k: _full(p).clone()
                           for k, p in lm.named_parameters()})
        loss, _, g = steps.loss_and_grads(lm, b)
        losses.append(float(loss))
        grads.append({k: _full(v).clone() for k, v in g.items()})
        adamw.update(OPT, g, opt, dict(lm.named_parameters()))
    return losses, grads, opt


def _state(lm, opt):
    return {"params": dict(lm.named_parameters()), "opt": opt,
            "data_step": np.asarray(STEPS, np.int64)}


def _gathered(tree):
    return {"/".join(p): _full(x).clone() if torch.is_tensor(x) else x
            for p, x in ckpt._leaves(tree)}


def _loop(arch, root, mesh, fail_at=None):
    loop, make_batch = train.build(
        _cfg(arch), batch=4, seq=32, lr=1e-3, steps=6, device="cpu",
        ckpt_dir=str(root), ckpt_every=2, inject_failure_at=fail_at,
        mesh=mesh)
    summary = loop.run(make_batch, 6)
    return summary["restarts"], loop.history


def run_world(fn, n: int, tmp_path, *args, timeout: float = WORLD_TIMEOUT_S):
    """``fn(rank, n, store, out, *args)`` in ``n`` spawned processes; the
    ranks' pickled results, by rank."""
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.start_processes(fn, args=(n, str(tmp_path / "store"), str(out),
                                       *args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"a world of {n} ran past {timeout} s")
    return [pickle.loads((out / f"{r}.pkl").read_bytes()) for r in range(n)]


def world_of_2(rank, n, store, out, root):
    torch.set_num_threads(1)
    assert sharding.init_distributed(f"file://{store}", n, rank,
                                     device="cpu")
    res = {}
    for arch in ARCHES:
        cfg = _cfg(arch)
        data = pipeline.SyntheticLM(cfg, SPEC, seed=0)
        for shape in SHAPES:
            key = f"{arch} {shape[0]}x{shape[1]}"
            mesh = mesh_mod.make_mesh(shape, ("data", "model"))
            batches = [data.make_global_batch(mesh, s) for s in range(STEPS)]
            lm = _model(arch, mesh)
            specs = sharding.param_specs(cfg, lm, mesh)
            sizes = sharding.axis_sizes(mesh)
            for name, p in lm.named_parameters():
                want = [d // sharding._axis_size(sizes, ax)
                        for d, ax in zip(p.shape, specs[name])]
                assert list(p.to_local().shape) == want, (key, name)
            before = []
            losses, grads, opt = _train(lm, batches, before)
            res[key] = {"batches": [{k: v.full_tensor() for k, v in
                                     b.items()} for b in batches],
                        "local_numel": sum(p.to_local().numel() for p in
                                           lm.parameters()),
                        "losses": losses, "grads": grads, "before": before}
            if shape == (2, 1):
                # save sharded, then restore on (1, 2), fresh targets
                ckpt.save(Path(root, arch), STEPS, _state(lm, opt))
                res[key]["state"] = _gathered(_state(lm, opt))
                other = mesh_mod.make_mesh((1, 2), ("data", "model"))
                lm2 = _model(arch, other)
                tgt = _state(lm2, adamw.init(dict(lm2.named_parameters())))
                back = ckpt.restore(Path(root, arch), STEPS, tgt)
                res[key]["restored_on_1x2"] = _gathered(back)
                assert all(p.device_mesh == other for p in
                           back["params"].values())
                # live state moved between the meshes: the moments by
                # reshard_tree, the model by reshard_params
                moved = elastic.reshard_tree(
                    opt.m, sharding.param_shardings(cfg, lm, other))
                assert all(v.device_mesh == other and
                           torch.equal(v.full_tensor(), _full(opt.m[k]))
                           for k, v in moved.items())
                elastic.reshard_params(cfg, lm, other)
                assert all(p.device_mesh == other for p in lm.parameters())
                res[key]["resharded"] = {k: _full(p).clone() for k, p in
                                         lm.named_parameters()}
        mesh = mesh_mod.make_mesh((2, 1), ("data", "model"))
        res[f"{arch} loop"] = (_loop(arch, Path(root, f"{arch}-clean"), mesh),
                               _loop(arch, Path(root, f"{arch}-faulty"), mesh,
                                     fail_at=3))
    Path(out, f"{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.destroy_process_group()


@contextlib.contextmanager
def one_thread():
    """torch on one thread inside the block (smoke shapes, and the test
    runs beside other workers and its own world)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unsharded():
    """The single-process run of each arch: batches, losses, grads, the
    state after the steps."""
    with one_thread():
        return _unsharded()


def _unsharded():
    out = {}
    for arch in ARCHES:
        data = pipeline.SyntheticLM(_cfg(arch), SPEC, seed=0)
        batches = [pipeline.to_device(data.host_batch(s), "cpu")
                   for s in range(STEPS)]
        lm = _model(arch)
        losses, grads, opt = _train(lm, batches)
        out[arch] = {"batches": batches, "losses": losses, "grads": grads,
                     "state": _gathered(_state(lm, opt)),
                     "numel": sum(p.numel() for p in lm.parameters())}
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    root = tmp / "ckpt"
    return run_world(world_of_2, 2, tmp, str(root)), root


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHES)
def test_sharded_steps_match_the_unsharded_step(world2, unsharded, arch,
                                                shape):
    """The global batch, the shards' sizes, two steps' losses and
    gradients on the mesh, on both ranks."""
    ranks, _ = world2
    ref = unsharded[arch]
    key = f"{arch} {shape[0]}x{shape[1]}"
    n_model = shape[1]
    for rank, res in enumerate(ranks):
        got = res[key]
        for b, want in zip(got["batches"], ref["batches"]):
            assert set(b) == set(want)
            assert all(torch.equal(b[k], want[k]) for k in want)
        if n_model == 1:        # no fsdp: every parameter whole on a rank
            assert got["local_numel"] == ref["numel"]
        else:
            assert got["local_numel"] < ref["numel"]
        for s in range(STEPS):
            lm = _model(arch)
            with torch.no_grad():
                for k, p in lm.named_parameters():
                    p.copy_(got["before"][s][k])
            loss, _, grads = steps.loss_and_grads(lm, ref["batches"][s])
            if s == 0:
                assert float(loss) == ref["losses"][0]
            assert abs(got["losses"][s] - float(loss)) <= \
                TOL * abs(float(loss)), (rank, s)
            for k, g in grads.items():
                _close(got["grads"][s][k], g, (rank, s, k))


@pytest.mark.parametrize("arch", ARCHES)
def test_checkpoint_restores_across_meshes_and_worlds(world2, unsharded,
                                                      arch, tmp_path):
    """Saved on (2, 1); restored on (1, 2) in the world of 2, and here on
    a world of one, on a (1, 1) mesh and unsharded: every leaf the saved
    state's bits.  ``reshard_params`` moves the live model the same."""
    ranks, root = world2
    saved = ranks[0][f"{arch} 2x1"]["state"]
    for rank, res in enumerate(ranks):
        got = res[f"{arch} 2x1"]
        assert got["state"].keys() == saved.keys()
        for k, v in saved.items():
            assert _same(got["restored_on_1x2"][k], v), (rank, k)
        for k, v in got["resharded"].items():
            assert torch.equal(v, saved[f"params/{k}"]), (rank, k)
    lm = _model(arch)
    plain = ckpt.restore(root / arch, STEPS,
                         _state(lm, adamw.init(dict(lm.named_parameters()))))
    for k, v in _gathered(plain).items():
        assert _same(v, saved[k]), k
    with _world_of_one(tmp_path) as mesh:
        lm = _model(arch, mesh)
        back = ckpt.restore(root / arch, STEPS, _state(
            lm, adamw.init(dict(lm.named_parameters()))))
        for k, v in _gathered(back).items():
            assert _same(v, saved[k]), k


def _same(a, b) -> bool:
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(a, b)


class _world_of_one:
    """A gloo world of this process alone, with its (1, 1) mesh; the group
    is destroyed on the way out."""

    def __init__(self, tmp_path):
        self.store = tmp_path / "store1"

    def __enter__(self):
        assert sharding.init_distributed(f"file://{self.store}", 1, 0,
                                         device="cpu")
        return mesh_mod.make_host_mesh()

    def __exit__(self, *exc):
        dist.destroy_process_group()
        return False


@pytest.mark.parametrize("arch", ARCHES)
def test_one_rank_mesh_is_the_unsharded_step_to_the_bit(unsharded, arch,
                                                         tmp_path):
    """On a (1, 1) mesh, with the batch from ``make_global_batch``, the
    losses, gradients and final state equal the unsharded run's bits."""
    ref = unsharded[arch]
    with _world_of_one(tmp_path) as mesh:
        data = pipeline.SyntheticLM(_cfg(arch), SPEC, seed=0)
        batches = [data.make_global_batch(mesh, s) for s in range(STEPS)]
        lm = _model(arch, mesh)
        losses, grads, opt = _train(lm, batches)
        state = _gathered(_state(lm, opt))
    assert losses == ref["losses"]
    for s in range(STEPS):
        for k, g in ref["grads"][s].items():
            assert torch.equal(grads[s][k], g), (s, k)
    for k, v in ref["state"].items():
        assert _same(state[k], v), k


@pytest.mark.parametrize("arch", ARCHES)
def test_restarted_sharded_run_equals_a_clean_one(world2, arch):
    """``ResilientLoop`` on (2, 1) through ``train.build(mesh=)``: a
    failure at step 3 restores step 2's sharded checkpoint, and the run
    ends as a clean one does, to the bit, on both ranks."""
    ranks, _ = world2
    for res in ranks:
        (r_clean, clean), (r_faulty, faulty) = res[f"{arch} loop"]
        assert r_clean == 0 and r_faulty == 1
        assert [s for s, _ in faulty] == [0, 1, 2, 2, 3, 4, 5]
        assert dict(faulty) == dict(clean)
    assert ranks[0][f"{arch} loop"] == ranks[1][f"{arch} loop"]


def test_kernel_wrappers_refuse_a_dtensor(tmp_path):
    """A DTensor never reaches a kernel's raw pointers: the dispatchers
    of ``kernels.ops`` raise, and a plain tensor still runs."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g) for _ in range(3))
    with _world_of_one(tmp_path) as mesh:
        dq = distribute_tensor(q, mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ops.flash_attention(dq, k, v)
        assert ops.flash_attention(q, k, v).shape == q.shape


def test_pins_redistribute_a_dtensor_and_keep_its_values(tmp_path):
    """Under an ambient mesh a pin places a DTensor as its spec says (the
    batch over the data axes, with ``last_model`` the features over
    ``model``) and changes no value."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(5))
    with _world_of_one(tmp_path) as mesh:
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with sharding.use_mesh(mesh):
            got = sharding.constrain_act(dx, last_model=True)
            pinned = sharding.pin(dx, (None, "model", None))
        assert got.placements == (Shard(0), Shard(2))
        assert pinned.placements == (Replicate(), Shard(1))
        assert torch.equal(got.full_tensor(), x)
        assert torch.equal(pinned.full_tensor(), x)
        assert sharding.constrain_act(dx) is dx        # no ambient mesh
