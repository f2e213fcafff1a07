"""Tensor-parallel compute over ``model``: each rank computes its heads,
FFN columns, vocabulary slice and experts (``sharding.local_shards`` and
the collectives of the model-parallel region), for the train step, the
prefill and the decode step on a ``(data, model)`` mesh.

Spawned ``gloo`` worlds, one per size: a world of 2 runs the (1, 2) mesh,
a world of 4 the (2, 2) and (1, 4) meshes; float32 smoke configs of
qwen3 (tied embeddings, GQA), stablelm (an untied ``lm_head``), rwkv6,
dbrx (MoE, experts over ``model``), zamba2 (Mamba2 and the shared
attention block) and llama-3.2-vision (gated cross-attention, its decode
against the cross caches), their KV caches float32 too (a bf16 cache
rounds a value that the mesh sums in another order to the next bf16
step).  On (1, 4) qwen3 and vision run with ``kv_repeat`` = 2: qwen3's 2
KV heads of 16 columns give each rank half a head, and rank ``r`` needs
KV head ``r // 2`` whole, so its ``wk`` / ``wv`` are the leaves gathered over
``model`` and cut to that head; dbrx's 2 KV heads there are computed
whole by each rank (4 ranks do not divide them) for the same reason;
stablelm runs with 2 heads of 32 there, which 4 ranks do not divide, so
each rank computes its attention whole from gathered weights (and its
MLP and vocabulary split).

Held on each mesh, on every rank, against the unsharded port from the
same parameters, computed here:
* two train steps' losses and gradients within 1e-5 of the largest
  magnitude of each (a 0-d gradient, a cross block's gate, within 1e-5 of
  the step's largest: it sums a product for every token and feature, which
  cancel to a small part of their absolute sum, so float32's rounding, not
  the mesh, sets its relative error; the unsharded step's own moves as far
  when the batch's rows are permuted), against the unsharded step on the
  global batch: on
  (2, 2) dbrx's MoE dispatch and load-balance loss are the global
  batch's (its capacity, the order of its entries, its statistics),
  not each data shard's;
* the prefill's logits (``make_prefill_step``; and ``LM.prefill``'s
  logits and caches for the dense family) and four decode steps' logits
  and caches from ``init_caches``, within 1e-5 of the largest magnitude;
* the spies: ``ops.flash_attention`` sees ``Hq / model`` query heads and
  ``ops.wkv_chunked`` ``H / model`` heads, and the only leaves gathered
  over ``model`` are the KV weights whose heads ``model`` does not
  divide; no parameter is redistributed otherwise.
A world of one on a (1, 1) mesh is bit-equal to the unsharded model in
train, prefill and decode.  qwen3's (1, 2) loss and gradients are also
held to ``jax.value_and_grad`` of the JAX package's ``LM.loss`` on one
device, from the same parameters (``convert.tree_from_port``).
"""
import contextlib
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

from test_torch_dist_train import (_world_of_one, one_thread,  # noqa: E402
                                   run_world)

ARCHES = ("qwen3_0p6b", "stablelm_1p6b", "rwkv6_3b", "dbrx_132b",
          "zamba2_1p2b", "llama3p2_vision_11b")
WORLDS = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
SHAPES = [s for shapes in WORLDS.values() for s in shapes]
SPEC = ShapeSpec("t", 32, 4, "train")
OPT = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 2
DECODES = 4
CACHE_LEN = 8
TOL = 1e-5
JAX_ARCH = "qwen3_0p6b"


def _cfg(arch, shape=(1, 1)):
    cfg = configs.get_smoke(arch).with_(param_dtype="float32",
                                        compute_dtype="float32",
                                        cache_dtype="float32")
    if arch in ("qwen3_0p6b", "llama3p2_vision_11b") and shape == (1, 4):
        cfg = cfg.with_(kv_repeat=2)
    if arch == "stablelm_1p6b" and shape == (1, 4):     # 2 heads of 32
        cfg = cfg.with_(n_heads=2, n_kv_heads=2, d_head=32)
    return cfg


def _key(arch, shape):
    return f"{arch} {shape[0]}x{shape[1]}"


def _model(cfg, mesh=None, train=True):
    """The seeded model (the vision family's cross-block gates set non-zero,
    so that the cross blocks reach the loss), trainable for the train
    steps; served as the
    launchers serve it, with parameters that require no grad (torch's
    ``matmul`` folds a strided input otherwise, which rounds the last
    bit differently)."""
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if cfg.family == "vlm":          # the cross blocks' gates start at 0
        with torch.no_grad():
            for cross in lm.cross_blocks:
                cross.gate_attn.fill_(0.5)
                cross.gate_mlp.fill_(0.7)
    if train:
        lm = layers.trainable(lm)
    return sharding.shard_params(cfg, lm, mesh) if mesh else lm


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x.detach()


def _tree_full(tree):
    return sharding._tree_map(lambda _, x: _full(x).clone(), tree)


def _serve_batch(cfg):
    return pipeline.to_device(
        pipeline.SyntheticLM(cfg, SPEC, seed=0).host_batch(5), "cpu")


def _serve(lm, cfg):
    """The prefill's logits (and the dense family's ``LM.prefill`` logits
    and caches), then DECODES decode steps from ``init_caches``: logits
    and the final caches, all whole tensors."""
    batch = {k: v for k, v in _serve_batch(cfg).items() if k != "labels"}
    out = {"prefill_step": _full(steps.make_prefill_step(lm)(batch))}
    with torch.inference_mode():
        if cfg.family == "dense":
            logits, caches = lm.prefill(batch)
            out["prefill"] = (_full(logits), _tree_full(caches))
        caches = lm.init_caches(SPEC.global_batch, CACHE_LEN)
        logits = []
        for t in range(DECODES):
            lg, caches = lm.decode_step(caches,
                                        batch["tokens"][:, t:t + 1], t)
            logits.append(_full(lg))
        out["decode"] = (logits, _tree_full(caches))
    return out


class Spies:
    """Heads that the flash and WKV dispatchers see, the parameters
    gathered over ``model`` (by name), and redistributes of a parameter
    anywhere else."""

    def __init__(self, monkey):
        self.names = {}
        self.active = False
        self.reset()
        real_flash, real_wkv = ops.flash_attention, ops.wkv_chunked
        real_gather = sharding.gather_over_model
        real_redist = DTensor.redistribute
        inside = []

        def flash(q, k, v, **kw):
            if self.active:
                self.flash.add((q.shape[1], k.shape[1]))
            return real_flash(q, k, v, **kw)

        def wkv(r, *args, **kw):
            if self.active:
                self.wkv.add(r.shape[1])
            return real_wkv(r, *args, **kw)

        def gather(t, partial):
            if self.active:
                self.gathered.add(self.names[id(sharding.tp_of(t).src)])
            inside.append(1)
            try:
                return real_gather(t, partial)
            finally:
                inside.pop()

        def redist(dt, *args, **kw):
            if self.active and id(dt) in self.names and not inside:
                self.redistributed.add(self.names[id(dt)])
            return real_redist(dt, *args, **kw)

        monkey.setattr(ops, "flash_attention", flash)
        monkey.setattr(ops, "wkv_chunked", wkv)
        monkey.setattr(sharding, "gather_over_model", gather)
        monkey.setattr(DTensor, "redistribute", redist)

    @contextlib.contextmanager
    def on(self):
        """Watch inside the block only (not the test's own gathers of
        whole parameters, nor AdamW's update)."""
        self.active = True
        try:
            yield
        finally:
            self.active = False

    def watch(self, lm):
        self.names = {id(p): n for n, p in lm.named_parameters()}

    def reset(self):
        self.flash, self.wkv = set(), set()
        self.gathered, self.redistributed = set(), set()

    def record(self):
        out = {"flash": self.flash, "wkv": self.wkv,
               "gathered": self.gathered,
               "redistributed": self.redistributed}
        self.reset()
        return out


def _train(lm, batches, before, spies=None):
    """STEPS of loss_and_grads + AdamW: (losses, whole grads); each
    step's parameters, whole, appended to ``before``; ``spies`` watch
    ``loss_and_grads``."""
    opt = adamw.init(dict(lm.named_parameters()))
    losses, grads = [], []
    for b in batches:
        before.append({k: _full(p).clone() for k, p in lm.named_parameters()})
        with spies.on() if spies else contextlib.nullcontext():
            loss, _, g = steps.loss_and_grads(lm, b)
        losses.append(float(loss))
        grads.append({k: _full(v).clone() for k, v in g.items()})
        adamw.update(OPT, g, opt, dict(lm.named_parameters()))
    return losses, grads


def world(rank, n, store, out):
    torch.set_num_threads(1)
    assert sharding.init_distributed(f"file://{store}", n, rank,
                                     device="cpu")
    res = {}
    with pytest.MonkeyPatch.context() as monkey:
        spies = Spies(monkey)
        for shape in WORLDS[n]:
            mesh = mesh_mod.make_mesh(shape, ("data", "model"))
            for arch in ARCHES:
                cfg = _cfg(arch, shape)
                data = pipeline.SyntheticLM(cfg, SPEC, seed=0)
                batches = [data.make_global_batch(mesh, s)
                           for s in range(STEPS)]
                lm = _model(cfg, mesh)
                spies.watch(lm)
                before = []
                losses, grads = _train(lm, batches, before, spies)
                got = {"losses": losses, "grads": grads, "before": before,
                       "train_spies": spies.record(),
                       "local_numel": sum(p.to_local().numel()
                                          for p in lm.parameters())}
                lm = _model(cfg, mesh, train=False)
                spies.watch(lm)
                with spies.on():
                    got["serve"] = _serve(lm, cfg)
                got["serve_spies"] = spies.record()
                res[_key(arch, shape)] = got
    Path(out, f"{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ranks = {}
    for n in WORLDS:
        ranks[n] = run_world(world, n, tmp_path_factory.mktemp(f"tp{n}"))
    return ranks


def _close(got, want, what, scale=None):
    if scale is None:
        scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got.float() - want.float()).abs().max()) \
        if want.numel() else 0.0
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


def _close_tree(got, want, what):
    flat_g, flat_w = _flat(got), _flat(want)
    assert flat_g.keys() == flat_w.keys(), what
    for k, w in flat_w.items():
        assert flat_g[k].shape == w.shape, (what, k)
        if w.is_floating_point():
            _close(flat_g[k], w, (what, k))
        else:
            assert torch.equal(flat_g[k], w), (what, k)


def _flat(tree):
    out = {}
    sharding._tree_map(lambda p, x: out.__setitem__("/".join(p), x), tree)
    return out


@pytest.fixture(scope="module")
def unsharded():
    """Each (arch, config)'s unsharded serving outputs and the number of
    its parameters' elements."""
    out = {}
    with one_thread():
        for shape in [(1, 1)] + SHAPES:
            for arch in ARCHES:
                cfg = _cfg(arch, shape)
                if cfg in out:
                    continue
                lm = _model(cfg, train=False)
                out[cfg] = {
                    "serve": _serve(lm, cfg),
                    "numel": sum(p.numel() for p in lm.parameters())}
    return out


def _unsharded_of(unsharded, arch, shape):
    return unsharded[_cfg(arch, shape)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHES)
def test_train_steps_on_the_mesh_match_the_unsharded_step(worlds, unsharded,
                                                          arch, shape):
    """Two steps' losses and gradients on every rank, each against the
    unsharded step from the step's parameters (the same bits on every
    rank); each rank holds less than the whole model."""
    cfg = _cfg(arch, shape)
    data = pipeline.SyntheticLM(cfg, SPEC, seed=0)
    ranks = [res[_key(arch, shape)]
             for res in worlds[shape[0] * shape[1]]]
    numel = _unsharded_of(unsharded, arch, shape)["numel"]
    assert all(got["local_numel"] < numel for got in ranks)
    for s in range(STEPS):
        before = ranks[0]["before"][s]
        for rank, got in enumerate(ranks):
            assert all(torch.equal(got["before"][s][k], v)
                       for k, v in before.items()), (rank, s)
        lm = _model(cfg)
        with torch.no_grad():
            for k, p in lm.named_parameters():
                p.copy_(before[k])
        with one_thread():
            loss, _, grads = steps.loss_and_grads(
                lm, pipeline.to_device(data.host_batch(s), "cpu"))
        loss = float(loss)
        top = max(float(g.abs().max()) for g in grads.values())
        for rank, got in enumerate(ranks):
            assert abs(got["losses"][s] - loss) <= TOL * abs(loss), \
                (rank, s, got["losses"][s], loss)
            for k, g in grads.items():
                _close(got["grads"][s][k], g, (rank, s, k),
                       top if g.dim() == 0 else None)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_and_decode_on_the_mesh_match_the_unsharded_model(
        worlds, unsharded, arch, shape):
    """The prefill's logits (and caches), four decode steps' logits and
    the caches after them, on every rank."""
    want = _unsharded_of(unsharded, arch, shape)["serve"]
    for rank, res in enumerate(worlds[shape[0] * shape[1]]):
        got = res[_key(arch, shape)]["serve"]
        assert got.keys() == want.keys()
        _close(got["prefill_step"], want["prefill_step"], (rank, "prefill"))
        if "prefill" in want:
            _close(got["prefill"][0], want["prefill"][0], (rank, "prefill"))
            _close_tree(got["prefill"][1], want["prefill"][1],
                        (rank, "prefill caches"))
        for t, (g, w) in enumerate(zip(got["decode"][0], want["decode"][0])):
            _close(g, w, (rank, "decode", t))
        _close_tree(got["decode"][1], want["decode"][1],
                    (rank, "decode caches"))


def _want_spies(cfg, m):
    """What each rank's dispatchers see and what it gathers over ``model``:
    (``{"wkv": heads}`` or ``{"flash": (query heads, KV heads)}``, the
    names of the gathered parameters)."""
    if cfg.family == "rwkv":
        return {"wkv": max(cfg.d_model // cfg.rwkv_head_dim,
                           cfg.rwkv_pad_heads) // m}, set()
    hq = cfg.pad_q_heads or cfg.n_heads
    he = cfg.n_kv_heads * cfg.kv_repeat
    names = [k for k, _ in LM(cfg, device="meta").named_parameters()]
    if hq % m:                    # the block whole on each rank
        return {"flash": (hq, he)}, {
            k for k in names if k.endswith(("attn.wq", "attn.wk",
                                            "attn.wv", "attn.wo"))}
    gathered = {k for k in names if k.endswith(("attn.wk", "attn.wv"))} \
        if cfg.n_kv_heads % m else set()
    return {"flash": (hq // m, max(1, he // m))}, gathered


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHES)
def test_each_rank_computes_its_heads_and_gathers_no_aligned_leaf(
        worlds, arch, shape):
    """The kernels' dispatchers see ``H / model`` heads (flash's KV heads
    the query heads' share of the effective KV heads), and the only
    parameters gathered over ``model`` are the KV weights of a layer
    whose KV heads ``model`` does not divide, or the attention weights of
    one whose query heads it does not divide."""
    cfg = _cfg(arch, shape)
    m = shape[1]
    heads, gathered = _want_spies(cfg, m)
    (kind, want), = heads.items()
    for rank, res in enumerate(worlds[m * shape[0]]):
        got = res[_key(arch, shape)]
        for phase in ("train_spies", "serve_spies"):
            spy = got[phase]
            assert spy[kind] == {want}, (rank, phase, spy)
            assert not spy["flash" if kind == "wkv" else "wkv"]
            assert spy["gathered"] == gathered, (rank, phase, spy)
            assert not spy["redistributed"], (rank, phase, spy)


def test_the_two_rank_step_matches_the_jax_package(worlds):
    """qwen3's (1, 2) loss and gradients at its first step against
    ``jax.value_and_grad`` of ``repro.models.LM.loss`` on one device,
    from the same parameters."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import LM as JLM
    cfg = _cfg(JAX_ARCH, (1, 2))
    got = worlds[2][0][_key(JAX_ARCH, (1, 2))]
    host = pipeline.SyntheticLM(cfg, SPEC, seed=0).host_batch(0)
    params = jax.tree.map(jnp.asarray,
                          convert.tree_from_port(cfg, got["before"][0]))
    batch = {k: jnp.asarray(v) for k, v in host.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: JLM(cfg).loss(p, batch), has_aux=True)(params)
    assert abs(got["losses"][0] - float(loss)) <= TOL * abs(float(loss))
    want = convert.tree_from_port(cfg, got["grads"][0])

    def walk(g, w, path=()):
        if isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                walk(g[k], w[k], path + (k,))
            return
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        assert err <= TOL * scale, ("/".join(path), err, scale)

    walk(want, jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch", ARCHES)
def test_one_rank_mesh_is_the_unsharded_model_to_the_bit(unsharded, arch,
                                                         tmp_path):
    """A (1, 1) mesh through the TP code: two train steps' losses and
    gradients, the prefill and the decode steps equal the unsharded
    model's bits."""
    cfg = _cfg(arch)
    data = pipeline.SyntheticLM(cfg, SPEC, seed=0)
    with one_thread():
        want_losses, want_grads = _train(
            _model(cfg), [pipeline.to_device(data.host_batch(s), "cpu")
                          for s in range(STEPS)], [])
        with _world_of_one(tmp_path) as mesh:
            losses, grads = _train(_model(cfg, mesh),
                                   [data.make_global_batch(mesh, s)
                                    for s in range(STEPS)], [])
            served = _serve(_model(cfg, mesh, train=False), cfg)
    assert losses == want_losses
    for s in range(STEPS):
        for k, g in want_grads[s].items():
            assert torch.equal(grads[s][k], g), (s, k)
    want = _unsharded_of(unsharded, arch, (1, 1))["serve"]
    flat_g, flat_w = _flat(served), _flat(want)
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        assert torch.equal(flat_g[k], w), k
