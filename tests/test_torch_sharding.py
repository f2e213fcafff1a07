"""The port's sharding rules, pins and straggler policy
(``repro_torch.parallel.sharding``, ``repro_torch.runtime.stragglers``)
against the JAX package, with no process group.

The rules are pure functions of the axis sizes, so the port's specs are
held to the reference's ``param_specs``, ``batch_specs`` and
``cache_specs`` on ``jax.sharding.AbstractMesh``es at production size
(``(16, 16)`` and ``(2, 16, 16)``) and at ``(2, 4)``, where ``_fits``
keeps axes that 16 drops, for all ten architectures: every leaf equal,
the reference's leading stack dims removed.  The port's ``P`` turns a
tuple of one axis name into that name, as ``PartitionSpec`` does, so
the entries compare as they are.
"""
import contextlib
import queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models.config import ShapeSpec  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.runtime.stragglers import DeadlineSkip as JDeadlineSkip  # noqa
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models.convert import _jax_path  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime.stragglers import DeadlineSkip  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _ref_by_path(tree) -> dict:
    return {jshd._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))}


def _port_by_path(tree) -> dict:
    out = {}
    sharding._tree_map(lambda path, s: out.setdefault("/".join(path),
                                                      tuple(s)), tree)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, mesh):
    """Every parameter's spec is the reference leaf's, without the stack
    dims the port's per-block tensors lack."""
    shape, axes = MESHES[mesh]
    am = AbstractMesh(shape, axes)
    cfg = configs.get(arch)
    jcfg = jconfigs.get(arch)
    want = _ref_by_path(jshd.param_specs(
        jcfg, jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0)), am))
    lm = LM(cfg, device="meta")
    got = sharding.param_specs(cfg, lm, dict(zip(axes, shape)))
    assert set(got) == {k for k, _ in lm.named_parameters()}
    for name, spec in got.items():
        path, idx = _jax_path(name)
        assert spec == want["/".join(path)][len(idx):], name
    # the same specs from a DeviceMesh-free AbstractMesh of the port's
    assert sharding.param_specs(
        cfg, lm, sharding.AbstractMesh(axes, shape)) == got


def test_fits_drops_an_axis_that_does_not_divide():
    """hubert's 504-way head: ``model`` = 16 does not divide it, 4 does."""
    cfg = configs.get("hubert_xlarge")
    lm = LM(cfg, device="meta")
    assert tuple(lm.lm_head.shape)[1] == 504
    at16 = sharding.param_specs(cfg, lm, {"data": 16, "model": 16})
    at4 = sharding.param_specs(cfg, lm, {"data": 2, "model": 4})
    assert at16["lm_head"] == (None, None)
    assert at4["lm_head"] == (None, "model")
    # yi-34b's FSDP rule shards over the data axes, pod-major
    yi = configs.get("yi_34b")
    specs = sharding.param_specs(yi, LM(yi, device="meta"),
                                 {"pod": 2, "data": 16, "model": 16})
    assert specs["blocks.0.attn.wq"] == (("pod", "data"), "model")


def _cache_trees(arch, batch, seq):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = LM(cfg, device="meta").init_caches(batch, seq)
    want = jax.eval_shape(lambda: JLM(jcfg).init_caches(batch, seq))
    return cfg, jcfg, got, want


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_NAMES
                                  if a != "hubert_xlarge"])
def test_cache_and_batch_specs_equal_the_reference(arch):
    """Each family's decode caches (a batch that divides the data axes,
    and one that does not: the sequence then shards) and its training
    batch."""
    for batch in (32, 8):
        sp = ShapeSpec("cell", 64, batch, "decode")
        cfg, jcfg, got, want = _cache_trees(arch, batch, 64)
        for mesh in MESHES.values():
            am = AbstractMesh(*mesh)
            sizes = dict(zip(mesh[1], mesh[0]))
            mine = _port_by_path(sharding.cache_specs(cfg, sp, sizes, got))
            ref = _ref_by_path(jshd.cache_specs(jcfg, sp, am, want))
            assert mine == ref, (batch, mesh)
            arrays = {"tokens": np.zeros((batch, 64), np.int32),
                      "labels": np.zeros((batch, 64), np.int32),
                      "img": np.zeros((batch, 16, 32), np.float32),
                      "step": np.zeros((), np.int32)}
            assert _port_by_path(sharding.batch_specs(
                cfg, sp, sizes, arrays)) == _ref_by_path(
                    jshd.batch_specs(jcfg, sp, am, arrays))


def test_placements_are_pod_major():
    """``to_placements`` on a mesh's names: a dim over ("pod", "data")
    is ``Shard(d)`` on both mesh dims in the mesh's order; a reversed
    order, which DTensor cannot express, raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Names:                  # what to_placements reads of a mesh
        mesh_dim_names = ("pod", "data", "model")
    got = sharding.to_placements(sharding.P(("pod", "data"), "model"),
                                 Names())
    assert got == (Shard(0), Shard(0), Shard(1))
    assert sharding.to_placements(sharding.P(None, None), Names()) == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(sharding.P(("data", "pod")), Names())


def test_deadline_skip_and_escalation():
    """The twin of ``tests/test_runtime_extras.py``'s test, against the
    reference's policy on the same queue."""
    for cls in (DeadlineSkip, JDeadlineSkip):
        pol = cls(deadline_s=0.01, escalate_after=3)
        q: "queue.Queue" = queue.Queue()
        q.put("a")

        def get(t):
            return q.get(timeout=t)
        assert pol.fetch(get) == "a"
        assert pol.fetch(get, fallback="skip") == "skip"
        assert pol.fetch(get, fallback="skip") == "skip"
        with pytest.raises(TimeoutError):
            pol.fetch(get, fallback="skip")
        assert pol.stats.skipped == 3 and pol.stats.served == 1


def test_pins_return_their_input():
    """Without an ambient mesh every pin is the identity; under a mesh (a
    dict of axis sizes) a local tensor comes back as it is, the same
    object, from the attention and rwkv pins and ``constrain_act``."""
    x = torch.randn(8, 16, 32)
    assert sharding.get_abstract_mesh() is None and sharding.dax() is None
    for mesh in (None, {"data": 2, "model": 4},
                 {"pod": 2, "data": 2, "model": 4}):
        ctx = sharding.use_mesh(mesh) if mesh else contextlib.nullcontext()
        with ctx:
            assert attn_mod._pin(x, (attn_mod._dax(), None, "model")) is x
            assert sharding.constrain_act(x, last_model=True) is x
            assert sharding.pin(x, (("pod", "data"), None, None)) is x
        if mesh:
            with sharding.use_mesh(mesh):
                assert sharding.get_abstract_mesh().shape == mesh
                assert sharding.dax() == tuple(a for a in ("pod", "data")
                                               if a in mesh)
    assert sharding.get_abstract_mesh() is None
    # the rwkv time mix with its WKV pins, under a mesh: the same output
    cfg = configs.get_smoke("rwkv6_3b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    blk = lm.blocks[0]
    want = rwkv_mod.time_mix_forward(blk.time, cfg, h)
    with sharding.use_mesh({"data": 2, "model": 2}):
        got = rwkv_mod.time_mix_forward(blk.time, cfg.with_(
            rwkv_wkv_pins=True), h, pin=sharding.constrain_act)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
