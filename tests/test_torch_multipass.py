"""The port's multipass PPCC chain (``engine_parts(fused=False)``,
``Fleet(fused=False)``) against ``repro.core.jaxsim``, on the CPU:

* a multipass run at the reference test's parameters (100 items, write
  probability 0.3, MPL 16, horizon 2,000) equal, every leaf, to the JAX
  reference's ``engine_parts(fused=False, fleet=True)`` run, and to the
  port's own fused run;
* the Theorem-1 invariants after every multipass step;
* ``run_grid(fused=False)`` equal to the reference's and to the fused
  fleet, every lane's final state; the multipass body calls no megastep.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import jaxsim  # noqa: E402
from repro.core import sweep as JS  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import ppcc as TP  # noqa: E402
from repro_torch.core import sweep as TS  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402


def _assert_same(a: E.EngState, b, lanes=None, tag=""):
    """Every leaf of port state ``a`` equals ``b`` (a port state, or a
    reference state with numpy leaves and ``lanes`` picking port lanes);
    floats as bit patterns."""
    a = E.state_to_numpy(a)
    if isinstance(b, E.EngState) and isinstance(b.now, torch.Tensor):
        b = E.state_to_numpy(b)
    for name in E.EngState._fields:
        x, y = getattr(a, name), getattr(b, name)
        pairs = (zip(x._fields, x, y) if isinstance(x, tuple)
                 else [(name, x, y)])
        for leaf, u, v in pairs:
            u = np.atleast_1d(u if lanes is None else u[lanes])
            v = np.atleast_1d(np.asarray(v))
            assert u.dtype == v.dtype, f"{tag} {leaf}"
            np.testing.assert_array_equal(
                u.view(np.uint8) if u.dtype.kind == "f" else u,
                v.view(np.uint8) if v.dtype.kind == "f" else v,
                err_msg=f"{tag} {name}.{leaf}")


def _params(mod):
    return mod.SimParams(db_size=100, txn_size_mean=8, write_prob=0.3,
                         mpl=16, horizon=2_000.0, seed=7)


def test_multipass_run_matches_reference_and_fused():
    init, cond, step = jaxsim.engine_parts(_params(JT), "ppcc",
                                           fused=False, fleet=True)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda: jax.lax.while_loop(cond, step, init(0)))())
    finals = {}
    for fused in (False, True):
        parts = E.engine_parts(_params(TT), "ppcc", fused=fused,
                               device="cpu")
        finals[fused] = TS.run_while(parts[1], parts[2],
                                     parts[0](torch.tensor([0])))[0]
    _assert_same(finals[False], ref, lanes=0, tag="multipass vs reference")
    _assert_same(finals[False], finals[True], tag="multipass vs fused")
    assert int(ref.commits) > 0 and int(ref.iters) > 100


def test_invariants_hold_after_every_multipass_step():
    p = TT.SimParams(db_size=50, txn_size_mean=8, write_prob=0.5, mpl=24,
                     horizon=1_500.0, seed=3)
    init, cond, step = E.engine_parts(p, "ppcc", fused=False, device="cpu")
    s = init(torch.tensor([0, 1]))
    steps = 0
    while bool(cond(s).any()) and steps < 400:
        s = TS._select(cond(s), step(s), s)
        steps += 1
        ps = s.pstate
        assert bool(TP.acyclic(ps).all()), f"cycle after step {steps}"
        assert bool(TP.path_length_leq_one(ps).all()), steps
        assert bool(TP.classes_consistent(ps).all()), steps
    assert steps > 50 and bool((s.commits > 0).all())


def test_run_grid_multipass_matches_reference_and_fused(monkeypatch):
    """The multipass fleet equals the reference's multipass grid in every
    metric and the fused fleet in every leaf.  Its body goes through the
    kernel dispatchers (``megakernel=True``, the plain versions on the
    CPU) but never calls the megastep."""
    kw = dict(figs=(6, 13), mpl_grid=(5, 25), seeds=(0,), horizon=400.0,
              protocols=("ppcc",))
    want, _ = JS.run_grid(**kw, fused=False)
    _, fused = TS.run_grid(**kw, device="cpu")

    def no_megastep(*args):
        raise AssertionError("the multipass chain called the megastep")

    monkeypatch.setattr(E.kops, "megastep_relations", no_megastep)
    got, fleet = TS.run_grid(**kw, fused=False, megakernel=True,
                             device="cpu")
    for fig in kw["figs"]:
        for metric in TS.METRICS + ("now",):
            np.testing.assert_array_equal(
                got[fig]["ppcc"][metric],
                np.asarray(want[fig]["ppcc"][metric]),
                err_msg=f"fig {fig} {metric}")
    assert not fleet.parts["ppcc"][2].cfg.fused
    _assert_same(fleet.final["ppcc"], fused.final["ppcc"],
                 tag="multipass fleet vs fused fleet")
    assert fleet.body_iters == fused.body_iters
