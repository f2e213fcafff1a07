"""The port's cohort engine and fleet (``repro_torch.core.engine``,
``repro_torch.core.sweep``) against the JAX reference, on the CPU:

* one cohort body step from the same converted reference state, for each
  protocol, with every leaf equal;
* small fleets (Figs. 7 and 13, MPL 5 and 25, seeds 0 and 1, horizon
  400) with every lane's final state equal, for all three protocols;
* the Theorem-1 invariants after every step of a PPCC fleet;
* ``run_grid`` on Figs. 6 and 13 with metrics equal to
  ``repro.core.sweep.run_grid``.

Run ``python tests/test_torch_engine.py --write-golden`` to regenerate
``src/repro_torch/golden/run_grid_h20000.json``: the JAX reference's
default ``run_grid()`` on the CPU, the per-lane metrics that
``chip_smoke.py`` holds the port's runs on the card to; ``--write-golden
--horizon 5000`` writes ``run_grid_h5000.json``, the same grid at the
horizon of ``chip_smoke.py``'s phase 3.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import jaxsim  # noqa: E402
from repro.core import sweep as JS  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import ppcc as TP  # noqa: E402
from repro_torch.core import sweep as TS  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402

GOLDEN_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "golden"
GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "golden" / "run_grid_h20000.json")


def golden_path(horizon: float) -> Path:
    """The golden of ``run_grid()`` at ``horizon``, its other defaults."""
    return GOLDEN_DIR / f"run_grid_h{int(horizon)}.json"


def write_golden(horizon: float = None) -> Path:
    """Run the reference ``run_grid()`` with its defaults (``horizon``
    replaced when given) and write the per-lane metrics, figure-major
    (lane ``f*M*S + m*S + s``).  Returns the file written."""
    import inspect

    import jax
    import numpy as np

    from repro.core import sweep

    defaults = {k: v.default for k, v in
                inspect.signature(sweep.run_grid).parameters.items()
                if k in ("figs", "mpl_grid", "seeds", "horizon",
                         "protocols")}
    command = "python tests/test_torch_engine.py --write-golden"
    if horizon is not None:
        defaults["horizon"] = float(horizon)
        command += f" --horizon {int(horizon)}"
    t0 = time.perf_counter()
    out, _ = sweep.run_grid(horizon=defaults["horizon"])
    seconds = time.perf_counter() - t0
    figs = list(defaults["figs"])
    lanes = {}
    for proto in defaults["protocols"]:
        lanes[proto] = {}
        for metric in sweep.METRICS + ("now",):
            flat = np.stack([np.asarray(out[f][proto][metric])
                             for f in figs]).reshape(-1)
            lanes[proto][metric] = [v.item() for v in flat]
    doc = {
        "what": "per-lane metrics of the JAX reference repro.core.sweep."
                "run_grid() with its defaults"
                + ("" if horizon is None else " but the horizon")
                + ", lanes figure-major (lane f*M*S + m*S + s)",
        "command": command,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "cpu_seconds": round(seconds, 1),
        "figs": figs,
        "mpl_grid": list(defaults["mpl_grid"]),
        "seeds": list(defaults["seeds"]),
        "horizon": float(defaults["horizon"]),
        "protocols": list(defaults["protocols"]),
        "lanes": lanes,
    }
    path = golden_path(defaults["horizon"])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    return path


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _assert_state(port: E.EngState, ref, lanes=None, tag=""):
    """Every leaf of the port's state equals the reference's (numpy
    leaves; ``lanes`` picks port lanes for a single-lane reference)."""
    got = E.state_to_numpy(port)
    for name in E.EngState._fields:
        g, w = getattr(got, name), getattr(ref, name)
        pairs = (zip(g._fields, g, w) if isinstance(g, tuple)
                 else [(name, g, w)])
        for leaf, a, b in pairs:
            a = np.atleast_1d(a if lanes is None else a[lanes])
            b = np.atleast_1d(np.asarray(b))
            assert a.dtype == b.dtype, f"{tag} {leaf}: {a.dtype} {b.dtype}"
            np.testing.assert_array_equal(
                a.view(np.uint8) if a.dtype.kind == "f" else a,
                b.view(np.uint8) if b.dtype.kind == "f" else b,
                err_msg=f"{tag} {name}.{leaf}")


# --------------------------------------------------------------------------
# one body step from the same state
# --------------------------------------------------------------------------

STEP_CASES = [("ppcc", 256, "index"), ("ppcc", 0, "degree"),
              ("2pl", 256, "index"), ("occ", 0, "index")]


@pytest.mark.parametrize("proto,pool,order", STEP_CASES)
def test_one_body_step_matches(proto, pool, order):
    """From reference states along a run, one port body step (plain
    versions inline, and through the kernel dispatchers) equals one
    reference ``_cohort_body`` step, leaf for leaf."""
    def params(mod):
        return mod.paper_figure_params(8).with_(mpl=20, horizon=3000.0)
    init, _, step = jaxsim.engine_parts(params(JT), proto, n_slots=24,
                                        fleet=True, pool=pool, order=order)
    ports = [E.engine_parts(params(TT), proto, n_slots=24, pool=pool,
                            order=order, megakernel=mk, device="cpu")[2]
             for mk in (False, True)]
    s = init(9)
    commits = 0
    for k in range(90):
        nxt = step(s)
        if k % 6 == 5:
            ref = jax.tree.map(np.asarray, nxt)
            for port_step in ports:
                got = port_step(E.state_from_numpy(
                    jax.tree.map(np.asarray, s), "cpu"))
                _assert_state(got, ref, lanes=0, tag=f"step {k}")
            commits = int(ref.commits)
        s = nxt
    assert commits > 0


# --------------------------------------------------------------------------
# small fleets: every lane's final state
# --------------------------------------------------------------------------

FLEET_MPLS, FLEET_SEEDS, FLEET_HORIZON = (5, 25), (0, 1), 400.0


def _reference_fleet(fig, proto):
    """The reference ``Fleet``'s lanes (``vmap`` of ``while_loop``) with
    their whole final states."""
    p = JT.paper_figure_params(fig).with_(horizon=FLEET_HORIZON)
    n_slots = JS.slot_bucket(max(FLEET_MPLS))
    pool = max(4096, int(FLEET_HORIZON) // 6)
    init, cond, step = jaxsim.engine_parts(p, proto, n_slots=n_slots,
                                           fleet=True, pool=pool)
    m, s = len(FLEET_MPLS), len(FLEET_SEEDS)
    seeds = jnp.asarray(np.tile(FLEET_SEEDS, m), jnp.int32)
    mpls = jnp.asarray(np.repeat(FLEET_MPLS, s), jnp.int32)
    rt = jax.tree.map(lambda x: jnp.broadcast_to(x, (m * s,)),
                      jaxsim.rt_of(p))
    run = jax.jit(jax.vmap(lambda sd, mp, r: jax.lax.while_loop(
        cond, step, init(sd, mp, r))))
    return jax.tree.map(np.asarray, run(seeds, mpls, rt))


@pytest.fixture(scope="module")
def port_fleets():
    return {fig: TS.run_fleet(fig, FLEET_MPLS, FLEET_SEEDS, FLEET_HORIZON,
                              device="cpu") for fig in (7, 13)}


@pytest.mark.parametrize("proto", TS.PROTOCOLS)
@pytest.mark.parametrize("fig", [7, 13])
def test_small_fleet_final_states_match(port_fleets, fig, proto):
    out, fleet = port_fleets[fig]
    ref = _reference_fleet(fig, proto)
    _assert_state(fleet.final[proto], ref, tag=f"fig {fig} {proto}")
    assert out[proto]["commits"].shape == (len(FLEET_MPLS),
                                           len(FLEET_SEEDS))
    np.testing.assert_array_equal(out[proto]["commits"].reshape(-1),
                                  ref.commits)
    assert (ref.ops_done > 0).all()
    assert fleet.body_iters[proto] >= int(ref.iters.max())


def test_theorem1_invariants_after_every_ppcc_step():
    p = TT.paper_figure_params(7).with_(horizon=1500.0)
    fleet = TS.Fleet(p, protocols=("ppcc",), n_slots=32, device="cpu")
    init, cond, step = fleet.parts["ppcc"]
    seeds = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    mpls = torch.tensor([5, 5, 25, 25], dtype=torch.int32)
    s = init(seeds, mpls, E.rt_of(p, 4, "cpu"))
    pad = torch.arange(32)[None, :] >= mpls[:, None]
    steps = 0
    while bool(cond(s).any()):
        s = TS._select(cond(s), step(s), s)
        steps += 1
        ps = s.pstate
        assert bool(TP.path_length_leq_one(ps).all()), steps
        assert bool(TP.acyclic(ps).all()), steps
        assert bool(TP.classes_consistent(ps).all()), steps
        assert not (ps.active & pad).any(), steps
    assert steps > 50 and bool((s.commits > 0).all())


def test_run_grid_matches_reference():
    kw = dict(figs=(6, 13), mpl_grid=(5, 50), seeds=(0,), horizon=400.0)
    want, _ = JS.run_grid(**kw)
    got, fleet = TS.run_grid(**kw, device="cpu")
    for fig in kw["figs"]:
        for proto in TS.PROTOCOLS:
            for metric in TS.METRICS + ("now",):
                np.testing.assert_array_equal(
                    got[fig][proto][metric],
                    np.asarray(want[fig][proto][metric]),
                    err_msg=f"fig {fig} {proto} {metric}")
    assert fleet.n_slots == 64


@pytest.mark.parametrize("horizon", [None, 1000.0, 5000.0, 10000.0])
def test_golden_describes_run_grid(horizon):
    """The committed grid goldens hold ``run_grid()`` at its defaults
    (``horizon`` replaced): 168 lanes per protocol, each metric."""
    import inspect
    defaults = {k: v.default for k, v in
                inspect.signature(TS.run_grid).parameters.items()}
    path = golden_path(defaults["horizon"] if horizon is None else horizon)
    doc = json.loads(path.read_text())
    for k in ("figs", "mpl_grid", "seeds", "protocols"):
        assert doc[k] == list(defaults[k]), k
    assert doc["horizon"] == (horizon or defaults["horizon"])
    n_lanes = len(doc["figs"]) * len(doc["mpl_grid"]) * len(doc["seeds"])
    for proto in doc["protocols"]:
        lanes = doc["lanes"][proto]
        assert sorted(lanes) == sorted(TS.METRICS + ("now",))
        assert all(len(v) == n_lanes for v in lanes.values())
        assert sum(lanes["commits"]) > 0
        assert max(lanes["now"]) > doc["horizon"]


def test_entry_points_want_the_card_unless_asked():
    """With no CUDA device, the default device raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TS.run_grid(figs=(6,), mpl_grid=(5,), seeds=(0,), horizon=10.0)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--write-golden"] and len(args) in (1, 3) and \
            (len(args) == 1 or args[1] == "--horizon"):
        print(f"wrote {write_golden(float(args[2]) if args[2:] else None)}")
    else:
        sys.exit("usage: python tests/test_torch_engine.py --write-golden "
                 "[--horizon H]")
