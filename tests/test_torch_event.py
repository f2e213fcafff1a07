"""The port's one-event engine and single-lane entry points
(``repro_torch.core.engine``) against ``repro.core.jaxsim``, on the CPU:

* ``engine_parts(step_mode="event")`` for each protocol at 50 items, MPL
  8, horizon 400, seeds 0 and 1 as lanes: every ``EngState`` leaf equal
  at the end, and after each of the first 50 events for PPCC;
* events whose ``next_time`` ties: the first slot is taken;
* ``simulate``, ``simulate_sweep`` and ``make_padded_engine`` in both
  step modes against the reference's;
* the committed goldens of ``chip_smoke.py``'s phase 8 describe its runs.

Run ``python tests/test_torch_event.py --write-golden`` to regenerate
``src/repro_torch/golden/event_h600.json`` (the JAX event engine, vmapped
over 8 seeds, Fig. 6's setting at MPL 25 to horizon 600, each protocol)
and ``simulate_h1000.json`` (``jaxsim.simulate`` in cohort mode, the same
setting to horizon 1,000), about a minute of CPU.
"""
import dataclasses
import functools
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
from repro.core import types as JT  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402

GOLDEN_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "golden"
# chip_smoke.py's phase 8: Fig. 6's setting (100 items, 8 +- 4 ops, write
# probability 0.2, 4 CPUs, 8 disks) at MPL 25
PHASE8_FIG, PHASE8_MPL = 6, 25
# the event engine's horizon is cut to 600: at 3,000 its three runs took
# 298.7 s of the chip script's wall on the card, at 1,000 152-188 s (the
# host's dispatch of some 3,400 small kernels an event); 600 is the
# shortest of 400, 500 and 600 at which every lane of every protocol
# commits (at 400 and 500 some commit nothing)
EVENT_HORIZON, EVENT_SEEDS = 600.0, tuple(range(8))
SIMULATE_HORIZON = 1000.0
EVENT_METRICS = ("commits", "aborts", "blocks", "ops_done", "iters", "now")
SIMULATE_METRICS = ("commits", "aborts", "blocks", "ops_executed",
                    "sim_time")
PROTOCOLS = ("ppcc", "2pl", "occ")


def phase8_params(mod, horizon: float):
    return mod.paper_figure_params(PHASE8_FIG).with_(mpl=PHASE8_MPL,
                                                     horizon=horizon)


def write_golden() -> list:
    """Run the JAX reference for phase 8's event and single-lane runs and
    write both goldens.  Returns the files written."""
    command = "python tests/test_torch_event.py --write-golden"
    common = {"command": command, "jax": jax.__version__,
              "backend": jax.default_backend()}
    p = phase8_params(JT, EVENT_HORIZON)
    t0 = time.perf_counter()
    lanes = {}
    for proto in PROTOCOLS:
        run = jaxsim.make_engine(p, proto, step_mode="event")
        final = jax.vmap(run)(jnp.asarray(EVENT_SEEDS, jnp.int32))
        lanes[proto] = {k: np.asarray(getattr(final, k)).tolist()
                        for k in EVENT_METRICS}
    event = {"what": "per-lane metrics of the JAX reference's one-event "
                     "engine, jax.vmap(jaxsim.make_engine(p, protocol, "
                     "step_mode='event')) over the seeds",
             **common, "cpu_seconds": round(time.perf_counter() - t0, 1),
             "params": dataclasses.asdict(p), "step_mode": "event",
             "seeds": list(EVENT_SEEDS), "protocols": list(PROTOCOLS),
             "lanes": lanes}
    p = phase8_params(JT, SIMULATE_HORIZON)
    t0 = time.perf_counter()
    results = {}
    for proto in PROTOCOLS:
        res = jaxsim.simulate(p, proto)
        results[proto] = {k: getattr(res, k) for k in SIMULATE_METRICS}
    single = {"what": "jaxsim.simulate(p, protocol) (cohort mode, seed "
                      "p.seed) of the JAX reference",
              **common, "cpu_seconds": round(time.perf_counter() - t0, 1),
              "params": dataclasses.asdict(p), "step_mode": "cohort",
              "protocols": list(PROTOCOLS), "results": results}
    paths = []
    for doc, name in ((event, f"event_h{int(EVENT_HORIZON)}.json"),
                      (single, f"simulate_h{int(SIMULATE_HORIZON)}.json")):
        path = GOLDEN_DIR / name
        path.write_text(json.dumps(doc, indent=1) + "\n")
        paths.append(path)
    return paths


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _assert_state(port: E.EngState, ref, lanes=None, tag=""):
    """Every leaf of the port's state equals the reference's (numpy
    leaves; ``lanes`` picks port lanes for a single-lane reference);
    floats are compared as bit patterns."""
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


def _small(mod):
    return mod.SimParams(db_size=50, mpl=8, horizon=400.0)


# --------------------------------------------------------------------------
# the one-event engine
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_event(proto):
    """The reference's event engine on the small setting, compiled once
    per protocol: ``(run(seed), step)``."""
    _, _, step = jaxsim.engine_parts(_small(JT), proto, step_mode="event")
    return jaxsim.make_engine(_small(JT), proto, step_mode="event"), step


@pytest.mark.parametrize("proto", PROTOCOLS)
def test_event_engine_final_states_match(proto):
    """Two seeds as lanes of one port run, each lane equal to the
    reference's run of its seed, leaf for leaf; ``simulate_sweep`` and
    ``simulate`` report the same metrics."""
    run = _jax_event(proto)[0]
    refs = [jax.tree.map(np.asarray, run(jnp.int32(sd))) for sd in (0, 1)]
    got = E.make_engine(_small(TT), proto, step_mode="event",
                        device="cpu")(torch.tensor([0, 1]))
    for lane, ref in enumerate(refs):
        _assert_state(got, ref, lanes=lane, tag=f"{proto} seed {lane}")
        assert ref.commits > 0 and ref.iters > 50
    sweep = E.simulate_sweep(_small(TT), proto, [0, 1], step_mode="event",
                             device="cpu")
    for k in EVENT_METRICS:
        np.testing.assert_array_equal(
            sweep[k], np.stack([getattr(r, k) for r in refs]), err_msg=k)
    res = E.simulate(_small(TT).with_(seed=1), proto, step_mode="event",
                     device="cpu")
    assert (res.commits, res.aborts, res.blocks, res.ops_executed) == \
        tuple(int(getattr(refs[1], k))
              for k in ("commits", "aborts", "blocks", "ops_done"))
    assert res.sim_time == min(float(refs[1].now), 400.0)


def test_event_steps_match_ppcc():
    """The first 50 events of a PPCC lane, every leaf after each."""
    step = _jax_event("ppcc")[1]
    init = jaxsim.engine_parts(_small(JT), "ppcc", step_mode="event")[0]
    tinit, _, tstep = E.engine_parts(_small(TT), "ppcc", step_mode="event",
                                     device="cpu")
    s, ts = init(3), tinit(torch.tensor([3]))
    _assert_state(ts, jax.tree.map(np.asarray, s), lanes=0, tag="init")
    kinds = set()
    for k in range(50):
        kinds.add(int(s.next_kind[int(jnp.argmin(s.next_time))]))
        s, ts = step(s), tstep(ts)
        _assert_state(ts, jax.tree.map(np.asarray, s), lanes=0,
                      tag=f"event {k}")
    assert {0, 1} <= kinds


@pytest.mark.parametrize("proto", ["ppcc", "occ"])
def test_event_ties_take_the_first_slot(proto):
    """States whose earliest ``next_time`` is shared by several slots:
    the port takes the first of them, as ``jnp.argmin`` does."""
    step = _jax_event(proto)[1]
    init = jaxsim.engine_parts(_small(JT), proto, step_mode="event")[0]
    tstep = E.engine_parts(_small(TT), proto, step_mode="event",
                           device="cpu")[2]
    s = init(5)
    for k in range(40):
        s = step(s)
        if k % 10 == 9:
            nt = np.asarray(s.next_time).copy()
            live = np.flatnonzero(nt < 1e29)
            tied = live[-3:]
            nt[tied] = nt[live].min()
            tie = s._replace(next_time=jnp.asarray(nt))
            ref = jax.tree.map(np.asarray, step(tie))
            got = tstep(E.state_from_numpy(jax.tree.map(np.asarray, tie),
                                           "cpu"))
            _assert_state(got, ref, lanes=0, tag=f"tie at {k}")


# --------------------------------------------------------------------------
# single-lane entry points in cohort mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("proto", ["ppcc", "occ"])
def test_simulate_matches(proto):
    p = _small(JT).with_(seed=4)
    want = jaxsim.simulate(p, proto)
    got = E.simulate(_small(TT).with_(seed=4), proto, device="cpu")
    for k in SIMULATE_METRICS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.commits > 0


def test_simulate_sweep_matches():
    seeds = [0, 2, 5]
    want = jaxsim.simulate_sweep(_small(JT), "2pl", seeds)
    got = E.simulate_sweep(_small(TT), "2pl", seeds, device="cpu")
    for k in ("commits", "aborts", "blocks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert sorted(got) == sorted(EVENT_METRICS)


@pytest.mark.parametrize("proto,mode", [("2pl", "cohort"), ("ppcc", "event")])
def test_make_padded_engine_matches(proto, mode):
    want = jax.tree.map(np.asarray, jaxsim.make_padded_engine(
        _small(JT), proto, n_slots=12, step_mode=mode)(3, 6))
    run = E.make_padded_engine(_small(TT), proto, n_slots=12,
                               step_mode=mode, device="cpu")
    _assert_state(run(3, 6), want, lanes=0, tag=f"{proto} {mode}")
    with pytest.raises(ValueError):
        run(3, 13)


def test_engine_options_that_raise():
    with pytest.raises(ValueError):
        E.engine_parts(_small(TT), "ppcc", step_mode="batch", device="cpu")
    with pytest.raises(ValueError):
        E.engine_parts(_small(TT), "ppcc", step_mode="event",
                       telemetry=True, device="cpu")
    # delta applies to the fused cohort mode only, as in the reference
    for kw in (dict(step_mode="event"), dict(fused=False)):
        cfg = E.engine_parts(_small(TT), "ppcc", delta=True, device="cpu",
                             **kw)[0].cfg
        assert not cfg.delta


def test_entry_points_want_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        E.simulate(_small(TT), "ppcc", step_mode="event")


# --------------------------------------------------------------------------
# the goldens of chip_smoke.py's phase 8
# --------------------------------------------------------------------------

def test_goldens_describe_phase_8():
    event = json.loads((GOLDEN_DIR / f"event_h{int(EVENT_HORIZON)}.json")
                       .read_text())
    assert event["params"] == dataclasses.asdict(
        phase8_params(TT, EVENT_HORIZON))
    assert event["step_mode"] == "event"
    assert event["seeds"] == list(EVENT_SEEDS)
    assert event["protocols"] == list(PROTOCOLS)
    for proto in PROTOCOLS:
        lanes = event["lanes"][proto]
        assert sorted(lanes) == sorted(EVENT_METRICS)
        assert all(len(v) == len(EVENT_SEEDS) for v in lanes.values())
        assert min(lanes["commits"]) > 0
        assert min(lanes["now"]) > EVENT_HORIZON
    single = json.loads((GOLDEN_DIR / "simulate_h1000.json").read_text())
    assert single["params"] == dataclasses.asdict(
        phase8_params(TT, SIMULATE_HORIZON))
    assert single["step_mode"] == "cohort"
    for proto in PROTOCOLS:
        res = single["results"][proto]
        assert sorted(res) == sorted(SIMULATE_METRICS)
        assert res["commits"] > 0
        assert res["sim_time"] == SIMULATE_HORIZON


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-golden"]:
        for path in write_golden():
            print(f"wrote {path}")
    else:
        sys.exit("usage: python tests/test_torch_event.py --write-golden")
