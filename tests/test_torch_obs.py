"""The port's in-loop telemetry (``EngCfg.telemetry``, ``repro_torch.obs``)
against the JAX reference, on the CPU, compared bit for bit.

Run ``python tests/test_torch_obs.py --write-golden`` to regenerate
``src/repro_torch/golden/telemetry_h10000.json``: the JAX reference's
``run_grid(delta=True, telemetry=True, trace_every=8, trace_len=256)``
at the defaults of ``run_grid_h10000.json`` (``run_grid``'s defaults
with the horizon cut to 10,000), whose telemetry ``chip_smoke.py``
holds the port's run on the card to.
"""
import hashlib
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
from repro.obs import metrics as JM  # noqa: E402
from repro.obs import trace as JTR  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import sweep as TS  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.obs import trace as TTR  # noqa: E402

GOLDEN_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "golden"
# chip_smoke.py's phase 6 runs the default grid to this horizon
HORIZON = 10_000
GRID_GOLDEN = GOLDEN_DIR / f"run_grid_h{HORIZON}.json"
TM_GOLDEN = GOLDEN_DIR / f"telemetry_h{HORIZON}.json"
TM_RUN = dict(delta=True, telemetry=True, trace_every=8, trace_len=256)
HISTS = ("lat_hist", "wait_hist", "restart_hist", "abort_causes",
         "block_causes")


def trace_sha256(trace) -> str:
    """sha256 of one lane's ring buffer as float32 little-endian bytes."""
    return hashlib.sha256(np.ascontiguousarray(
        trace, dtype="<f4").tobytes()).hexdigest()


def edges_sha256(edges) -> str:
    """sha256 of the histogram edges the engine bins against (float32)."""
    return hashlib.sha256(np.asarray(edges, "<f4").tobytes()).hexdigest()


def mid_lane(figs, mpl_grid, seeds) -> int:
    """The mid-grid lane: the middle figure at the middle MPL, first
    seed (lanes figure-major, ``f*M*S + m*S + s``)."""
    m, s = len(mpl_grid), len(seeds)
    return (len(figs) // 2) * m * s + (m // 2) * s


def write_golden(path: Path = TM_GOLDEN) -> None:
    """Run the reference ``run_grid`` with ``TM_RUN`` at the defaults of
    ``GRID_GOLDEN``, check its lane metrics against that file, and write
    every lane's telemetry."""
    from repro.core import sweep
    from repro.obs import metrics as JM

    base = json.loads(GRID_GOLDEN.read_text())
    grid = {k: base[k] for k in ("figs", "mpl_grid", "seeds", "horizon",
                                 "protocols")}
    t0 = time.perf_counter()
    out, _ = sweep.run_grid(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in grid.items()}, **TM_RUN)
    seconds = time.perf_counter() - t0
    figs = grid["figs"]
    n_lanes = len(figs) * len(grid["mpl_grid"]) * len(grid["seeds"])
    lanes, mid_trace = {}, {}
    mid = mid_lane(figs, grid["mpl_grid"], grid["seeds"])
    for proto in grid["protocols"]:
        for metric in sweep.METRICS + ("now",):
            flat = np.stack([np.asarray(out[f][proto][metric])
                             for f in figs]).reshape(-1)
            if [v.item() for v in flat] != base["lanes"][proto][metric]:
                raise AssertionError(
                    f"{proto}.{metric} with {TM_RUN} differs from "
                    f"{GRID_GOLDEN.name}")

        def flat_tm(key):
            a = np.stack([np.asarray(out[f][proto]["telemetry"][key])
                          for f in figs])
            return a.reshape((n_lanes,) + a.shape[3:])

        lanes[proto] = {k: flat_tm(k).tolist() for k in HISTS}
        traces = flat_tm("trace")
        lanes[proto]["trace_sha256"] = [trace_sha256(t) for t in traces]
        mid_trace[proto] = traces[mid].tolist()
    seed_l, mpl_l, rt_l = sweep.grid_lanes(figs, grid["mpl_grid"],
                                           grid["seeds"])
    doc = {
        "what": "per-lane telemetry of the JAX reference repro.core.sweep."
                f"run_grid(**run) at the defaults of {GRID_GOLDEN.name}, "
                "lanes figure-major (lane f*M*S + m*S + s); traces as "
                "sha256 of float32 little-endian bytes, the mid lane's "
                "in full",
        "command": "python tests/test_torch_obs.py --write-golden",
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "cpu_seconds": round(seconds, 1),
        **grid,
        "run": TM_RUN,
        "lanes_sha256": TS.lanes_sha256(seed_l, mpl_l, rt_l),
        "edges_f32_sha256": edges_sha256(JM.EDGES),
        "mid_lane": mid,
        "mid_trace": mid_trace,
        "lanes": lanes,
    }
    path.write_text(_dump(doc))


def _dump(doc) -> str:
    """JSON with one lane's list per line (compact, diff-friendly)."""
    text = json.dumps(doc, separators=(",", ":"))
    return text.replace("],[", "],\n[") + "\n"


# --------------------------------------------------------------------------
# the engine's telemetry against the reference's, every leaf
# --------------------------------------------------------------------------

# the reference's own high-contention test size (tests/test_delta_relations.py)
N_SLOTS, POOL = 16, 256
SEEDS, MPLS = (0, 1, 2), (14, 8, 14)
RING = dict(trace_every=2, trace_len=16)     # wraps after 32 iterations


def _params(mod):
    return mod.SimParams(db_size=100, txn_size_mean=8, write_prob=0.3,
                         mpl=14, horizon=800.0, seed=5)


def _leaves(state):
    for name in state._fields:
        val = getattr(state, name)
        if isinstance(val, tuple):
            for f in val._fields:
                yield f"{name}.{f}", getattr(val, f)
        else:
            yield name, val


@pytest.fixture(scope="module")
def port_runs():
    """The port's final fleet states, telemetry on and off, by
    protocol (built on first use)."""
    cache = {}

    def get(proto, telemetry):
        if (proto, telemetry) not in cache:
            init, cond, step = E.engine_parts(
                _params(TT), proto, n_slots=N_SLOTS, pool=POOL,
                telemetry=telemetry, **RING, device="cpu")
            s = init(torch.tensor(SEEDS), torch.tensor(MPLS))
            cache[proto, telemetry] = E.state_to_numpy(
                TS.run_while(cond, step, s)[0])
        return cache[proto, telemetry]
    return get


@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_telemetry_matches_reference(port_runs, proto):
    """Every final leaf of a telemetry fleet whose ring buffer wraps,
    ``tm`` included, equals the JAX fleet's."""
    init, cond, step = jaxsim.engine_parts(
        _params(JT), proto, n_slots=N_SLOTS, fleet=True, pool=POOL,
        telemetry=True, **RING)
    run = jax.jit(jax.vmap(lambda sd, mp: jax.lax.while_loop(
        cond, step, init(sd, mp))))
    want = jax.tree.map(np.asarray, run(jnp.asarray(SEEDS, jnp.int32),
                                        jnp.asarray(MPLS, jnp.int32)))
    got = port_runs(proto, True)
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(
            a.view(np.uint8) if a.dtype.kind == "f" else a,
            b.view(np.uint8) if b.dtype.kind == "f" else b, err_msg=name)
    tm = got.tm
    assert tm.trace.shape == (3, 16, len(TM.TRACE_CHANNELS))
    assert (got.iters > 2 * 16).all()                # the ring wrapped
    np.testing.assert_array_equal(tm.lat_hist.sum(1), got.commits)
    np.testing.assert_array_equal(tm.abort_causes.sum(1), got.aborts)
    assert tm.abort_causes.sum() > 0


@pytest.mark.parametrize("proto", TS.PROTOCOLS)
def test_telemetry_off_changes_nothing(port_runs, proto):
    on, off = port_runs(proto, True), port_runs(proto, False)
    for (name, a), (_, b) in zip(_leaves(on), _leaves(off)):
        if name.startswith("tm."):
            assert b.size == 0, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_run_grid_delta_telemetry_matches_reference():
    kw = dict(figs=(6, 13), mpl_grid=(5, 20), seeds=(0,), horizon=300.0,
              delta=True, telemetry=True, trace_every=8, trace_len=32)
    want, _ = JS.run_grid(**kw)
    got, fleet = TS.run_grid(**kw, device="cpu")
    for fig in kw["figs"]:
        for proto in TS.PROTOCOLS:
            g, w = got[fig][proto], want[fig][proto]
            assert set(g) == set(w)
            for metric in TS.METRICS + ("now",):
                np.testing.assert_array_equal(
                    g[metric], np.asarray(w[metric]),
                    err_msg=f"fig {fig} {proto} {metric}")
            assert set(g["telemetry"]) == set(w["telemetry"])
            for leaf, a in g["telemetry"].items():
                np.testing.assert_array_equal(
                    a, np.asarray(w["telemetry"][leaf]),
                    err_msg=f"fig {fig} {proto} telemetry.{leaf}")
    assert fleet.final["ppcc"].rel.dep.shape[1:] == (32, 32)


# --------------------------------------------------------------------------
# host-side reductions and the trace export
# --------------------------------------------------------------------------

def test_host_reductions_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(TM.EDGES, JM.EDGES)
    np.testing.assert_array_equal(TM.bin_values(), JM.bin_values())
    vals = np.concatenate([rng.lognormal(6, 2, 500), [0.0, 1.0, 1e6, 2e6]])
    np.testing.assert_array_equal(TM.value_bin(vals), JM.value_bin(vals))
    block = {
        "lat_hist": rng.integers(0, 50, (2, 3, TM.NBINS)),
        "wait_hist": rng.integers(0, 5, (2, 3, TM.NBINS)),
        "restart_hist": rng.integers(0, 9, (2, 3, TM.RBINS)),
        "abort_causes": rng.integers(0, 9, (2, 3, len(TM.ABORT_CAUSES))),
        "block_causes": rng.integers(0, 9, (2, 3, len(TM.BLOCK_CAUSES)))}
    assert TM.summarize(block) == JM.summarize(block)
    empty = {k: np.zeros_like(v) for k, v in block.items()}
    got, want = TM.summarize(empty), JM.summarize(empty)
    assert json.dumps(got) == json.dumps(want)           # nan == nan
    for qs in ((0.5, 0.99, 0.999), (0.1, 0.9)):
        assert TM.percentiles(block["lat_hist"][0, 0], qs) == \
            JM.percentiles(block["lat_hist"][0, 0], qs)
    th, jh = TM.HostHist(), JM.HostHist()
    for v in vals:
        th.add(v)
        jh.add(v)
    np.testing.assert_array_equal(th.hist, jh.hist)
    assert th.count == jh.count and th.percentiles() == jh.percentiles()

    ring = np.full((12, len(TM.TRACE_CHANNELS)), -1.0, np.float32)
    ring[:9] = rng.random((9, len(TM.TRACE_CHANNELS))) * 100
    ring[:9, 0] = rng.permutation(9) * 37.5           # a wrapped ring
    np.testing.assert_array_equal(TTR.trace_rows(ring), JTR.trace_rows(ring))
    assert TTR.chrome_trace_events(ring, "lane", 2) == \
        JTR.chrome_trace_events(ring, "lane", 2)
    lanes = {"a": ring, "b": ring[::-1]}
    n_t = TTR.write_chrome_trace(tmp_path / "t.json", lanes, {"x": 1})
    n_j = JTR.write_chrome_trace(tmp_path / "j.json", lanes, {"x": 1})
    assert n_t == n_j and (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


# --------------------------------------------------------------------------
# the committed golden
# --------------------------------------------------------------------------

def test_golden_schema_and_input_digest():
    """``telemetry_h10000.json`` describes the run ``chip_smoke.py``
    makes: the grid of ``run_grid_h10000.json``, the defaults of
    ``run_grid`` but the horizon, the lanes the port builds for it
    (their digest), the port's histogram edges, and every lane's
    telemetry of that run."""
    import inspect
    doc = json.loads(TM_GOLDEN.read_text())
    base = json.loads(GRID_GOLDEN.read_text())
    defaults = {k: v.default for k, v in
                inspect.signature(TS.run_grid).parameters.items()}
    for k in ("figs", "mpl_grid", "seeds", "protocols"):
        assert doc[k] == base[k] == list(defaults[k]), k
    assert doc["horizon"] == base["horizon"] == HORIZON
    assert doc["run"] == TM_RUN
    seed_l, mpl_l, rt_l = TS.grid_lanes(doc["figs"], doc["mpl_grid"],
                                        doc["seeds"], "cpu")
    assert doc["lanes_sha256"] == TS.lanes_sha256(seed_l, mpl_l, rt_l)
    assert doc["edges_f32_sha256"] == edges_sha256(TM.EDGES)
    n_lanes = len(seed_l)
    assert doc["mid_lane"] == mid_lane(doc["figs"], doc["mpl_grid"],
                                       doc["seeds"])
    widths = {"lat_hist": TM.NBINS, "wait_hist": TM.NBINS,
              "restart_hist": TM.RBINS,
              "abort_causes": len(TM.ABORT_CAUSES),
              "block_causes": len(TM.BLOCK_CAUSES)}
    for proto in doc["protocols"]:
        lanes = doc["lanes"][proto]
        assert set(lanes) == set(HISTS) | {"trace_sha256"}
        for key, width in widths.items():
            a = np.asarray(lanes[key])
            assert a.shape == (n_lanes, width) and a.dtype.kind == "i", key
        np.testing.assert_array_equal(
            np.asarray(lanes["lat_hist"]).sum(1),
            base["lanes"][proto]["commits"])
        np.testing.assert_array_equal(
            np.asarray(lanes["abort_causes"]).sum(1),
            base["lanes"][proto]["aborts"])
        mid = np.asarray(doc["mid_trace"][proto], np.float32)
        assert mid.shape == (TM_RUN["trace_len"], len(TM.TRACE_CHANNELS))
        assert lanes["trace_sha256"][doc["mid_lane"]] == trace_sha256(mid)
        assert len(lanes["trace_sha256"]) == n_lanes


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
        print(f"wrote {TM_GOLDEN}")
    else:
        sys.exit("usage: python tests/test_torch_obs.py --write-golden")
