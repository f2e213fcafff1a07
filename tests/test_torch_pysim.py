"""The port's numpy oracle (``repro_torch.core.pysim``) and workload
generator (``repro_torch.core.workload``) against ``repro.core.pysim``
and ``repro.core.workload``: the same seeds give the same results, field
for field, the telemetry block and the committed history included."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pysim as JS  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.core import workload as JW  # noqa: E402
from repro_torch.core import pysim as TS  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.core import workload as TW  # noqa: E402

FIELDS = ("protocol", "commits", "aborts", "blocks", "restarts",
          "ops_executed", "sum_response_time", "sim_time")


def _params(mod, seed, **kw):
    return mod.SimParams(db_size=100, mpl=16, horizon=2000.0, seed=seed,
                         **kw)


def _assert_same(a, b, tag):
    """Equal values, recursing into dicts, lists and arrays."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), tag
        for k in a:
            _assert_same(a[k], b[k], f"{tag}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=tag)
    else:
        assert a == b, (tag, a, b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("protocol", ["ppcc", "2pl", "occ"])
def test_simulate_matches_field_for_field(protocol, seed):
    got = TS.simulate(_params(TT, seed), protocol)
    want = JS.simulate(_params(JT, seed), protocol)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.commits > 0
    _assert_same(got.telemetry, want.telemetry, "telemetry")
    assert got.row() == want.row()


@pytest.mark.parametrize("protocol", ["ppcc", "2pl", "occ"])
def test_history_and_serialization_graph_match(protocol):
    p = dict(write_prob=0.5)
    got = TS.simulate(_params(TT, 3, **p), protocol, record_history=True)
    want = JS.simulate(_params(JT, 3, **p), protocol, record_history=True)
    assert got.history == want.history and len(got.history) > 0
    g_port = TS.serialization_graph(got.history)
    assert g_port == JS.serialization_graph(want.history)
    assert TS.is_acyclic(g_port) and JS.is_acyclic(g_port)
    # a two-transaction cycle is found by both
    cyc = {0: {1}, 1: {0}}
    assert not TS.is_acyclic(cyc) and not JS.is_acyclic(cyc)


@pytest.mark.parametrize("quantum", [None, 20])
@pytest.mark.parametrize("theta", [0.0, 0.9])
def test_workload_batch_matches(quantum, theta):
    tp = TT.SimParams(db_size=500, txn_size_mean=16, write_prob=0.5,
                      zipf_theta=theta)
    jp = JT.SimParams(db_size=500, txn_size_mean=16, write_prob=0.5,
                      zipf_theta=theta)
    got = TW.workload_batch(5, tp, 64, 20, quantum)
    want = JW.workload_batch(5, jp, 64, 20, quantum)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng_a, rng_b = np.random.default_rng(2), np.random.default_rng(2)
    assert [(int(o.kind), o.item) for o in TW.sample_txn_ops(rng_a, tp)] \
        == [(int(o.kind), o.item) for o in JW.sample_txn_ops(rng_b, jp)]
    assert repr(TT.Op(TT.OpKind.WRITE, 3)) == repr(JT.Op(JT.OpKind.WRITE,
                                                         3)) == "W(3)"
