"""Lane-sharded fleets on ``torch.distributed`` (``repro_torch.core.sweep``
``fleet_mesh``, ``Fleet(mesh=)``, ``run_fleet(shard=True)``) in spawned
``gloo`` worlds of 2 and 4 on the CPU.

At the reference test's settings (``tests/test_sweep.py``: Fig. 7, horizon
400, MPL 5, ``n_slots=8``, ``max_iters=50``, MPLs (3, 5) x seeds (0, 1, 2,
3)), every rank's results over ``host_mesh`` and over ``pod_mesh`` equal
the unsharded fleet's, computed in the parent, in every metric and
``now``, bit for bit, for PPCC and OCC; with telemetry every
accumulator too.  Six lanes in a world of 4 leave ranks outside the mesh,
and they still return every lane.  Each world runs under its own timeout,
with a ``file://`` store under the test's directory.
"""
import contextlib
import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.core import sweep  # noqa: E402
from repro_torch.core.types import paper_figure_params  # noqa: E402

MPLS, SEEDS = (3, 5), (0, 1, 2, 3)
# PPCC (megastep, reserve_cohort) and OCC (occ_validate): the two bodies
# with kernels of their own; 2PL's runs on reserve_cohort alone
KW = dict(protocols=("ppcc", "occ"), n_slots=8, max_iters=50, device="cpu")
RUN_KW = dict(KW, n_slots=None)      # run_fleet's own bucket (Fig. 7's MPL)
WORLD_TIMEOUT_S = 150


def _params():
    return paper_figure_params(7).with_(horizon=400.0, mpl=5)


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


def _start(rank, n, store, lws=None):
    torch.set_num_threads(1)
    if lws:
        os.environ["LOCAL_WORLD_SIZE"] = str(lws)
    from repro_torch.parallel import sharding
    assert sharding.init_distributed(f"file://{store}", n, rank,
                                     device="cpu")
    assert not sharding.init_distributed(f"file://{store}", n, rank,
                                         device="cpu")       # a no-op
    return sharding


def _fleet(mesh, seeds=SEEDS):
    return sweep.Fleet(_params(), mesh=mesh, **KW)(MPLS, seeds)


def world_of_2(rank, n, store, out):
    shd = _start(rank, n, store)
    res = {}
    mesh = shd.host_mesh()
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
        {"data": 2, "model": 1}
    res["host"] = _fleet(mesh)
    pm = sweep.fleet_mesh(8, pods=True)
    assert dict(zip(pm.mesh_dim_names, pm.shape)) == \
        {"pod": 1, "data": 2, "model": 1}
    assert shd.data_axes(pm) == ("pod", "data")
    res["pod"] = _fleet(pm)
    res["run_fleet"], fl = sweep.run_fleet(
        7, MPLS, SEEDS, 400.0, telemetry=True, trace_every=4, trace_len=16,
        **RUN_KW)
    assert fl.mesh is not None and fl.final["ppcc"].commits.shape == (4,)
    Path(out, f"{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.destroy_process_group()


def world_of_4(rank, n, store, out):
    shd = _start(rank, n, store, lws=2)
    res = {}
    res["host"] = _fleet(shd.host_mesh())
    pm = sweep.fleet_mesh(8)                  # two hosts: the pod path
    assert dict(zip(pm.mesh_dim_names, pm.shape)) == \
        {"pod": 2, "data": 2, "model": 1}
    # lanes pod-major: rank 2 (pod 1, data 0) holds lanes 4 and 5
    assert sweep._lane_block(pm, 8) == (rank, (2 * rank, 2 * rank + 2))
    res["pod"] = _fleet(pm)
    # six lanes: a host mesh of 3 ranks and a pod mesh of (2, 1, 1)
    m3 = sweep.fleet_mesh(6, pods=False)
    assert tuple(m3.shape) == (3, 1)
    res["host6"] = _fleet(m3, SEEDS[:3])
    m21 = sweep.fleet_mesh(6)
    assert tuple(m21.shape) == (2, 1, 1)
    res["pod6"] = _fleet(m21, SEEDS[:3])
    Path(out, f"{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.destroy_process_group()


@contextlib.contextmanager
def one_thread():
    """torch on one thread inside the block (these lane batches are tiny,
    and the test runs beside other workers and its own world)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unsharded():
    with one_thread():
        return {"8": sweep.Fleet(_params(), **KW)(MPLS, SEEDS),
                "6": sweep.Fleet(_params(), **KW)(MPLS, SEEDS[:3]),
                "tm": sweep.run_fleet(7, MPLS, SEEDS, 400.0, shard=False,
                                      telemetry=True, trace_every=4,
                                      trace_len=16, **RUN_KW)[0]}


def _equal(got, want, where):
    assert set(got) == set(want), where
    for proto, res in want.items():
        assert set(got[proto]) == set(res), (where, proto)
        for k, v in res.items():
            if isinstance(v, dict):
                _equal({proto: got[proto][k]}, {proto: v}, (where, k))
                continue
            assert got[proto][k].dtype == v.dtype, (where, proto, k)
            np.testing.assert_array_equal(got[proto][k], v,
                                          err_msg=f"{where} {proto} {k}")


def test_fleet_on_a_world_of_2(tmp_path, unsharded):
    for rank, res in enumerate(run_world(world_of_2, 2, tmp_path)):
        _equal(res["host"], unsharded["8"], (rank, "host_mesh"))
        _equal(res["pod"], unsharded["8"], (rank, "pod_mesh"))
        _equal(res["run_fleet"], unsharded["tm"], (rank, "run_fleet"))
    assert not dist.is_initialized()


def test_fleet_on_a_world_of_4(tmp_path, unsharded):
    for rank, res in enumerate(run_world(world_of_4, 4, tmp_path)):
        _equal(res["host"], unsharded["8"], (rank, "host_mesh"))
        _equal(res["pod"], unsharded["8"], (rank, "pod_mesh"))
        _equal(res["host6"], unsharded["6"], (rank, "six lanes, host"))
        _equal(res["pod6"], unsharded["6"], (rank, "six lanes, pods"))
