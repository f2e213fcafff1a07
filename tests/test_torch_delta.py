"""The port's delta-maintained relations (``EngCfg.delta``) against the JAX
reference, on the CPU, compared bit for bit:

* ``empty_relations``, ``dirty_slots``, ``dirty_slab`` and
  ``scatter_relations`` against ``repro.core.ppcc`` on random states,
  with duplicates among the invalid slab entries;
* the plain row slab ``kernels.ref.rowslab_ref`` against the JAX oracle
  ``repro.kernels.ref.rowslab_ref`` and the Pallas kernel
  ``repro.kernels.megastep.rowslab`` in interpret mode;
* the delta fleet at the reference's own test size with every final
  ``EngState`` leaf, ``rel`` included, equal to the JAX fleet's, and
  every other leaf equal to the port's delta-off run;
* ``rel`` equal to a full recompute after every step;
* the plain drain ``kernels.ref.rowslab_drain_ref`` (what the row-slab
  drain kernel computes in one launch) equal to the reference's
  ``jaxsim._delta_update`` on the engine's inputs, and, on random
  inconsistent tables, free of its slab size and equal to its closed
  form: an entry is recomputed where its row or column slot is dirty.
"""
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as JB  # noqa: E402
from repro.core import jaxsim  # noqa: E402
from repro.core import ppcc as JP  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.kernels import megastep as JMS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import ppcc as TP  # noqa: E402
from repro_torch.core import sweep as TS  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROWS = ("dep_rows", "ww_rows", "wat_rows", "rat_rows")


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _words(rng, n, d, p):
    return np.array(JB.pack(jnp.asarray(rng.random((n, d)) < p)))


def _slab(rng, n, k, n_valid):
    """A slab of ``n_valid`` ascending distinct valid ids; the invalid
    entries repeat ids (valid ones among them), n and ids past n."""
    ids = np.sort(rng.choice(n, size=n_valid, replace=False))
    junk = rng.choice([0, n - 1, n, n + 3], size=k - n_valid)
    slab = np.concatenate([ids, junk]).astype(np.int32)
    valid = np.arange(k) < n_valid
    return slab, valid


# --------------------------------------------------------------------------
# the four ppcc primitives
# --------------------------------------------------------------------------

def test_empty_relations_match():
    for n in (0, 5):
        want = JP.empty_relations(n)
        got = TP.empty_relations(3, n, "cpu")
        for g, w in zip(got, want):
            assert g.dtype == torch.bool and g.shape == (3, n, n)
            np.testing.assert_array_equal(g[1].numpy(), np.asarray(w))


@pytest.mark.parametrize("n,d", [(14, 100), (33, 70)])
def test_dirty_slots_and_slab_match(n, d):
    rng = np.random.default_rng(n + d)
    lanes = 4
    per_lane = []
    for lane in range(lanes):
        old_r, old_w = _words(rng, n, d, 0.05), _words(rng, n, d, 0.03)
        new_r, new_w = old_r.copy(), old_w.copy()
        # a few slots' words change; the last lane keeps every word
        for i in rng.choice(n, size=3 if lane < lanes - 1 else 0,
                            replace=False):
            new_r[i] = _words(rng, 1, d, 0.05)[0]
            new_w[i] = 0
        old_item = rng.integers(0, d, n).astype(np.int32)
        new_item = np.where(rng.random(n) < 0.2,
                            rng.integers(0, d, n), old_item).astype(np.int32)
        old_isw = rng.random(n) < 0.4
        new_isw = np.where(rng.random(n) < 0.1, ~old_isw, old_isw)
        per_lane.append((old_r, old_w, new_r, new_w, old_item, new_item,
                         old_isw, new_isw))
    stack = [torch.stack([_t(x[k]) for x in per_lane]) for k in range(8)]
    base = TP.init_state(lanes, n, d, "cpu")
    old = base._replace(read_set=stack[0], write_set=stack[1])
    new = base._replace(read_set=stack[2], write_set=stack[3])
    dirty = TP.dirty_slots(old, new, *stack[4:])
    counts = []
    for lane, x in enumerate(per_lane):
        jb = JP.init_state(n, d)
        jo = jb._replace(read_set=jnp.asarray(x[0]), write_set=jnp.asarray(x[1]))
        jn = jb._replace(read_set=jnp.asarray(x[2]), write_set=jnp.asarray(x[3]))
        want = JP.dirty_slots(jo, jn, *(jnp.asarray(a) for a in x[4:]))
        np.testing.assert_array_equal(dirty[lane].numpy(), np.asarray(want))
        counts.append(int(np.asarray(want).sum()))
    assert min(counts) < max(counts) and max(counts) > 4
    for k in (1, 4, n, n + 5):
        slab, valid, cnt = TP.dirty_slab(dirty, k)
        assert slab.dtype == torch.int32 and cnt.dtype == torch.int32
        for lane in range(lanes):
            want = JP.dirty_slab(jnp.asarray(dirty[lane].numpy()), k)
            for g, w in zip((slab, valid, cnt), want):
                np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w))


@pytest.mark.parametrize("n,k", [(14, 4), (14, 14), (33, 8)])
def test_scatter_relations_matches(n, k):
    rng = np.random.default_rng(n * k)
    lanes = 3
    mats = rng.random((4, lanes, n, n)) < 0.3
    rows = rng.random((4, lanes, k, n)) < 0.5
    slabs, valids = zip(*(_slab(rng, n, k, v)
                          for v in (0, k // 2, k)[:lanes]))
    got = TP.scatter_relations(
        TP.Relations(*(torch.from_numpy(m) for m in mats)),
        *(torch.from_numpy(r) for r in rows),
        torch.from_numpy(np.stack(slabs)), torch.from_numpy(np.stack(valids)))
    for lane in range(lanes):
        want = JP.scatter_relations(
            JP.Relations(*(jnp.asarray(m[lane]) for m in mats)),
            *(jnp.asarray(r[lane]) for r in rows),
            jnp.asarray(slabs[lane]), jnp.asarray(valids[lane]))
        for name, g, w in zip(TP.Relations._fields, got, want):
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w),
                                          err_msg=f"{name} lane {lane}")


# --------------------------------------------------------------------------
# the plain row slab against the oracle and the Pallas kernel
# --------------------------------------------------------------------------

def _rowslab_inputs(rng, n, d, k, n_valid):
    """One lane's row-slab inputs in the reference's dtypes: a protocol
    state's words and flags, carried tables from an older cursor (stale
    for the slab rows, as in the engine), the new cursor and a slab."""
    s = JP.init_state(n, d)._replace(
        read_set=jnp.asarray(_words(rng, n, d, min(0.4, 8 / d))),
        write_set=jnp.asarray(_words(rng, n, d, min(0.3, 4 / d))),
        active=jnp.asarray(rng.random(n) < 0.8))
    old_item = jnp.asarray(rng.integers(0, d, n), jnp.int32)
    old_w = jnp.asarray(rng.random(n) < 0.4)
    rel = JP.compute_relations(s, old_item, old_w)
    item = np.where(rng.random(n) < 0.5, rng.integers(0, d, n),
                    np.asarray(old_item)).astype(np.int32)
    is_w = rng.random(n) < 0.4
    slab, valid = _slab(rng, n, k, n_valid)
    return tuple(jnp.asarray(a) for a in (
        s.read_set, s.write_set, rel.writers_at, rel.readers_at, item, is_w,
        s.active, slab, valid))


@pytest.mark.parametrize("n,k", [(14, 1), (14, 4), (14, 14), (33, 1),
                                 (33, 4), (33, 33)])
def test_rowslab_ref_matches_oracle_and_pallas(n, k):
    rng = np.random.default_rng(n * 31 + k)
    d = 100
    # lane 0: a full slab (its last id may be n-1), lane 1: all invalid,
    # lane 2: part valid
    per_lane = [_rowslab_inputs(rng, n, d, k, v)
                for v in (k, 0, max(1, k // 2))]
    args = tuple(torch.stack([_t(a[i]) for a in per_lane])
                 for i in range(9))
    got = ref.rowslab_ref(*args)
    for lane, a in enumerate(per_lane):
        want = JREF.rowslab_ref(*a)
        pallas = JMS.rowslab(*a, block=8, interpret=True)
        for g, w, p, name in zip(got, want, pallas, ROWS):
            assert g.dtype == torch.bool and g.shape == (3, k, n)
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w),
                                          err_msg=f"{name} vs oracle")
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(p),
                                          err_msg=f"{name} vs Pallas")
    assert not any(g[1].any() for g in got)          # all-invalid slab
    assert got[0][0].any()
    ops.reset_launches()
    assert all(torch.equal(a, b) for a, b in
               zip(ops.rowslab_relations(*args), got))
    assert ops.launch_counts()["rowslab"] == 0


# --------------------------------------------------------------------------
# the delta fleet against the JAX fleet
# --------------------------------------------------------------------------

def _params(mod):
    return mod.SimParams(db_size=100, txn_size_mean=8, write_prob=0.3,
                         mpl=14, horizon=1_500.0, seed=5)


SEEDS, MPLS = (2, 3), (14, 9)
# (n_slots, delta_k): K = 0 picks bucket(n // 4, 8) = 8, two slabs; K = 4
# at n = 14 is four slabs, the last one reaching past n
FLEET_CASES = [(16, 0), (14, 4)]


@pytest.fixture(scope="module")
def port_plain():
    """The port's delta-off fleets, one per slot count."""
    out = {}
    for n_slots in {n for n, _ in FLEET_CASES}:
        init, cond, step = E.engine_parts(_params(TT), "ppcc",
                                          n_slots=n_slots, pool=256,
                                          device="cpu")
        s = init(torch.tensor(SEEDS), torch.tensor(MPLS))
        out[n_slots] = TS.run_while(cond, step, s)[0]
    return out


def _leaves(state):
    for name in state._fields:
        val = getattr(state, name)
        if isinstance(val, tuple):
            for f in val._fields:
                yield f"{name}.{f}", getattr(val, f)
        else:
            yield name, val


@pytest.mark.parametrize("n_slots,delta_k", FLEET_CASES)
def test_delta_fleet_matches_reference(port_plain, n_slots, delta_k):
    init, cond, step = jaxsim.engine_parts(
        _params(JT), "ppcc", n_slots=n_slots, fleet=True, pool=256,
        delta=True, delta_k=delta_k)
    run = jax.jit(jax.vmap(lambda sd, mp: jax.lax.while_loop(
        cond, step, init(sd, mp))))
    want = jax.tree.map(np.asarray, run(jnp.asarray(SEEDS, jnp.int32),
                                        jnp.asarray(MPLS, jnp.int32)))
    tinit, tcond, tstep = E.engine_parts(
        _params(TT), "ppcc", n_slots=n_slots, pool=256, delta=True,
        delta_k=delta_k, device="cpu")
    assert tstep.cfg.delta and tstep.cfg.delta_k == (delta_k or 8)
    got, _ = TS.run_while(tcond, tstep, tinit(torch.tensor(SEEDS),
                                              torch.tensor(MPLS)))
    assert got.rel.dep.shape == (2, n_slots, n_slots)
    mine = E.state_to_numpy(got)
    assert [k for k, _ in _leaves(mine)] == [k for k, _ in _leaves(want)]
    for (name, a), (_, b) in zip(_leaves(mine), _leaves(want)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(
            a.view(np.uint8) if a.dtype.kind == "f" else a,
            b.view(np.uint8) if b.dtype.kind == "f" else b, err_msg=name)
    assert (want.commits > 0).all()
    off = E.state_to_numpy(port_plain[n_slots])
    for (name, a), (_, b) in zip(_leaves(mine), _leaves(off)):
        if not name.startswith("rel."):
            np.testing.assert_array_equal(a, b, err_msg=f"off: {name}")


def test_rel_equals_full_recompute_after_every_step(monkeypatch):
    """After every step the carried ``rel`` equals ``compute_relations``
    of the state and its op cursor; with K = 4 at n = 14 the dirty sets
    need several slabs per step (later slabs hold valid slots)."""
    chunks = -(-14 // 4)
    seen = []
    plain = ref.rowslab_ref

    def spy(*args):
        seen.append(int(args[-1].sum(1).max()))
        return plain(*args)

    monkeypatch.setattr(ref, "rowslab_ref", spy)
    init, cond, step = E.engine_parts(_params(TT), "ppcc", n_slots=14,
                                      pool=256, delta=True, delta_k=4,
                                      device="cpu")
    s = init(torch.tensor(SEEDS), torch.tensor(MPLS))
    steps = 0
    while bool(cond(s).any()) and steps < 400:
        s = TS._select(cond(s), step(s), s)
        steps += 1
        c = E._classify(step.cfg, s)
        want = TP.compute_relations(s.pstate, c.cur_item, c.cur_w)
        for name, g, w in zip(TP.Relations._fields, s.rel, want):
            assert torch.equal(g, w), (name, steps)
    assert steps > 100 and bool((s.commits > 0).all())
    assert len(seen) == steps * chunks
    # some step drained up to 9 dirty slots: three slabs
    assert max(seen[1::chunks]) > 0 and max(seen[2::chunks]) > 0


# --------------------------------------------------------------------------
# the drain behind one function: rowslab_drain_ref
# --------------------------------------------------------------------------

class _JaxState(NamedTuple):
    """The two ``EngState`` leaves ``jaxsim._delta_update`` reads."""
    pstate: JP.PPCCState
    rel: JP.Relations


def test_rowslab_drain_ref_matches_reference_delta_update(monkeypatch):
    """The engine's drain (the plain version at K = 4 on the CPU) against
    the reference's ``jaxsim._delta_update`` on the same inputs, lane by
    lane, over the first steps of the delta fleet at n = 14."""
    calls = []
    real = E._delta_update

    def spy(cfg, s, ps5, *rest):
        out = real(cfg, s, ps5, *rest)
        calls.append((s.pstate, s.rel, ps5, rest, out))
        return out

    monkeypatch.setattr(E, "_delta_update", spy)
    init, cond, step = E.engine_parts(_params(TT), "ppcc", n_slots=14,
                                      pool=256, delta=True, delta_k=4,
                                      device="cpu")
    s = init(torch.tensor(SEEDS), torch.tensor(MPLS))
    for _ in range(40):
        s = TS._select(cond(s), step(s), s)
    jcfg = dataclasses.replace(
        jaxsim._cfg(_params(JT), 400_000), protocol="ppcc", n=14,
        fleet=True, megakernel=False, delta=True, delta_k=4)
    drain = jax.jit(lambda st, ps5, *rest: jaxsim._delta_update(
        jcfg, st, ps5, *rest))

    def words(t, lane):
        return jnp.asarray(t[lane].numpy().view(np.uint32))

    def pstate(ps, lane):
        return JP.PPCCState(*(words(x, lane) if x.dtype == torch.int32
                              else jnp.asarray(x[lane].numpy())
                              for x in ps))

    most = 0
    for old, rel, ps5, rest, got in calls[::3]:
        for lane in range(len(SEEDS)):
            st = _JaxState(pstate(old, lane), JP.Relations(
                *(jnp.asarray(t[lane].numpy()) for t in rel)))
            want = drain(st, pstate(ps5, lane),
                         *(jnp.asarray(x[lane].numpy()) for x in rest))
            for name, g, w in zip(TP.Relations._fields, got, want):
                np.testing.assert_array_equal(g[lane].numpy(),
                                              np.asarray(w), err_msg=name)
        most = max(most, int((got.dep != rel.dep).any(2).sum(1).max()))
    assert len(calls) == 40 and most > 4     # some step needed two slabs


def _closed_form(read, write, dep, ww, wat, rat, item, is_write, active,
                 dirty):
    """Every dirty slot fresh at once: dep/ww entries recomputed where the
    row or the column slot is dirty, op-table rows where the row is."""
    n = dirty.shape[1]
    eye = torch.eye(n, dtype=torch.bool)
    wat_f, rat_f = (ref._item_table(b, item) for b in (write, read))
    d3 = dirty[:, :, None]
    wat2 = torch.where(d3, wat_f, wat)
    rat2 = torch.where(d3, rat_f, rat)
    others = torch.where(is_write[:, :, None], rat2, wat2)
    party = (others & active[:, None, :] & ~eye) | eye
    dep_f = (party[:, :, None, :] & party[:, None, :, :]).any(-1)
    same = (item[:, :, None] == item[:, None, :]) & \
        (is_write[:, :, None] | is_write[:, None, :])
    dep_f = (dep_f | same) & ~eye
    ww_f = ((write[:, :, None, :] & write[:, None, :, :]) != 0).any(-1) & ~eye
    fresh = d3 | dirty[:, None, :]
    return (torch.where(fresh, dep_f, dep), torch.where(fresh, ww_f, ww),
            wat2, rat2)


@pytest.mark.parametrize("n,d", [(14, 100), (33, 100)])
def test_rowslab_drain_ref_is_slab_free_and_closed_form(n, d):
    """On random tables that are not a full recompute's (so stale entries
    show), with lanes of no dirty slot, one, all n and random masks: the
    drain gives the same tables at every slab size K, equal to the closed
    form the drain kernel computes, and leaves its inputs unchanged."""
    gen = torch.Generator().manual_seed(n * d)
    lanes = 4
    words = [_t(_words(np.random.default_rng(n + i), lanes * n, d, p))
             .view(lanes, n, -1) for i, p in enumerate((0.05, 0.03))]
    tables = [torch.rand((lanes, n, n), generator=gen) < 0.3
              for _ in range(4)]
    item = torch.randint(0, d, (lanes, n), generator=gen, dtype=torch.int32)
    is_w, active = (torch.rand((lanes, n), generator=gen) < q
                    for q in (0.4, 0.8))
    dirty = torch.rand((lanes, n), generator=gen) < 0.3
    dirty[0] = False
    dirty[1] = False
    dirty[1, n // 2] = True
    dirty[2] = True
    args = (*words, *tables, item, is_w, active, dirty)
    before = [a.clone() for a in args]
    want = _closed_form(*args)
    for k in (1, 4, n, 0):
        got = ref.rowslab_drain_ref(*args, k=k)
        for name, g, w in zip(TP.Relations._fields, got, want):
            assert g.dtype == torch.bool and g.is_contiguous()
            assert torch.equal(g, w), (name, k)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    for g, t in zip(want, tables):
        assert torch.equal(g[0], t[0])             # no dirty slot: a copy
    assert not torch.equal(want[0][1], tables[0][1])
    ops.reset_launches()
    assert all(torch.equal(a, b) for a, b in
               zip(ops.rowslab_drain(*args, k=4), want))
    assert ops.launch_counts()["rowslab_drain"] == 0
