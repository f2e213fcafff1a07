"""The port's scalar protocol steps, cohort calls and batch admission
(``repro_torch.core.ppcc``) against ``repro.core.ppcc``, on the CPU.

States are built by the reference itself (``begin``, random ``try_op``s,
a round of ``wc_acquire_many``), stacked as lanes of one port state, and
each lane of every port result is held to the reference's call on that
lane's state: verdicts and every state leaf, bit for bit.  Admission runs
at the reference tests' shapes (n = 16, d = 40, m = 100) with ties, edge
lists and invalid ops out of range, and once at the ``sched_admit`` shape
(n = 256, d = 1,024, m = 512)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ppcc as JP  # noqa: E402
from repro_torch.core import ppcc as TP  # noqa: E402

I = jnp.int32
N, D, LANES = 16, 40, 3
# the reference's admission calls, compiled once per shape
J_ADMIT = jax.jit(JP.admit_ops)
J_ORDER = jax.jit(JP.admit_order_degree)
J_BLOCKED = jax.jit(JP.admit_ops_blocked, static_argnames=("block", "order"))


def _warmed(rng, n=N, d=D, ops=40):
    s = JP.init_state(n, d)
    for i in range(n):
        s = JP.begin(s, I(i))
    for _ in range(ops):
        s, _ = JP.try_op(s, I(rng.integers(0, n)), I(rng.integers(0, d)),
                         jnp.bool_(rng.random() < 0.4))
    s, _ = JP.wc_acquire_many(s, jnp.array(rng.random(n) < 0.3), exact=False)
    # a few slots have left: inactive rows among the active ones
    for i in rng.choice(n, 2, replace=False):
        s = JP.commit(s, I(int(i)))
    return s


def _lanes(states):
    """The reference states as one port state, a lane each."""
    tree = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *states)
    return TP.state_from_numpy(tree, "cpu")


def _assert_lane(port: TP.PPCCState, lane: int, ref, tag=""):
    got = TP.state_to_numpy(port)
    for f in TP.PPCCState._fields:
        np.testing.assert_array_equal(getattr(got, f)[lane],
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{tag} {f}")


def _eq(a: torch.Tensor, b, tag=""):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=tag)


@pytest.fixture(scope="module", params=range(3))
def states(request):
    rng = np.random.default_rng(request.param)
    refs = [_warmed(rng) for _ in range(LANES)]
    return rng, refs, _lanes(refs)


def test_state_round_trip(states):
    _, refs, port = states
    for lane, ref in enumerate(refs):
        _assert_lane(port, lane, ref)
    lone = TP.state_from_numpy(jax.tree.map(np.asarray, refs[0]), "cpu")
    assert lone.lanes == 1
    _assert_lane(lone, 0, refs[0])


def test_scalar_steps_match(states):
    """``_lock_verdict``, ``try_read``, ``try_write``, ``try_op``,
    ``wc_acquire_locks``, ``can_commit``, ``commit``, ``abort`` and
    ``begin`` at random (slot, item) pairs, one per lane."""
    rng, refs, port = states
    for _ in range(6):
        i = rng.integers(0, N, LANES).astype(np.int32)
        x = rng.integers(0, D, LANES).astype(np.int32)
        w = rng.random(LANES) < 0.5
        ti, tx, tw = (torch.from_numpy(a) for a in (i, x, w))
        lv = TP._lock_verdict(port, ti, tx)
        outs = {"try_read": TP.try_read(port, ti, tx),
                "try_write": TP.try_write(port, ti, tx),
                "try_op": TP.try_op(port, ti, tx, tw)}
        wc_s, got = TP.wc_acquire_locks(port, ti)
        can = TP.can_commit(port, ti)
        left = {"commit": TP.commit(port, ti), "abort": TP.abort(port, ti),
                "begin": TP.begin(port, ti)}
        for lane, ref in enumerate(refs):
            ri, rx = I(i[lane]), I(x[lane])
            assert int(lv[lane]) == int(JP._lock_verdict(ref, ri, rx))
            want = {"try_read": JP.try_read(ref, ri, rx),
                    "try_write": JP.try_write(ref, ri, rx),
                    "try_op": JP.try_op(ref, ri, rx, jnp.bool_(w[lane]))}
            for name, (s2, v) in outs.items():
                ws, wv = want[name]
                assert int(v[lane]) == int(wv), name
                _assert_lane(s2, lane, ws, name)
            rs, rgot = JP.wc_acquire_locks(ref, ri)
            assert bool(got[lane]) == bool(rgot)
            _assert_lane(wc_s, lane, rs, "wc_acquire_locks")
            assert bool(can[lane]) == bool(JP.can_commit(ref, ri))
            for name, fn in (("commit", JP.commit), ("abort", JP.abort),
                             ("begin", JP.begin)):
                _assert_lane(left[name], lane, fn(ref, ri), name)


def test_cohort_calls_match(states):
    """``op_parties``, ``cohort_select``, ``try_ops_batched`` and
    ``cohort_step`` on random pending ops; items repeat (ties)."""
    rng, refs, port = states
    item = rng.integers(0, D // 4, (LANES, N)).astype(np.int32)
    is_w = rng.random((LANES, N)) < 0.4
    ready = rng.random((LANES, N)) < 0.7
    t_item, t_w, t_ready = (torch.from_numpy(a) for a in (item, is_w, ready))
    party = TP.op_parties(port, t_item, t_w)
    sel = TP.cohort_select(port, t_item, t_w, t_ready)
    sb, vb = TP.try_ops_batched(port, t_item, t_w, sel)
    sc, vc, selc, reason = TP.cohort_step(port, t_item, t_w, t_ready)
    for lane, ref in enumerate(refs):
        ji, jw, jr = (jnp.asarray(a[lane]) for a in (item, is_w, ready))
        _eq(party[lane], JP.op_parties(ref, ji, jw), "op_parties")
        js = JP.cohort_select(ref, ji, jw, jr)
        _eq(sel[lane], js, "cohort_select")
        rs, rv = JP.try_ops_batched(ref, ji, jw, js)
        _eq(vb[lane], rv, "try_ops_batched")
        _assert_lane(sb, lane, rs, "try_ops_batched")
        rs, rv, rsel, rreason = JP.cohort_step(ref, ji, jw, jr)
        _eq(vc[lane], rv)
        _eq(selc[lane], rsel)
        _eq(reason[lane], rreason)
        _assert_lane(sc, lane, rs, "cohort_step")


@pytest.mark.parametrize("exact", [True, False])
def test_wc_acquire_many_matches(states, exact):
    rng, refs, port = states
    mask = rng.random((LANES, N)) < 0.6
    s2, won = TP.wc_acquire_many(port, torch.from_numpy(mask), exact=exact)
    for lane, ref in enumerate(refs):
        rs, rwon = JP.wc_acquire_many(ref, jnp.asarray(mask[lane]),
                                      exact=exact)
        _eq(won[lane], rwon)
        _assert_lane(s2, lane, rs, f"exact={exact}")


# --------------------------------------------------------------------------
# batch admission
# --------------------------------------------------------------------------

def _op_lists(rng, kind, lanes, n, d, m):
    """[L, m] op lists: random, or an edge list.  Invalid ops carry txn
    and item values out of range, which must change nothing."""
    txn = rng.integers(0, n, (lanes, m))
    item = rng.integers(0, d, (lanes, m))
    wr = rng.random((lanes, m)) < 0.3
    valid = rng.random((lanes, m)) < 0.9
    if kind == "one txn":
        txn[:] = rng.integers(0, n)
    elif kind == "one item":
        item[:] = rng.integers(0, d)
    elif kind == "writes only":
        wr[:] = True
    elif kind == "reads only":
        wr[:] = False
    elif kind == "all invalid":
        valid[:] = False
    txn = np.where(valid, txn, rng.choice([-3, n, n + 7], (lanes, m)))
    item = np.where(valid, item, rng.choice([-1, 32 * (-(-d // 32)), 10 ** 6],
                                            (lanes, m)))
    return (txn.astype(np.int32), item.astype(np.int32), wr, valid)


def _ref_admit(fn, ref, ops, lane, **kw):
    return fn(ref, *(jnp.asarray(a[lane]) for a in ops), **kw)


def _assert_verdict(got, lane, want, tag):
    for f in ("admitted", "blocked", "aborted"):
        _eq(getattr(got, f)[lane], getattr(want, f), f"{tag} {f}")
    _assert_lane(got.state, lane, want.state, tag)


@pytest.mark.parametrize("kind", ["random", "one txn", "one item",
                                  "writes only", "reads only",
                                  "all invalid"])
def test_admission_matches(states, kind):
    """``admit_ops``, ``admit_ops_blocked`` (index and degree order, with
    and without a block) and ``admit_order_degree``."""
    rng, refs, port = states
    m = 100
    ops = _op_lists(rng, kind, LANES, N, D, m)
    t_ops = tuple(torch.from_numpy(a) for a in ops)
    res = TP.admit_ops(port, *t_ops)
    perm = TP.admit_order_degree(port, *t_ops)
    blocked = {(order, block): TP.admit_ops_blocked(port, *t_ops,
                                                    block=block, order=order)
               for order, block in (("index", 16), ("degree", None))}
    for lane, ref in enumerate(refs):
        _assert_verdict(res, lane, _ref_admit(J_ADMIT, ref, ops, lane),
                        "admit_ops")
        _eq(perm[lane], _ref_admit(J_ORDER, ref, ops, lane),
            "admit_order_degree")
        for (order, block), got in blocked.items():
            want = _ref_admit(J_BLOCKED, ref, ops, lane, block=block,
                              order=order)
            _assert_verdict(got, lane, want, f"blocked {order} {block}")
    assert perm.dtype == torch.int32
    if kind == "all invalid":
        assert not (res.admitted | res.blocked | res.aborted).any()
        for a, b in zip(res.state, port):
            assert torch.equal(a, b)
    if kind == "random":
        assert res.admitted.any() and res.blocked.any()


def test_admission_at_the_sched_admit_shape():
    """n = 256, d = 1,024, m = 512 (the reference's ``sched_admit``
    benchmark shape), from every slot begun and a first batch admitted."""
    rng = np.random.default_rng(7)
    n, d, m = 256, 1024, 512
    s = JP.init_state(n, d)
    s = JP.begin_many(s, jnp.ones(n, bool))
    first = _op_lists(rng, "random", 1, n, d, m)
    s = JP.admit_ops(s, *(jnp.asarray(a[0]) for a in first)).state
    s, _ = JP.wc_acquire_many(s, jnp.array(rng.random(n) < 0.25),
                              exact=False)
    port = _lanes([s])
    ops = _op_lists(rng, "random", 1, n, d, m)
    t_ops = tuple(torch.from_numpy(a) for a in ops)
    _assert_verdict(TP.admit_ops(port, *t_ops), 0,
                    _ref_admit(J_ADMIT, s, ops, 0), "admit_ops")
    got = TP.admit_ops_blocked(port, *t_ops, order="degree")
    _assert_verdict(got, 0, _ref_admit(J_BLOCKED, s, ops, 0, block=None,
                                       order="degree"), "degree")


@pytest.mark.parametrize("n,d,kind", [(1, 32, "random"), (31, 33, "random"),
                                      (33, 31, "random"), (65, 32, "random"),
                                      (33, 32, "dense"),
                                      (33, 32, "all locked")])
def test_admission_at_the_word_edges(n, d, kind):
    """``admit_ops`` (the plain loop, the card's oracle) at the word edges
    of the kernel's packed state: n = 1, 31, 33, 65 slots, d = 31, 32, 33
    items, a state dense in arcs and class bits, every slot locked."""
    rng = np.random.default_rng(n * 100 + d)
    m = 40
    s = JP.begin_many(JP.init_state(n, d), jnp.ones(n, bool))
    first = _op_lists(rng, "random", 1, n, d, m)
    s = J_ADMIT(s, *(jnp.asarray(a[0]) for a in first)).state
    s = s._replace(haslocks=jnp.asarray(rng.random(n) < 0.25))
    if kind == "dense":
        dense = (rng.random((n, n)) < 0.5) & ~np.eye(n, dtype=bool)
        s = s._replace(
            prec=jnp.asarray(dense),
            preceding=jnp.asarray(rng.random(n) < 0.5),
            preceded=jnp.asarray(rng.random(n) < 0.5))
    elif kind == "all locked":
        s = s._replace(haslocks=jnp.ones(n, bool))
    ops = _op_lists(rng, "random", 1, n, d, m)
    got = TP.admit_ops(_lanes([s]), *(torch.from_numpy(a) for a in ops))
    _assert_verdict(got, 0, _ref_admit(J_ADMIT, s, ops, 0), "admit_ops")


def test_empty_op_list():
    rng = np.random.default_rng(1)
    port = _lanes([_warmed(rng), _warmed(rng)])
    empty = (torch.zeros((2, 0), dtype=torch.int32),) * 2 + \
        (torch.zeros((2, 0), dtype=torch.bool),) * 2
    res = TP.admit_ops(port, *empty)
    assert res.admitted.shape == (2, 0)
    for a, b in zip(res.state, port):
        assert torch.equal(a, b)
    assert TP.admit_order_degree(port, *empty).shape == (2, 0)


def test_default_admit_block_matches():
    for n in list(range(0, 300)) + [1000, 4096, 65_536, 262_144]:
        assert TP.default_admit_block(n) == JP.default_admit_block(n), n


@pytest.mark.parametrize("field,value", [("txn", N), ("txn", -1),
                                         ("item", 64), ("item", -2)])
def test_valid_op_out_of_range_raises(states, field, value):
    """The reference clamps or drops a valid op out of range; the port
    raises (``[0, n)`` for txn, ``[0, 32 W)`` for item, W = 2 here)."""
    rng, _, port = states
    ops = dict(zip(("txn", "item", "is_write", "valid"),
                   (torch.from_numpy(a) for a in
                    _op_lists(rng, "random", LANES, N, D, 10))))
    ops["valid"][1, 3] = True
    ops[field][1, 3] = value
    for fn in (TP.admit_ops, TP.admit_order_degree, TP.admit_ops_blocked):
        with pytest.raises(ValueError):
            fn(port, *ops.values())


def test_admit_ops_blocked_rejects_bad_arguments(states):
    rng, _, port = states
    ops = tuple(torch.from_numpy(a)
                for a in _op_lists(rng, "random", LANES, N, D, 10))
    for block in (0, -4, 2.5):
        with pytest.raises(ValueError):
            TP.admit_ops_blocked(port, *ops, block=block)
    with pytest.raises(ValueError):
        TP.admit_ops_blocked(port, *ops, order="random")
    with pytest.raises(ValueError):
        TP.admit_ops(port, *(a[:1] for a in ops))
