"""The port's protocol core (``repro_torch.core.ppcc``) against
``repro.core.ppcc`` on reachable states: protocol states taken from a
short run of the JAX reference engine, each with the cohort its next
iteration would process.  Exact equality on every leaf."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import jaxsim  # noqa: E402
from repro.core import ppcc as JP  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import ppcc as TP  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MPL, SLOTS, POOL = 24, 32, 256
CAPTURES, SPACING, MAX_STEPS = 5, 15, 400


def _params(mod):
    return mod.paper_figure_params(8).with_(mpl=MPL, horizon=5000.0)


@pytest.fixture(scope="module")
def reachable():
    """Reference engine states whose next cohort holds both read-phase
    and wait-to-commit slots, at least SPACING iterations apart, as one
    port state with a lane per capture, plus each capture's cohort."""
    init, cond, step = jaxsim.engine_parts(
        _params(JT), "ppcc", n_slots=SLOTS, fleet=True, pool=POOL)
    cfg = E.make_cfg(_params(TT), "ppcc", n_slots=SLOTS, pool=POOL,
                     device="cpu")
    s = init(4)
    trees, states, last = [], [], -SPACING
    for k in range(MAX_STEPS):
        s = step(s)
        tree = jax.tree.map(np.asarray, s)
        state = E.state_from_numpy(tree, "cpu")
        c = E._classify(cfg, state)
        if k - last >= SPACING and c.read_m.any() and c.wc_m.any():
            trees.append(tree)
            states.append(state)
            last = k
            if len(trees) == CAPTURES:
                break
    assert len(trees) == CAPTURES
    port = E.EngState(*(
        type(f0)(*(torch.cat(xs) for xs in zip(*fs)))
        if isinstance(f0, tuple) else torch.cat(fs)
        for f0, fs in ((fs[0], fs) for fs in zip(*states))))
    return trees, port, E._classify(cfg, port)


def _ref_pstate(ps: TP.PPCCState, lane) -> JP.PPCCState:
    """Lane ``lane`` of a port protocol state as a reference state."""
    return JP.PPCCState(
        read_set=jnp.asarray(ps.read_set[lane].numpy().view(np.uint32)),
        write_set=jnp.asarray(ps.write_set[lane].numpy().view(np.uint32)),
        prec=jnp.asarray(ps.prec[lane].numpy()),
        preceding=jnp.asarray(ps.preceding[lane].numpy()),
        preceded=jnp.asarray(ps.preceded[lane].numpy()),
        active=jnp.asarray(ps.active[lane].numpy()),
        haslocks=jnp.asarray(ps.haslocks[lane].numpy()))


def _assert_pstate(got: TP.PPCCState, lane, want: JP.PPCCState):
    for name in TP.PPCCState._fields:
        g = getattr(got, name)[lane].numpy()
        if name in ("read_set", "write_set"):
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                      err_msg=name)


def _cohort_lane(cohort, lane):
    return (jnp.asarray(cohort.cur_item[lane].numpy()),
            jnp.asarray(cohort.cur_w[lane].numpy()),
            jnp.asarray(cohort.read_m[lane].numpy()),
            jnp.asarray(cohort.wc_m[lane].numpy()))


def test_reachable_states_convert_exactly(reachable):
    trees, port, _ = reachable
    for lane, tree in enumerate(trees):
        back = E.state_to_numpy(port)
        np.testing.assert_array_equal(back.pstate.read_set[lane],
                                      tree.pstate.read_set)
        np.testing.assert_array_equal(back.key[lane], tree.key)
        _assert_pstate(port.pstate, lane, tree.pstate)


@pytest.mark.parametrize("order", ["index", "degree"])
@pytest.mark.parametrize("with_relations", [False, True])
def test_cohort_step_fused_matches(reachable, order, with_relations):
    trees, port, c = reachable
    ps = port.pstate
    rel = None
    if with_relations:
        rel = ops.megastep_relations(ps.read_set, ps.write_set, port.dirty,
                                     c.cur_item, c.cur_w, ps.active,
                                     c.read_m, ps.haslocks)
    got = TP.cohort_step_fused(ps, c.cur_item, c.cur_w, c.read_m, c.wc_m,
                               order=order, relations=rel)
    n_sel = 0
    for lane in range(len(trees)):
        jps = _ref_pstate(port.pstate, lane)
        item, isw, ready, wc = _cohort_lane(c, lane)
        jrel = None
        if with_relations:
            jrel = JREF.megastep_ref(jps.read_set, jps.write_set,
                                     jnp.asarray(trees[lane].dirty), item,
                                     isw, jps.active, ready,
                                     jps.haslocks)[:6]
        want = JP.cohort_step_fused(jps, item, isw, ready, wc, order=order,
                                    relations=jrel)
        _assert_pstate(got.state, lane, want.state)
        for name in ("verdict", "selected", "degree", "won", "can_commit",
                     "reason"):
            np.testing.assert_array_equal(
                getattr(got, name)[lane].numpy(),
                np.asarray(getattr(want, name)), err_msg=name)
        n_sel += int(np.asarray(want.selected).sum())
    assert n_sel > 0
    assert got.verdict.dtype == got.degree.dtype == torch.int32


def test_relations_and_inputs_match(reachable):
    trees, port, c = reachable
    ps = port.pstate
    rel = TP.compute_relations(ps, c.cur_item, c.cur_w)
    six = TP.relations_inputs(rel, c.read_m, ps.haslocks)
    for lane in range(len(trees)):
        jps = _ref_pstate(port.pstate, lane)
        item, isw, ready, _ = _cohort_lane(c, lane)
        jrel = JP.compute_relations(jps, item, isw)
        jsix = JP.relations_inputs(jrel, ready, jps.haslocks)
        for g, w in zip(six, jsix):
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w))


def test_begin_commit_abort_can_commit_match(reachable):
    trees, port, _ = reachable
    ps = port.pstate
    rng = np.random.default_rng(0)
    masks = [torch.from_numpy(rng.random(ps.active.shape) < p)
             for p in (0.3, 0.3, 0.2)]
    slot = torch.from_numpy(rng.integers(0, SLOTS, ps.lanes))
    got = {"begin_many": TP.begin_many(ps, masks[0]),
           "commit_many": TP.commit_many(ps, masks[1]),
           "abort_many": TP.abort_many(ps, masks[2]),
           "begin": TP.begin(ps, slot)}
    can = TP.can_commit_many(ps)
    for lane in range(len(trees)):
        jps = _ref_pstate(port.pstate, lane)
        m = [jnp.asarray(x[lane].numpy()) for x in masks]
        _assert_pstate(got["begin_many"], lane, JP.begin_many(jps, m[0]))
        _assert_pstate(got["commit_many"], lane, JP.commit_many(jps, m[1]))
        _assert_pstate(got["abort_many"], lane, JP.abort_many(jps, m[2]))
        _assert_pstate(got["begin"], lane,
                       JP.begin(jps, jnp.int32(int(slot[lane]))))
        np.testing.assert_array_equal(can[lane].numpy(),
                                      np.asarray(JP.can_commit_many(jps)))


def test_theorem1_checks_match_and_detect_violations(reachable):
    trees, port, _ = reachable
    ps = port.pstate
    # lane 0 as reached; lane 1 with a length-2 path a -> b -> c; lane 2
    # with a 2-cycle; lane 3 with an arc whose class bits are missing
    prec = ps.prec.clone()
    prec[1, 0, 1] = prec[1, 1, 2] = True
    prec[2, 3, 4] = prec[2, 4, 3] = True
    prec[3, 5, 6] = True
    preceding = ps.preceding.clone()
    preceding[3, 5] = False
    bent = ps._replace(prec=prec, preceding=preceding)
    checks = (("path_length_leq_one", TP.path_length_leq_one,
               JP.path_length_leq_one), ("acyclic", TP.acyclic, JP.acyclic),
              ("classes_consistent", TP.classes_consistent,
               JP.classes_consistent))
    for name, tfn, jfn in checks:
        for state in (ps, bent):
            got = tfn(state)
            for lane in range(len(trees)):
                want = bool(jfn(_ref_pstate(state, lane)))
                assert bool(got[lane]) == want, (name, lane)
    assert bool(TP.acyclic(ps).all()) and \
        bool(TP.classes_consistent(ps).all())
    assert not bool(TP.path_length_leq_one(bent)[1])
    assert not bool(TP.acyclic(bent)[2])
    assert not bool(TP.classes_consistent(bent)[3])
