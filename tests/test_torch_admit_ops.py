"""The packed design of ``csrc/admit_ops.cu`` on the CPU (no ``nvcc``, no
card): the wrapper's routes and shared-memory sizing in plain Python, and
a numpy twin of the kernel's packing and walk held bit for bit to
``kernels.ref.admit_ops_ref``.

The twin does what the kernel does, word for word: the 32 x 32 bit
transpose as the five ``__shfl_xor_sync`` stages of ``transpose32`` over
32 simulated lanes, prec packed to bit rows ``P`` by gathering 32 bytes a
word and to bit columns ``PT`` by transposing ``P``, the sets transposed to
item-major columns ``R`` and ``WC``, rows ``stride(route, n)`` words apart
(padding included), then each step's five predicates as word operations,
one OR over the words, and the apply (the column bit, the new arcs in both
orientations, the class words).  It runs at the word edges (n = 1, 31, 32,
33, 65; items 31, 32, 33), dense arcs and class bits, every slot locked,
runs of ops on one txn and on one item, and pairs of ops where the second
reads what the first writes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ppcc as TP  # noqa: E402
from repro_torch.kernels import admit_ops as kao  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

U32 = np.uint32
LANE = np.arange(32)
SHIFT = LANE.astype(np.uint64)


# --- routes and shared memory -------------------------------------------

@pytest.mark.parametrize("route", kao.ROUTES)
def test_each_routes_largest_size_fits(route):
    """The largest size each route is given fits in a block's 227 KB: the
    shared route at its switch for every W it takes, the global route at
    the largest n the wrapper takes."""
    if route == kao.SHARED:
        for w in (1, 2, 3, 8, 32, 33, 100, 400, 800):
            n = kao.shared_max_n(w)
            assert n >= 1
            assert kao.smem_bytes(route, n, w) <= kao.SMEM_LIMIT
            assert kao.smem_bytes(route, n + 1, w) > kao.SMEM_LIMIT
        assert kao.shared_max_n(1024) == 0
    else:
        assert kao.smem_bytes(route, kao.MAX_N, 1024) <= kao.SMEM_LIMIT
        assert kao.smem_bytes(route, kao.MAX_N + 32, 1) > kao.SMEM_LIMIT


@pytest.mark.parametrize("w,switch", [(1, 928), (3, 903), (32, 544),
                                      (33, 544), (64, 352), (400, 32)])
def test_shared_route_switch(w, switch):
    """The switch falls where ``route`` says, on both sides of it; both
    shapes of the smoke land where the design puts them."""
    assert kao.shared_max_n(w) == switch
    assert kao.route(switch, w) == kao.SHARED
    assert kao.route(switch + 1, w) == kao.GLOBAL


@pytest.mark.parametrize("n,w,want", [(256, 32, kao.SHARED),
                                      (4096, 1024, kao.GLOBAL),
                                      (32_769, 4, kao.GLOBAL),
                                      (1, 1, kao.SHARED)])
def test_route_at_the_smokes_shapes(n, w, want):
    assert kao.route(n, w) == want
    assert kao.smem_bytes(want, n, w) <= kao.SMEM_LIMIT


@pytest.mark.parametrize("route,n,s", [(kao.SHARED, 1, 1), (kao.SHARED, 64, 3),
                                       (kao.SHARED, 256, 9),
                                       (kao.GLOBAL, 33, 4),
                                       (kao.GLOBAL, 4096, 128),
                                       (kao.GLOBAL, 32_769, 1028)])
def test_stride_and_scratch(route, n, s):
    assert kao.stride(route, n) == s
    want = 0 if route == kao.SHARED else 3 * (2 * n + 64 * 5) * s
    assert kao.scratch_words(route, 3, n, 5) == want


def test_wrapper_refuses_cpu_tensors_before_building():
    s = TP.begin_many(TP.init_state(1, 8, 40, device="cpu"),
                      torch.ones((1, 8), dtype=torch.bool))
    z = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kao.admit_ops(*s, z, z, z.bool(), z.bool())


# --- the twin ------------------------------------------------------------

def transpose32(v):
    """``transpose32``: row i of ``v`` (uint32[32], one per lane) in,
    column b out at index b, by the kernel's five shuffle stages."""
    v = v.astype(U32).copy()
    m = U32(0x0000FFFF)
    j = 16
    while j:
        p = v[LANE ^ j]
        hi = (LANE & j) != 0
        v = np.where(hi, (v & ~m) | ((p >> U32(j)) & m),
                     (v & m) | ((p << U32(j)) & ~m)).astype(U32)
        j >>= 1
        m = U32(m ^ (m << U32(j))) if j else m
    return v


def pack_rows(prec, n, s):
    """``pack_rows``: ``P[t * S + g]`` bit i = ``prec[t, 32 g + i]``."""
    nw = kao.words(n)
    p = np.zeros(n * s, U32)
    for t in range(n):
        for g in range(nw):
            k = 32 * g + LANE
            bits = np.where(k < n, prec[t, np.minimum(k, n - 1)], False)
            p[t * s + g] = U32(np.sum(bits.astype(np.uint64) << SHIFT))
    return p


def transpose_blocks(a, rows, cw, astride, orows, s, out_len):
    """``transpose_blocks``: ``B[(32 c + b) * S + G]`` bit i = bit b of
    ``A[(32 G + i) * astride + c]``."""
    out = np.zeros(out_len, U32)
    for big in range(kao.words(rows)):
        for c in range(cw):
            r = 32 * big + LANE
            v = np.where(r < rows, a[np.minimum(r, rows - 1) * astride + c],
                         0).astype(U32)
            col = transpose32(v)
            o = 32 * c + LANE
            keep = o < orows
            out[o[keep] * s + big] = col[keep]
    return out


def flag_words(f, n):
    nw = kao.words(n)
    pad = np.zeros(32 * nw, bool)
    pad[:n] = f
    return (pad.reshape(nw, 32).astype(np.uint64) << SHIFT).sum(1).astype(U32)


def twin(route, state, txn, item, is_write, valid):
    """One lane of the kernel on numpy arrays: verdicts and the new
    state."""
    rs, ws, prec, pg, pd, ac, hl = (np.array(x) for x in state)
    n, w = rs.shape
    nw, s, items = kao.words(n), kao.stride(route, n), 32 * w
    P = pack_rows(prec, n, s)
    PT = transpose_blocks(P, n, nw, s, n, s, n * s)
    R = transpose_blocks(rs.view(U32).ravel(), n, w, w, items, s, items * s)
    WC = transpose_blocks(ws.view(U32).ravel(), n, w, w, items, s, items * s)
    HL, AC, PG, PD = (flag_words(f, n) for f in (hl, ac, pg, pd))
    idx = np.arange(nw)
    m = len(txn)
    verdict = np.full(m, -1)
    def words(t, x):
        return [a[o * s + idx].copy() for a, o in
                ((WC, x), (R, x), (P, t), (PT, t))]

    ok = [j for j in range(m) if valid[j] and 0 <= int(txn[j]) < n
          and 0 <= int(item[j]) < items]
    for j in ok:
        t, x, wr = int(txn[j]), int(item[j]), bool(is_write[j])
        wc, rc, pr, pc = words(t, x)
        tw, tb = t >> 5, U32(1 << (t & 31))
        me = np.where(idx == tw, tb, U32(0)).astype(U32)
        own = wc & HL
        if wr:
            nb = rc & AC & ~me & ~pc
            violate, self_ = (nb & PD).any(), (me & PG).any()
        else:
            nb = wc & AC & ~me & ~pr
            violate, self_ = (nb & PG).any(), (me & PD).any()
        arcs = nb.any()
        lock_v = (2 if (own & pr).any() else 1) if (own & ~me).any() else 0
        allowed = lock_v == 0 and (not arcs or not (violate or self_))
        verdict[j] = lock_v if lock_v else (0 if allowed else 1)
        if allowed:
            (WC if wr else R)[x * s + tw] |= tb
            (ws if wr else rs).view(U32)[t, x >> 5] |= U32(1 << (x & 31))
        if allowed and arcs:
            (PD if wr else PG)[:] |= me
            (PT if wr else P)[t * s + idx] |= nb
            (PG if wr else PD)[:] |= nb
            for i in np.nonzero(nb)[0]:
                for b in range(32):
                    if int(nb[i]) >> b & 1:
                        k = 32 * int(i) + b
                        (P if wr else PT)[k * s + tw] |= tb
                        if wr:
                            prec[k, t] = True
                        else:
                            prec[t, k] = True
    k = np.arange(n)
    unpack = [((F[k >> 5] >> (k & 31).astype(U32)) & U32(1)).astype(bool)
              for F in (PG, PD)]
    return (verdict == 0, verdict == 1, verdict == 2, rs, ws, prec,
            *unpack, ac, hl)


def _state(gen, kind, n, d, m):
    """A reachable state of one lane (every slot begun, a first batch
    admitted by the plain loop, a quarter of the slots locked) and an op
    list, or an edge of either."""
    def op_list():
        return [torch.randint(0, n, (1, m), generator=gen,
                              dtype=torch.int32),
                torch.randint(0, d, (1, m), generator=gen,
                              dtype=torch.int32),
                torch.rand((1, m), generator=gen) < 0.4,
                torch.rand((1, m), generator=gen) < 0.9]

    s = TP.begin_many(TP.init_state(1, n, d, device="cpu"),
                      torch.ones((1, n), dtype=torch.bool))
    s = TP.admit_ops(s, *op_list()).state
    s = s._replace(haslocks=torch.rand((1, n), generator=gen) < 0.25)
    ops = op_list()
    if kind == "dense":
        s = s._replace(
            prec=(torch.rand((1, n, n), generator=gen) < 0.5)
            & ~torch.eye(n, dtype=torch.bool),
            preceding=torch.rand((1, n), generator=gen) < 0.5,
            preceded=torch.rand((1, n), generator=gen) < 0.5)
    elif kind == "all locked":
        s = s._replace(haslocks=torch.ones((1, n), dtype=torch.bool))
    elif kind == "runs":
        # runs of 4 ops on one txn, then runs of 4 on one item
        ops[0] = ops[0][:, ::4].repeat_interleave(4, 1)[:, :m]
        half = m // 2
        ops[1][:, half:] = ops[1][:, half::4].repeat_interleave(
            4, 1)[:, :m - half]
    elif kind == "edge items":
        top = min(d, 34)
        ops[1] = torch.tensor([[31, 32, 33]], dtype=torch.int32).repeat(
            1, -(-m // 3))[:, :m] % top
    return s, ops


@pytest.mark.parametrize("route", kao.ROUTES)
@pytest.mark.parametrize("kind", ["random", "dense", "all locked", "runs",
                                  "edge items"])
@pytest.mark.parametrize("n,d", [(1, 33), (31, 32), (33, 31), (65, 70)])
def test_twin_matches_plain(route, kind, n, d):
    m = 48
    gen = torch.Generator().manual_seed(n * 131 + d)
    s, ops = _state(gen, kind, n, d, m)
    want = ref.admit_ops_ref(*s, *ops)
    got = twin(route, [t[0].numpy() for t in s],
               *(o[0].numpy() for o in ops))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_[0].numpy())
    if kind == "random" and n > 1:
        assert want[0].any()


# Two ops where the second reads what the first writes, one way each, on
# a state built for it: three active slots without locks, arcs or class
# bits; ``writes`` and ``reads`` give each slot's items (x0 = 0, x1 = 1),
# the ops are ``(txn, item, write)``.  A walk that read the second op's
# words before the first op's writes landed gets each of them wrong.
DEPENDENT_PAIRS = {
    # 0 reads x0; then 1 writes x0 and meets 0 as a new reader
    "same item": ({}, {}, [(0, 0, False), (1, 0, True)]),
    # 0 reads x0 (writer 1: 0 becomes preceding); then 0 writes x1 (reader
    # 2), which a preceding txn may not
    "same txn": ({1: [0]}, {2: [1]}, [(0, 0, False), (0, 1, True)]),
    # 0 reads x0 (writer 1: 1 becomes preceded); then 1 reads x1 (writer 2)
    "txn among the arcs": ({1: [0], 2: [1]}, {},
                           [(0, 0, False), (1, 1, False)]),
    # 0 reads x0 (writer 1: 1 becomes preceded); then 2 writes x1, whose
    # reader 1 may not precede it
    "an arc on the arcs": ({1: [0]}, {1: [1]},
                           [(0, 0, False), (2, 1, True)]),
    # 0 reads x0 (writer 1: 0 becomes preceding); then 2 reads x1, whose
    # writer 0 may not be preceding
    "an arc on the txn": ({1: [0], 0: [1]}, {},
                          [(0, 0, False), (2, 1, False)]),
}


def dependent_pair(name):
    """``(state, ops)`` of ``DEPENDENT_PAIRS[name]``: one lane, n = 3,
    W = 1, CPU tensors."""
    writes, reads, ops = DEPENDENT_PAIRS[name]
    n = 3
    sets = {}
    for key, table in (("read", reads), ("write", writes)):
        words = torch.zeros((1, n, 1), dtype=torch.int32)
        for slot, items in table.items():
            for x in items:
                words[0, slot, 0] |= 1 << x
        sets[key] = words
    flags = torch.zeros((1, n), dtype=torch.bool)
    state = (sets["read"], sets["write"],
             torch.zeros((1, n, n), dtype=torch.bool), flags, flags.clone(),
             torch.ones((1, n), dtype=torch.bool), flags.clone())
    cols = list(zip(*ops))
    return state, [torch.tensor([cols[0]], dtype=torch.int32),
                   torch.tensor([cols[1]], dtype=torch.int32),
                   torch.tensor([cols[2]]), torch.ones((1, 2), dtype=bool)]


@pytest.mark.parametrize("name", list(DEPENDENT_PAIRS))
def test_dependent_pairs(name):
    """The twin equals the plain loop on each pair, the first op is
    admitted, and the second op's outcome depends on it: taken alone, on
    the state before the first, it gives another verdict or other arcs."""
    state, ops = dependent_pair(name)
    want = ref.admit_ops_ref(*state, *ops)
    got = twin(kao.SHARED, [t[0].numpy() for t in state],
               *(o[0].numpy() for o in ops))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_[0].numpy())
    assert want[0][0, 0]
    first = ref.admit_ops_ref(*state, *(o[:, :1] for o in ops))
    both_from_first = ref.admit_ops_ref(*first[3:], *(o[:, 1:] for o in ops))
    alone = ref.admit_ops_ref(*state, *(o[:, 1:] for o in ops))
    verdict_differs = any(not torch.equal(a, b) for a, b in
                          zip(alone[:3], both_from_first[:3]))
    # the second op's own changes: its state minus its input state
    arcs_alone = alone[5] & ~state[2]
    arcs_after = both_from_first[5] & ~first[5]
    assert verdict_differs or not torch.equal(arcs_alone, arcs_after)


def test_transpose32_is_a_transpose():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 2 ** 32, 32, dtype=np.uint64).astype(U32)
    bits = (v[:, None] >> LANE.astype(U32)) & U32(1)       # [row, col]
    out = transpose32(v)
    np.testing.assert_array_equal((out[:, None] >> LANE.astype(U32))
                                  & U32(1), bits.T)
