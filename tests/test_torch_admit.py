"""The premises of ``csrc/admit.cu``'s ``ppcc_admit``, ``twopl_admit`` and
``occ_admit`` designs, held on the CPU against the JAX references
``repro.sched.scheduler.ppcc_tick``, ``twopl_tick`` and ``occ_tick`` and
the port's plain versions ``kernels.ref.ppcc_admit_ref``,
``twopl_admit_ref`` and ``occ_admit_ref``:

(a) ``prec`` is ``raw & admitted[:, None] & admitted[None, :]`` off the
    diagonal: the reference's row-then-column writes leave exactly that,
    so the kernel writes ``prec`` in one pass after the scan;
(b) a step that is not admitted changes no set, and preceding and
    preceded hold admitted transactions only: so a word-level twin of the
    packed scan that tests B steps at once against the same sets and
    applies the first admitted one (the sets as int32 words, the row and
    column of each transaction packed, three any-tests a step, the words
    owned K a thread of 128 as the kernel holds them) equals the plain
    version;
(c) the pack kernel's arithmetic (4 columns a lane as one word, row
    words from nibbles ORed across 8 lanes, column words gathered 8 rows a
    word and then by bytes) equals packing ``raw`` and ``raw.T``; and
    ``greedy_pack``'s, the row words of ``raw | ww`` ORed with the column
    words of ``raw`` and the diagonal cleared, equals packing the conflict
    rows ``(raw | raw.T | ww) & ~eye``; and its OCC form's, the row words
    of ``raw | ww`` where a lane's word is not right of its warp's row word,
    equals packing ``raw | ww`` at and below each row's own word;
(d) for ``twopl_admit`` too a step that is not admitted changes nothing:
    a word-level twin of its scan (the packed conflict rows, ``admitted``
    as words owned K a thread, B steps tested at once, the first admitted
    one applied) equals the plain version and ``twopl_tick``, also at the
    main path's n = 4,096;
(e) ``occ_admit`` is that walk on other rows: at step i only j < i can
    be a survivor, so ``earlier`` removes no bit and a row's bits j >= i
    change nothing; the scan twin of (d) on the packed rows of ``raw | ww``
    at and below each row's own word, with the diagonals of ``raw`` and
    ``ww`` set as the scheduler leaves them, equals ``occ_admit_ref`` and
    ``occ_tick``'s survivors, also at n = 4,096.

Every comparison is exact: the outputs are bool."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.sched import scheduler as JS  # noqa: E402
from repro_torch.core import bitset as TB  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TWIN_N = (1, 31, 32, 33, 64, 255, 300)
SCAN_THREADS = 128               # csrc/admit.cu: kScanThreads
SCAN_MAX_K = 4                   # kScanMaxK
CTA_THREADS = 512                # kCtaThreads


def row_words(n):
    """Words of a packed row in the kernel's scratch
    (``ppcc_admit_row_words``): 128 K up to n = 16,384, 512 K on the CTA
    route above, K a power of two."""
    nw = -(-n // 32)
    k = 1
    if n <= SCAN_THREADS * 32 * SCAN_MAX_K:
        while SCAN_THREADS * k < nw:
            k *= 2
        return SCAN_THREADS * k
    k = 2
    while CTA_THREADS * k < nw:
        k *= 2
    return CTA_THREADS * k


def _sets(seed, n, d, p):
    rng = np.random.default_rng(seed)
    return rng.random((n, d)) < p, rng.random((n, d)) < p / 2


def _raw(read, write):
    """raw[i, j]: read set i meets write set j, the diagonal cleared."""
    raw = (read.astype(np.int32) @ write.T.astype(np.int32)) > 0
    np.fill_diagonal(raw, False)
    return raw


def _admit_inputs(seed, n):
    rng = np.random.default_rng(seed)
    raw = rng.random((n, n)) < min(0.5, 3.0 / max(n, 1))
    np.fill_diagonal(raw, False)
    valid = rng.random(n) < 0.9
    seq = rng.permutation(n).astype(np.int32)
    return raw, valid, seq


@pytest.mark.parametrize("order", ["priority", "degree"])
@pytest.mark.parametrize("n,d", [(48, 256), (130, 512)])
def test_prec_is_raw_between_admitted(order, n, d):
    """(a) on the reference's own ``ppcc_tick`` output."""
    read, write = _sets(n + d, n, d, 0.04)
    valid = np.random.default_rng(n).random(n) < 0.9
    res = JS.ppcc_tick(jnp.asarray(read), jnp.asarray(write),
                       jnp.asarray(valid), use_kernel=False, order=order)
    adm = np.asarray(res.admitted)
    assert adm.any() and not adm.all()
    want = _raw(read, write) & adm[:, None] & adm[None, :]
    np.testing.assert_array_equal(np.asarray(res.state.prec), want)
    # the classes hold admitted transactions only (the kernel's tests
    # read preceding and preceded without ANDing them with admitted)
    for cls in (res.state.preceding, res.state.preceded):
        cls = np.asarray(cls)
        assert cls.any() and not (cls & ~adm).any()


def _tile_pack(raw, ws, triangle=False):
    """The pack kernel's arithmetic: warp w of CTA (G, I0 / 8) takes rows
    32 I .. 32 I + 31 (I = I0 + w) of columns 128 G .. 128 G + 127, lane l
    the 4 columns 128 G + 4 l .. + 3 of each row as 0/1 bytes of a word
    (with ``triangle``, as ``greedy_pack`` for OCC, only where the lane's
    word 4 G + l / 8 is not right of the rows' word I).
    A row's word G*4 + c is the OR of the nibbles (bytes * 0x01020408 >>
    24) of lanes 8 c .. 8 c + 7, each shifted by 4 (l % 8); a column's
    word I gathers bit r of its byte over the rows, 8 rows a word by
    shifts and then a byte from each of the 4 words.  Words past the row
    are 0, to width ws."""
    n = raw.shape[0]
    nw = -(-n // 32)
    rows = np.zeros((n, ws), np.uint32)
    cols = np.zeros((n, ws), np.uint32)
    lanes = np.arange(32)
    for i0 in range(0, ws, 8):
        for grp in range(ws // 4):
            if i0 >= nw and grp * 4 >= nw:
                continue
            for big_i in range(i0, i0 + 8):
                x = np.zeros((32, 32), np.uint32)      # [row r, lane]
                need = (4 * grp + lanes // 8 <= big_i) | (not triangle)
                for r in range(32):
                    i = 32 * big_i + r
                    for b in range(4):
                        c = 128 * grp + 4 * lanes + b
                        ok = (i < n) & (c < n) & need
                        byte = np.where(ok, raw[min(i, n - 1)][
                            np.minimum(c, n - 1)], False)
                        x[r] |= byte.astype(np.uint32) << (8 * b)
                nib = ((x * np.uint32(0x01020408)) >> 24) << \
                    (4 * (lanes % 8)).astype(np.uint32)
                for r in range(32):
                    i = 32 * big_i + r
                    if i < n:
                        for c in range(4):
                            rows[i, grp * 4 + c] = np.bitwise_or.reduce(
                                nib[r, 8 * c:8 * c + 8])
                y = [sum(x[8 * q + k] << np.uint32(k) for k in range(8))
                     for q in range(4)]
                for lane in range(32):
                    for b in range(4):
                        j = 128 * grp + 4 * lane + b
                        if j < n:
                            cols[j, big_i] = sum(
                                int((y[q][lane] >> (8 * b)) & 0xff) << (8 * q)
                                for q in range(4))
    return (torch.from_numpy(rows.view(np.int32)),
            torch.from_numpy(cols.view(np.int32)))


def _padded(words, ws):
    out = torch.zeros((words.shape[0], ws), dtype=torch.int32)
    out[:, :words.shape[1]] = words
    return out


def conflict_rows_twin(raw, ww, ws):
    """``greedy_pack``'s 2PL arithmetic: its CTA's warps take the row
    words of ``raw | ww`` at their tile and the column words of ``raw`` at
    the transposed tile, each a warp tile of 32 rows x 128 columns computed
    as ``_tile_pack`` computes it; the two OR into one row, and the
    diagonal's bit is cleared."""
    rows = _tile_pack(raw | ww, ws)[0] | _tile_pack(raw, ws)[1]
    for i in range(raw.shape[0]):
        rows[i, i >> 5] &= TB.wrap32(torch.tensor(~(1 << (i & 31)) &
                                                  0xffffffff))
    return rows


def word_triangle(n):
    """``tri[i, j]``: column j's word is not right of row i's."""
    w = torch.arange(n) >> 5
    return w[None, :] <= w[:, None]


PACK_N = (1, 31, 33, 70, 200)


@pytest.mark.parametrize(
    "n,kind", [pytest.param(n, "raw", id=str(n)) for n in PACK_N]
    + [pytest.param(n, "conflict", id=f"conflict-rows-{n}") for n in PACK_N]
    + [pytest.param(n, "occ", id=f"occ-rows-{n}") for n in PACK_N])
def test_tile_pack_is_pack_of_raw_and_its_transpose(n, kind):
    """(c): rows are ``pack(raw)`` and columns ``pack(raw.T)``, padded;
    ``greedy_pack``'s rows are ``pack((raw | raw.T | ww) & ~eye)`` for
    2PL and ``pack((raw | ww) & tri)`` for OCC, ``tri`` the words at and
    below each row's own (the diagonal kept)."""
    raw, _, _ = _admit_inputs(n, n)
    raw |= np.random.default_rng(1).random((n, n)) < 0.3
    ws = row_words(n)
    t = torch.from_numpy(raw)
    if kind == "occ":
        ww = np.random.default_rng(2).random((n, n)) < 0.2
        np.fill_diagonal(ww, True)
        want = (t | torch.from_numpy(ww)) & word_triangle(n)
        got = _tile_pack(raw | ww, ws, triangle=True)[0]
        assert torch.equal(got, _padded(TB.pack(want), ws))
        return
    if kind == "conflict":
        ww = np.random.default_rng(2).random((n, n)) < 0.2
        np.fill_diagonal(raw, True)        # the diagonal is cleared anyway
        t = torch.from_numpy(raw)
        want = (t | t.T | torch.from_numpy(ww)) & ~torch.eye(n, dtype=bool)
        assert torch.equal(conflict_rows_twin(raw, ww, ws),
                           _padded(TB.pack(want), ws))
        return
    rows, cols = _tile_pack(raw, ws)
    assert torch.equal(rows, _padded(TB.pack(t), ws))
    assert torch.equal(cols, _padded(TB.pack(t.T.contiguous()), ws))


def packed_scan_twin(raw, valid, seq):
    """The scan on int32 words: thread t of 128 owns words t K .. t K + K
    - 1 of admitted, preceding and preceded.  B steps (16, or 8 at K =
    4) are tested at once against the same sets (each ANDs the packed row and column of
    its transaction with admitted and takes three any-tests over the
    threads: arcs out, arcs in, an arc to a preceding or from a preceded
    transaction); the first admitted one among them is applied and the
    walk resumes after it.  prec follows from (a).  Returns
    ``ppcc_admit``'s four outputs."""
    n = raw.shape[0]
    ws = row_words(n)
    k = ws // SCAN_THREADS
    batch = 16 if k <= 2 else 8          # csrc/admit.cu: batch_steps(K)
    rows = _padded(TB.pack(raw), ws)
    cols = _padded(TB.pack(raw.T.contiguous()), ws)
    steps = [int(i) | (int(valid[i]) << 31) for i in seq.tolist()]
    adm, pg, pd = torch.zeros((3, SCAN_THREADS, k), dtype=torch.int32)
    s = 0
    while s < n:
        tests = []
        for e in steps[s:s + batch]:
            rw = rows[e & 0x7fffffff].view(SCAN_THREADS, k)
            cw = cols[e & 0x7fffffff].view(SCAN_THREADS, k)
            any_r = bool(((rw & adm) != 0).any())
            any_w = bool(((cw & adm) != 0).any())
            # preceding and preceded hold admitted transactions only
            hit = bool((((rw & pg) | (cw & pd)) != 0).any())
            tests.append((bool(e >> 31) and not (any_r and any_w)
                          and not hit, any_r, any_w))
        first = next((b for b, t in enumerate(tests) if t[0]), None)
        if first is None:
            s += len(tests)
            continue
        e = steps[s + first]
        i, (_, any_r, any_w) = e & 0x7fffffff, tests[first]
        rw, cw = rows[i].view(SCAN_THREADS, k), cols[i].view(SCAN_THREADS, k)
        me = torch.zeros((SCAN_THREADS, k), dtype=torch.int32)
        me[(i >> 5) // k, (i >> 5) % k] = TB.wrap32(
            torch.tensor(1 << (i & 31)))
        pg = pg | (cw & adm) | (me if any_r else 0)
        pd = pd | (rw & adm) | (me if any_w else 0)
        adm = adm | me
        s += first + 1
    flags = [TB.unpack(x.reshape(-1), n) for x in (adm, pg, pd)]
    adm = flags[0]
    prec = raw & adm[:, None] & adm[None, :]
    return (*flags, prec)


@pytest.mark.parametrize("n", TWIN_N)
def test_packed_scan_twin_matches_plain(n):
    """(b), with prec from (a), at n off and on the word and warp edges."""
    raw, valid, seq = _admit_inputs(n, n)
    args = (torch.from_numpy(raw), torch.from_numpy(valid),
            torch.from_numpy(seq))
    got = packed_scan_twin(*args)
    want = ref.ppcc_admit_ref(*args)
    for name, g, x in zip(("admitted", "preceding", "preceded", "prec"),
                          got, want):
        assert torch.equal(g, x), name
    if n > 30:
        assert want[0].any() and not want[0].all()
        assert want[1].any() and want[2].any()


def test_row_words_routes():
    """The scratch widths at the main path's n and at the route switch."""
    assert row_words(64) == 128
    assert row_words(4096) == 128
    assert row_words(16_384) == 512
    assert row_words(16_385) == 1024
    assert row_words(262_144) == 8192


def twopl_scan_twin(rows, valid):
    """``greedy_scan`` on int32 words: ``rows`` are the packed rows
    at the kernel's width, ``admitted`` the words owned K a thread (128
    threads up to n = 16,384, 512 above).  B steps (32, 16 at K = 4, one
    on the CTA route) are tested at once against the same set; the first
    valid one that meets no admitted transaction is admitted and the walk
    resumes after it."""
    n, ws = rows.shape
    threads = SCAN_THREADS if n <= SCAN_THREADS * 32 * SCAN_MAX_K \
        else CTA_THREADS
    k = ws // threads
    batch = 1 if threads == CTA_THREADS else (32 if k <= 2 else 16)
    words = rows.view(n, threads, k)
    adm = torch.zeros((threads, k), dtype=torch.int32)
    s = 0
    while s < n:
        top = min(s + batch, n)
        hit = ((words[s:top] & adm) != 0).flatten(1).any(1)
        ok = (valid[s:top] & ~hit).nonzero()
        if not len(ok):
            s = top
            continue
        i = s + int(ok[0])
        adm[(i >> 5) // k, (i >> 5) % k] |= TB.wrap32(
            torch.tensor(1 << (i & 31)))
        s = i + 1
    return TB.unpack(adm.reshape(-1), n)


def _twopl_inputs(seed, n, d, reads):
    """YCSB-like read and write sets over d items (``reads`` a row on
    average, half of them written) and the scheduler's raw and ww with
    their diagonals, and valid at 0.9."""
    rng = np.random.default_rng(seed)
    read = rng.random((n, d)) < reads / d
    write = read & (rng.random((n, d)) < 0.5)
    r32, w32 = read.astype(np.float32), write.astype(np.float32)
    raw = (r32 @ w32.T) > 0
    ww = (w32 @ w32.T) > 0
    return read, write, raw, ww, rng.random(n) < 0.9


@pytest.mark.parametrize("n,d,reads", [(n, max(64, 2 * n), 4)
                                       for n in TWIN_N] + [(4096, 512, 3)])
def test_twopl_scan_twin_matches_plain_and_jax(n, d, reads):
    """(d), from the packed rows of (c), at n off and on the word and warp
    edges and at the main path's n = 4,096: equal to ``twopl_admit_ref``
    and to ``twopl_tick``'s ``admitted``."""
    read, write, raw, ww, valid = _twopl_inputs(n + d, n, d, reads)
    t_raw, t_ww = torch.from_numpy(raw), torch.from_numpy(ww)
    eye = torch.eye(n, dtype=torch.bool)
    rows = _padded(TB.pack((t_raw | t_raw.T | t_ww) & ~eye), row_words(n))
    got = twopl_scan_twin(rows, torch.from_numpy(valid))
    want = ref.twopl_admit_ref(t_raw, t_ww, torch.from_numpy(valid))
    assert torch.equal(got, want)
    res = JS.twopl_tick(jnp.asarray(read), jnp.asarray(write),
                        jnp.asarray(valid), use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(res.admitted))
    if n > 30:
        assert want.any() and not want.all()


@pytest.mark.parametrize("n,d,reads", [(n, max(64, 2 * n), 4)
                                       for n in TWIN_N] + [(4096, 512, 3)])
def test_occ_scan_twin_matches_plain_and_jax(n, d, reads):
    """(e), from the packed rows of (c)'s OCC form, at n off and on the
    word and warp edges and at the main path's n = 4,096: equal to
    ``occ_admit_ref`` and to ``occ_tick``'s survivors."""
    read, write, raw, ww, valid = _twopl_inputs(n + d, n, d, reads)
    t_raw, t_ww = torch.from_numpy(raw), torch.from_numpy(ww)
    rows = _padded(TB.pack((t_raw | t_ww) & word_triangle(n)), row_words(n))
    got = twopl_scan_twin(rows, torch.from_numpy(valid))
    want = ref.occ_admit_ref(t_raw, t_ww, torch.from_numpy(valid))
    assert torch.equal(got, want)
    res = JS.occ_tick(jnp.asarray(read), jnp.asarray(write),
                      jnp.asarray(valid), use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(res.admitted))
    if n > 30:
        assert want.any() and not want.all()
        # the scheduler's diagonals, set wherever a transaction writes
        assert t_raw.diagonal().any() and t_ww.diagonal().any()
