"""The port's batch scheduler and page store (``repro_torch.sched``)
against the JAX reference (``repro.sched``), on the CPU, with exact
equality.

Run ``python tests/test_torch_sched.py --write-golden`` to regenerate
``src/repro_torch/golden/sched_n4096_w1024.json``: the JAX reference's
drain loop over the full-width YCSB batch (``repro_torch.sched.workload``)
in four modes and its page-store tick for each policy, as counts and
digests, which ``chip_smoke.py`` holds the port's run on the card to.
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

from repro.sched import scheduler as JS  # noqa: E402
from repro.sched import txstore as JX  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.sched import scheduler as S  # noqa: E402
from repro_torch.sched import txstore as X  # noqa: E402
from repro_torch.sched import workload as W  # noqa: E402

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "golden" / "sched_n4096_w1024.json")


def _jax_record(res, stats=None, ppcc_state=False):
    s = res.state
    extra = {}
    if ppcc_state:
        extra = dict(prec=np.asarray(s.prec),
                     preceding=np.asarray(s.preceding),
                     preceded=np.asarray(s.preceded))
    return W.tick_record(np.asarray(res.admitted), np.asarray(res.aborted),
                         np.asarray(res.commit_rank), stats, **extra)


def jax_drain(read_words, write_words, mode, ticks):
    """The reference's drain loop (``examples/serve_batch.py`` without
    the LM): ``tick`` -> ``tick_stats`` -> ``pending &= ~admitted``.
    ``ppcc_degree`` threads the carry; after the loop it repeats the last
    tick with unchanged inputs and that tick's carry.  Returns (records,
    repeat record or None)."""
    r, w = jnp.asarray(read_words), jnp.asarray(write_words)
    pending = np.ones(read_words.shape[0], bool)
    carry, out, v = None, [], None
    policy, order = W.MODES[mode]
    for _ in range(ticks):
        if not pending.any():
            break
        v = jnp.array(pending)           # a copy: pending changes below
        if order == "degree":
            res, carry = JS.tick(r, w, v, policy="ppcc", order="degree",
                                 carry=carry, return_carry=True)
        else:
            res = JS.tick(r, w, v, policy=policy)
        stats = JS.tick_stats(r, w, v, res)
        out.append(_jax_record(res, stats, policy == "ppcc"))
        pending &= ~np.asarray(res.admitted)
    repeat = None
    if order == "degree":
        res, _ = JS.tick(r, w, v, policy="ppcc", order="degree", carry=carry,
                         return_carry=True)
        repeat = _jax_record(res, None, True)
    return out, repeat


def jax_store(policy, pages, read, write, payload, additive):
    """One reference page-store tick -> record of the new pages and the
    snapshot reads."""
    batch = JX.TxBatch(read_sets=jnp.asarray(read),
                       write_sets=jnp.asarray(write),
                       payload=jnp.asarray(payload),
                       additive=jnp.asarray(additive),
                       valid=jnp.ones(read.shape[0], bool))
    new, reads, st = JX.apply_tick(jnp.asarray(pages), batch, policy)
    return W.store_record(np.asarray(new), np.asarray(reads),
                        np.asarray(st.admitted), np.asarray(st.aborted))


def write_golden(path: Path = GOLDEN) -> None:
    """Run the reference on the full-width workload and write the
    golden: counts and sha256 digests only, so the file stays small."""
    t0 = time.perf_counter()
    rw, ww = W.ycsb_batch()
    modes = {}
    repeat = None
    for mode in W.MODES:
        modes[mode], rep = jax_drain(rw, ww, mode, W.TICKS)
        repeat = rep or repeat
        print(f"{mode}: {[r['admitted'] for r in modes[mode]]} admitted, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    store_in = W.store_batch()
    store = {p: jax_store(p, *store_in) for p in ("ppcc", "2pl", "occ")}
    doc = {
        "what": "JAX reference repro.sched on the full-width YCSB batch: "
                "per mode, TICKS ticks of tick -> tick_stats -> pending &= "
                "~admitted (counts, sha256 of admitted/aborted/commit_rank "
                "and for ppcc prec/preceding/preceded, the tick_stats "
                "dict); the ppcc_degree carry repeat; txstore.apply_tick "
                "per policy on the page-store batch",
        "command": "python tests/test_torch_sched.py --write-golden",
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "use_kernel": True,
        "cpu_seconds": round(time.perf_counter() - t0, 1),
        "workload": {"n": W.N_TXN, "pages": W.N_PAGES, "words": rw.shape[1],
                     "per_txn": W.PER_TXN, "theta": W.THETA,
                     "p_write": W.P_WRITE, "seed": W.SEED,
                     "ticks": W.TICKS},
        "input_sha256": W.digest(rw, ww),
        "modes": modes,
        "carry_repeat": repeat,
        "store": {"n": W.STORE_TXN, "pages": W.STORE_PAGES,
                  "page": W.STORE_PAGE, "seed": W.STORE_SEED,
                  "input_sha256": W.digest(*store_in),
                  "policies": store},
    }
    path.write_text(json.dumps(doc, indent=1) + "\n")


# ---------------------------------------------------------------- tests
N, D = 64, 1000              # one shape throughout: the reference's jit
                             # and interpret-mode kernels compile once


@pytest.fixture(scope="module")
def batch():
    """The YCSB generator at test size: (uint32 words, int32 words)."""
    rw, ww = W.ycsb_batch(n=N, d=D, seed=7)
    return (rw, ww), (torch.from_numpy(rw.view(np.int32)),
                      torch.from_numpy(ww.view(np.int32)))


def _port_record(res, stats=None, ppcc_state=False):
    extra = {}
    if ppcc_state:
        s = res.state
        extra = dict(prec=s.prec[0].numpy(), preceding=s.preceding[0].numpy(),
                     preceded=s.preceded[0].numpy())
    return W.tick_record(res.admitted.numpy(), res.aborted.numpy(),
                         res.commit_rank.numpy(), stats, **extra)


def port_drain(read_bits, write_bits, mode, ticks):
    """``workload.drain`` as the records ``jax_drain`` makes."""
    steps, repeat = W.drain(read_bits, write_bits, mode, ticks)
    ppcc_state = W.MODES[mode][0] == "ppcc"
    return ([_port_record(res, stats, ppcc_state) for res, stats in steps],
            repeat and _port_record(repeat, None, True))


def _assert_tick(got, want, ppcc_state):
    for name in ("admitted", "aborted", "commit_rank"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if ppcc_state:
        for name in ("prec", "preceding", "preceded", "active"):
            g = getattr(got.state, name)
            assert g.shape[0] == 1, name               # one lane
            np.testing.assert_array_equal(
                g[0].numpy(), np.asarray(getattr(want.state, name)),
                err_msg=name)


@pytest.mark.parametrize("mode", tuple(W.MODES))
def test_tick_matches_reference(batch, mode):
    (rw, ww), (tr, tw) = batch
    valid = np.random.default_rng(1).random(N) < 0.9
    policy, order = W.MODES[mode]
    want = JS.tick(jnp.asarray(rw), jnp.asarray(ww), jnp.asarray(valid),
                   policy=policy, order=order)
    got = S.tick(tr, tw, torch.from_numpy(valid), policy=policy, order=order)
    _assert_tick(got, want, policy == "ppcc")
    assert got.admitted.any() and not got.admitted.all()


@pytest.mark.parametrize("policy", ("ppcc", "2pl", "occ"))
def test_bool_masks_and_word_padding(policy):
    """Boolean masks are packed, ``words=`` pads; both give the
    reference's tick, and padding changes nothing."""
    rng = np.random.default_rng(3)
    pages = W.ycsb_pages(rng, 40, 90)
    read, write = W.masks(pages, rng.random(pages.shape) < 0.5, 90)
    valid = np.ones(40, bool)
    want = JS.tick(jnp.asarray(read), jnp.asarray(write), jnp.asarray(valid),
                   policy=policy, words=8)
    tr, tw = torch.from_numpy(read), torch.from_numpy(write)
    tv = torch.from_numpy(valid)
    got = S.tick(tr, tw, tv, policy=policy, words=8)
    _assert_tick(got, want, policy == "ppcc")
    _assert_tick(S.tick(tr, tw, tv, policy=policy), want, policy == "ppcc")
    assert S._as_bits(tr, 8).shape == (40, 8)
    with pytest.raises(ValueError):
        S._as_bits(tr, 2)


def test_tick_rejects_what_the_reference_rejects(batch):
    _, (tr, tw) = batch
    v = torch.ones(N, dtype=torch.bool)
    with pytest.raises(ValueError):
        S.tick(tr, tw, v, policy="2pl", order="degree")
    with pytest.raises(ValueError):
        S.tick(tr, tw, v, policy="occ", return_carry=True)
    with pytest.raises(KeyError):
        S.tick(tr, tw, v, policy="mvcc")


def test_carry_made_by_the_reference(batch, monkeypatch):
    """A reference tick's carry, through ``carry_from_numpy``, resumes a
    port tick: unchanged inputs reuse it and compute no relations, a
    changed valid mask recomputes them; both equal the reference."""
    (rw, ww), (tr, tw) = batch
    valid = np.ones(N, bool)
    jr, jw = jnp.asarray(rw), jnp.asarray(ww)
    jres, jcarry = JS.tick(jr, jw, jnp.asarray(valid), policy="ppcc",
                           order="degree", return_carry=True)
    carry = S.carry_from_numpy(*(np.asarray(x) for x in jcarry[:3]),
                               [np.asarray(r) for r in jcarry.rel],
                               device="cpu")
    assert carry.read_bits.dtype == torch.int32
    for k, r in enumerate(carry.rel):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jcarry.rel[k]))
    calls = []
    real = tref.conflict_fused_full_ref
    monkeypatch.setattr(tref, "conflict_fused_full_ref",
                        lambda *a: calls.append(1) or real(*a))
    res, carry2 = S.tick(tr, tw, torch.from_numpy(valid), policy="ppcc",
                         order="degree", carry=carry, return_carry=True)
    assert calls == []
    _assert_tick(res, jres, True)
    assert carry2.rel[0] is carry.rel[0]
    valid2 = valid.copy()
    valid2[np.asarray(jres.admitted)] = False
    want2 = JS.tick(jr, jw, jnp.asarray(valid2), policy="ppcc",
                    order="degree", carry=jcarry)
    got2 = S.tick(tr, tw, torch.from_numpy(valid2), policy="ppcc",
                  order="degree", carry=carry)
    assert calls == [1]
    _assert_tick(got2, want2, True)


@pytest.mark.parametrize("policy", ("ppcc", "2pl", "occ"))
def test_tick_stats_match(batch, policy):
    (rw, ww), (tr, tw) = batch
    valid = np.random.default_rng(2).random(N) < 0.8
    jv = jnp.asarray(valid)
    jres = JS.tick(jnp.asarray(rw), jnp.asarray(ww), jv, policy=policy)
    want = JS.tick_stats(jnp.asarray(rw), jnp.asarray(ww), jv, jres)
    tv = torch.from_numpy(valid)
    got = S.tick_stats(tr, tw, tv, S.tick(tr, tw, tv, policy=policy))
    assert got == want
    assert type(got["degree_mean"]) is float


@pytest.mark.parametrize("mode", tuple(W.MODES))
def test_drain_loop_matches_reference(batch, mode):
    """Four ticks of tick -> tick_stats -> pending &= ~admitted, and for
    the degree mode the carry repeat, record for record."""
    (rw, ww), (tr, tw) = batch
    want, want_rep = jax_drain(rw, ww, mode, 4)
    got, got_rep = port_drain(tr, tw, mode, 4)
    assert got == want
    assert got_rep == want_rep
    assert len(got) == 4 and sum(r["admitted"] for r in got) > 0


@pytest.mark.parametrize("policy", ("ppcc", "2pl", "occ"))
def test_apply_tick_matches_reference(policy):
    """``txstore.apply_tick``: the new pages and the snapshot reads bit
    for bit, on a small page-store batch."""
    inputs = W.store_batch(n=48, d=400, page=4, seed=11)
    want = jax_store(policy, *inputs)
    pages, read, write, payload, additive = (torch.from_numpy(a)
                                             for a in inputs)
    batch = X.TxBatch(read_sets=read, write_sets=write, payload=payload,
                      additive=additive,
                      valid=torch.ones(48, dtype=torch.bool))
    new, reads, st = X.apply_tick(pages, batch, policy)
    assert new.dtype == torch.float32 and st.n_admitted.dtype == torch.int32
    assert W.store_record(new.numpy(), reads.numpy(), st.admitted.numpy(),
                        st.aborted.numpy()) == want
    assert int(st.n_admitted) == want["n_admitted"] > 1


def test_golden_inputs_are_the_generators():
    """The committed golden was written from the workload this checkout
    generates, and lists every mode with TICKS ticks."""
    doc = json.loads(GOLDEN.read_text())
    rw, ww = W.ycsb_batch()
    assert doc["input_sha256"] == W.digest(rw, ww)
    assert doc["store"]["input_sha256"] == W.digest(*W.store_batch())
    assert doc["workload"]["words"] == rw.shape[1] == 1024
    assert sorted(doc["modes"]) == sorted(W.MODES)
    for mode in W.MODES:
        assert len(doc["modes"][mode]) == W.TICKS, mode
    assert sorted(doc["store"]["policies"]) == ["2pl", "occ", "ppcc"]


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of ``repro_torch`` and ``chip_smoke.py`` imports
    without ``jax`` or ``repro`` reaching ``sys.modules``."""
    import subprocess
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"runpy.run_path({str(root / 'chip_smoke.py')!r}, run_name='x')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
        print(f"wrote {GOLDEN}")
    else:
        sys.exit("usage: python tests/test_torch_sched.py --write-golden")
