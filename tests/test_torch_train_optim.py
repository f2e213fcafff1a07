"""The port's optimizer, gradient compression and data pipeline
(``repro_torch.optim``, ``repro_torch.data``) against the JAX reference
(``repro.optim``, ``repro.data``), on the CPU, with numpy inputs.

* AdamW: ``update`` over ten steps on the same gradients (the warmup
  branch, the cosine decay and the steps past its end), with clipping on
  and off, a bf16 parameter among float32 ones: the moments, the master
  weights, the parameters, the gradient norm and the learning rate
  within 1e-6 relative (the reference's XLA and torch compute ``pow``,
  ``cos`` and the sums of squares in their own ways; every other
  operation is the same float32 operation); ``cosine_lr`` the same.
* Compression: codes, scales, the error state, the reconstruction and
  the byte count bit-equal over two rounds of error feedback.
* Data: ``SyntheticLM.host_batch`` bit-equal for every family, the
  stream's state round trip, and ``Prefetcher``'s depth and deadline
  (the twin of ``tests/test_data_pipeline.py``).
"""
import queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.config import ShapeSpec as JShape  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402

SHAPES = {"a_embed": (40, 24), "b_w": (24, 3, 7), "c_norm": (24,),
          "d_gate": (), "e_bf16": (5, 9)}
RTOL = 1e-6


def np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def to_torch(tree):
    out = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    out["e_bf16"] = out["e_bf16"].bfloat16()
    return out


def to_jax(tree):
    out = {k: jnp.asarray(v) for k, v in tree.items()}
    out["e_bf16"] = out["e_bf16"].astype(jnp.bfloat16)
    return out


def close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np32(want), rtol=RTOL,
                               atol=1e-7, err_msg=what)


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_update_matches_reference(clip):
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=8, clip_norm=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p0 = leaves(0)
    jp, tp = to_jax(p0), to_torch(p0)
    js, ts = jadamw.init(jp), adamw.init(tp)
    jupd = jax.jit(lambda g, s, p: jadamw.update(jcfg, g, s, p))
    clipped = []
    for step in range(10):
        g = leaves(100 + step, scale=3.0)
        jp, js, jm = jupd(to_jax(g), js, jp)
        tp, ts, tm = adamw.update(tcfg, to_torch(g), ts, tp)
        clipped.append(float(jm["grad_norm"]) > clip)
        assert int(ts.step) == int(js.step) == step + 1
        close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        close(tm["lr"], jm["lr"], "lr")
        for k in SHAPES:
            close(ts.m[k], js.m[k], f"m/{k}")
            close(ts.v[k], js.v[k], f"v/{k}")
            close(ts.master[k], js.master[k], f"master/{k}")
            assert tp[k].dtype == (torch.bfloat16 if k == "e_bf16"
                                   else torch.float32)
            np.testing.assert_allclose(tp[k].float().numpy(), np32(jp[k]),
                                       rtol=1e-2 if k == "e_bf16" else RTOL,
                                       atol=1e-7, err_msg=k)
    assert all(clipped) if clip == 1.0 else not any(clipped)


@pytest.mark.parametrize("group_elems", [1, 200, 1000])
def test_adamw_grouped_passes_bit_equal(monkeypatch, group_elems):
    """The update's elementwise passes over groups of at most
    ``GROUP_ELEMS`` elements (one leaf a group; the small leaves together,
    a leaf past the limit alone) give the bits of one pass over every
    leaf."""
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=8, clip_norm=1.0)
    cfg = adamw.AdamWConfig(**kw)
    runs = []
    for elems in (1 << 40, group_elems):
        monkeypatch.setattr(adamw, "GROUP_ELEMS", elems)
        tp = to_torch(leaves(0))
        ts = adamw.init(tp)
        for step in range(3):
            tp, ts, _ = adamw.update(cfg, to_torch(leaves(100 + step, 3.0)),
                                     ts, tp)
        runs.append((tp, ts))
    names = list(SHAPES)
    assert len(adamw._groups(names, runs[0][0])) == \
        {1: 5, 200: 3, 1000: 2}[group_elems]
    (p1, s1), (p2, s2) = runs
    for k in SHAPES:
        for a, b in ((p1, p2), (s1.m, s2.m), (s1.v, s2.v),
                     (s1.master, s2.master)):
            assert torch.equal(a[k], b[k]), k


def test_cosine_lr_matches_reference():
    for kw in (dict(), dict(peak_lr=1e-3, warmup_steps=5, total_steps=50),
               dict(warmup_steps=0, total_steps=3, min_lr_ratio=0.0)):
        jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        steps = np.arange(0, max(60, jcfg.total_steps + 10), 3,
                          dtype=np.int32)
        want = np32(jax.vmap(lambda s: jadamw.cosine_lr(jcfg, s))(
            jnp.asarray(steps)))
        got = adamw.cosine_lr(tcfg, torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_global_norm_matches_reference():
    g = leaves(7)
    np.testing.assert_allclose(
        float(adamw.global_norm(to_torch(g))),
        float(jadamw.global_norm(to_jax(g))), rtol=RTOL)


def test_compress_bit_equal_to_reference():
    shapes = {"a": (3, 100), "b": (257,), "c": (16, 16), "d": (2, 300, 5)}
    rng = np.random.default_rng(4)
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    jef = jcomp.init_ef({k: jnp.asarray(v) for k, v in grads[0].items()})
    tef = compress.init_ef({k: torch.from_numpy(v)
                            for k, v in grads[0].items()})
    for g in grads:                       # two rounds: the error carries
        jq, js, jef = jcomp.compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tq, ts, tef = compress.compress_grads(tg, tef)
        for k in shapes:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(tef.error[k].numpy(),
                                          np.asarray(jef.error[k]))
        jd = jcomp.decompress_grads(jq, js, {k: jnp.asarray(v)
                                             for k, v in g.items()})
        td = compress.decompress_grads(tq, ts, tg)
        for k in shapes:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        assert compress.compressed_bytes(tq, ts) == \
            jcomp.compressed_bytes(jq, js)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_host_batch_bit_equal_to_reference(arch):
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    tp = pipeline.SyntheticLM(cfg, ShapeSpec("t", 16, 4, "train"), seed=3)
    jp = jpipe.SyntheticLM(jcfg, JShape("t", 16, 4, "train"), seed=3)
    for step in (0, 5):
        a, b = tp.host_batch(step=step), jp.host_batch(step=step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    dev = pipeline.to_device(tp.host_batch(), "cpu")
    assert dev["labels"].dtype == torch.int64
    assert all(v.dtype in (torch.int64, torch.float32) for v in dev.values())


def _pipe(seed=0):
    return pipeline.SyntheticLM(configs.get_smoke("llama3p2_1b"),
                                ShapeSpec("t", 16, 8, "train"), seed=seed)


def test_labels_are_shifted_tokens_and_stream_resumes():
    b = _pipe().host_batch(step=0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    p = _pipe()
    it = iter(p)
    first = [next(it)["tokens"] for _ in range(3)]
    assert p.state.step == 2
    snap = p.state.to_dict()
    p2 = _pipe()
    p2.state = pipeline.PipelineState.from_dict(snap)
    np.testing.assert_array_equal(p2.host_batch()["tokens"], first[2])


def test_prefetcher_depth_and_deadline():
    pf = pipeline.Prefetcher(iter(range(100)), depth=2)
    assert pf.get(timeout=1.0) == 0
    assert pf.get(timeout=1.0) == 1
    pf.stop()
    slow = pipeline.Prefetcher(iter([]), depth=1)
    assert slow.get(timeout=0.5) is None      # exhausted -> sentinel

    def stalled():
        yield 1
        import time
        time.sleep(5)
        yield 2
    late = pipeline.Prefetcher(stalled(), depth=1)
    assert late.get(timeout=1.0) == 1
    with pytest.raises(queue.Empty):           # the deadline: skip the step
        late.get(timeout=0.2)
