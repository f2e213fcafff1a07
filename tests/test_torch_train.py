"""The port's training path (``LM.loss``, ``launch.steps.make_train_step``,
``transformer.remat``) against the JAX reference (``repro.models.LM.loss``,
``jax.value_and_grad``, ``repro.launch.steps.make_train_step``), on the CPU.

The same weights (the reference's own init, carried across by
``convert.params_from_jax``) and the same numpy batches go through both
packages in float32 (every family's smoke config in
``tests/test_torch_train_families.py``, which takes its helpers from
here).  The port's gradients come back to the reference's stacked tree
through ``convert.tree_from_port`` and are compared leaf by leaf, as are
the optimizer's moments after one step.  This file holds the remat
policies, gradient accumulation, the non-finite guard and the
full-width golden.  Tolerances, float32 (sums taken in
another order; the port's attention is the flash formulation and its
hand-written backward's plain version, the reference's the plain
softmax under XLA autodiff): losses 1e-5 relative; each gradient and
moment leaf within 1e-4 of the leaf's largest magnitude; the master
weights after a step within 2.5 x lr absolute, since Adam's first
update is about lr x sign(g) and an element whose gradient is near the
epsilon moves by up to twice lr between two correct runs.

Run ``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_train.py
--write-golden`` to regenerate ``src/repro_torch/golden/train_full_width.json``
(about a minute of CPU): the reference's run of
``repro_torch.launch.train_golden`` (qwen3-0.6b at full width cut to 2
layers, float32, seeded weights, 3 AdamW steps), which the CPU test and
``chip_smoke.py`` hold the port to.  ``--write-golden --arch rwkv6_3b``
writes ``train_rwkv_full_width.json``, the same run of rwkv6-3b at full
width cut to 2 layers (its WKV through the plain forward and backward on
the CPU, through the two kernels in ``chip_smoke.py``'s phase 12).
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train_golden as TG  # noqa: E402
from repro_torch.models import LM, convert, layers  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ("qwen3_0p6b", "llama3p2_1b", "stablelm_1p6b", "yi_34b",
         "rwkv6_3b", "zamba2_1p2b", "dbrx_132b", "llama4_maverick_400b",
         "llama3p2_vision_11b", "hubert_xlarge")
F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S = 4, 16
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=5)


def pair(cfg, seed=0):
    """(JAX params, trainable port LM on the CPU) with the reference's
    init; the vlm family's cross-block gates (0 at init) set non-zero in
    both."""
    params = JLM(cfg).init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, params)
    if cfg.family == "vlm":
        cross = tree["cross_blocks"]
        n = cross["gate_attn"].shape[0]
        cross["gate_attn"] = np.linspace(0.3, 0.9, n, dtype=np.float32)
        cross["gate_mlp"] = np.linspace(0.9, 0.3, n, dtype=np.float32)
        params = jax.tree.map(jnp.asarray, tree)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(convert.params_from_jax(cfg, tree))
    return params, layers.trainable(lm)


def batches(cfg, shape=(B, S), seed=1, mask=True):
    """(the reference's batch, the port's): tokens (the audio family's
    frames in their place, the vlm family's image tokens beside them),
    labels, and a loss mask with a few zeros."""
    rng = np.random.default_rng([seed, 3])
    arrays = {"labels": rng.integers(0, cfg.vocab, shape, dtype=np.int32)}
    if cfg.family == "audio":
        arrays["frames"] = rng.standard_normal((*shape, cfg.d_model),
                                               dtype=np.float32)
    else:
        arrays["tokens"] = rng.integers(0, cfg.vocab, shape, dtype=np.int32)
    if cfg.family == "vlm":
        arrays["img"] = rng.standard_normal(
            (shape[0], cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
    if mask:
        arrays["loss_mask"] = (rng.random(shape) > 0.2).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for k in ("tokens", "labels"):
        if k in tb:
            tb[k] = tb[k].long()
    return {k: jnp.asarray(v) for k, v in arrays.items()}, tb


def flat(tree, prefix=()):
    """``{path: numpy}`` of a nested dict, float32."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(jnp.asarray(v, jnp.float32))
    return out


def close_leaves(got: dict, want, tol=LEAF_TOL, what="grad"):
    """Every leaf of the reference's tree ``want`` against the port's
    ``got`` (the same paths): within ``tol`` of the leaf's largest
    magnitude (at least 1e-6)."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        w, g = want[path], got[path]
        scale = max(1e-6, float(np.abs(w).max()) if w.size else 0.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * scale, \
            f"{what} {'/'.join(path)}: max abs err {err} > {tol} x {scale}"


def cfg_of(arch, **kw):
    return configs.get_smoke(arch).with_(**F32, **kw)


@pytest.mark.parametrize("arch,policies", [
    ("qwen3_0p6b", ("full", "dots")), ("dbrx_132b", ("full", "dots")),
    ("llama4_maverick_400b", ("full",)), ("llama3p2_vision_11b", ("full",)),
    ("rwkv6_3b", ("full", "dots")), ("zamba2_1p2b", ("full", "dots")),
    ("hubert_xlarge", ("dots",))])
def test_remat_policies_bit_equal(arch, policies):
    """Every remat policy gives the bits of ``"nothing"``: the recompute
    runs the same operations on the same inputs (flash's forward, run
    twice under ``"full"``, gives the same output and logsumexp)."""
    cfg = configs.get_smoke(arch).with_(**F32, remat_policy="nothing")
    _, lm = pair(cfg)
    _, tb = batches(cfg, seed=7)
    loss, m, grads = tsteps.loss_and_grads(lm, tb)
    for policy in policies:
        other = layers.trainable(LM(cfg.with_(remat_policy=policy),
                                    device="cpu"))
        other.load_state_dict(lm.state_dict())
        l2, m2, g2 = tsteps.loss_and_grads(other, tb)
        assert torch.equal(loss, l2), policy
        for k, v in grads.items():
            assert torch.equal(v, g2[k]), (policy, k)


def test_grad_accumulation_matches_full_batch():
    """``accum = 2`` against the full batch (the twin of
    tests/test_system.py::test_grad_accumulation_matches_full_batch),
    and against the reference's ``accum = 2``: with equal token counts per
    microbatch the mean of the microbatch losses is the batch loss and the
    mean of their gradients its gradient, up to float32 rounding."""
    cfg = cfg_of("qwen3_0p6b")
    params, lm = pair(cfg)
    jb, tb = batches(cfg, shape=(8, 16), seed=2, mask=False)
    state0 = {k: v.clone() for k, v in lm.state_dict().items()}
    s1 = tsteps.make_train_step(lm, adamw.AdamWConfig(**OPT), accum=1)
    s2 = tsteps.make_train_step(lm, adamw.AdamWConfig(**OPT), accum=2)
    _, o1, m1 = s1(lm, adamw.init(dict(lm.named_parameters())), tb)
    p1 = {k: v.clone() for k, v in lm.state_dict().items()}
    lm.load_state_dict(state0)
    _, o2, m2 = s2(lm, adamw.init(dict(lm.named_parameters())), tb)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for k in o1.m:
        torch.testing.assert_close(o2.m[k], o1.m[k], atol=1e-7, rtol=1e-4)
    for k, v in lm.state_dict().items():
        torch.testing.assert_close(v, p1[k], atol=2.5 * OPT["peak_lr"],
                                   rtol=0)
    jstep = jax.jit(jsteps.make_train_step(cfg, jadamw.AdamWConfig(**OPT),
                                           accum=2))
    _, _, jm = jstep(params, jadamw.init(params), jb)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_non_finite_loss_applies_nothing():
    """A step whose loss is not finite leaves the parameters, the moments,
    the master weights and the step counter as they were, and says so."""
    cfg = cfg_of("qwen3_0p6b")
    _, lm = pair(cfg)
    _, tb = batches(cfg)
    step = tsteps.make_train_step(lm, adamw.AdamWConfig(**OPT))
    state = adamw.init(dict(lm.named_parameters()))
    lm, state, m = step(lm, state, tb)          # one real step first
    assert not m.get("skipped") and int(state.step) == 1
    before = ({k: v.clone() for k, v in lm.state_dict().items()},
              *({k: v.clone() for k, v in t.items()}
                for t in (state.m, state.v, state.master)))
    with torch.no_grad():
        lm.ln_f.fill_(float("nan"))
    bad = {k: v.clone() for k, v in lm.state_dict().items()}
    lm, state2, m = step(lm, state, tb)
    assert m["skipped"] and not np.isfinite(float(m["loss"]))
    assert int(state2.step) == 1
    for k, v in lm.state_dict().items():
        assert torch.equal(v, bad[k]) or (torch.isnan(v).all()
                                          and torch.isnan(bad[k]).all()), k
    for got, want in zip((state2.m, state2.v, state2.master), before[1:]):
        for k in want:
            assert torch.equal(got[k], want[k]), k


# ----------------------------------------------------------------- golden

def test_full_width_golden():
    """The port's CPU run of ``train_golden`` (qwen3-0.6b at full width, 2
    layers, float32, 3 AdamW steps) against the reference's golden, within
    its tolerance (1e-4 relative)."""
    hold_golden("qwen3_0p6b")


def test_rwkv_full_width_golden():
    """The same for rwkv6-3b at full width, 2 layers: its WKV forward and
    backward through ``ops.wkv_chunked``'s ``_WKV`` (the plain versions on
    the CPU), against the reference's autodiff of its chunk scan."""
    hold_golden("rwkv6_3b")


def hold_golden(arch):
    gold = json.loads(TG.GOLDENS[arch].read_text())
    assert gold["run"] == TG.run_record(arch)

    def checked_tree():
        tree = convert.random_jax_tree(TG.golden_config(arch), TG.SEED)
        assert convert.tree_sha256(tree) == gold["weights_sha256"]
        return tree
    # the weights' only reference goes to port_run, which frees them once
    # loaded (rwkv6-3b's 2 layers hold 2.1 GB of them)
    check_golden(TG.port_run("cpu", checked_tree(), arch), gold)


def check_golden(got, gold):
    rtol = gold["tolerance"]["rtol"]
    want = gold["record"]
    for k in ("loss0", "ce0", "grad_norm0"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert sorted(got["leaf_grad_norms"]) == sorted(want["leaf_grad_norms"])
    for k, w in want["leaf_grad_norms"].items():
        np.testing.assert_allclose(got["leaf_grad_norms"][k], w, rtol=rtol,
                                   err_msg=k)


def jax_run(tree, arch) -> dict:
    """The reference's side of ``train_golden.port_run``."""
    cfg = jconfigs.get(arch).with_(n_layers=TG.LAYERS, **F32)
    params = jax.tree.map(jnp.asarray, tree)
    jlm = JLM(cfg)
    batches_ = [{k: jnp.asarray(v) for k, v in h.items()}
                for h in TG.host_batches(TG.golden_config(arch))]
    (loss, m), g = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        params, batches_[0])
    leaf = {"/".join(p): float(np.sqrt(np.sum(np.asarray(v, np.float64)
                                              ** 2)))
            for p, v in sorted(flat(g).items())}
    out = {"loss0": float(loss), "ce0": float(m["ce"]),
           "grad_norm0": float(jadamw.global_norm(g)),
           "leaf_grad_norms": leaf}
    step = jax.jit(jsteps.make_train_step(cfg, jadamw.AdamWConfig(**TG.OPT)))
    opt = jadamw.init(params)
    rec = {"loss": [], "ce": [], "grad_norm": []}
    for b in batches_:
        params, opt, sm = step(params, opt, b)
        for k in rec:
            rec[k].append(float(sm[k]))
    return {**out, **rec}


DESCRIPTIONS = {
    "qwen3_0p6b": "qwen3-0.6b at its published width cut to 2 layers",
    "rwkv6_3b": "rwkv6-3b at its published width (d 2,560, d_ff 8,960, "
                "vocab 65,536, 40 WKV heads of 64 padded to 48) cut to 2 "
                "layers"}


def write_golden(arch):
    t0 = time.perf_counter()
    cfg = TG.golden_config(arch)
    tree = convert.random_jax_tree(cfg, TG.SEED)
    sha = convert.tree_sha256(tree)
    want = jax_run(tree, arch)
    got = TG.port_run("cpu", tree, arch)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    err = max([rel(got[k], want[k]) for k in want if k != "leaf_grad_norms"]
              + [rel(got["leaf_grad_norms"][k], v)
                 for k, v in want["leaf_grad_norms"].items()])
    gold = {
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                   "tests/test_torch_train.py --write-golden"
                   + ("" if arch == TG.ARCH else f" --arch {arch}"),
        "jax": jax.__version__, "torch": torch.__version__,
        "cpu_seconds": round(time.perf_counter() - t0, 1),
        "run": TG.run_record(arch),
        "weights_sha256": sha,
        "description": f"{DESCRIPTIONS[arch]}, "
                       "float32, seeded weights (convert.random_jax_tree), "
                       "SyntheticLM batches of 2 x 128: step 0's loss, ce, "
                       "global and per-leaf gradient norms, then 3 AdamW "
                       "steps (warmup 2, cosine to 3, clipping at 1) with "
                       "each step's loss, ce and grad_norm",
        "tolerance": {"rtol": 1e-4, "cpu_max_rel_err": err,
                      "how": "every recorded number within rtol of the "
                             "reference's; the port's float32 run on the "
                             "CPU (plain kernel versions) showed "
                             "cpu_max_rel_err"},
        "record": want,
    }
    TG.GOLDENS[arch].write_text(json.dumps(gold, indent=1) + "\n")
    print(f"port on the CPU vs the reference: max rel err {err:.3g} "
          f"({time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--write-golden" in args:
        arch = args[args.index("--arch") + 1] if "--arch" in args \
            else TG.ARCH
        write_golden(arch)
        print(f"wrote {TG.GOLDENS[arch]}")
    else:
        sys.exit("usage: python tests/test_torch_train.py --write-golden "
                 "[--arch rwkv6_3b]")
