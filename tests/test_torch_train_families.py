"""Every family's training step against the JAX reference on the CPU: the
twin of ``tests/test_torch_lm.py`` for ``LM.loss``, its gradients and one
``make_train_step``, each family's smoke config in float32, with the
helpers and tolerances of ``tests/test_torch_train.py``; and the
chunked cross-entropy (``ce_chunk``) against the reference's checkpointed
scan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_train import (ARCHS, LOSS_RTOL, OPT, JLM, adamw,  # noqa: E402
                              batches, cfg_of, close_leaves, convert, flat,
                              jadamw, layers, LM, pair, tsteps)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_one_step_match_reference(arch):
    """``LM.loss`` and its gradients, then one ``make_train_step``: the
    loss, ce, aux and token count, every gradient leaf, the step's
    metrics and the optimizer's moments leaf by leaf, its master
    weights within the sign-flip bound."""
    cfg = cfg_of(arch)
    params, lm = pair(cfg)
    jb, tb = batches(cfg)
    opt_cfg = jadamw.AdamWConfig(**OPT)
    jlm = JLM(cfg)

    @jax.jit
    def ref(params, batch):
        # the reference's make_train_step at accum = 1, its two calls kept
        # apart so that the gradients come out too (one compile)
        (loss, m), g = jax.value_and_grad(jlm.loss, has_aux=True)(params,
                                                                  batch)
        _, opt, om = jadamw.update(opt_cfg, g, jadamw.init(params), params)
        return loss, m, g, opt, dict(m, loss=loss, **om)

    loss, m, g, jopt, jm = ref(params, jb)
    got_loss, got_m, grads = tsteps.loss_and_grads(lm, tb)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_RTOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(got_m[k]), float(m[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    close_leaves(convert.tree_from_port(cfg, grads), g)

    step = tsteps.make_train_step(lm, adamw.AdamWConfig(**OPT))
    state = adamw.init(dict(lm.named_parameters()))
    lm, state, sm = step(lm, state, tb)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(sm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(state.step) == int(jopt.step) == 1
    close_leaves(convert.tree_from_port(cfg, state.m), jopt.m, what="m")
    close_leaves(convert.tree_from_port(cfg, state.v), jopt.v, what="v")
    got_w = flat(convert.tree_from_port(cfg, state.master))
    for path, w in flat(jopt.master).items():
        np.testing.assert_allclose(got_w[path], w, rtol=0,
                                   atol=2.5 * OPT["peak_lr"],
                                   err_msg="/".join(path))
    got_p = flat(convert.tree_from_port(cfg, dict(lm.named_parameters())))
    for path, w in got_w.items():
        np.testing.assert_array_equal(got_p[path], w)


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "llama3p2_vision_11b"])
def test_chunked_ce_matches_reference(arch):
    """``ce_chunk`` (the checkpointed per-chunk CE) with a loss mask:
    loss and gradients against the reference's chunked scan, and equal
    to the unchunked port."""
    cfg = cfg_of(arch, ce_chunk=4)
    params, lm = pair(cfg)
    jb, tb = batches(cfg, seed=5)
    (loss, m), g = jax.jit(jax.value_and_grad(JLM(cfg).loss, has_aux=True))(
        params, jb)
    got_loss, got_m, grads = tsteps.loss_and_grads(lm, tb)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_RTOL)
    assert float(got_m["tokens"]) == float(m["tokens"])
    close_leaves(convert.tree_from_port(cfg, grads), g)
    whole = layers.trainable(LM(cfg.with_(ce_chunk=0), device="cpu"))
    whole.load_state_dict(lm.state_dict())
    w_loss, _, w_grads = tsteps.loss_and_grads(whole, tb)
    np.testing.assert_allclose(float(got_loss), float(w_loss), rtol=1e-6)
    for k, v in grads.items():
        torch.testing.assert_close(v, w_grads[k], atol=1e-6, rtol=1e-5)


