"""The port's cross-attention, gated cross block and non-causal encoder
attention (``repro_torch.models.attention``, ``repro_torch.models.
transformer``) against the JAX reference, on the CPU, in float32 within
1e-5 (absolute and relative: sums taken in another order).

* cross-attention over a source of another length (the image tokens):
  k and v projected from the source, no RoPE, qk-norm, KV heads
  repeated, no mask, through the flash kernel's plain version;
* the gated cross block with non-zero gates (0 at init, where the block
  passes its input through);
* the ``kv_override`` decode branch against seeded keys and values;
* hubert's non-causal full-sequence attention (``cfg.causal=False``).

The vlm and audio models' prefill and decode against the reference run
in ``tests/test_torch_lm.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5


def np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def vision_cfg(**kw):
    """The vision smoke config in float32 with qk-norm on (the published
    config has none; the cross branch applies it as configured)."""
    return configs.get_smoke("llama3p2_vision_11b").with_(**F32, **kw)


def attn_pair(cfg, seed):
    """(the reference's attention params, the port's Attention)."""
    p = jattn.attn_init(jax.random.PRNGKey(seed), cfg, cross=True)
    att = tattn.Attention(cfg, "cpu")
    att.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    return p, att


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_cross_attention_matches_reference(kv_repeat, qk_norm):
    cfg = vision_cfg(qk_norm=qk_norm)
    p, att = attn_pair(cfg, 1)
    x = normal((2, 12, cfg.d_model), 2)
    img = normal((2, cfg.n_img_tokens, cfg.d_model), 3)
    pos = np.arange(12, dtype=np.int32)
    y, cache = tattn.attention(att, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos), kv_repeat=kv_repeat,
                               xs=torch.from_numpy(img))
    jy, _ = jattn.attention(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                            kv_repeat=kv_repeat, xs=jnp.asarray(img))
    assert cache is None
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_kv_override_decode_matches_reference(qk_norm):
    """One token against seeded keys and values ``[B, T, H_eff, Dh]``, at
    a position whose RoPE would move q (kv_override applies none)."""
    cfg = vision_cfg(qk_norm=qk_norm)
    p, att = attn_pair(cfg, 4)
    h = cfg.n_kv_heads * cfg.kv_repeat
    x = normal((2, 1, cfg.d_model), 5)
    k = normal((2, cfg.n_img_tokens, h, cfg.head_dim), 6)
    v = normal((2, cfg.n_img_tokens, h, cfg.head_dim), 7)
    pos = np.asarray([37], np.int32)
    y, cache = tattn.attention(att, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos),
                               kv_override=(torch.from_numpy(k),
                                            torch.from_numpy(v)))
    jy, _ = jattn.attention(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                            kv_override=(jnp.asarray(k), jnp.asarray(v)))
    assert cache is None
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("gates", [(0.0, 0.0), (0.4, -0.7)])
def test_cross_block_matches_reference(gates):
    """The gated cross block: zero gates pass the input through exactly,
    non-zero ones run both gated residuals."""
    cfg = vision_cfg()
    p = jtf.cross_block_init(jax.random.PRNGKey(8), cfg)
    p = jax.tree.map(np.array, p)
    p["gate_attn"] = np.float32(gates[0])
    p["gate_mlp"] = np.float32(gates[1])
    blk = ttf.CrossBlock(cfg, "cpu")
    flat = {}
    for key, val in p.items():
        if isinstance(val, dict):
            flat.update({f"{key}.{k}": v for k, v in val.items()})
        else:
            flat[key] = val
    blk.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in flat.items()})
    x = normal((2, 12, cfg.d_model), 9)
    img = normal((2, cfg.n_img_tokens, cfg.d_model), 10)
    pos = np.arange(12, dtype=np.int32)
    y = ttf.cross_block(blk, cfg, torch.from_numpy(x),
                        torch.from_numpy(img), torch.from_numpy(pos))
    jy = jtf.cross_block(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x),
                         jnp.asarray(img), jnp.asarray(pos))
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=TOL, rtol=TOL)
    if gates == (0.0, 0.0):
        np.testing.assert_array_equal(y.numpy(), x)
    else:
        assert float(np.abs(y.numpy() - x).max()) > 0.1


def test_non_causal_attention_matches_reference():
    """hubert's encoder attention: every query sees every key, the later
    ones included (a causal mask would change the first rows)."""
    cfg = configs.get_smoke("hubert_xlarge").with_(**F32)
    assert not cfg.causal
    p = jattn.attn_init(jax.random.PRNGKey(11), cfg)
    att = tattn.Attention(cfg, "cpu")
    att.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    x = normal((2, 20, cfg.d_model), 12)
    pos = np.arange(20, dtype=np.int32)
    y, _ = tattn.attention(att, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    jy, _ = jattn.attention(p, cfg, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=TOL, rtol=TOL)
    causal, _ = tattn.attention(att, cfg.with_(causal=True),
                                torch.from_numpy(x), torch.from_numpy(pos))
    assert float((causal[:, 0] - y[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", ["non-causal", "cross"])
def test_sliding_window_masks_only_causal_self_attention(kind):
    """A sliding window narrower than the sequence changes nothing for a
    non-causal self-attention or a cross-attention: the reference takes
    no mask at all for either (``cross or not cfg.causal``)."""
    if kind == "cross":
        cfg = vision_cfg(sliding_window=4)
        p, att = attn_pair(cfg, 13)
        xs = normal((2, cfg.n_img_tokens, cfg.d_model), 14)
    else:
        cfg = configs.get_smoke("hubert_xlarge").with_(**F32,
                                                       sliding_window=4)
        p = jattn.attn_init(jax.random.PRNGKey(13), cfg)
        att = tattn.Attention(cfg, "cpu")
        att.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in p.items()})
        xs = None
    x = normal((2, 20, cfg.d_model), 15)
    pos = np.arange(20, dtype=np.int32)
    y, _ = tattn.attention(att, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos),
                           xs=None if xs is None else torch.from_numpy(xs))
    jy, _ = jattn.attention(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                            xs=None if xs is None else jnp.asarray(xs))
    np.testing.assert_allclose(y.numpy(), np32(jy), atol=TOL, rtol=TOL)
    free, _ = tattn.attention(att, cfg.with_(sliding_window=0),
                              torch.from_numpy(x), torch.from_numpy(pos),
                              xs=None if xs is None else torch.from_numpy(xs))
    np.testing.assert_array_equal(y.numpy(), free.numpy())
