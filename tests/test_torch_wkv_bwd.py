"""The backward of the port's chunked WKV on the CPU: the plain version
``repro_torch.kernels.ref.wkv_chunked_bwd_ref`` (what ``kernels.ops.
wkv_chunked``'s ``_WKV`` runs on CPU tensors, and what ``csrc/wkv_bwd.cu``
is held to on the card) against

* float64 autograd of the step-by-step WKV recurrence (``recurrence64``,
  the gold semantics of ``ref.wkv_ref`` in float64, no chunks): within
  ``F64_TOL`` = 2e-5 of each gradient's largest magnitude (float32 sums
  over up to 256 steps against float64);
* ``jax.vjp`` of the reference model's chunk scan
  (``repro.models.rwkv.wkv_chunked``) on the model's ``[B, S, H*D]``
  tensors, with and without an initial state and a final-state
  cotangent: within ``JAX_TOL`` = 2e-5 of the largest magnitude (both
  float32, sums in another order).

Shapes: ``tests/test_torch_wkv.py``'s ``inputs`` at its shapes, plus a
chunk of 1 and of 128, padded dead heads (zero r, k, v) and strong decay
(|log w| near 2.5 a step at a chunk of 64, the reference's own limit for
its centring).  ``ops.wkv_chunked`` under grad goes through ``_WKV`` and
gives the same gradients, with a gradient of only the output or only
the final state.

``wkv_bwd_twin`` is a torch twin of the kernel's order of operations: the
prefix by channel in segments of 256 / D threads, r' and k' as the
forward makes them, the reverse scan of dlog w's sums as 8 rows a thread
and then the later row groups' totals, gL's two parts summed by row
group; it is within ``JAX_TOL`` of the plain version, so the kernel's
order is no source of error beyond it.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

from test_torch_wkv import inputs, to_bsd  # noqa: E402

F64_TOL = 2e-5
JAX_TOL = 2e-5
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "dstate0")

# test_torch_wkv.py's shapes (b, h, s, dk, chunk, dead), a chunk of 1 and
# of 128
SHAPES = [(1, 2, 64, 16, 16, 0), (2, 3, 128, 32, 64, 0),
          (1, 1, 256, 64, 64, 0), (2, 2, 96, 16, 32, 0),
          (1, 3, 48, 32, 16, 0), (1, 2, 256, 64, 128, 0),
          (2, 4, 64, 16, 32, 1), (1, 2, 8, 16, 1, 0), (1, 2, 8, 64, 1, 0),
          (2, 3, 128, 16, 128, 0)]


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small torch ops (a recurrence step by step, a
    chunk loop): one intra-op thread keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def strong(b, h, s, dk, seed=9):
    """``inputs`` with |log w| near 2.5 a step (2.5 e^{0.05 N})."""
    r, k, v, _, u = inputs(b, h, s, dk, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lw = -2.5 * np.exp(rng.standard_normal((b, h, s, dk)) * 0.05)
    return r, k, v, lw.astype(np.float32), u


def extras(b, h, dk, seed):
    """A seeded initial state and final-state cotangent, and the output's
    cotangent maker."""
    rng = np.random.default_rng(seed)
    s0 = rng.standard_normal((b, h, dk, dk), dtype=np.float32) * 0.1
    ds = rng.standard_normal((b, h, dk, dk), dtype=np.float32)
    return s0, ds, rng


def recurrence64(r, k, v, log_w, u, state0):
    """The WKV recurrence step by step in float64: r/k/v/log_w ``[B, H,
    S, D]``, u ``[H, D]`` -> (out, final state)."""
    state = state0
    w = torch.exp(log_w)
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, :, t, :, None] * state + kv
    return torch.stack(outs, 2), state


def plain_bwd(x, chunk, s0, go, ds):
    """``wkv_chunked_bwd_ref`` on float32 inputs from the plain forward's
    states."""
    r, k, v, lw, u = (torch.from_numpy(a) for a in x)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    _, _, states = ref.wkv_chunked_ref(r, k, v, lw, u, chunk=chunk,
                                       state0=ts0, return_states=True)
    return ref.wkv_chunked_bwd_ref(
        r, k, v, lw, u, states, torch.from_numpy(go),
        None if ds is None else torch.from_numpy(ds), chunk=chunk)


def close(got, want, tol, names=NAMES):
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        scale = max(1e-30, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


def f64_grads(x, s0, go, ds):
    """float64 autograd of ``recurrence64``: (dr, dk, dv, dlog_w, du,
    dstate0 or None)."""
    ts = [torch.from_numpy(a).double().requires_grad_() for a in x]
    s064 = (torch.zeros(ts[0].shape[:2] + (ts[0].shape[3],) * 2,
                        dtype=torch.float64) if s0 is None
            else torch.from_numpy(s0).double().requires_grad_())
    out, st = recurrence64(*ts, s064)
    loss = (out * torch.from_numpy(go).double()).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds).double()).sum()
    wrt = ts + ([s064] if s0 is not None else [])
    grads = torch.autograd.grad(loss, wrt)
    return list(grads) + ([None] if s0 is None else [])


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state0+dstate"])
@pytest.mark.parametrize("b,h,s,dk,chunk,dead", SHAPES)
def test_plain_bwd_matches_float64_autograd(b, h, s, dk, chunk, dead,
                                            with_state):
    x = inputs(b, h, s, dk, seed=s + dk + chunk, dead=dead)
    s0, ds, rng = extras(b, h, dk, seed=chunk)
    if not with_state:
        s0 = ds = None
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    got = plain_bwd(x, chunk, s0, go, ds)
    close(got, f64_grads(x, s0, go, ds), F64_TOL)
    if dead and not with_state:          # zero r, k, v and no state
        for g in got[:4]:
            assert not g[:, h - dead:].any()


def test_plain_bwd_strong_decay_matches_float64_autograd():
    """|log w| near 2.5 a step at a chunk of 64: e^{c} near e^{-80},
    where the centring keeps every exponential finite."""
    x = strong(1, 2, 256, 64)
    s0, ds, rng = extras(1, 2, 64, seed=3)
    go = rng.standard_normal((1, 2, 256, 64), dtype=np.float32)
    got = plain_bwd(x, 64, s0, go, ds)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    close(got, f64_grads(x, s0, go, ds), F64_TOL)


def jax_vjp(x, chunk, s0, go, ds):
    """``jax.vjp`` of the reference model's ``wkv_chunked`` on ``[B, S,
    H*D]`` tensors, back in ``[B, H, S, D]`` (du as ``[H, D]``)."""
    r, k, v, lw, u = x
    b, h, s, dk = r.shape
    args = [jnp.asarray(to_bsd(a)) for a in (r, k, v, lw)] + \
        [jnp.asarray(u.reshape(-1))]
    if s0 is not None:
        args.append(jnp.asarray(s0))

    def f(*a):
        return jrwkv.wkv_chunked(*a[:5], dk, state0=a[5] if len(a) > 5
                                 else None, chunk=chunk)
    (out, st), vjp = jax.vjp(f, *args)
    cot = (jnp.asarray(to_bsd(go)),
           jnp.zeros_like(st) if ds is None else jnp.asarray(ds))
    grads = vjp(cot)

    def heads(g):
        return np.asarray(g).reshape(b, s, h, dk).transpose(0, 2, 1, 3)
    out = [heads(g) for g in grads[:4]] + [np.asarray(grads[4]).reshape(
        h, dk)]
    return out + ([np.asarray(grads[5])] if s0 is not None else [None])


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state0+dstate"])
@pytest.mark.parametrize("b,h,s,dk,chunk,dead", SHAPES)
def test_plain_bwd_matches_jax_vjp(b, h, s, dk, chunk, dead, with_state):
    x = inputs(b, h, s, dk, seed=2 * s + dk, dead=dead)
    s0, ds, rng = extras(b, h, dk, seed=s)
    if not with_state:
        s0 = ds = None
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    close(plain_bwd(x, chunk, s0, go, ds), jax_vjp(x, chunk, s0, go, ds),
          JAX_TOL)


def test_plain_bwd_strong_decay_matches_jax_vjp():
    x = strong(2, 2, 128, 32, seed=4)
    s0, ds, rng = extras(2, 2, 32, seed=5)
    go = rng.standard_normal((2, 2, 128, 32), dtype=np.float32)
    close(plain_bwd(x, 64, s0, go, ds), jax_vjp(x, 64, s0, go, ds),
          JAX_TOL)


@pytest.mark.parametrize("which", ["out and state", "out", "state"])
@pytest.mark.parametrize("b,h,s,dk,chunk,dead", [SHAPES[1], SHAPES[5],
                                                 SHAPES[6], SHAPES[7]])
def test_ops_wkv_chunked_differentiates_through_its_function(
        b, h, s, dk, chunk, dead, which):
    """``ops.wkv_chunked`` under grad on CPU tensors: ``_WKV`` (its
    backward node), with an initial state, the gradient of the output,
    of the final state or of both (autograd gives None for the other),
    against ``jax.vjp``."""
    x = inputs(b, h, s, dk, seed=3 * s + dk, dead=dead)
    s0, ds, rng = extras(b, h, dk, seed=dk)
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    if which == "out":
        ds = None
    if which == "state":
        go = np.zeros_like(go)
    ts = [torch.from_numpy(a).requires_grad_() for a in x + (s0,)]
    out, st = ops.wkv_chunked(*ts[:5], chunk=chunk, state0=ts[5])
    assert type(out.grad_fn).__name__ == "_WKVBackward"
    loss = 0.0
    if which != "state":
        loss = (out * torch.from_numpy(go)).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds)).sum()
    got = torch.autograd.grad(loss, ts)
    close(got, jax_vjp(x, chunk, s0, go, ds), JAX_TOL)


def test_model_wkv_gradient_reaches_u_and_the_dead_heads():
    """The model's ``wkv_chunked`` (``[B, S, H*D]`` views, u reshaped to
    ``[H, D]``) under grad: every input's gradient, u's included (over
    every head, a padded dead one too), against ``jax.vjp`` of the
    reference's."""
    from repro_torch.models import rwkv as trwkv
    b, h, s, dk, chunk = 2, 4, 128, 16, 32
    x = inputs(b, h, s, dk, seed=11, dead=1)
    s0, ds, rng = extras(b, h, dk, seed=12)
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    ts = [torch.from_numpy(to_bsd(a)).requires_grad_() for a in x[:4]]
    tu = torch.from_numpy(x[4].reshape(-1)).requires_grad_()
    ts0 = torch.from_numpy(s0).requires_grad_()
    out, st = trwkv.wkv_chunked(*ts, tu, dk, state0=ts0, chunk=chunk)
    loss = (out * torch.from_numpy(to_bsd(go))).sum() + \
        (st * torch.from_numpy(ds)).sum()
    got = torch.autograd.grad(loss, ts + [tu, ts0])
    want = jax_vjp(x, chunk, s0, go, ds)
    got = [g.numpy().reshape(b, s, h, dk).transpose(0, 2, 1, 3)
           for g in got[:4]] + [got[4].numpy().reshape(h, dk),
                                got[5].numpy()]
    close(got, want, JAX_TOL)
    # u's gradient covers every head: 0 where r, k, v are (a dead head)
    assert got[4].shape == (h, dk) and not got[4][h - 1].any() \
        and got[4][0].any()


# ------------------------------------------------------------------ twin

SEG_THREADS = 256          # the kernel's CTA
ROWS = 128                 # its rows a chunk (C padded to 128)


def segment_cumsum(w):
    """The kernel's prefix of a chunk ``[..., C, D]``: each channel in
    256 / D segments of 128 / (256 / D) rows, each segment summed in
    order, then the earlier segments' totals added in order.  Returns
    (cum, cum_last)."""
    c, d = w.shape[-2], w.shape[-1]
    nseg = SEG_THREADS // d
    rps = ROWS // nseg
    x = torch.nn.functional.pad(w, (0, 0, 0, ROWS - c))
    segs = [x[..., i * rps:(i + 1) * rps, :].cumsum(-2) for i in
            range(nseg)]
    tot = [sg[..., -1:, :] for sg in segs]
    out, acc = [], torch.zeros_like(tot[0])
    for sg, t in zip(segs, tot):
        out.append(sg + acc)
        acc = acc + t
    return torch.cat(out, -2)[..., :c, :], acc


def grouped_suffix(hs):
    """The kernel's reverse scan of ``[..., C, D]`` over the rows: within
    each group of 8 rows from the last up, then the later groups' totals
    added from the last group down."""
    c = hs.shape[-2]
    x = torch.nn.functional.pad(hs, (0, 0, 0, ROWS - c))
    groups = [x[..., g * 8:(g + 1) * 8, :].flip(-2).cumsum(-2).flip(-2)
              for g in range(ROWS // 8)]
    out = []
    for g in range(ROWS // 8):
        later = torch.zeros_like(groups[g][..., :1, :])
        for g2 in range(ROWS // 8 - 1, g, -1):
            later = later + groups[g2][..., :1, :]
        out.append(groups[g] + later)
    return torch.cat(out, -2)[..., :c, :]


def wkv_bwd_twin(r, k, v, log_w, u, states, dout, dstate, chunk):
    """``csrc/wkv_bwd.cu``'s order of operations on float32 ``[B, H, S,
    D]`` tensors (the products as matrix products: their sums run in
    another order on the card, as in the plain version)."""
    b, h, s, d = r.shape
    uu = u[None, :, None, :]
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril(-1)
    g = torch.zeros((b, h, d, d)) if dstate is None else dstate.clone()
    out = {n: [] for n in ("dr", "dk", "dv", "dw")}
    du = torch.zeros((b, h, d))
    for ci in reversed(range(s // chunk)):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        rq, kq, vq, wq, go = (x[:, :, sl] for x in (r, k, v, log_w, dout))
        st = states[:, :, ci]
        cum, last = segment_cumsum(wq)
        c = last * 0.5
        ec, el = torch.exp(c).transpose(-1, -2), torch.exp(last)
        rp = rq * torch.exp((cum - wq) - c)
        kp = kq * torch.exp(c - cum)
        ru = ((rq * uu) * kq).sum(-1, keepdim=True)
        dru = (go * vq).sum(-1, keepdim=True)
        gm = ec * g
        a = torch.where(tril, rp @ kp.transpose(-1, -2), 0.0)
        out["dv"].append(a.transpose(-1, -2) @ go + ru * go + kp @ gm)
        da = torch.where(tril, go @ vq.transpose(-1, -2), 0.0)
        acc2 = vq @ gm.transpose(-1, -2)
        dk_pre = da.transpose(-1, -2) @ rp + acc2
        gcum = -(kp * dk_pre)
        part2 = torch.nn.functional.pad(kp * acc2, (0, 0, 0, ROWS - chunk))
        gl2 = sum(part2[..., i * 8:(i + 1) * 8, :].sum(-2, keepdim=True)
                  for i in range(ROWS // 8))
        out["dk"].append(torch.exp(c - cum) * dk_pre + (dru * uu) * rq)
        sm = ec * st
        gl1 = ((el.transpose(-1, -2) * st) * g).sum(-1)[:, :, None]
        dr_pre = da @ kp + go @ sm.transpose(-1, -2)
        gce = rp * dr_pre
        out["dr"].append(torch.exp((cum - wq) - c) * dr_pre
                         + (dru * uu) * kq)
        du += ((dru * rq) * kq).sum(2)
        hs = gcum + torch.nn.functional.pad(gce[:, :, 1:], (0, 0, 0, 1))
        out["dw"].append(grouped_suffix(hs) + (gl1 + gl2))
        g = el.transpose(-1, -2) * g + ec * (rp.transpose(-1, -2) @ go)
    dr, dk, dv, dw = (torch.cat(out[n][::-1], 2)
                      for n in ("dr", "dk", "dv", "dw"))
    return dr, dk, dv, dw, du.sum(0), g


@pytest.mark.parametrize("b,h,s,dk,chunk,dead", SHAPES)
def test_kernel_order_twin_matches_plain(b, h, s, dk, chunk, dead):
    x = inputs(b, h, s, dk, seed=s + 5 * dk, dead=dead)
    s0, ds, rng = extras(b, h, dk, seed=7)
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    r, k, v, lw, u = (torch.from_numpy(a) for a in x)
    _, _, states = ref.wkv_chunked_ref(r, k, v, lw, u, chunk=chunk,
                                       state0=torch.from_numpy(s0),
                                       return_states=True)
    twin = wkv_bwd_twin(r, k, v, lw, u, states, torch.from_numpy(go),
                        torch.from_numpy(ds), chunk)
    close(twin, plain_bwd(x, chunk, s0, go, ds), JAX_TOL)


def test_kernel_order_twin_strong_decay():
    x = strong(1, 2, 256, 64, seed=13)
    s0, ds, rng = extras(1, 2, 64, seed=14)
    go = rng.standard_normal((1, 2, 256, 64), dtype=np.float32)
    r, k, v, lw, u = (torch.from_numpy(a) for a in x)
    _, _, states = ref.wkv_chunked_ref(r, k, v, lw, u, chunk=64,
                                       state0=torch.from_numpy(s0),
                                       return_states=True)
    twin = wkv_bwd_twin(r, k, v, lw, u, states, torch.from_numpy(go),
                        torch.from_numpy(ds), 64)
    close(twin, f64_grads(x, s0, go, ds), F64_TOL)


def test_forward_states_are_the_chunk_entry_states():
    """``return_states``: the state entering chunk c is the final state of
    the first c chunks; the first is the initial state."""
    x = [torch.from_numpy(a) for a in inputs(2, 3, 128, 16, seed=8)]
    s0 = torch.from_numpy(extras(2, 3, 16, seed=1)[0])
    out, st, states = ref.wkv_chunked_ref(*x, chunk=32, state0=s0,
                                          return_states=True)
    assert states.shape == (2, 3, 4, 16, 16)
    assert torch.equal(states[:, :, 0], s0)
    for c in range(1, 4):
        _, part = ref.wkv_chunked_ref(*(t[:, :, :32 * c] for t in x[:4]),
                                      x[4], chunk=32, state0=s0)
        assert torch.equal(states[:, :, c], part)
    o2, st2 = ref.wkv_chunked_ref(*x, chunk=32, state0=s0)
    assert torch.equal(out, o2) and torch.equal(st, st2)
