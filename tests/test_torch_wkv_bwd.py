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

``wkv_bwd_twin`` is a torch twin of the kernels' order of operations
(``csrc/wkv_bwd.cu``): every chunk's term P of G's update on its own, the
prefix in tiles of 16 rows (each in order, then the earlier tiles'
totals); the scan of G over the chunks in reverse, each row on its own,
with gL = sum_j G S' and S' the state the chunk writes (the next chunk's
saved state, or the forward's final state for the last chunk); then
each chunk's gradients from its saved state and its G alone, dlog w's reverse scan in 512 / D segments a channel with
the later segments' totals added from the last down, du's part of each
chunk by tiles of 16 rows, then summed over the batch and the chunks in
order.  It is within ``JAX_TOL`` of the plain version (and the strong
decay within ``F64_TOL`` of float64 autograd), so the kernels' order is
no source of error beyond it; and the scan's G of each chunk is
the plain backward's dstate0 of the suffix that starts after it, which
checks the split itself.
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

TILE = 16                  # the kernels' prefix tiles and row tiles
THREADS = 512              # the chunk kernel's CTA
ROWS = 128                 # a chunk's rows at most


def tile_cumsum(w):
    """Both backward kernels' prefix of a chunk ``[..., C, D]`` by channel:
    tiles of 16 rows, each summed in order, then the earlier tiles' totals
    added in order.  Returns (cum, cum_last)."""
    c = w.shape[-2]
    x = torch.nn.functional.pad(w, (0, 0, 0, ROWS - c))
    out, acc = [], torch.zeros_like(x[..., :1, :])
    for i in range(ROWS // TILE):
        tile = x[..., i * TILE:(i + 1) * TILE, :].cumsum(-2)
        out.append(tile + acc)
        acc = acc + tile[..., -1:, :]
    return torch.cat(out, -2)[..., :c, :], acc


def segment_suffix(hs):
    """The chunk kernel's reverse scan of ``[..., C, D]`` over the rows:
    512 / D segments of D / 4 rows, each summed from its last row up, then
    the later segments' totals added from the last segment down."""
    c, d = hs.shape[-2], hs.shape[-1]
    n = THREADS // d
    rows = ROWS // n
    x = torch.nn.functional.pad(hs, (0, 0, 0, ROWS - c))
    segs = [x[..., i * rows:(i + 1) * rows, :].flip(-2).cumsum(-2).flip(-2)
            for i in range(n)]
    out = []
    for i in range(n):
        later = torch.zeros_like(segs[i][..., :1, :])
        for j in range(n - 1, i, -1):
            later = later + segs[j][..., :1, :]
        out.append(segs[i] + later)
    return torch.cat(out, -2)[..., :c, :]


def pstate(r, log_w, dout, chunk):
    """``wkv_bwd_pstate``'s order on float32 ``[B, H, S, D]`` tensors,
    every chunk on its own: (P = e^c (r'^T dO) ``[B, H, S / C, D, D]``,
    the chunk's term of G's update; e^L ``[B, H, S / C, D]``)."""
    b, h, s, d = r.shape
    nc = s // chunk
    ps = torch.zeros((b, h, nc, d, d))
    el = torch.zeros((b, h, nc, d))
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        lw = log_w[:, :, sl]
        cum, last = tile_cumsum(lw)
        c = last * 0.5
        rp = r[:, :, sl] * torch.exp((cum - lw) - c)
        ps[:, :, ci] = torch.exp(c).transpose(-1, -2) * \
            (rp.transpose(-1, -2) @ dout[:, :, sl])
        el[:, :, ci] = torch.exp(last)[:, :, 0]
    return ps, el


def dstate_scan(ps, el, states, state, dstate):
    """``wkv_bwd_dstate``'s order: each row of G on its own (all rows at
    once here), the chunks in reverse from the final state's gradient (or
    0): gL = sum_j G S' with S' the state the chunk writes (the next
    chunk's saved state, or the forward's final ``state`` for the last
    chunk), G kept, then G <- e^L G + P.  Returns (G of every chunk ``[B,
    H, S / C, D, D]``, the gradient of the state it writes; gL ``[B, H, S
    / C, D]``; dstate0)."""
    nc = ps.shape[2]
    g = torch.zeros_like(ps[:, :, 0]) if dstate is None else dstate.clone()
    gs, gl = torch.zeros_like(ps), torch.zeros_like(el)
    for ci in reversed(range(nc)):
        s_next = states[:, :, ci + 1] if ci + 1 < nc else state
        gl[:, :, ci] = (g * s_next).sum(-1)
        gs[:, :, ci] = g
        g = el[:, :, ci, :, None] * g + ps[:, :, ci]
    return gs, gl, g


def chunk_grads(r, k, v, log_w, u, st, g, gl, dout):
    """``wkv_bwd_chunk``'s order for one chunk ``[B, H, C, D]`` from its
    saved state ``st``, the G and gL of the scan: (dr, dk, dv, dlog
    w, du's part ``[B, H, D]``)."""
    c_n = r.shape[-2]
    uu = u[None, :, None, :]
    tril = torch.ones((c_n, c_n), dtype=torch.bool).tril(-1)
    cum, last = tile_cumsum(log_w)
    c = last * 0.5
    ec = torch.exp(c).transpose(-1, -2)
    er, ek = torch.exp((cum - log_w) - c), torch.exp(c - cum)
    rp, kp = r * er, k * ek
    ru = ((r * uu) * k).sum(-1, keepdim=True)
    dru = (dout * v).sum(-1, keepdim=True)
    gm, sm = ec * g, ec * st
    a = torch.where(tril, rp @ kp.transpose(-1, -2), 0.0)
    da = torch.where(tril, dout @ v.transpose(-1, -2), 0.0)
    dv = (kp @ gm + a.transpose(-1, -2) @ dout) + ru * dout
    dk_pre = v @ gm.transpose(-1, -2) + da.transpose(-1, -2) @ rp
    dr_pre = dout @ sm.transpose(-1, -2) + da @ kp
    dk = ek * dk_pre + (dru * uu) * r
    dr = er * dr_pre + (dru * uu) * k
    gcum, gce = -(kp * dk_pre), rp * dr_pre
    hs = gcum + torch.nn.functional.pad(gce[:, :, 1:], (0, 0, 0, 1))
    dw = segment_suffix(hs) + gl[:, :, None, :]
    x = torch.nn.functional.pad((dru * r) * k, (0, 0, 0, ROWS - c_n))
    du = torch.zeros_like(x[:, :, 0])
    for i in range(ROWS // TILE):      # a tile's rows in order, then tiles
        part = torch.zeros_like(du)
        for t in range(i * TILE, (i + 1) * TILE):
            part = part + x[:, :, t]
        du = du + part
    return dr, dk, dv, dw, du


def wkv_bwd_twin(r, k, v, log_w, u, states, dout, dstate, state, chunk):
    """``csrc/wkv_bwd.cu``'s order of operations on float32 ``[B, H, S,
    D]`` tensors: every chunk's P, the scan (G and gL of every chunk, from
    the forward's final ``state``), each chunk's
    gradients from its S and G alone, du's parts summed over the batch and
    then the chunks (the products as matrix products: their sums run in
    another order on the card, as in the plain version)."""
    b, h, s, d = r.shape
    nc = s // chunk
    gs, gl, ds0 = dstate_scan(*pstate(r, log_w, dout, chunk), states, state,
                              dstate)
    out = {n: [] for n in ("dr", "dk", "dv", "dw")}
    du_part = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        got = chunk_grads(*(x[:, :, sl] for x in (r, k, v, log_w)), u,
                          states[:, :, ci], gs[:, :, ci], gl[:, :, ci],
                          dout[:, :, sl])
        for n, x in zip(out, got):
            out[n].append(x)
        du_part.append(got[4])
    du = torch.zeros((h, d))
    for bb in range(b):
        for ci in range(nc):
            du = du + du_part[ci][bb]
    dr, dk, dv, dw = (torch.cat(out[n], 2) for n in ("dr", "dk", "dv", "dw"))
    return dr, dk, dv, dw, du, ds0


def twin_inputs(x, chunk, s0, go, ds):
    r, k, v, lw, u = (torch.from_numpy(a) for a in x)
    _, state, states = ref.wkv_chunked_ref(
        r, k, v, lw, u, chunk=chunk,
        state0=None if s0 is None else torch.from_numpy(s0),
        return_states=True)
    return (r, k, v, lw, u, states, torch.from_numpy(go),
            None if ds is None else torch.from_numpy(ds), state)


@pytest.mark.parametrize("b,h,s,dk,chunk,dead", SHAPES)
def test_kernel_order_twin_matches_plain(b, h, s, dk, chunk, dead):
    x = inputs(b, h, s, dk, seed=s + 5 * dk, dead=dead)
    s0, ds, rng = extras(b, h, dk, seed=7)
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    twin = wkv_bwd_twin(*twin_inputs(x, chunk, s0, go, ds), chunk)
    close(twin, plain_bwd(x, chunk, s0, go, ds), JAX_TOL)


def test_kernel_order_twin_strong_decay():
    x = strong(1, 2, 256, 64, seed=13)
    s0, ds, rng = extras(1, 2, 64, seed=14)
    go = rng.standard_normal((1, 2, 256, 64), dtype=np.float32)
    twin = wkv_bwd_twin(*twin_inputs(x, 64, s0, go, ds), 64)
    close(twin, f64_grads(x, s0, go, ds), F64_TOL)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state0+dstate"])
@pytest.mark.parametrize("b,h,s,dk,chunk", [(2, 3, 128, 32, 32),
                                            (1, 2, 256, 64, 64),
                                            (1, 2, 8, 16, 1)])
def test_dstate_pass_is_the_gradient_of_each_suffix(b, h, s, dk, chunk,
                                                    with_state):
    """The split itself: the scan's G of chunk c - 1 (the gradient of
    the state entering chunk c) is the plain backward's dstate0 over the
    suffix of chunks from c on, with the suffix's saved states and the same
    final-state gradient; its last update is the whole call's dstate0."""
    x = inputs(b, h, s, dk, seed=s + dk)
    s0, ds, rng = extras(b, h, dk, seed=dk)
    if not with_state:
        s0 = ds = None
    go = rng.standard_normal((b, h, s, dk), dtype=np.float32)
    r, k, v, lw, u, states, tgo, tds, fin = twin_inputs(x, chunk, s0, go,
                                                        ds)
    gs, _, ds0 = dstate_scan(*pstate(r, lw, tgo, chunk), states, fin, tds)
    for ci in range(s // chunk):
        sl = slice(ci * chunk, s)
        want = ref.wkv_chunked_bwd_ref(
            *(t[:, :, sl] for t in (r, k, v, lw)), u, states[:, :, ci:],
            tgo[:, :, sl], tds, chunk=chunk)[5]
        got = ds0 if ci == 0 else gs[:, :, ci - 1]
        close([got], [want], JAX_TOL, names=(f"G entering chunk {ci}",))


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
