"""The plain version of the port's chunked WKV kernel
(``repro_torch.kernels.ref.wkv_chunked_ref``, what ``kernels.ops.
wkv_chunked`` runs on the CPU) against the JAX package's Pallas kernel in
interpret mode (``repro.kernels.ops.wkv_chunked``, as
``tests/test_kernels.py`` runs it), the sequential oracle ``wkv_ref`` of
both packages, and the model's chunked WKV (``models.rwkv.wkv_chunked``),
on the CPU.

Shapes: ``tests/test_kernels.py``'s, plus S that is not a multiple of 64
(96 in chunks of 32, 48 in chunks of 16), a chunk of 128, heads padded
with zero inputs, and an initial state.  Tolerance: ``test_kernels.py``'s
atol 1e-4, rtol 1e-3 (float32 sums in another order).

The premise of ``csrc/wkv.cu``'s design is held here too: a torch twin
of its formulation (the prefix as warp scans over 32 rows with the
warps' totals added in order; the chunk products as three TF32 passes,
the high part rounded to nearest as ``cvt.rna.tf32.f32`` does, emulated
on the float32 bit patterns, the low part truncated; each product summed
in k-steps of 8 into a main and a correction float32 accumulator; inter,
intra and bonus terms in the kernel's order) is within the same
tolerance of the Pallas kernel and of the plain version at D in {16, 32,
64}, chunks {1, 16, 64, 128} and S in {chunk, 8 chunk}, with and without
an initial state; one TF32 pass is not.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.core import bitset as TB  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

ATOL, RTOL = 1e-4, 1e-3


def inputs(b, h, s, dk, seed=3, dead=0):
    """r, k, v, log_w [B, H, S, D] and u [H, D] as numpy float32, made as
    ``test_kernels.py`` makes them; the last ``dead`` heads are zero."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, dk), dtype=np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, h, s, dk), dtype=np.float32)
                 * 0.5 - 2)
    u = rng.standard_normal((h, dk), dtype=np.float32) * 0.1
    if dead:
        for x in (r, k, v):
            x[:, h - dead:] = 0
    return r, k, v, lw.astype(np.float32), u


def check(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def to_bsd(x):
    b, h, s, d = x.shape
    return np.ascontiguousarray(np.moveaxis(x, 1, 2).reshape(b, s, h * d))


@pytest.mark.parametrize("b,h,s,dk,chunk,dead", [
    (1, 2, 64, 16, 16, 0), (2, 3, 128, 32, 64, 0), (1, 1, 256, 64, 64, 0),
    (2, 2, 96, 16, 32, 0), (1, 3, 48, 32, 16, 0), (1, 2, 256, 64, 128, 0),
    (2, 4, 64, 16, 32, 1),
])
def test_wkv_plain_matches_pallas_and_oracle(b, h, s, dk, chunk, dead):
    r, k, v, lw, u = inputs(b, h, s, dk, dead=dead)
    out, state = ops.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                                 chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (b, h, s, dk)
    check(out, jops.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                                chunk=chunk))
    jout, jstate = jref.wkv_ref(*(jnp.asarray(to_bsd(x))
                                  for x in (r, k, v, lw)),
                                jnp.asarray(u.reshape(-1)), dk)
    check(to_bsd(out.numpy()), jout)
    check(state, jstate)
    tout, tstate = ref.wkv_ref(*(torch.from_numpy(to_bsd(x))
                                 for x in (r, k, v, lw)),
                               torch.from_numpy(u.reshape(-1)), dk)
    check(to_bsd(out.numpy()), tout)
    check(state, tstate)
    if dead:
        assert not out[:, h - dead:].any() and not state[:, h - dead:].any()


def test_wkv_plain_carries_an_initial_state():
    r, k, v, lw, u = inputs(2, 2, 64, 16, seed=4)
    s0 = np.random.default_rng(5).standard_normal((2, 2, 16, 16),
                                                  dtype=np.float32)
    out, state = ops.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                                 chunk=16, state0=torch.from_numpy(s0))
    jout, jstate = jref.wkv_ref(*(jnp.asarray(to_bsd(x))
                                  for x in (r, k, v, lw)),
                                jnp.asarray(u.reshape(-1)), 16,
                                state0=jnp.asarray(s0))
    check(to_bsd(out.numpy()), jout)
    check(state, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_wkv_chunked_matches_reference(dtype):
    """The model's chunked WKV on ``[B, S, H*D]`` tensors (strided
    ``[B, H, S, D]`` views into the kernel's plain version) against the
    reference model's, output and final state, from a given state."""
    b, h, s, dk = 2, 3, 128, 16
    r, k, v, lw, u = inputs(b, h, s, dk, seed=6)
    s0 = np.random.default_rng(7).standard_normal((b, h, dk, dk),
                                                  dtype=np.float32) * 0.1
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    args = [to_bsd(x) for x in (r, k, v)]
    out, state = trwkv.wkv_chunked(
        *(torch.from_numpy(a).to(tdt) for a in args),
        torch.from_numpy(to_bsd(lw)), torch.from_numpy(u.reshape(-1)), dk,
        state0=torch.from_numpy(s0), chunk=32)
    jout, jstate = jrwkv.wkv_chunked(
        *(jnp.asarray(a, jdt) for a in args), jnp.asarray(to_bsd(lw)),
        jnp.asarray(u.reshape(-1)), dk, state0=jnp.asarray(s0), chunk=32)
    assert out.shape == (b, s, h * dk) and out.dtype == torch.float32
    check(out, jout)
    check(state, jstate)


def tf32(x):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: half an ulp added to the
    bit pattern's magnitude, then the 13 low bits cleared."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    return TB.wrap32((u + 0x1000) & 0xffffe000).view(torch.float32)


def split(x):
    """The kernel's 3xTF32 split: hi = ``tf32(x)``, lo = x - hi (exact)
    truncated to TF32, as the tensor cores read it."""
    hi = tf32(x)
    lo = (x - hi).view(torch.int32) & TB.wrap32(torch.tensor(0xffffe000))
    return hi, lo.view(torch.float32)


def warp_cumsum(w):
    """The kernel's prefix over the chunk's rows (padded to 128 with 0):
    an inclusive Hillis-Steele scan within each warp of 32 rows, then the
    warps' totals added in order.  Returns (cum, cum_last)."""
    c = w.shape[-2]
    x = torch.nn.functional.pad(w, (0, 0, 0, 128 - c))
    lane = torch.arange(128)[:, None] % 32
    for off in (1, 2, 4, 8, 16):
        y = torch.nn.functional.pad(x, (0, 0, off, 0))[..., :128, :]
        x = torch.where(lane >= off, x + y, x)
    acc = torch.zeros_like(x[..., :1, :])
    off = []
    for wq in range(4):
        off.append(acc.expand(*x.shape[:-2], 32, x.shape[-1]))
        acc = acc + x[..., 32 * wq + 31:32 * wq + 32, :]
    cum = x + torch.cat(off, dim=-2)
    return cum[..., :c, :], acc


def bonus_dot(r, u, k):
    """r . (u k) per row as the kernel sums it: each lane its 4 channels in
    order, then the lanes of a row by a butterfly (a pairwise tree); at D =
    64 each CTA of the pair sums its 32 channels so, then the two parts
    are added, the first CTA's first."""
    x = (r * u) * k
    parts = []
    for x in (x.split(32, dim=-1) if x.shape[-1] == 64 else (x,)):
        part = x[..., 0::4]
        for i in range(1, 4):
            part = part + x[..., i::4]
        while part.shape[-1] > 1:
            part = part[..., 0::2] + part[..., 1::2]
        parts.append(part)
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def wkv_tc_twin(r, k, v, log_w, u, chunk, state0=None, into=None):
    """``csrc/wkv.cu``'s formulation on float32 [B, H, S, D] inputs: per
    chunk the warp-scan prefix, r' = r e^{ce - c} and k' = k e^{c - cum},
    out = r' (e^c S) + (A masked to s < t) v into one pair of main and
    correction accumulators (``mm3_into``), then their sum plus (r . u k)
    v (``bonus_dot``); S' = e^{cum_last} S + (k' e^c)^T v.  The
    value-column split sums nothing differently.  ``into`` stands in for
    ``mm3_into``, another way to take the products.  Returns (out, final
    state)."""
    into = into or mm3_into

    def mm3(a, b):
        zero = torch.zeros(a.shape[:-1] + b.shape[-1:])
        main, corr = into((zero, zero), a, b)
        return main + corr

    b, h, s, d = r.shape
    state = torch.zeros((b, h, d, d)) if state0 is None else state0.clone()
    uu = u[None, :, None, :]
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril(-1)
    outs = []
    for c0 in range(0, s, chunk):
        rq, kq, vq, wq = (x[:, :, c0:c0 + chunk] for x in (r, k, v, log_w))
        cum, last = warp_cumsum(wq)
        c = last * 0.5
        rp = rq * torch.exp((cum - wq) - c)
        kp = kq * torch.exp(c - cum)
        ec = torch.exp(c)
        zero = torch.zeros_like(vq)
        acc = into((zero, zero), rp, ec.transpose(-1, -2) * state)
        a = torch.where(tril, mm3(rp, kp.transpose(-1, -2)), 0.0)
        main, corr = into(acc, a, vq)
        outs.append((main + corr) + bonus_dot(rq, uu, kq) * vq)
        state = torch.exp(last).transpose(-1, -2) * state + \
            mm3((kp * ec).transpose(-1, -2), vq)
    return torch.cat(outs, dim=2), state


def mm3_into(acc, a, b):
    """``(main, corr)`` plus a @ b as the kernel takes it on the tensor
    cores: k-steps of 8 of the 3xTF32 split, lo.hi and hi.lo added to the
    correction accumulator and hi.hi to the main one, each float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    main, corr = acc
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        corr = corr + al[..., ks] @ bh[..., ks, :]
        corr = corr + ah[..., ks] @ bl[..., ks, :]
        main = main + ah[..., ks] @ bh[..., ks, :]
    return main, corr


def test_tf32_rounds_to_nearest_away():
    """The emulated rounding on hand-made bit patterns: below, at and
    above half of TF32's last place, for both signs, and exact TF32."""
    bits = torch.tensor([0x3f800fff, 0x3f801000, 0x3f801001, 0x3f803000,
                         0xbf801000, 0xbf800fff, 0x3f802000],
                        dtype=torch.int64)
    want = [0x3f800000, 0x3f802000, 0x3f802000, 0x3f804000, 0xbf802000,
            0xbf800000, 0x3f802000]
    got = tf32(TB.wrap32(bits).view(torch.float32))
    assert (got.view(torch.int32).to(torch.int64) & 0xffffffff).tolist() \
        == want
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2 ** -21


@pytest.mark.parametrize("state0", [False, True], ids=["zeros", "state0"])
@pytest.mark.parametrize("s_mult", [1, 8], ids=["S=chunk", "S=8chunk"])
@pytest.mark.parametrize("chunk", [1, 16, 64, 128])
@pytest.mark.parametrize("dk", [16, 32, 64])
def test_wkv_tensor_core_twin_matches_pallas_and_plain(dk, chunk, s_mult,
                                                       state0):
    b, h, s = 1, 2, chunk * s_mult
    r, k, v, lw, u = inputs(b, h, s, dk, seed=dk + chunk + s)
    s0 = (np.random.default_rng(dk + s).standard_normal(
        (b, h, dk, dk), dtype=np.float32) * 0.1) if state0 else None
    t = [torch.from_numpy(x) for x in (r, k, v, lw, u)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    out, state = wkv_tc_twin(*t, chunk, state0=ts0)
    want, wstate = ref.wkv_chunked_ref(*t, chunk=chunk, state0=ts0)
    check(out, want)
    check(state, wstate)
    if s0 is None:
        check(out, jops.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                                    chunk=chunk))


def test_single_tf32_pass_leaves_the_tolerance():
    """Why three passes: the same twin with one TF32 pass a product (about
    three decimal digits) leaves atol 1e-4, rtol 1e-3 at the main path's
    D = 64 and chunk 128."""
    r, k, v, lw, u = (torch.from_numpy(x) for x in inputs(1, 2, 1024, 64,
                                                           seed=1))
    want, _ = ref.wkv_chunked_ref(r, k, v, lw, u, chunk=128)

    def one(acc, a, b):
        main, corr = acc
        for k0 in range(0, a.shape[-1], 8):
            ks = slice(k0, k0 + 8)
            main = main + tf32(a[..., ks]) @ tf32(b[..., ks, :])
        return main, corr
    got, _ = wkv_tc_twin(r, k, v, lw, u, 128, into=one)
    assert bool(((got - want).abs() > ATOL + RTOL * want.abs()).any())
    check(wkv_tc_twin(r, k, v, lw, u, 128)[0], want)
