"""Bit-exact twin of ``jax.random`` with threefry2x32 (jax 0.9.0,
``jax_threefry_partitionable=True``), batched over keys.

Every function takes a batch of keys ``[..., 2]`` (int32 or int64
holding the reference's ``uint32`` key words) and returns results with
that batch shape leading.  Arithmetic runs in int64 masked to 32 bits.
There is no global generator: each engine lane carries its own key,
exactly as each lane of the reference's ``vmap`` does.

Two behaviours of the reference decide how the draws are computed here:

* XLA on the CPU fuses ``uniform``'s ``floats * (max - min) + min``
  into one fused multiply-add.  A float32 multiply-then-add rounds
  twice and differs in about one draw in seven; computing the product
  and sum in float64 (both exact at the engine's ranges) and rounding
  once to float32 reproduces the single rounding.
* ``jax.random.categorical`` goes through ``-log(-log(u))`` and XLA's
  ``log`` is not torch's.  The engine's logits are 0 or -inf, so the
  pick is the argmax of ``u`` over the allowed entries, and ``u`` is
  monotone in the 23 mantissa bits (``bits >> 9``): ``categorical_pick``
  takes that argmax directly (first index on a tie) and never calls
  ``log``.
"""
from __future__ import annotations

import math

import torch

from .bitset import wrap32

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds); int64 operands in
    [0, 2**32), broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def PRNGKey(seed: torch.Tensor) -> torch.Tensor:
    """int32 seeds ``[...]`` -> keys ``[..., 2]`` = ``[0, seed]``."""
    seed = torch.as_tensor(seed)
    lo = _u32(seed)
    return wrap32(torch.stack([torch.zeros_like(lo), lo], -1))


def _hash(key: torch.Tensor, shape) -> tuple:
    """Threefry over the counters ``iota_2x32_shape(shape)`` for every
    key of the batch: two int64 arrays ``[..., *shape]``."""
    shape = tuple(shape)
    count = math.prod(shape)
    lo = torch.arange(count, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    lo, hi = (lo & _M32).reshape(shape), hi.reshape(shape)
    tail = (1,) * len(shape)
    k1 = _u32(key[..., 0]).reshape(*key.shape[:-1], *tail)
    k2 = _u32(key[..., 1]).reshape(*key.shape[:-1], *tail)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like form): ``[..., 2]`` ->
    ``[..., num, 2]``.  The i-th key hashes counter i alone, so
    ``split(key, a)[..., i, :]`` equals ``split(key, b)[..., i, :]`` for
    every ``i`` below both."""
    b1, b2 = _hash(key, (num,))
    return wrap32(torch.stack([b1, b2], -1))


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per entry, ``bits1 ^ bits2``: int64 ``[..., *shape]``
    in [0, 2**32)."""
    b1, b2 = _hash(key, shape)
    return b1 ^ b2


def _bound(x, dtype, device) -> torch.Tensor:
    """A bound as a tensor on ``device``: a tensor is cast, a Python
    number is filled on the device (no blocking host-to-device copy)."""
    if torch.is_tensor(x):
        return x.to(dtype)
    return torch.full((), x, dtype=dtype, device=device)


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32.  ``minval``/``maxval`` are
    floats or tensors broadcastable to ``[..., *shape]``."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    floats = f.view(torch.float32) - 1.0
    dev = floats.device
    lo = _bound(minval, torch.float32, dev)
    hi = _bound(maxval, torch.float32, dev)
    span = hi - lo                                   # float32, as XLA
    # one rounding, as XLA's fused multiply-add: the float64 product and
    # sum are exact here, the cast to float32 is the only rounding
    out = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, out)


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` to int32: two 32-bit draws per value
    combined with JAX's ``2**16`` multiplier.  ``minval``/``maxval``
    are ints or tensors broadcastable to ``[..., *shape]``."""
    # both halves' bits in one hash: [..., 2, *shape]
    higher, lower = bits(split(key, 2), shape).unbind(key.dim() - 1)
    dev = higher.device
    lo = _bound(minval, torch.int64, dev)
    hi = _bound(maxval, torch.int64, dev)
    span = (hi - lo) & _M32
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((higher % span) * mult & _M32) + lower % span) & _M32
    return wrap32(lo + off % span)


def mantissas(key: torch.Tensor, width: int) -> torch.Tensor:
    """The 23 mantissa bits ``categorical_pick`` ranks by: int64
    ``[..., width]``.  Drawing them for many keys at once costs one hash
    instead of one per key."""
    return bits(key, (width,)) >> 9


def pick_mantissa(m: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """The first argmax of ``mantissas`` ``m`` over the ``allowed``
    entries (bool ``[..., D]``): int64 ``[...]``."""
    return torch.where(allowed, m, torch.full_like(m, -1)).argmax(-1)


def categorical_pick(key: torch.Tensor, allowed: torch.Tensor
                     ) -> torch.Tensor:
    """``jax.random.categorical(key, where(allowed, 0, -inf))``: the
    first argmax of the 23 mantissa bits over the allowed entries.
    ``allowed`` is bool ``[..., D]``; returns int64 ``[...]``."""
    return pick_mantissa(mantissas(key, allowed.shape[-1]), allowed)
