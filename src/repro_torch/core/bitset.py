"""Packed 32-bit bitsets with a leading lane axis — the port of
``repro/core/bitset.py``.

Item ``x`` lives in word ``x >> 5`` at bit ``x & 31`` of an
``int32[..., W]`` row, ``W = ceil(d / 32)``.  The words hold the same
bit patterns as the reference's ``uint32`` words (torch has no ``>>``,
``gather`` or ``index_put`` for ``torch.uint32``), so a bit is tested as
``(w >> b) & 1`` — the arithmetic shift's sign fill never reaches bit 0
— and a word is built in int64 and wrapped, never by forming ``1 << 31``
in int32.  Pad bits past ``d`` are invariantly zero, so word-wise
AND/OR/popcount over whole rows is exact.

Protocol state carries an explicit lane axis: set rows are
``int32[L, n, W]`` and per-slot vectors ``[L, n]`` (a single lane is
``L = 1``).
"""
from __future__ import annotations

import torch

from ..device import resolve

WORD = 32
_M32 = 0xFFFFFFFF


def bucket(n: int, quantum: int) -> int:
    """Round ``n`` up to a positive multiple of ``quantum``."""
    if quantum <= 0:
        raise ValueError(f"quantum must be positive, got {quantum}")
    return max(quantum, quantum * -(-n // quantum))


def n_words(d: int) -> int:
    """Words per row for a d-item universe."""
    return bucket(d, WORD) // WORD


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values holding 32-bit patterns -> int32 with the same bits."""
    return (((x + 2 ** 31) & _M32) - 2 ** 31).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2**32): the unsigned value."""
    return x.to(torch.int64) & _M32


def zeros(lanes: int, n: int, d: int, device=None) -> torch.Tensor:
    """Empty packed set rows: int32[L, n, n_words(d)] on ``device`` (the
    card unless the caller asks for the CPU)."""
    return torch.zeros((lanes, n, n_words(d)), dtype=torch.int32,
                       device=resolve(device))


def word_bit(item: torch.Tensor):
    """(word index, bit shift) of an item index; shapes follow ``item``."""
    return item >> 5, item & 31


def pack(sets: torch.Tensor) -> torch.Tensor:
    """bool[..., d] -> int32[..., ceil(d/32)]."""
    d = sets.shape[-1]
    pad = (-d) % WORD
    if pad:
        sets = torch.nn.functional.pad(sets, (0, pad))
    x = sets.reshape(*sets.shape[:-1], -1, WORD).to(torch.int64)
    weights = torch.ones(WORD, dtype=torch.int64, device=sets.device) << \
        torch.arange(WORD, dtype=torch.int64, device=sets.device)
    return wrap32((x * weights).sum(-1))


def unpack(bits: torch.Tensor, d: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., d] (drops the pad bits)."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=bits.device)
    x = (bits[..., None] >> shifts) & 1
    return x.reshape(*bits.shape[:-1], bits.shape[-1] * WORD)[
        ..., :d].bool()


def _words_at(bits: torch.Tensor, row: torch.Tensor, w: torch.Tensor):
    lanes = torch.arange(bits.shape[0], device=bits.device)
    return bits[lanes, row, w]


def get(bits: torch.Tensor, row: torch.Tensor, item: torch.Tensor
        ) -> torch.Tensor:
    """bool[L]: membership bit ``bits[l, row[l], item[l]]``."""
    w, b = word_bit(item)
    return ((_words_at(bits, row, w) >> b) & 1).bool()


def get_col(bits: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
    """bool[L, n]: membership of each lane's ``item[l]`` across all rows."""
    w, b = word_bit(item)
    cols = torch.gather(bits, 2, w.view(-1, 1, 1).expand(-1, bits.shape[1],
                                                       1))[..., 0]
    return ((cols >> b[:, None]) & 1).bool()


def item_cols(bits: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """bool[L, m, n] gather: out[l, i, k] = bits[l, k, items[l, i]]."""
    w, b = word_bit(items)                               # [L, m]
    lanes, n = bits.shape[0], bits.shape[1]
    cols = torch.gather(bits.transpose(1, 2), 1,
                        w[:, :, None].expand(lanes, w.shape[1], n))
    return ((cols >> b[:, :, None]) & 1).bool()


def set_bit(bits: torch.Tensor, row: torch.Tensor, item: torch.Tensor,
            on: torch.Tensor) -> torch.Tensor:
    """OR ``on[l]`` into ``bits[l, row[l], item[l]]``."""
    w, b = word_bit(item)
    lanes = torch.arange(bits.shape[0], device=bits.device)
    old = bits[lanes, row, w]
    new = wrap32(as_u32(old) | (on.to(torch.int64) << b))
    out = bits.clone()
    out[lanes, row, w] = new
    return out


def or_rowwise(bits: torch.Tensor, items: torch.Tensor, on: torch.Tensor
               ) -> torch.Tensor:
    """Per-row scatter: bits[l, i, items[l, i]] |= on[l, i] for every
    row i."""
    w, b = word_bit(items)
    old = torch.gather(bits, 2, w[..., None])[..., 0]
    new = wrap32(as_u32(old) | (on.to(torch.int64) << b))
    return bits.scatter(2, w[..., None], new[..., None])


def clear_rows(bits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero every masked row (bool[..., n] mask)."""
    return torch.where(mask[..., None], torch.zeros((), dtype=bits.dtype,
                                                    device=bits.device),
                       bits)


def any_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32[L, N, W] x int32[L, K, W] -> bool[L, N, K] row-pair
    intersection."""
    return ((a[:, :, None, :] & b[:, None, :, :]) != 0).any(-1)


def overlap_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise intersection test: bool[...] = any(a[r] & b[r])."""
    return ((a & b) != 0).any(-1)


def any_bit(bits: torch.Tensor) -> torch.Tensor:
    """bool[...]: row is non-empty."""
    return (bits != 0).any(-1)


def popcount(bits: torch.Tensor) -> torch.Tensor:
    """int32[...]: set-bit count per row (SWAR per 32-bit word, summed)."""
    v = as_u32(bits)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    per_word = ((v * 0x01010101) & _M32) >> 24
    return per_word.sum(-1, dtype=torch.int32)


def or_reduce(bits: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Bitwise-OR reduction along ``axis`` (halving tree: log2 steps)."""
    x = bits.movedim(axis, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        half = x.shape[0] // 2
        x = x[:half] | x[half:]
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=bits.dtype,
                           device=bits.device)
    return x[0]


pack_bitsets = pack
