"""Vectorized row hashing for join keys wider than 63 bits.

Counterpart of ``tiflash_tpu/ops/hashing.py`` (``hash_array_u32``,
``string_value_hashes``, ``hash_columns``, ``hash_columns_u63``), bit for
bit: two murmur3-style fmix32 lanes over the (hi, lo) halves of each
64-bit key, combined across columns boost-style.

The reference mixes in uint32.  CUDA torch lacks most uint32 and uint64
kernels, so here a uint32 value is an int64 tensor in [0, 2^32): every
shift and xor is exact there, and each multiply by a 32-bit constant
splits its left factor into 16-bit halves, so no int64 product wraps,
before it is masked back to 32 bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.block import Column

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_SEED_MIX = 0x9E3779B9  # golden-ratio combine like boost
_NULL_HASH = 0xDEADBEEF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): each partial product stays
    below 2^48."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def _u32(data: torch.Tensor) -> torch.Tensor:
    """A 4-byte-or-smaller column as uint32 values in int64 (two's
    complement wrap, as the reference's ``astype(uint32)``)."""
    return data.to(torch.int64) & _M32


def hash_array_u32(data: torch.Tensor,
                   init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hash one column's values to uint32 (as int64), combined with
    ``init`` if given."""
    if data.dtype == torch.bool:
        data = data.to(torch.int64)
        h = _fmix32(data)
    elif data.element_size() == 8:
        bits = data.view(torch.int64) if data.is_floating_point() else data
        lo = bits & _M32
        hi = (bits >> 32) & _M32
        h = _fmix32(lo) ^ _fmix32(_mul32(hi, _C1))
    else:
        h = _fmix32(_u32(data))
    if init is not None:
        # boost::hash_combine-style merge so column order matters
        h = init ^ ((h + _SEED_MIX + ((init << 6) & _M32) + (init >> 2)) & _M32)
        h = _fmix32(h)
    return h


def _fnv1a32_host(s: str) -> int:
    """FNV-1a over utf-8 bytes: a dictionary-independent string hash."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & _M32
    return h


def string_value_hashes(col: Column) -> torch.Tensor:
    """Per-row uint32 value hashes (as int64) of a dictionary string
    column: a host table over the dictionary, one gather on its device."""
    d = col.dictionary or ()
    lut = torch.tensor([_fnv1a32_host(s) for s in d] or [0], dtype=torch.int64,
                       device=col.data.device)
    return lut[col.data.clamp(0, lut.shape[0] - 1).long()]


def hash_columns(cols: Sequence[Column], *, null_sentinel: bool = True,
                 seed: int = 0) -> torch.Tensor:
    """Combined uint32 hash (as int64) over several key columns.  NULL
    hashes to a fixed sentinel; strings hash by value."""
    dev = cols[0].data.device
    h = torch.full((), seed, dtype=torch.int64, device=dev) if seed else None
    for col in cols:
        data = string_value_hashes(col) if col.dictionary is not None else col.data
        hc = hash_array_u32(data, init=h)
        if col.validity is not None and null_sentinel:
            sentinel = _NULL_HASH ^ (h if h is not None else 0)
            hc = torch.where(col.validity, hc, torch.as_tensor(sentinel, device=dev))
        h = hc
    assert h is not None, "hash_columns needs at least one column"
    return h


def hash_columns_u63(cols: Sequence[Column], **kw) -> torch.Tensor:
    """Two independent 32-bit lanes combined into a non-negative int64,
    the sort and probe key of a join whose keys pass 63 bits."""
    h1 = hash_columns(cols, **kw)
    h2 = hash_columns(cols, seed=0x6A09E667, **kw)
    return ((h1 << 31) ^ h2) & (2 ** 62 - 1)


__all__ = ["hash_array_u32", "hash_columns", "hash_columns_u63",
           "string_value_hashes"]
