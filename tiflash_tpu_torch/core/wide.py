"""Multi-limb wide-decimal arithmetic, the slice the port's main path uses.

Counterpart of ``tiflash_tpu/core/wide.py``.  A wide mantissa is L int64
limbs in base 10^18 stored as a trailing dimension ``(..., L)``:

    value = limb[0] * (10**18)**(L-1) + ... + limb[L-1],
    limb[0] signed, limbs[1..L-1] in [0, 10**18)

Internal arithmetic decomposes limbs into base-10^9 digits so every
intermediate fits int64.  Torch's ``//`` on integer tensors is floor
division, like ``jnp``'s, so the digit arithmetic ports unchanged.

Ported: what the fused recombination (``ops/stream_fuse.py``) and the
wide-sum rewrite (``ops/aggregate.py:_wide_rewrite``) call.  Wide
multiply, divide and compare come with the functions slice of the port.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

W9 = 10 ** 9
W18 = 10 ** 18


def make_wide(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi.to(torch.int64), lo.to(torch.int64)], dim=-1)


def widen_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 mantissa -> two-limb.  Floor division keeps lo in [0, W18)."""
    hi = x // W18
    return make_wide(hi, x - hi * W18)


def digits_of_wide(w: torch.Tensor) -> List[torch.Tensor]:
    """Base-10^9 digits [d0, d1, ..., d_{2L-1}] (d0 least significant,
    top digit signed) for any limb count L = w.shape[-1]."""
    L = w.shape[-1]
    out: List[torch.Tensor] = []
    for i in range(L - 1, -1, -1):
        limb = w[..., i]
        hi9 = limb // W9
        out.append(limb - hi9 * W9)
        out.append(hi9)
    return out


def digits_of_i64(x: torch.Tensor) -> List[torch.Tensor]:
    """int64 -> [d0, d1] base-10^9 digits (d0 in [0, W9), d1 signed)."""
    d1 = x // W9
    return [x - d1 * W9, d1]


# largest t with |out2 + t*W9| < 2^63 for any out2 in [0, W9)
_MAX_TOP = (2 ** 63 - 1 - (W9 - 1)) // W9


def renorm_digits(digits: Sequence[torch.Tensor],
                  limbs: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry-normalize base-10^9 digit values into an ``limbs``-limb value
    + overflow flag.  Returns (wide (..., limbs), overflowed bool (...))."""
    nd = 2 * limbs
    ds = list(digits) + [torch.zeros_like(digits[0])] * (nd - len(digits))
    if len(ds) > nd:
        raise ValueError(f"{len(ds)} digits exceed {limbs} limbs")
    out = []
    carry = torch.zeros_like(ds[0])
    for i in range(nd):
        cur = ds[i] + carry
        carry = cur // W9          # floor: out digits stay in [0, W9)
        out.append(cur - carry * W9)
    top = out[nd - 1] + carry * W9
    overflow = top.abs() > _MAX_TOP
    top = top.clamp(-_MAX_TOP, _MAX_TOP)
    top_limb = out[nd - 2] + top * W9
    lower = [out[2 * j] + out[2 * j + 1] * W9
             for j in range(limbs - 2, -1, -1)]  # MSB-first below top
    arr = torch.stack([top_limb.to(torch.int64)]
                      + [x.to(torch.int64) for x in lower], dim=-1)
    return arr, overflow


def wide_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    L = a.shape[-1]
    out = [None] * L
    carry = 0
    for i in range(L - 1, 0, -1):
        cur = a[..., i] + b[..., i] + carry
        carry = cur // W18
        out[i] = cur - carry * W18
    out[0] = a[..., 0] + b[..., 0] + carry
    return torch.stack([x.to(torch.int64) for x in out], dim=-1)


def wide_neg(a: torch.Tensor) -> torch.Tensor:
    L = a.shape[-1]
    out = [None] * L
    borrow = 0
    for i in range(L - 1, 0, -1):
        t = a[..., i] + borrow
        nz = t > 0
        out[i] = torch.where(nz, W18 - t, torch.zeros_like(t))
        borrow = nz.to(torch.int64)
    out[0] = -(a[..., 0] + borrow)
    return torch.stack([x.to(torch.int64) for x in out], dim=-1)


def wide_mul_pow10(w: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """value * 10**k exactly (0 <= k <= 9).  Returns (wide, overflow)."""
    assert 0 <= k <= 9
    if k == 0:
        return w, torch.zeros(w.shape[:-1], dtype=torch.bool, device=w.device)
    m = 10 ** k
    digits = [d * m for d in digits_of_wide(w)]  # each < 1e9*1e9 = 1e18
    return renorm_digits(digits, limbs=w.shape[-1])


def wide_mul_pow2(w: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """value * 2**k exactly (k >= 0), in steps of 2^20 so every scaled
    digit stays below renorm's input bound.  Returns (wide, overflow)."""
    ov = torch.zeros(w.shape[:-1], dtype=torch.bool, device=w.device)
    while k > 0:
        m = min(k, 20)
        digits = [d * (1 << m) for d in digits_of_wide(w)]
        w, o = renorm_digits(digits, limbs=w.shape[-1])
        ov = ov | o
        k -= m
    return w, ov


def wide_div_round_half_up(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """value / c with TiDB ROUND_HALF_UP (away from zero), c positive
    int64 <= ~9e9 (row counts).  Base-10^9 long division."""
    L = w.shape[-1]
    neg = w[..., 0] < 0
    mag = torch.where(neg[..., None], wide_neg(w), w)
    ds = digits_of_wide(mag)         # LSB first
    c = c.to(torch.int64)
    q = []
    rem = torch.zeros_like(ds[0])
    for d in reversed(ds):           # most-significant first
        cur = rem * W9 + d
        qi = cur // c
        rem = cur - qi * c
        q.append(qi)
    q = q[::-1]
    q[0] = q[0] + (rem * 2 >= c).to(torch.int64)
    out, _ = renorm_digits(q, limbs=L)
    return torch.where(neg[..., None], wide_neg(out), out)


def wide_to_host_ints(arr, validity=None) -> List:
    """(n, L) host array -> python bigint mantissas (None where invalid)."""
    import numpy as np

    a = np.asarray(arr)
    L = a.shape[-1]
    out = []
    for i in range(a.shape[0]):
        if validity is not None and not validity[i]:
            out.append(None)
        else:
            v = 0
            for j in range(L):
                v = v * W18 + int(a[i, j])
            out.append(v)
    return out


__all__ = [
    "W9", "W18", "make_wide", "widen_i64", "digits_of_wide",
    "digits_of_i64", "renorm_digits", "wide_add", "wide_neg",
    "wide_mul_pow10", "wide_mul_pow2", "wide_div_round_half_up",
    "wide_to_host_ints",
]
