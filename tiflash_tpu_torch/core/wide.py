"""Multi-limb wide-decimal arithmetic, the slice the port's main path uses.

Counterpart of ``tiflash_tpu/core/wide.py``.  A wide mantissa is L int64
limbs in base 10^18 stored as a trailing dimension ``(..., L)``:

    value = limb[0] * (10**18)**(L-1) + ... + limb[L-1],
    limb[0] signed, limbs[1..L-1] in [0, 10**18)

Internal arithmetic decomposes limbs into base-10^9 digits so every
intermediate fits int64.  Torch's ``//`` on integer tensors is floor
division, like ``jnp``'s, so the digit arithmetic ports unchanged.

Ported: what the fused recombination (``ops/stream_fuse.py``), the
wide-sum rewrite (``ops/aggregate.py:_wide_rewrite``) and the decimal
functions (``expr/functions.py``: compare, plus/minus, multiply and the
exact long division) call.  The division seeds each quotient digit from a
float64 ratio and corrects it with exact limb arithmetic; eager torch
float64 is IEEE on the CPU and on the card, and the corrections make the
quotient exact either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

W9 = 10 ** 9
W18 = 10 ** 18
MAX_WIDE_PRECISION = 65


def wide_hi(w: torch.Tensor) -> torch.Tensor:
    return w[..., 0]


def wide_lo(w: torch.Tensor) -> torch.Tensor:
    return w[..., 1]


def make_wide(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi.to(torch.int64), lo.to(torch.int64)], dim=-1)


def widen_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 mantissa -> two-limb.  Floor division keeps lo in [0, W18)."""
    hi = x // W18
    return make_wide(hi, x - hi * W18)


def narrow_i64(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """two-limb -> (int64 value, fits flag).  The value is garbage where
    the flag is False (|value| >= 2**63); the product wraps but is exact
    whenever the flag is True."""
    hi, lo = wide_hi(w), wide_lo(w)
    val = hi * W18 + lo
    max_lo_at_9 = 2 ** 63 - 1 - 9 * W18    # hi == 9 ceiling
    min_lo_at_m10 = 10 * W18 - 2 ** 63     # hi == -10 floor
    fits = ((hi < 9) | ((hi == 9) & (lo <= max_lo_at_9))) & (
        (hi > -10) | ((hi == -10) & (lo >= min_lo_at_m10)))
    return val, fits


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


def wide_cmp_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically on limbs: valid because limbs below the top
    are in [0, W18)."""
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    L = a.shape[-1]
    lt = a[..., L - 1] < b[..., L - 1]
    for i in range(L - 2, -1, -1):
        lt = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & lt)
    return lt


def wide_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    eq = a[..., 0] == b[..., 0]
    for i in range(1, a.shape[-1]):
        eq = eq & (a[..., i] == b[..., i])
    return eq


def wide_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wide_add(a, wide_neg(b))


def wide_to_f64(w: torch.Tensor) -> torch.Tensor:
    """float64 value (relative error a few ulp).  Negatives are negated to
    magnitude limbs first: combining the floor layout directly cancels
    catastrophically."""
    neg = w[..., 0] < 0
    mag = torch.where(neg[..., None], wide_neg(w), w)
    acc = mag[..., 0].to(torch.float64)
    for i in range(1, w.shape[-1]):
        acc = acc * float(W18) + mag[..., i].to(torch.float64)
    return torch.where(neg, -acc, acc)


def _div_small_floor(w: torch.Tensor, c) -> Tuple[torch.Tensor, torch.Tensor]:
    """floor(w / c) and remainder for non-negative w and a small positive
    int c <= ~9.2e9 (so rem * W9 + digit fits int64)."""
    ds = digits_of_wide(w)            # LSB first
    q = []
    rem = torch.zeros_like(ds[0])
    for d in reversed(ds):            # MSB first
        cur = rem * W9 + d
        qi = torch.div(cur, c, rounding_mode="floor")
        rem = cur - qi * c
        q.append(qi)
    out, _ = renorm_digits(q[::-1], limbs=w.shape[-1])
    return out, rem


def _div_envelopes(limbs: int):
    """(fit, cap): magnitudes below these renormalize without saturation
    at every internal step of the division for ``limbs`` limbs."""
    ceil = 9.22 * 10 ** (18 * limbs)
    return ceil * 0.992, ceil * 0.995


def _shifted_scaled(dd: Sequence[torch.Tensor], k: int, c: Optional[torch.Tensor],
                    limbs: int = 2) -> torch.Tensor:
    """den * c * W9**k as an ``limbs``-limb value (c=None means c == 1),
    when the caller guarantees the product fits.  Digits landing at
    positions >= 2*limbs-1 fold into the top base-10^9 coefficient."""
    zero = torch.zeros_like(dd[0])
    ntop = 2 * limbs - 1
    pos = [zero] * ntop
    top = zero
    for j, d in enumerate(dd):
        p = j + k
        if p < ntop:
            pos[p] = d
        else:
            f = W9 ** (p - ntop)
            if f < 2 ** 62:  # higher folds require d == 0 to fit anyway
                top = top + d * f
    if c is not None:
        pos = [x * c for x in pos]
        top = top * c
    w, _ = renorm_digits(pos + [top], limbs=limbs)
    return w


def wide_divmod(w: torch.Tensor, den: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """floor(|w| / |den|) and remainder, the sign applied to the quotient
    (truncating division); ``den`` nonzero.  Restoring base-10^9 long
    division over the quotient digit positions: each digit is seeded from
    a float64 ratio (off by at most ~2) and corrected with exact limb
    arithmetic, two conditional restore steps each way.  Every
    intermediate product is capped below the representable ceiling."""
    L = w.shape[-1]
    if den.shape[-1] != L:  # mixed limb counts: re-limb the divisor
        den, _ = resize_wide(den, L)
    fit_f, cap_f = _div_envelopes(L)
    neg = (w[..., 0] < 0) ^ (den[..., 0] < 0)
    r = torch.where((w[..., 0] < 0)[..., None], wide_neg(w), w)
    dmag = torch.where((den[..., 0] < 0)[..., None], wide_neg(den), den)
    dd = digits_of_wide(dmag)
    denf = wide_to_f64(dmag)
    nq = 2 * L           # quotient digit positions W9^0 .. W9^(2L-1)
    qdigits: List[torch.Tensor] = []
    for k in range(nq, -1, -1):
        denkf = denf * float(W9) ** k
        fits = denkf < fit_f
        if k == 0:
            fits = torch.ones_like(fits)  # den itself always fits
        denk = _shifted_scaled(dd, k, None, limbs=L)
        # the cap keeps c*denk below the saturation ceiling while never
        # capping below the true digit
        cap = torch.floor(cap_f / denkf)
        est = torch.floor(wide_to_f64(r) / denkf)
        c = torch.minimum(est.clamp(0.0, float(W9 + 2)), cap).to(torch.int64)
        c = torch.where(fits, c, torch.zeros_like(c))
        r = wide_sub(r, _shifted_scaled(dd, k, c, limbs=L))
        for _ in range(2):  # float undershoot: r still >= den*W9^k
            over = fits & ~wide_cmp_lt(r, denk) & (r[..., 0] >= 0)
            c = c + over.to(torch.int64)
            r = torch.where(over[..., None], wide_sub(r, denk), r)
        for _ in range(2):  # float overshoot: r went negative
            under = fits & (r[..., 0] < 0)
            c = c - under.to(torch.int64)
            r = torch.where(under[..., None], wide_add(r, denk), r)
        qdigits.append(c)
    qdigits = qdigits[::-1]          # now LSB first, length nq+1
    qdigits[nq - 1] = qdigits[nq - 1] + qdigits[nq] * W9
    q, _ = renorm_digits(qdigits[:nq], limbs=L)
    q = torch.where(neg[..., None], wide_neg(q), q)
    return q, r


def wide_div_wide_round_half_up(w: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """w / den with TiDB ROUND_HALF_UP (away from zero), den nonzero wide."""
    if den.shape[-1] != w.shape[-1]:
        den, _ = resize_wide(den, w.shape[-1])
    q, r = wide_divmod(w, den)
    dmag = torch.where((den[..., 0] < 0)[..., None], wide_neg(den), den)
    # bump iff 2r >= |den|  <=>  r >= ceil(|den| / 2); 2r itself may exceed
    # the representable range, so compare against the halved divisor
    half_ceil, _ = _div_small_floor(
        wide_add(dmag, widen_i64_to(torch.ones_like(den[..., 0]), den.shape[-1])), 2)
    bump = ~wide_cmp_lt(r, half_ceil)
    neg = (w[..., 0] < 0) ^ (den[..., 0] < 0)
    one = widen_i64_to(torch.ones_like(w[..., 0]), w.shape[-1])
    return torch.where(bump[..., None],
                       torch.where(neg[..., None], wide_sub(q, one), wide_add(q, one)),
                       q)


def wide_mul(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a * b exactly, with an overflow flag for a product past the limb
    count's range: a base-10^9 schoolbook product on magnitudes."""
    L = max(a.shape[-1], b.shape[-1])
    if a.shape[-1] != L:
        a, _ = resize_wide(a, L)
    if b.shape[-1] != L:
        b, _ = resize_wide(b, L)
    neg = (a[..., 0] < 0) ^ (b[..., 0] < 0)
    ma = torch.where((a[..., 0] < 0)[..., None], wide_neg(a), a)
    mb = torch.where((b[..., 0] < 0)[..., None], wide_neg(b), b)
    da, db = digits_of_wide(ma), digits_of_wide(mb)
    zero = torch.zeros_like(da[0])
    ntop = 2 * L - 1
    pos = [zero] * ntop
    top = zero
    for i in range(2 * L):
        for j in range(2 * L):
            p = i + j
            if p < ntop:
                pos[p] = pos[p] + da[i] * db[j]
            else:
                f = W9 ** (p - ntop)
                if f < 2 ** 62:
                    top = top + da[i] * db[j] * f
    w, ovf = renorm_digits(pos + [top], limbs=L)
    ovf = ovf | (wide_to_f64(ma) * wide_to_f64(mb) > 0.98 * 9.22 * 10 ** (18 * L))
    return torch.where(neg[..., None], wide_neg(w), w), ovf


def wide_scale_up(w: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """value * 10**k for any k >= 0 (in steps of ``wide_mul_pow10``)."""
    ovf = torch.zeros(w.shape[:-1], dtype=torch.bool, device=w.device)
    while k > 0:
        w, o = wide_mul_pow10(w, min(k, 9))
        ovf = ovf | o
        k -= 9
    return w, ovf


def resize_wide(w: torch.Tensor, limbs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-limb a wide value to ``limbs`` limbs; (result, overflow flag when
    shrinking loses magnitude).  Shrinking keeps the low limbs and folds
    the sign fill (upper limbs all 0, or -1 followed by 10^18-1 fills)
    into the new top limb; anything else overflows."""
    if w.shape[-1] == limbs:
        return w, torch.zeros(w.shape[:-1], dtype=torch.bool, device=w.device)
    if w.shape[-1] < limbs:
        return renorm_digits(digits_of_wide(w), limbs=limbs)
    canon, ov = renorm_digits(digits_of_wide(w), limbs=w.shape[-1])
    cut = w.shape[-1] - limbs
    upper, low = canon[..., :cut], canon[..., cut:]
    pos_fit = torch.all(upper == 0, dim=-1)
    neg_fit = upper[..., 0] == -1
    for j in range(1, cut):
        neg_fit = neg_fit & (upper[..., j] == W18 - 1)
    new_top = torch.where(neg_fit, low[..., 0] - W18, low[..., 0])
    out = torch.cat([new_top[..., None], low[..., 1:]], dim=-1)
    return out, ov | ~(pos_fit | neg_fit)


def widen_i64_to(x: torch.Tensor, limbs: int) -> torch.Tensor:
    """int64 mantissa -> L-limb wide."""
    out, _ = renorm_digits(digits_of_i64(x), limbs=limbs)
    return out


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
    "W9", "W18", "MAX_WIDE_PRECISION", "make_wide", "wide_hi", "wide_lo",
    "widen_i64", "narrow_i64", "digits_of_wide", "digits_of_i64",
    "renorm_digits", "wide_add", "wide_neg", "wide_sub", "wide_mul_pow10",
    "wide_mul_pow2", "wide_cmp_lt", "wide_eq", "wide_to_f64",
    "wide_div_round_half_up", "wide_divmod", "wide_div_wide_round_half_up",
    "wide_mul", "wide_scale_up", "resize_wide", "widen_i64_to",
    "wide_to_host_ints",
]
