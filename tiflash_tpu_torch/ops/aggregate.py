"""Aggregation: the keyless, direct-indexed, sort and stream methods.

Counterpart of ``tiflash_tpu/ops/aggregate.py``.  Ported here:

- ``AggDesc``, ``AggregateResult`` and TiDB's result-type rules
  (``agg_result_dtype``);
- ``_wide_rewrite``: exact wide-decimal sum/avg around the int64 methods,
  narrow-stored when stats prove int64 is exact, else by base-10^9 digit
  decomposition;
- key packing for small static key domains (``pack_keys_direct``);
- ``hash_aggregate`` dispatch to the keyless method (``aggregate_scalar``),
  the direct method (``aggregate_direct``) for packed key domains up to
  ``DIRECT_DOMAIN_LIMIT``, the stream method (``aggregate_stream``) for
  keys the block is clustered on, and the sort method
  (``aggregate_sort``) for the other keys without a static domain.  The
  direct method has its masked sub-method (domains <= 64), its
  ``direct_agg`` kernel branch (``ops/cuda/direct_agg.py``) and its
  segment sub-method.

The aggregate functions are the reference's: sum, count, avg, min, max,
count_distinct, first, quantile, var_pop/var_samp/stddev_pop/stddev_samp,
bit_and/bit_or/bit_xor, group_concat (plain and DISTINCT, always by the
sort method) and approx_count_distinct (exact when grouped, the KMV
estimate of ``ops/sketch.py`` when keyless).  ``count_distinct`` marks
the first live row of each distinct (group keys, argument) pair and
``quantile`` the row holding the element at floor(q * (n_valid - 1)) of
each group's sorted values: a stable sort and a boundary compare,
scattered back to row order; the sort method with one unfiltered
count_distinct or quantile sorts its argument as a trailing key instead.
Per-group min/max/first is a ``scatter_reduce_`` where the reference
takes a sorted segmented scan (``ops/segments.py``, a TPU scatter
workaround); the integers are the same.  Bit aggregates reduce int64 bit
patterns (``torch.uint64`` lacks the ops) by a segmented scan over rows
sorted by group, and return BIGINT UNSIGNED, never NULL.  Float sums
(sum, avg, the variance moments) add in another order than the
reference's, so they agree to rounding, within the bound each test
states.  The distributed forms (``approx_cd_partial``/``approx_cd_final``)
and ``mode="auto"`` raise: they come with the distribution slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.block import Block, Column
from ..core.dtypes import (
    DataType,
    Decimal,
    FLOAT64,
    INT64,
    TypeKind,
    UINT64,
)

# MySQL bit-reduction aggregates: 64-bit accumulation, never NULL (an
# empty group holds the identity)
_BIT_FUNCS = ("bit_and", "bit_or", "bit_xor")
_BIT_OPS = {"bit_and": "band", "bit_or": "bor", "bit_xor": "bxor"}
_VAR_FUNCS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")
_SKETCH_FUNCS = ("approx_count_distinct", "approx_cd_final")
_DISTRIBUTED = ("approx_cd_partial", "approx_cd_final")


def _bit_identity(func: str) -> int:
    """The identity as an int64 bit pattern (bit_and: all ones)."""
    return -1 if func == "bit_and" else 0


@dataclasses.dataclass(frozen=True)
class AggDesc:
    """One aggregate: ``func(arg) AS name [FILTER filter_col]``.  ``arg``
    is None for count(*).  ``param`` is quantile's fraction, group_concat's
    item cap (default 64) or the sketch's k; ``separator`` and
    ``distinct`` (values deduplicated, in binary-collation order) are
    group_concat's."""

    func: str
    arg: Optional[str]
    name: str
    filter_col: Optional[str] = None
    param: Optional[float] = None
    separator: str = ","
    distinct: bool = False


def agg_result_dtype(func: str, arg: Optional[DataType]) -> DataType:
    """TiDB result-type rules: sum widens decimal precision by 22, avg
    adds 4 to precision and scale; both cap at 65."""
    if func in ("count", "count_distinct", "approx_count_distinct",
                "approx_cd_partial", "approx_cd_final"):
        return INT64
    assert arg is not None
    if func in ("min", "max", "first"):
        return arg.with_nullable(True)
    if func == "sum":
        if arg.is_decimal:
            return Decimal(min(arg.precision + 22, 65), arg.scale, nullable=True)
        if arg.is_float:
            return FLOAT64.with_nullable(True)
        if arg.is_unsigned:
            return UINT64.with_nullable(True)
        return INT64.with_nullable(True)
    if func == "avg":
        if arg.is_float:
            return FLOAT64.with_nullable(True)
        if arg.is_decimal:
            return Decimal(min(arg.precision + 4, 65), min(arg.scale + 4, 30),
                           nullable=True)
        return Decimal(18, 4, nullable=True)
    if func in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        return FLOAT64.with_nullable(True)
    if func in ("quantile", "group_concat"):
        return arg.with_nullable(True)
    if func in ("bit_and", "bit_or", "bit_xor"):
        return UINT64
    raise NotImplementedError(f"aggregate {func}")


def _check_supported(aggs: Sequence[AggDesc]) -> None:
    for a in aggs:
        if a.func in _DISTRIBUTED:
            raise NotImplementedError(
                f"aggregate {a.func} is the partial/final form of "
                "approx_count_distinct, only meaningful ahead of an exchange: "
                "it comes with the distribution slice of the port")


# ---------------------------------------------------------------------------
# wide-decimal (precision 19..65) sum/avg
# ---------------------------------------------------------------------------

# scaled-sum magnitudes below this are provably exact in int64 accumulation
_WIDE_SAFE = 2 ** 62


def _abs_bound(col: Column) -> Optional[int]:
    if col.stats is None:
        return None
    return max(abs(int(col.stats[0])), abs(int(col.stats[1])))


def _wide_rewrite(block: Block, aggs: Sequence[AggDesc]):
    """Exact wide-decimal (result precision > 18) sum/avg AROUND the
    unchanged int64 aggregation methods.

    - narrow-stored: when stats prove ``rows * max|mantissa| * 10^shift``
      fits int64, the int64 accumulation is already exact and its 1-D
      output is simply typed wide;
    - digit decomposition: otherwise the argument splits into base-10^9
      digit columns, each summed by the unchanged method, and the digit
      sums carry-normalize into a two-limb column (``core/wide.py``).

    Returns None when no aggregate needs widening, else
    ``(block', aggs', post)``."""
    from ..core.wide import (
        digits_of_i64,
        digits_of_wide,
        renorm_digits,
        wide_div_round_half_up,
        wide_mul_pow10,
    )

    def _is_wide2(c: Column) -> bool:
        return c.dtype.is_wide_decimal and c.data.ndim == 2

    relevant = [
        a for a in aggs
        if a.func in ("sum", "avg") and a.arg is not None
        and block[a.arg].dtype.is_decimal
        and agg_result_dtype(a.func, block[a.arg].dtype).is_wide_decimal
    ]
    minmax = [
        a for a in aggs
        if a.func in ("min", "max", "first") and a.arg is not None
        and _is_wide2(block[a.arg])
    ]
    for a in aggs:
        if (a.arg is not None and _is_wide2(block[a.arg])
                and a.func not in ("sum", "avg", "count", "min", "max", "first")):
            raise NotImplementedError(
                f"{a.func} over a two-limb wide-decimal column")
    if not relevant and not minmax:
        return None

    rows = block.capacity
    out_block = block
    aggs2: List[AggDesc] = []
    skip: set = set()
    assemble: dict = {}
    for a in aggs:
        if a in minmax:
            # min/max over a two-limb column: aggregate its int64 rank in
            # a stable limb-wise sort, then gather the value back by rank
            from .sort import lexsort_stable

            col = block[a.arg]
            n = col.data.shape[0]
            perm = lexsort_stable([col.data[:, j] for j in range(col.data.shape[-1])])
            ranks = torch.empty(n, dtype=torch.int64, device=perm.device)
            ranks[perm] = torch.arange(n, dtype=torch.int64, device=perm.device)
            nm = f"__wm__{a.name}"
            out_block = out_block.with_column(nm, Column(ranks, col.validity, INT64))
            res_nm = f"__wmr__{a.name}"
            aggs2.append(AggDesc(a.func, nm, res_nm, a.filter_col))
            assemble[res_nm] = ("rank_gather", a, col.data[perm],
                                agg_result_dtype(a.func, col.dtype))
            continue
        if a not in relevant:
            aggs2.append(a)
            continue
        col = block[a.arg]
        rdt = agg_result_dtype(a.func, col.dtype)
        shift = rdt.scale - col.dtype.scale
        wide_in = col.data.ndim == 2
        if not wide_in:
            b = _abs_bound(col)
            if b is not None and b * rows * (10 ** shift) < _WIDE_SAFE:
                aggs2.append(a)
                vb = b * rows if a.func == "sum" else b * (10 ** shift)
                assemble[a.name] = ("narrow", vb)
                continue
        digs = (
            digits_of_wide(col.data)
            if wide_in
            else digits_of_i64(col.data.to(torch.int64))
        )
        sum_names = []
        for j, d in enumerate(digs):
            nm = f"__wd{j}__{a.name}"
            out_block = out_block.with_column(nm, Column(d, col.validity, INT64))
            sum_names.append(f"__ws{j}__{a.name}")
            aggs2.append(AggDesc("sum", nm, sum_names[-1], a.filter_col))
        cnt_name = None
        if a.func == "avg":
            cnt_name = f"__wc__{a.name}"
            aggs2.append(
                AggDesc("count", f"__wd0__{a.name}", cnt_name, a.filter_col)
            )
            skip.add(cnt_name)
        skip.update(sum_names[1:])
        assemble[sum_names[0]] = ("wide", a, sum_names, cnt_name, shift, rdt)

    def post(res: Block) -> Block:
        names: List[str] = []
        cols: List[Column] = []
        d = res.as_dict()
        for nm in res.names:
            if nm in skip:
                continue
            spec = assemble.get(nm)
            if spec is None:
                names.append(nm)
                cols.append(d[nm])
                continue
            if spec[0] == "narrow":
                c = d[nm]
                names.append(nm)
                cols.append(Column(c.data, c.validity, c.dtype,
                                   stats=(-spec[1], spec[1])))
                continue
            if spec[0] == "rank_gather":
                _, a, sorted_w, rdt = spec
                c = d[nm]
                idx = c.data.clamp(0, sorted_w.shape[0] - 1).long()
                names.append(a.name)
                cols.append(Column(sorted_w[idx], c.validity, rdt))
                continue
            _, a, sum_names, cnt_name, shift, rdt = spec
            validity = d[sum_names[0]].validity
            w, _ovf = renorm_digits([d[s].data for s in sum_names],
                                    limbs=rdt.decimal_limbs)
            if a.func == "avg":
                if shift:
                    w, _ = wide_mul_pow10(w, shift)
                w = wide_div_round_half_up(w, d[cnt_name].data.clamp(min=1))
            names.append(a.name)
            cols.append(Column(w, validity, rdt))
        return Block(names=tuple(names), columns=tuple(cols), sel=res.sel,
                     clustered_by=res.clustered_by)

    return out_block, aggs2, post


# ---------------------------------------------------------------------------
# key packing (direct method eligibility)
# ---------------------------------------------------------------------------


def key_domain_size(col: Column) -> Optional[int]:
    """Statically known key domain, if any: |dictionary| for strings, 2 for
    bool.  (+1 slot for NULL when nullable.)"""
    base: Optional[int] = None
    if col.dtype.is_string and col.dictionary is not None:
        base = max(1, len(col.dictionary))
    elif col.dtype.kind is TypeKind.BOOL:
        base = 2
    if base is None:
        return None
    return base + (1 if col.dtype.nullable or col.validity is not None else 0)


def pack_keys_direct(cols: Sequence[Column]) -> Optional[Tuple[torch.Tensor, int]]:
    """Mixed-radix pack of small-domain keys -> (slot_ids int32, domain)."""
    domains = [key_domain_size(c) for c in cols]
    if any(d is None for d in domains):
        return None
    total = 1
    for d in domains:
        total *= d
    slot = None
    for c, d in zip(cols, domains):
        v = c.data.to(torch.int32)
        if c.validity is not None:
            v = torch.where(c.validity, v + 1, torch.zeros_like(v))  # NULL -> 0
        elif c.dtype.nullable:
            v = v + 1
        slot = v if slot is None else slot * d + v
    return slot, total


def unpack_keys_direct(
    slots: torch.Tensor, cols: Sequence[Column]
) -> List[Column]:
    """Inverse of pack_keys_direct for materializing group-key columns."""
    domains = [key_domain_size(c) for c in cols]
    out: List[Column] = []
    rem = slots
    for c, d in reversed(list(zip(cols, domains))):
        v = rem % d
        rem = rem // d
        if c.validity is not None or c.dtype.nullable:
            validity = v > 0
            data = (v - 1).clamp(min=0)
        else:
            validity = None
            data = v
        out.append(
            Column(data.to(c.dtype.torch_dtype), validity, c.dtype, c.dictionary)
        )
    out.reverse()
    return out


DIRECT_DOMAIN_LIMIT = 4096
MASKED_DOMAIN_LIMIT = 64


# ---------------------------------------------------------------------------
# segmented reductions and distinct flags
# ---------------------------------------------------------------------------


def _identity_for(func: str, dtype: DataType):
    """The identity of ``func`` in the column's physical dtype."""
    phys = dtype.torch_dtype
    if func == "min":
        return float("inf") if dtype.is_float else torch.iinfo(phys).max
    if func == "max":
        return float("-inf") if dtype.is_float else torch.iinfo(phys).min
    return 0


def _segment_reduce(func: str, vals: torch.Tensor, idx: torch.Tensor,
                    num_segments: int, ident) -> torch.Tensor:
    """Per-segment min or max of ``vals`` by segment ids ``idx`` (empty
    segments hold ``ident``)."""
    acc = torch.full((num_segments,), ident, dtype=vals.dtype, device=vals.device)
    reduce = {"min": "amin", "max": "amax"}[func]
    return acc.scatter_reduce_(0, idx, vals, reduce=reduce, include_self=True)


def _distinct_first_flags(block: Block, keys: Sequence[str], arg: str,
                          live: torch.Tensor) -> torch.Tensor:
    """Bool row mask: True on the first live occurrence of each
    (group keys, arg) pair, in row order: a stable sort on (dead last,
    keys, arg), a compare with the previous sorted row, scattered back."""
    from .sort import lexsort_stable

    operands: List[torch.Tensor] = [~live]
    for name in list(keys) + [arg]:
        c = block[name]
        if c.validity is not None:
            operands.append(~c.validity)
            # NULL slots carry arbitrary data (join payloads): zero them so
            # all NULLs compare equal
            operands.append(torch.where(c.validity, c.data, torch.zeros_like(c.data)))
        else:
            operands.append(c.data)
    perm = lexsort_stable(operands)
    n = block.capacity
    neq = torch.zeros(n, dtype=torch.bool, device=live.device)
    for op in operands:
        arr = op[perm]
        neq |= arr != torch.roll(arr, 1)
    neq[:1] = True
    flags = torch.empty_like(neq)
    flags[perm] = neq
    return flags


def _quantile_row_flags(block: Block, keys: Sequence[str], arg: str, q: float,
                        live: torch.Tensor) -> torch.Tensor:
    """Bool row mask marking, per group, the row holding the q-quantile of
    ``arg``: the element at floor(q * (n_valid - 1)) of the group's sorted
    valid values, in row order.  Group keys sort on their raw data, as in
    the reference."""
    from .segments import forward_fill_positions
    from .sort import lexsort_stable

    n = block.capacity
    c = block[arg]
    valid = live if c.validity is None else (live & c.validity)
    operands: List[torch.Tensor] = [~live]
    for name in keys:
        kc = block[name]
        if kc.validity is not None:
            operands.append(~kc.validity)
        operands.append(kc.data)
    n_group_ops = len(operands)
    operands.append(~valid)  # valid values first within the group
    operands.append(c.data)
    perm = lexsort_stable(operands)
    dev = live.device
    gb = torch.zeros(n, dtype=torch.bool, device=dev)
    for op in operands[:n_group_ops]:
        arr = op[perm]
        gb |= arr != torch.roll(arr, 1)
    gb[:1] = True
    gid = torch.cumsum(gb.to(torch.int64), 0) - 1
    start = forward_fill_positions(gb)
    valid_s = valid[perm]
    cnt = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, gid, valid_s.to(torch.int64))
    target = start + torch.floor(q * (cnt[gid] - 1).to(torch.float64)).to(torch.int64)
    flags_sorted = (torch.arange(n, device=dev) == target) & valid_s
    flags = torch.empty_like(flags_sorted)
    flags[perm] = flags_sorted
    return flags


def _compute_distinct_flags(block: Block, keys: Sequence[str],
                            aggs: Sequence[AggDesc], live: torch.Tensor) -> dict:
    """Per count_distinct aggregate its first-occurrence row flags, per
    quantile its target-row flags, over the rows passing its filter."""
    out = {}
    for a in aggs:
        if a.func == "count_distinct":
            out[a.name] = _distinct_first_flags(block, keys, a.arg,
                                                _agg_live(block, a, live))
        elif a.func == "quantile":
            q = a.param if a.param is not None else 0.5
            out[a.name] = _quantile_row_flags(block, keys, a.arg, q,
                                              _agg_live(block, a, live))
    return out


def _masked_eligible(aggs: Sequence[AggDesc]) -> bool:
    return all(a.func in ("sum", "count", "avg", "min", "max", "first") + _BIT_FUNCS
               for a in aggs)


def _stream_batched_eligible(aggs: Sequence[AggDesc]) -> bool:
    return all(a.func in ("sum", "count", "avg", "min", "max") for a in aggs)


def _bit_values(col: Column, valid_row: torch.Tensor, func: str) -> torch.Tensor:
    """The argument as int64 bit patterns (the reference's astype(uint64)),
    the identity on rows that do not contribute."""
    from ..expr.functions import _u64_operand

    bits = _u64_operand(col.data)
    return torch.where(valid_row, bits,
                       torch.full((), _bit_identity(func), dtype=torch.int64,
                                  device=bits.device))


_TRASH_LANES = 1024


def _slot_spans(idx: torch.Tensor, num_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first row, last row) of each slot of non-decreasing slot ids
    ``idx``, -1 for an empty slot; rows at or past ``num_slots`` are
    trash.  Each slot has one first and one last row, so the scatter
    writes each address once (the other rows go to trash lanes by
    position): no atomics contend, unlike an ``index_add_`` into few
    slots."""
    n = idx.shape[0]
    dev = idx.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    trash = num_slots + pos % _TRASH_LANES
    out = []
    for shift in (1, -1):
        edge = idx != torch.roll(idx, shift)
        if n:
            edge[0 if shift == 1 else n - 1] = True
        table = torch.full((num_slots + _TRASH_LANES,), -1, dtype=torch.int64, device=dev)
        table.scatter_(0, torch.where(edge & (idx < num_slots), idx, trash), pos)
        out.append(table[:num_slots])
    return out[0], out[1]


def _scan_segment_reduce(op: str, vals: torch.Tensor, gids: torch.Tensor,
                         num_slots: int, ident, sorted_ids: bool) -> torch.Tensor:
    """Per-slot reduction of ``op`` (``window._segmented_prefix``'s ops)
    by a segmented scan over the rows in group order (a stable sort of
    the ids unless they never decrease already), read at each slot's last
    row; an empty slot holds ``ident``.  The order of operations depends
    on the rows alone, so a float sum is the same on every device."""
    from .window import _segmented_prefix

    dev = vals.device
    idx = gids.long()
    if not sorted_ids:
        order = torch.argsort(idx, stable=True)
        idx, vals = idx[order], vals[order]
    n = idx.shape[0]
    ident_t = torch.full((), ident, dtype=vals.dtype, device=dev)
    if not n:
        return ident_t.expand(num_slots).clone()
    start = idx != torch.roll(idx, 1)
    start[:1] = True
    run = _segmented_prefix(op, vals, start)
    _, last = _slot_spans(idx, num_slots)
    return torch.where(last >= 0, run[last.clamp(min=0)], ident_t)


def _bit_segment_reduce(func: str, bits: torch.Tensor, gids: torch.Tensor,
                        num_slots: int, sorted_ids: bool) -> Column:
    """Per-slot bit_and/or/xor of int64 bit patterns, as a BIGINT
    UNSIGNED column (never NULL: an empty slot holds the identity).  Bit
    operations are exact in any order."""
    from ..expr.functions import _u64

    red = _scan_segment_reduce(_BIT_OPS[func], bits, gids, num_slots,
                               _bit_identity(func), sorted_ids)
    return Column(_u64(red), None, UINT64)


def _moments(a: AggDesc, col: Column, valid_row: torch.Tensor, segsum, cnt):
    """var_pop/var_samp/stddev_pop/stddev_samp from the sum and the sum of
    squares of the argument as a double (decimals divided by 10^scale)."""
    from ..expr.functions import _div_f64, _sqrt

    x = col.data.to(torch.float64)
    if col.dtype.is_decimal:
        x = _div_f64(x, 10 ** col.dtype.scale)
    x = torch.where(valid_row, x, torch.zeros_like(x))
    s1, s2 = segsum(x), segsum(x * x)
    nf = cnt.clamp(min=1).to(torch.float64)
    var = torch.clamp(s2 / nf - (s1 / nf) ** 2, min=0.0)
    if a.func.endswith("samp"):
        var = var * nf / torch.clamp(nf - 1.0, min=1.0)
        ok = cnt > 1
    else:
        ok = cnt > 0
    data = _sqrt(var) if a.func.startswith("stddev") else var
    return Column(data, ok, agg_result_dtype(a.func, col.dtype))


def _group_concat(a: AggDesc, col: Column, base: torch.Tensor, cnt: torch.Tensor,
                  sorted_layout, segsum) -> Column:
    """Per-slot dictionary codes as a (num_slots, max_items) gather matrix:
    the sort put each group's contributing rows first in its span (in row
    order, or value order for DISTINCT), so slot g's item j is row
    start_g + j (DISTINCT: the j-th distinct value's first row).  The
    strings are joined with the separator when the column is decoded."""
    from .merge import flagged_positions

    if sorted_layout is None:
        raise NotImplementedError("group_concat requires the sort method")
    if col.dictionary is None:
        raise NotImplementedError(
            "group_concat argument must be a dictionary string column")
    first_flags, ends_dense = sorted_layout
    dev = base.device
    max_items = int(a.param) if a.param else 64
    n_rows = col.data.shape[0]
    item = torch.arange(max_items, dtype=torch.int64, device=dev)
    if a.distinct:
        vrow = base if col.validity is None else (base & col.validity)
        newval = col.data != torch.roll(col.data, 1)
        dist_first = vrow & (first_flags | newval)
        shown = segsum(dist_first.to(torch.int64))
        compact = flagged_positions(dist_first, n_rows)
        dstarts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum(shown, 0)[:-1]])
        idx = (dstarts[:, None] + item[None, :]).clamp(0, n_rows - 1)
        codes = col.data[compact[idx].clamp(min=0).long()]
    else:
        prev_e = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                            ends_dense[:-1]])
        starts = (prev_e + 1).clamp(min=0)
        idx = (starts[:, None] + item[None, :]).clamp(0, n_rows - 1)
        codes = col.data[idx]
        shown = cnt
    vmat = item[None, :] < shown.clamp(max=max_items)[:, None]
    return Column(codes, vmat, agg_result_dtype(a.func, col.dtype), col.dictionary,
                  concat_sep=a.separator)


@dataclasses.dataclass
class AggregateResult:
    block: Block            # group keys + agg outputs; sel marks live slots
    num_groups: torch.Tensor
    # 0 = fits; else the slot capacity actually required
    overflow: torch.Tensor


def _agg_live(block: Block, a: AggDesc, live: torch.Tensor) -> torch.Tensor:
    """Row mask for one aggregate: live rows passing its -If filter."""
    if a.filter_col is None:
        return live
    f = block[a.filter_col]
    m = f.data.to(torch.bool)
    if f.validity is not None:
        m = m & f.validity
    return live & m


def _finish(a: AggDesc, col: Optional[Column], sums: torch.Tensor,
            cnts: torch.Tensor) -> Column:
    """sum or avg column from per-slot sums and non-null counts."""
    rdt = agg_result_dtype(a.func, col.dtype)
    if a.func == "sum":
        return Column(sums.to(rdt.torch_dtype), cnts > 0, rdt)
    from ..expr.functions import _div_round_half_up

    if rdt.is_decimal:
        src = col.dtype.scale if col.dtype.is_decimal else 0
        num = sums * (10 ** (rdt.scale - src))
        d = _div_round_half_up(num, cnts.clamp(min=1))
    else:
        d = sums / cnts.clamp(min=1).to(torch.float64)
    return Column(d.to(rdt.torch_dtype), cnts > 0, rdt)


def _accumulate(
    aggs: Sequence[AggDesc],
    block: Block,
    gids: torch.Tensor,
    live: torch.Tensor,
    num_slots: int,
    distinct_flags: Optional[dict] = None,
    sorted_layout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    sorted_ids: bool = False,
) -> List[Tuple[str, Column]]:
    """Segment sub-method: every aggregate as an ``index_add_`` (min/max/
    first a ``scatter_reduce_``) into ``num_slots`` dense slots plus a
    trailing trash slot, where dead rows (``gids == num_slots``) land.
    With ``sorted_ids`` (the sort and stream methods) a sum reads each
    slot's span instead: an integer sum as a difference of the running
    sum, a float sum from a segmented scan.
    ``distinct_flags`` holds, per count_distinct and quantile, its row
    flags in the block's row order.  ``sorted_layout`` = (group start
    flags, each slot's last row) of rows sorted by group, which
    group_concat needs; ``sorted_ids`` says the ids never decrease."""
    idx = gids.long()

    spans: list = []

    def segsum(vals: torch.Tensor) -> torch.Tensor:
        if sorted_ids and vals.is_floating_point():
            # rows in group order: a float sum as a segmented scan, in one
            # order of additions on every device (the reference's shape)
            return _scan_segment_reduce("sum", vals, gids, num_slots, 0.0, True)
        if sorted_ids:
            # an integer sum: the running sum differenced over each slot's
            # span (exact mod 2^64), the reference's sorted layout
            if not spans:
                spans.extend(_slot_spans(idx, num_slots))
            first, last = spans
            ps = torch.cumsum(vals, 0)
            zero = torch.zeros((), dtype=ps.dtype, device=ps.device)
            before = torch.where(first > 0, ps[(first - 1).clamp(min=0)], zero)
            return torch.where(last >= 0, ps[last.clamp(min=0)] - before, zero)
        acc = torch.zeros(num_slots + 1, dtype=vals.dtype, device=vals.device)
        return acc.index_add_(0, idx, vals)[:num_slots]

    def nn_count(col: Optional[Column], base: torch.Tensor) -> torch.Tensor:
        ones = base.to(torch.int64)
        if col is not None and col.validity is not None:
            ones = ones * col.validity.to(torch.int64)
        return segsum(ones)

    out: List[Tuple[str, Column]] = []
    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        base = _agg_live(block, a, live)
        if a.func == "count_distinct":
            cnt = nn_count(col, base & distinct_flags[a.name])
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        cnt = nn_count(col, base)
        if a.func == "count":
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        valid_row = base if col.validity is None else (base & col.validity)
        if a.func == "group_concat":
            out.append((a.name, _group_concat(a, col, base, cnt, sorted_layout,
                                              segsum)))
            continue
        if a.func == "quantile":
            rdt = agg_result_dtype(a.func, col.dtype)
            ident = _identity_for("max", col.dtype)
            vals = torch.where(base & distinct_flags[a.name], col.data,
                               torch.full((), ident, dtype=col.data.dtype,
                                          device=live.device))
            red = _segment_reduce("max", vals, idx, num_slots + 1, ident)[:num_slots]
            out.append((a.name, Column(red.to(rdt.torch_dtype), cnt > 0, rdt,
                                       col.dictionary)))
            continue
        if a.func in _VAR_FUNCS:
            out.append((a.name, _moments(a, col, valid_row, segsum, cnt)))
            continue
        if a.func == "first":
            # the value at the group's first valid row
            n_rows = col.data.shape[0]
            pos = torch.arange(n_rows, dtype=torch.int64, device=live.device)
            pmin = _segment_reduce("min", torch.where(valid_row, pos,
                                                      torch.full_like(pos, n_rows)),
                                   idx, num_slots + 1, n_rows)[:num_slots]
            rdt = agg_result_dtype(a.func, col.dtype)
            out.append((a.name, Column(col.data[pmin.clamp(max=n_rows - 1)], cnt > 0,
                                       rdt, col.dictionary)))
            continue
        if a.func in _BIT_FUNCS:
            out.append((a.name, _bit_segment_reduce(
                a.func, _bit_values(col, valid_row, a.func), gids, num_slots,
                sorted_ids)))
            continue
        if a.func in ("min", "max"):
            rdt = agg_result_dtype(a.func, col.dtype)
            ident = _identity_for(a.func, col.dtype)
            vals = torch.where(valid_row, col.data,
                               torch.full((), ident, dtype=col.data.dtype,
                                          device=live.device))
            red = _segment_reduce(a.func, vals, idx, num_slots + 1, ident)[:num_slots]
            out.append((a.name, Column(red.to(rdt.torch_dtype), cnt > 0, rdt,
                                       col.dictionary)))
            continue
        acc_dt = torch.float64 if col.dtype.is_float else torch.int64
        vals = torch.where(valid_row, col.data.to(acc_dt),
                           torch.zeros((), dtype=acc_dt, device=live.device))
        sums = segsum(vals)
        if a.func == "sum":
            rdt = agg_result_dtype(a.func, col.dtype)
            scale_shift = rdt.scale - (col.dtype.scale if col.dtype.is_decimal else 0)
            if rdt.is_decimal and scale_shift:
                sums = sums * (10 ** scale_shift)
        out.append((a.name, _finish(a, col, sums, cnt)))
    return out


def _accumulate_masked(
    aggs: Sequence[AggDesc],
    block: Block,
    slot_ids: torch.Tensor,
    live: torch.Tensor,
    domain: int,
) -> Tuple[List[Tuple[str, Column]], torch.Tensor]:
    """Tiny-domain accumulation: one masked reduction per (slot,
    aggregate).  sum/avg/count over the same (arg, filter) share their
    reductions."""
    slot_masks = [(slot_ids == s) & live for s in range(domain)]
    occupied = torch.stack([m.any() for m in slot_masks])

    def per_slot(fn):
        return torch.stack([fn(s) for s in range(domain)])

    memo_sums: dict = {}
    memo_cnts: dict = {}
    out: List[Tuple[str, Column]] = []
    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        base = _agg_live(block, a, live)
        extra = None if a.filter_col is None else base
        valid = base if (col is None or col.validity is None) else (base & col.validity)

        def nn(s, _col=col, _extra=extra):
            m = slot_masks[s] if _extra is None else (slot_masks[s] & _extra)
            if _col is not None and _col.validity is not None:
                m = m & _col.validity
            return torch.sum(m, dtype=torch.int64)

        key = (a.arg, a.filter_col)
        if key not in memo_cnts:
            memo_cnts[key] = per_slot(nn)
        cnts = memo_cnts[key]
        if a.func == "count":
            out.append((a.name, Column(cnts, None, INT64)))
            continue
        if a.func in ("min", "max"):
            rdt = agg_result_dtype(a.func, col.dtype)
            ident = torch.full((), _identity_for(a.func, col.dtype),
                               dtype=col.data.dtype, device=live.device)
            red_fn = torch.amin if a.func == "min" else torch.amax

            def reduce_slot(s, _col=col, _valid=valid, _ident=ident, _fn=red_fn):
                vals = torch.where(slot_masks[s] & _valid, _col.data, _ident)
                return _fn(vals) if vals.numel() else _ident

            reds = per_slot(reduce_slot)
            out.append((a.name, Column(reds.to(rdt.torch_dtype), cnts > 0, rdt,
                                       col.dictionary)))
            continue
        if a.func == "first":
            n_rows = col.data.shape[0]
            pos = torch.arange(n_rows, dtype=torch.int64, device=live.device)
            far = torch.full_like(pos, n_rows)
            pmins = per_slot(lambda s, _valid=valid: torch.amin(
                torch.where(slot_masks[s] & _valid, pos, far)) if n_rows else
                torch.zeros((), dtype=torch.int64, device=live.device))
            out.append((a.name, Column(col.data[pmins.clamp(max=max(n_rows - 1, 0))],
                                       cnts > 0, agg_result_dtype(a.func, col.dtype),
                                       col.dictionary)))
            continue
        if a.func in _BIT_FUNCS:
            gids = torch.where(live, slot_ids, torch.full_like(slot_ids, domain))
            out.append((a.name, _bit_segment_reduce(
                a.func, _bit_values(col, valid, a.func), gids, domain, False)))
            continue
        if key not in memo_sums:
            acc_dt = torch.float64 if col.dtype.is_float else torch.int64
            data = col.data.to(acc_dt)
            zero = torch.zeros((), dtype=acc_dt, device=data.device)
            memo_sums[key] = per_slot(
                lambda s: torch.sum(torch.where(slot_masks[s] & valid, data, zero))
            )
        out.append((a.name, _finish(a, col, memo_sums[key], cnts)))
    return out, occupied


def _kernel_eligible(block: Block, aggs: Sequence[AggDesc]) -> bool:
    """The direct_agg kernel covers sum/count/avg over fixed-point
    (int/decimal/bool/date) arguments without an -If filter."""
    for a in aggs:
        if a.func not in ("sum", "count", "avg"):
            return False
        if a.filter_col is not None:
            return False
        if a.arg is not None and block[a.arg].dtype.is_float:
            return False
    return True


def _accumulate_direct_kernel(
    aggs: Sequence[AggDesc],
    block: Block,
    slot_ids: torch.Tensor,
    live: torch.Tensor,
    domain: int,
) -> Tuple[List[Tuple[str, Column]], torch.Tensor]:
    """Kernel-backed accumulation with the contract of ``_accumulate``:
    one ``direct_sums`` call over the deduplicated sum/avg arguments plus
    0/1 columns for count(x) of arguments not summed."""
    from .cuda.direct_agg import direct_sums

    arg_order: List[str] = []
    for a in aggs:
        if a.func in ("sum", "avg") and a.arg not in arg_order:
            arg_order.append(a.arg)
    values: List[torch.Tensor] = []
    masks: List[Optional[torch.Tensor]] = []
    for name in arg_order:
        c = block[name]
        values.append(c.data.to(torch.int64))
        masks.append(c.validity)
    count_args: List[str] = []
    for a in aggs:
        if (a.func == "count" and a.arg is not None and a.arg not in arg_order
                and a.arg not in count_args):
            count_args.append(a.arg)
    for name in count_args:
        values.append((block[name].valid_mask() & live).to(torch.int64))
        masks.append(None)

    sums, live_counts, nn_counts = direct_sums(slot_ids, values, masks, live,
                                               domain)

    col_of = {name: i for i, name in enumerate(arg_order)}
    extra_of = {name: len(arg_order) + i for i, name in enumerate(count_args)}
    out: List[Tuple[str, Column]] = []
    for a in aggs:
        if a.func == "count":
            if a.arg is None:
                cnt = live_counts
            elif a.arg in col_of:
                cnt = nn_counts[col_of[a.arg]]
            else:
                cnt = sums[:, extra_of[a.arg]]
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        idx = col_of[a.arg]
        out.append((a.name, _finish(a, block[a.arg], sums[:, idx], nn_counts[idx])))
    return out, live_counts > 0


def aggregate_direct(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    slots_domain: Tuple[torch.Tensor, int],
    use_kernel: Optional[bool] = None,
) -> AggregateResult:
    """Dense small-domain aggregation (direct-indexed method).

    Sub-methods: with ``use_kernel=None``, the masked one up to
    MASKED_DOMAIN_LIMIT slots, then the ``direct_agg`` kernel branch when
    ``_kernel_eligible`` holds, else the segment one.  ``use_kernel``
    True or False forces the kernel branch or the segment sub-method.
    The kernel branch runs the CUDA kernel on CUDA tensors and its plain
    torch version on CPU tensors (``ops/cuda/direct_agg.py``)."""
    slot_ids, domain = slots_domain
    live = block.sel_mask()
    dev = live.device
    if (use_kernel is None and domain <= MASKED_DOMAIN_LIMIT
            and _masked_eligible(aggs)):
        acc, occupied = _accumulate_masked(aggs, block, slot_ids, live, domain)
    else:
        if use_kernel is None:
            use_kernel = _kernel_eligible(block, aggs)
        elif use_kernel and not _kernel_eligible(block, aggs):
            raise ValueError("the direct_agg kernel takes sum/count/avg over "
                             "fixed-point arguments without a filter")
        if use_kernel:
            acc, occupied = _accumulate_direct_kernel(aggs, block, slot_ids,
                                                      live, domain)
        else:
            gids = torch.where(live, slot_ids,
                               torch.full_like(slot_ids, domain))
            dflags = _compute_distinct_flags(block, keys, aggs, live)
            acc = _accumulate(aggs, block, gids, live, domain, dflags)
            occ = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
            occ.index_add_(0, gids.long(), live.to(torch.int32))
            occupied = occ[:domain] > 0
    key_cols = unpack_keys_direct(
        torch.arange(domain, dtype=torch.int32, device=dev),
        [block[k] for k in keys])
    names = tuple(keys) + tuple(n for n, _ in acc)
    cols = tuple(key_cols) + tuple(c for _, c in acc)
    out = Block(names=names, columns=cols, sel=occupied)
    return AggregateResult(out, torch.sum(occupied, dtype=torch.int32),
                           torch.zeros((), dtype=torch.int64, device=dev))


def _gc_invalid(block: Block, a: AggDesc) -> Optional[torch.Tensor]:
    """Rows that do not contribute to a group_concat (failing its filter
    or a NULL argument), or None when every row does; they sort to the
    group's tail so the contributing rows start its span."""
    inv = None
    if a.filter_col is not None:
        f = block[a.filter_col]
        m = f.data.to(torch.bool)
        if f.validity is not None:
            m = m & f.validity
        inv = ~m
    gcol = block[a.arg]
    if gcol.validity is not None:
        inv = ~gcol.validity if inv is None else (inv | ~gcol.validity)
    return inv


def aggregate_sort(
    block: Block, keys: Sequence[str], aggs: Sequence[AggDesc], num_slots: int
) -> AggregateResult:
    """General sort-based aggregation over ``num_slots`` group slots.

    Rows sort stably on (dead last, then each key with its NULLs grouped
    first, then position); a group starts wherever a sort operand
    changes.  Each group's keys are gathered at its first row, and the
    aggregates are an ``index_add_`` on the group ids (the reference's
    scatter-free cumulative-sum layout is a TPU workaround; the integers
    are the same).  More groups than ``num_slots`` report the number
    needed as the overflow."""
    from .segments import backward_fill_positions, forward_fill_positions
    from .sort import lexsort_stable

    _check_supported(aggs)
    n = block.capacity
    live = block.sel_mask()
    dev = live.device
    key_cols = [block[k] for k in keys]
    gc_orders = [(a, _gc_invalid(block, a)) for a in aggs if a.func == "group_concat"]
    if sum(1 for a, inv in gc_orders if inv is not None or a.distinct) > 1:
        raise NotImplementedError(
            "at most one group_concat with a nullable/filtered/DISTINCT "
            "argument per aggregation (each needs its own in-group order)")
    special = [a for a in aggs if a.func in ("count_distinct", "quantile")]
    # one unfiltered count_distinct or quantile sorts its argument as a
    # trailing key: its row flags come off the sorted rows directly
    in_sort_special = (len(special) == 1 and special[0].filter_col is None
                       and not gc_orders)
    operands: List[torch.Tensor] = [~live]  # live rows first
    for c in key_cols:
        # a wide-decimal key sorts limb by limb (lower limbs are >= 0)
        datas = ([c.data[:, i] for i in range(c.data.shape[1])]
                 if c.data.ndim == 2 else [c.data])
        validity = c.validity
        if validity is not None and validity.ndim == 2:
            validity = validity.all(dim=1)
        if validity is not None:
            operands.append(~validity)  # NULLs group together, first
            # NULL slots may hold any payload (a join's unmatched rows):
            # zero them so one NULL group stays one group
            operands.extend(torch.where(validity, d, torch.zeros_like(d))
                            for d in datas)
        else:
            operands.extend(datas)
    num_group_keys = len(operands)
    if in_sort_special:
        sc = block[special[0].arg]
        operands.append(~sc.valid_mask())  # valid arg values first in group
        operands.append(sc.data)
    for a, inv in gc_orders:
        if inv is not None:
            operands.append(inv)  # rows that do not contribute go last
        if a.distinct:
            operands.append(block[a.arg].data)  # duplicates adjacent, in order
    # the sort is stable: ties keep row order, group_concat's item order
    perm = lexsort_stable(operands)

    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for op in operands[:num_group_keys]:
        arr = op[perm]
        neq |= arr != torch.roll(arr, 1)
    neq[:1] = False
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    if in_sort_special and special[0].func == "count_distinct":
        pneq = neq.clone()
        for op in operands[num_group_keys:]:
            arr = op[perm]
            pneq |= arr != torch.roll(arr, 1)
        pneq[:1] = True
        dflags = {special[0].name: pneq}
    elif in_sort_special:
        # quantile: each group's target row from the sorted positions
        q = special[0].param if special[0].param is not None else 0.5
        first_of_grp = neq.clone()
        first_of_grp[:1] = True
        start = forward_fill_positions(first_of_grp)
        valid_s = ~operands[num_group_keys][perm]
        last_flag = torch.roll(first_of_grp, -1)
        last_flag[n - 1:] = True
        end_row = backward_fill_positions(last_flag)
        cumv = torch.cumsum(valid_s.to(torch.int64), 0)
        at_prev = torch.where(start > 0, cumv[(start - 1).clamp(min=0)],
                              torch.zeros_like(start))
        cnt_row = cumv[end_row] - at_prev
        target = start + torch.floor(q * (cnt_row - 1).to(torch.float64)).to(torch.int64)
        dflags = {special[0].name: (pos == target) & valid_s}
    else:
        dflags = {k: v[perm] for k, v in
                  _compute_distinct_flags(block, keys, aggs, live).items()}
    gid_sorted = torch.cumsum(neq.to(torch.int32), 0, dtype=torch.int32)
    live_sorted = live[perm]
    # live rows come first and group ids never decrease
    num_groups = (torch.max(torch.where(live_sorted, gid_sorted,
                                        torch.full_like(gid_sorted, -1)))
                  + 1) if n else torch.zeros((), dtype=torch.int32, device=dev)
    overflow = torch.where(num_groups > num_slots, num_groups,
                           torch.zeros_like(num_groups)).to(torch.int64)
    gids = torch.where(live_sorted, torch.clamp(gid_sorted, max=num_slots),
                       torch.full_like(gid_sorted, num_slots))

    needed: List[str] = []
    for a in aggs:
        for nm in (a.arg, a.filter_col):
            if nm is not None and nm not in needed:
                needed.append(nm)
    sorted_block = (block.select(needed).take(perm) if needed
                    else Block(names=(), columns=(), sel=None))
    first = live_sorted & (neq | (pos == 0) | ~torch.roll(live_sorted, 1))
    layout = None
    if gc_orders:
        live_next = torch.cat([live_sorted[1:],
                               torch.zeros(1, dtype=torch.bool, device=dev)])
        neq_next = torch.cat([neq[1:], torch.ones(1, dtype=torch.bool, device=dev)])
        last = live_sorted & (neq_next | ~live_next)
        ends = torch.full((num_slots + 1,), -1, dtype=torch.int64, device=dev)
        ends.scatter_(0, torch.where(last, gids, torch.full_like(gids, num_slots)).long(),
                      pos)
        layout = (first, ends[:num_slots])
    acc = _accumulate(aggs, sorted_block, gids, live_sorted, num_slots, dflags,
                      sorted_layout=layout, sorted_ids=True)

    # each group's keys from its first row, composed through perm
    starts = torch.zeros(num_slots + 1, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(first, gids, torch.full_like(gids, num_slots)).long(),
                    pos)
    orig_start = perm[starts[:num_slots]] if n else starts[:num_slots]
    out_key_cols = [
        Column(c.data[orig_start],
               None if c.validity is None else c.validity[orig_start],
               c.dtype, c.dictionary)
        for c in key_cols
    ]
    occupied = torch.arange(num_slots, dtype=torch.int32, device=dev) < num_groups
    names = tuple(keys) + tuple(nm for nm, _ in acc)
    cols = tuple(out_key_cols) + tuple(c for _, c in acc)
    out = Block(names=names, columns=cols, sel=occupied)
    return AggregateResult(out, num_groups, overflow)


def _stream_accumulate_batched(
    aggs: Sequence[AggDesc],
    block: Block,
    keys: Sequence[str],
    key_cols: Sequence[Column],
    live: torch.Tensor,
    gids: torch.Tensor,
    ends_ok: torch.Tensor,
    e_idx: torch.Tensor,
    num_slots: int,
    first_of_group: torch.Tensor,
) -> Tuple[List[Tuple[str, Column]], torch.Tensor]:
    """Every per-group quantity of the stream method is a read at the
    group's end row: a cumulative sum differenced against the previous
    group's end (spans are dense, so that is a shift), or a key value,
    constant within its group.  The reference packs the reads into one
    gather per dtype class, a TPU gather workaround; here each is one
    indexing op.  Min/max reduce by the group ids ``gids``."""

    def at_ends(cum: torch.Tensor) -> torch.Tensor:
        arr = cum[e_idx]
        prev = torch.cat([torch.zeros(1, dtype=arr.dtype, device=arr.device),
                          arr[:-1]])
        return torch.where(ends_ok, arr - prev, torch.zeros((), dtype=arr.dtype,
                                                            device=arr.device))

    live_cum = torch.cumsum(live.to(torch.int64), 0)
    live_counts = at_ends(live_cum)
    occupied = ends_ok & (live_counts > 0)

    out: List[Tuple[str, Column]] = []
    for name, c in zip(keys, key_cols):
        validity = None if c.validity is None else c.validity[e_idx]
        out.append((name, Column(c.data[e_idx], validity, c.dtype, c.dictionary)))

    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        base = _agg_live(block, a, live)
        valid_row = base if col is None or col.validity is None else (base & col.validity)
        plain = a.filter_col is None and (col is None or col.validity is None)
        cnt = live_counts if plain else at_ends(
            torch.cumsum(valid_row.to(torch.int64), 0))
        if a.func == "count":
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        if a.func in ("min", "max"):
            rdt = agg_result_dtype(a.func, col.dtype)
            ident = _identity_for(a.func, col.dtype)
            vals = torch.where(valid_row, col.data,
                               torch.full((), ident, dtype=col.data.dtype,
                                          device=live.device))
            red = _segment_reduce(a.func, vals, gids.long(), num_slots + 1,
                                  ident)[:num_slots]
            out.append((a.name, Column(red.to(rdt.torch_dtype), cnt > 0, rdt,
                                       col.dictionary)))
            continue
        if col.dtype.is_float:
            # a running sum that restarts at each group, read at its end
            # (a global difference would cancel across groups)
            from .window import _segmented_prefix

            vals = torch.where(valid_row, col.data.to(torch.float64),
                               torch.zeros((), dtype=torch.float64, device=live.device))
            sums = _segmented_prefix("sum", vals, first_of_group)[e_idx]
        else:
            vals = torch.where(valid_row, col.data.to(torch.int64),
                               torch.zeros((), dtype=torch.int64, device=live.device))
            # the running sums may wrap; their differences are exact mod 2^64
            sums = at_ends(torch.cumsum(vals, 0))
        if a.func == "sum":
            rdt = agg_result_dtype(a.func, col.dtype)
            scale_shift = rdt.scale - (col.dtype.scale if col.dtype.is_decimal else 0)
            if rdt.is_decimal and scale_shift:
                sums = sums * (10 ** scale_shift)
        out.append((a.name, _finish(a, col, sums, cnt)))
    return out, occupied


def aggregate_stream(
    block: Block, keys: Sequence[str], aggs: Sequence[AggDesc], num_slots: int
) -> AggregateResult:
    """Stream aggregation over key-clustered input, without a sort.

    Rows with equal group keys are adjacent (``Block.clustered_by``), so
    group boundaries come from a compare with the previous row.  They are
    found over all rows, dead ones included: a group with no live row
    keeps its slot, unoccupied, and the output ``sel`` is not a prefix.
    Keys and their validity are read at each group's end row, or, with a
    count_distinct, at its first row (the reference's general path).
    More groups than ``num_slots`` (counted over all rows) report the
    number needed as the overflow."""
    from .merge import flagged_positions

    _check_supported(aggs)
    n = block.capacity
    live = block.sel_mask()
    dev = live.device
    key_cols = [block[k] for k in keys]

    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in key_cols:
        neq |= c.data != torch.roll(c.data, 1)
        if c.validity is not None:
            neq |= c.validity != torch.roll(c.validity, 1)
    neq[:1] = False
    gids = torch.clamp(torch.cumsum(neq.to(torch.int64), 0), max=num_slots)
    total_groups = torch.sum(neq, dtype=torch.int64) + 1
    overflow = torch.where(total_groups > num_slots, total_groups,
                           torch.zeros_like(total_groups))

    is_end = torch.cat([neq[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    ends_dense = flagged_positions(is_end, num_slots)
    ends_ok = ends_dense >= 0
    e_idx = ends_dense.clamp(min=0).long()

    if _stream_batched_eligible(aggs):
        first_of_group = neq.clone()
        first_of_group[:1] = True
        acc, occupied = _stream_accumulate_batched(aggs, block, keys, key_cols, live,
                                                   gids, ends_ok, e_idx, num_slots,
                                                   first_of_group)
        out = Block(names=tuple(nm for nm, _ in acc),
                    columns=tuple(c for _, c in acc), sel=occupied)
        return AggregateResult(out, torch.sum(occupied, dtype=torch.int32), overflow)

    dflags = _compute_distinct_flags(block, keys, aggs, live)
    acc = _accumulate(aggs, block, gids, live, num_slots, dflags, sorted_ids=True)
    # occupied slots: groups with a live row (a cumulative sum at the ends)
    prev_ends = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                           ends_dense[:-1].to(torch.int64)])
    # slots past the last group start past the end: clamp (they are dead)
    starts = (prev_ends + 1).clamp(0, max(n - 1, 0))
    live_cum = torch.cumsum(live.to(torch.int64), 0)
    at_prev = torch.where(starts > 0, live_cum[(starts - 1).clamp(min=0)],
                          torch.zeros_like(starts))
    occupied = ends_ok & ((live_cum[e_idx] - at_prev) > 0)
    # keys gathered at each group's first row
    out_key_cols = [
        Column(c.data[starts], None if c.validity is None else c.validity[starts],
               c.dtype, c.dictionary)
        for c in key_cols
    ]
    out = Block(names=tuple(keys) + tuple(nm for nm, _ in acc),
                columns=tuple(out_key_cols) + tuple(c for _, c in acc), sel=occupied)
    return AggregateResult(out, torch.sum(occupied, dtype=torch.int32), overflow)


def _sketch_hashes(block: Block, a: AggDesc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(62-bit value hashes, live and not-NULL mask) for a sketch
    aggregate."""
    from .hashing import hash_columns_u63

    col = block[a.arg]
    live = _agg_live(block, a, block.sel_mask())
    if col.validity is not None:
        live = live & col.validity
    return hash_columns_u63([col]), live


def aggregate_scalar(block: Block, aggs: Sequence[AggDesc]) -> Block:
    """Aggregation without GROUP BY: single-row output (slot 0), by the
    masked method, or with a count_distinct, quantile or variance by the
    segment one; approx_count_distinct is the KMV estimate."""
    if any(a.func in _SKETCH_FUNCS for a in aggs):
        from .sketch import SKETCH_K, kmv_candidates, kmv_estimate

        rest = [a for a in aggs if a.func not in _SKETCH_FUNCS]
        base = aggregate_scalar(block, rest) if rest else None
        cols: dict = {}
        for a in aggs:
            if a.func not in _SKETCH_FUNCS:
                cols[a.name] = base[a.name]
                continue
            h, live = _sketch_hashes(block, a)
            k = int(a.param) if a.param else SKETCH_K
            est = kmv_estimate(kmv_candidates(h, live, k))
            cols[a.name] = Column(est[None], None, INT64)
        return Block.from_dict(cols)
    live = block.sel_mask()
    if _masked_eligible(aggs):
        acc, _ = _accumulate_masked(
            aggs, block,
            torch.zeros(block.capacity, dtype=torch.int32, device=live.device),
            live, 1,
        )
    else:
        gids = torch.where(live, 0, 1).to(torch.int32)
        dflags = _compute_distinct_flags(block, [], aggs, live)
        acc = _accumulate(aggs, block, gids, live, 1, dflags)
    return Block(names=tuple(n for n, _ in acc),
                 columns=tuple(c for _, c in acc), sel=None)


def hash_aggregate(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    num_slots: Optional[int] = None,
) -> AggregateResult:
    """Method dispatch (the ``chooseAggregationMethod`` analog)."""
    _check_supported(aggs)
    for a in aggs:
        if a.func in _BIT_FUNCS and a.arg in block.names:
            # MySQL takes a temporal argument's numeric form (TIME
            # 11:11:35 -> 111135) before the bit operation
            c = block[a.arg]
            if c.dtype.kind in (TypeKind.DATE, TypeKind.DATETIME, TypeKind.DURATION):
                from ..expr.functions import cast_column

                block = block.with_column(a.arg, cast_column(
                    c, INT64.with_nullable(c.dtype.nullable)))
    rw = _wide_rewrite(block, aggs)
    if rw is not None:
        block, aggs, post = rw
        res = _dispatch_aggregate(block, keys, aggs, num_slots)
        return AggregateResult(post(res.block), res.num_groups, res.overflow)
    return _dispatch_aggregate(block, keys, aggs, num_slots)


def _dispatch_aggregate(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    num_slots: Optional[int] = None,
) -> AggregateResult:
    dev = block.device
    if keys and any(a.func == "approx_count_distinct" for a in aggs):
        # grouped, the exact count is available, and "approximate" may be
        # exact
        aggs = [dataclasses.replace(a, func="count_distinct")
                if a.func == "approx_count_distinct" else a for a in aggs]
    if not keys:
        b = aggregate_scalar(block, aggs)
        return AggregateResult(b, torch.ones((), dtype=torch.int32, device=dev),
                               torch.zeros((), dtype=torch.int64, device=dev))
    if any(a.func == "group_concat" for a in aggs):
        # group_concat needs the sorted contiguous-span layout
        return aggregate_sort(block, keys, aggs, num_slots or block.capacity)
    packed = pack_keys_direct([block[k] for k in keys])
    if packed is not None and packed[1] <= DIRECT_DOMAIN_LIMIT:
        if (any(a.func in _BIT_FUNCS for a in aggs)
                and (packed[1] > MASKED_DOMAIN_LIMIT or not _masked_eligible(aggs))):
            # bit reductions take the masked method or the sort method
            return aggregate_sort(block, keys, aggs, num_slots or block.capacity)
        return aggregate_direct(block, keys, aggs, packed)
    if num_slots is None:
        num_slots = block.capacity
    cb = block.clustered_by
    if cb and len(keys) <= len(cb) and set(keys) == set(cb[: len(keys)]):
        # equal group keys are already adjacent: no sort
        return aggregate_stream(block, keys, aggs, num_slots)
    return aggregate_sort(block, keys, aggs, num_slots)


__all__ = [
    "AggDesc", "AggregateResult", "hash_aggregate", "aggregate_direct",
    "aggregate_sort", "aggregate_stream", "aggregate_scalar", "agg_result_dtype",
    "key_domain_size",
    "pack_keys_direct", "unpack_keys_direct", "DIRECT_DOMAIN_LIMIT",
]
