"""Aggregation: the keyless, direct-indexed and sort methods.

Counterpart of ``tiflash_tpu/ops/aggregate.py``.  Ported here:

- ``AggDesc``, ``AggregateResult`` and TiDB's result-type rules
  (``agg_result_dtype``);
- ``_wide_rewrite``: exact wide-decimal sum/avg around the int64 methods,
  narrow-stored when stats prove int64 is exact, else by base-10^9 digit
  decomposition;
- key packing for small static key domains (``pack_keys_direct``);
- ``hash_aggregate`` dispatch to the keyless method (``aggregate_scalar``),
  the direct method (``aggregate_direct``) for packed key domains up to
  ``DIRECT_DOMAIN_LIMIT``, and the sort method (``aggregate_sort``) for
  keys without a static domain.  The direct method has its masked
  sub-method (domains <= 64), its ``direct_agg`` kernel branch
  (``ops/cuda/direct_agg.py``) and its segment sub-method.

Supported aggregates are sum, count and avg.  The stream method (keys the
block is clustered on) comes with the Q3 slice of the port; the other
aggregate functions with the functions slice.
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

_SUPPORTED = ("sum", "count", "avg")


@dataclasses.dataclass(frozen=True)
class AggDesc:
    """One aggregate: ``func(arg) AS name [FILTER filter_col]``.  ``arg``
    is None for count(*)."""

    func: str
    arg: Optional[str]
    name: str
    filter_col: Optional[str] = None
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
        if a.func not in _SUPPORTED or a.distinct:
            raise NotImplementedError(
                f"aggregate {a.func}{' distinct' if a.distinct else ''} is "
                "not ported yet: count_distinct, quantile, group_concat and "
                "the rest come with the functions slice of the port")


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

    relevant = [
        a for a in aggs
        if a.func in ("sum", "avg") and a.arg is not None
        and block[a.arg].dtype.is_decimal
        and agg_result_dtype(a.func, block[a.arg].dtype).is_wide_decimal
    ]
    if not relevant:
        return None

    rows = block.capacity
    out_block = block
    aggs2: List[AggDesc] = []
    skip: set = set()
    assemble: dict = {}
    for a in aggs:
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
) -> List[Tuple[str, Column]]:
    """Segment sub-method: every aggregate as an ``index_add_`` into
    ``num_slots`` dense slots plus a trailing trash slot, where dead rows
    (``gids == num_slots``) land."""
    idx = gids.long()

    def segsum(vals: torch.Tensor) -> torch.Tensor:
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
        cnt = nn_count(col, base)
        if a.func == "count":
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        valid_row = base if col.validity is None else (base & col.validity)
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
    if use_kernel is None and domain <= MASKED_DOMAIN_LIMIT:
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
            acc = _accumulate(aggs, block, gids, live, domain)
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
    from .sort import lexsort_stable

    _check_supported(aggs)
    n = block.capacity
    live = block.sel_mask()
    dev = live.device
    key_cols = [block[k] for k in keys]
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
    perm = lexsort_stable(operands)

    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for op in operands:
        arr = op[perm]
        neq |= arr != torch.roll(arr, 1)
    neq[:1] = False
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
    acc = _accumulate(aggs, sorted_block, gids, live_sorted, num_slots)

    # each group's keys from its first row, composed through perm
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first = live_sorted & (neq | (pos == 0) | ~torch.roll(live_sorted, 1))
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


def aggregate_scalar(block: Block, aggs: Sequence[AggDesc]) -> Block:
    """Aggregation without GROUP BY: single-row output (slot 0)."""
    live = block.sel_mask()
    acc, _ = _accumulate_masked(
        aggs, block,
        torch.zeros(block.capacity, dtype=torch.int32, device=live.device),
        live, 1,
    )
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
    if not keys:
        b = aggregate_scalar(block, aggs)
        return AggregateResult(b, torch.ones((), dtype=torch.int32, device=dev),
                               torch.zeros((), dtype=torch.int64, device=dev))
    packed = pack_keys_direct([block[k] for k in keys])
    if packed is not None and packed[1] <= DIRECT_DOMAIN_LIMIT:
        return aggregate_direct(block, keys, aggs, packed)
    if num_slots is None:
        num_slots = block.capacity
    cb = block.clustered_by
    if cb and len(keys) <= len(cb) and set(keys) == set(cb[: len(keys)]):
        raise NotImplementedError(
            "group keys the block is clustered on take the stream "
            "aggregation method: it comes with the Q3 slice of the port")
    return aggregate_sort(block, keys, aggs, num_slots)


__all__ = [
    "AggDesc", "AggregateResult", "hash_aggregate", "aggregate_direct",
    "aggregate_sort", "aggregate_scalar", "agg_result_dtype", "key_domain_size",
    "pack_keys_direct", "unpack_keys_direct", "DIRECT_DOMAIN_LIMIT",
]
