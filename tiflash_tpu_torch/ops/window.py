"""Window functions over a sorted batch.

Counterpart of ``tiflash_tpu/ops/window.py``.  One stable lexicographic
sort by (dead last, partition keys, order keys) puts each partition's
rows together in window order; every function is then a segmented scan
or a gather over the sorted rows:

- row_number = position - partition start + 1; rank from the peer
  group's start; dense_rank counts peer-group starts; percent_rank,
  cume_dist and ntile from the partition's size;
- lead/lag gather at a shifted position, with the default (or NULL)
  outside the partition; first_value/last_value/nth_value gather at the
  frame's ends;
- sum/count/avg over the running default frame (RANGE UNBOUNDED
  PRECEDING .. CURRENT ROW, peers included) and over ROWS and RANGE
  frames read prefix sums: integer and decimal sums a global
  ``torch.cumsum`` differenced at the frame's ends; float sums a prefix
  that restarts at each partition (``_segmented_prefix``), differenced
  the same way (``at_hi - at_lo``), as the reference does;
- framed min/max from a sparse table (doubling), running min/max from
  ``_segmented_prefix``.

RANGE frames take exactly one numeric order key; offsets are in the
column's physical unit (mantissa steps for decimals, days for dates), and
a 0 bound includes peers.  The frame ends are counts over the sorted
order keys (``_merge_count``): one stable sort of the rows and their
shifted queries together.  The output keeps the reference's contract:
rows sorted by (partition, order), dead rows last, and NULL partition
keys grouped as one partition whatever data lies under them.

The reference's sort-based routing and packed gathers are TPU
workarounds; the port fills segment ends from cumulative counts
(``ops/segments.py``) and indexes directly.
``_segmented_prefix`` is a Hillis-Steele scan with partition resets
(log2 n passes), the shape of the reference's ``associative_scan``; a
float sum adds in a different tree than XLA's, so float results agree to
rounding, within the bound each test states.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.block import Block, Column
from ..core.dtypes import FLOAT64, INT64, DataType, Decimal, TypeKind
from .segments import backward_fill_positions, forward_fill_positions
from .sort import SortKey, _sort_operand, lexsort_stable


@dataclasses.dataclass(frozen=True)
class WindowDesc:
    """func in {row_number, rank, dense_rank, percent_rank, cume_dist,
    ntile, lead, lag, first_value, last_value, nth_value, sum, count, min,
    max, avg}; ``arg`` names the value column where one applies; lead/lag
    take ``offset`` and an optional ``default``; ntile and nth_value carry
    their number in ``offset``.

    ``frame``: (preceding, following) bounds; None on a side is
    UNBOUNDED.  ``frame_type`` "rows" counts rows, "range" measures the
    order key's value distance (exactly one numeric order key).
    ``frame=None`` is the running default frame."""

    func: str
    name: str
    arg: Optional[str] = None
    offset: int = 1
    default: Optional[object] = None
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    frame_type: str = "rows"


_SCAN_OPS = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
    "band": torch.bitwise_and,
    "bor": torch.bitwise_or,
    "bxor": torch.bitwise_xor,
}


def _segmented_prefix(op: str, vals: torch.Tensor,
                      seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``op`` that restarts where ``seg_start`` is True.

    Integer sums are one ``torch.cumsum`` differenced against the prefix
    before the segment start (exact mod 2^64); float sums, min/max and the
    bit operations take a Hillis-Steele scan over (reset flag, value)
    pairs, so a float sum never cancels across segments."""
    if op == "sum" and not vals.is_floating_point():
        ps = torch.cumsum(vals, 0)
        start = forward_fill_positions(seg_start)
        before = torch.where(start > 0, ps[(start - 1).clamp(min=0)],
                             torch.zeros_like(ps))
        return ps - before
    try:
        fn = _SCAN_OPS[op]
    except KeyError:
        raise NotImplementedError(op) from None
    v, f = vals, seg_start
    n = vals.shape[0]
    d = 1
    while d < n:
        # element i absorbs element i - d unless a reset lies between
        merged = torch.where(f[d:], v[d:], fn(v[:-d], v[d:]))
        v = torch.cat([v[:d], merged])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _merge_count(data_keys: List[torch.Tensor], query_keys: List[torch.Tensor],
                 right: bool) -> torch.Tensor:
    """Number of data rows whose key tuple is < the query's (right=False)
    or <= it (right=True), for every query row: one stable sort of the
    2n rows, a tag ordering each query before (or after) equal data rows,
    and a cumulative count of data rows read back at the queries."""
    n = data_keys[0].shape[0]
    dev = data_keys[0].device
    tag_d = torch.full((n,), 0 if right else 1, dtype=torch.int8, device=dev)
    tag_q = torch.full((n,), 1 if right else 0, dtype=torch.int8, device=dev)
    ops = [torch.cat([d, q]) for d, q in zip(data_keys, query_keys)]
    ops.append(torch.cat([tag_d, tag_q]))
    is_data = torch.cat([torch.ones(n, dtype=torch.int64, device=dev),
                         torch.zeros(n, dtype=torch.int64, device=dev)])
    perm = lexsort_stable(ops)
    cnt_sorted = torch.cumsum(is_data[perm], 0)
    cnt = torch.empty_like(cnt_sorted)
    cnt[perm] = cnt_sorted
    return cnt[n:]


def _range_bounds(order_ops: List[torch.Tensor], part_start_idx: torch.Tensor,
                  part_end_idx: torch.Tensor, prec: Optional[int],
                  foll: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANGE-frame (lo, hi) row indices from the sorted order key's
    ascending operands ([null rank,] value').  Offsets apply in the
    transformed space for ASC and DESC alike; the partition start leads
    the key, so the counts are global row indices."""
    vals = order_ops[-1]
    if not vals.is_floating_point():
        vals = vals.to(torch.int64)
    lead = [part_start_idx] + list(order_ops[:-1])
    if prec is None:
        lo = part_start_idx
    else:
        lo = _merge_count(lead + [vals], lead + [vals - prec], right=False)
    if foll is None:
        hi = part_end_idx
    else:
        hi = _merge_count(lead + [vals], lead + [vals + foll], right=True) - 1
    return lo, hi


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.clamp(0, x.shape[0] - 1).long()]


def _boundaries(ops: Sequence[torch.Tensor], n: int, dev) -> torch.Tensor:
    """True where any operand differs from the previous row (and row 0)."""
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for arr in ops:
        neq |= arr != torch.roll(arr, 1)
    neq[:1] = True
    return neq


def _avg_column(sums: torch.Tensor, cnt: torch.Tensor, c: Column) -> Column:
    """avg = sum / count: decimals at scale + 4 rounded half up, else a
    double."""
    from ..expr.functions import _div_round_half_up

    if c.dtype.is_decimal:
        rdt = Decimal(18, c.dtype.scale + 4, nullable=True)
        d = _div_round_half_up(sums * (10 ** 4), cnt.clamp(min=1))
    else:
        rdt = FLOAT64.with_nullable(True)
        d = sums / cnt.clamp(min=1).to(torch.float64)
    return Column(d.to(rdt.torch_dtype), cnt > 0, rdt)


def _sum_dtype(c: Column, is_float: bool) -> DataType:
    if c.dtype.is_decimal:
        return DataType(TypeKind.DECIMAL, True, 18, c.dtype.scale)
    return (FLOAT64 if is_float else INT64).with_nullable(True)


def _extreme(func: str, dtype: torch.dtype):
    """The identity of min (``func == "min"``) or max in ``dtype``."""
    if dtype.is_floating_point:
        return float("inf") if func == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if func == "min" else info.min


def window_block(block: Block, partition_by: Sequence[str],
                 order_by: Sequence[SortKey],
                 funcs: Sequence[WindowDesc]) -> Block:
    """Compute every window function; the output rows are sorted by
    (partition, order) with dead rows last (sel-compacted, as a sort)."""
    n = block.capacity
    live = block.sel_mask()
    dev = live.device

    # dead rows sort last; without a selection every row is live and the
    # flag orders nothing
    operands: List[torch.Tensor] = [] if block.sel is None else [~live]
    for name in partition_by:
        c = block[name]
        if c.validity is not None:
            operands.append(~c.validity)
            # NULL slots may hold any payload (a join's unmatched rows):
            # zero them so the NULLs form one partition
            operands.append(torch.where(c.validity, c.data, torch.zeros_like(c.data)))
        else:
            operands.append(c.data)
    n_part_ops = len(operands)
    for sk in order_by:
        operands.extend(_sort_operand(block[sk.name], sk.desc, sk.nulls_first_resolved))
    n_sort_ops = len(operands)
    perm = lexsort_stable(operands) if operands else torch.arange(n, device=dev)
    sorted_ops = [op[perm] for op in operands]
    sblock = block.take(perm)
    sel = None
    if block.sel is not None:
        sel = torch.arange(n, dtype=torch.int32, device=dev) < torch.sum(
            live, dtype=torch.int32)

    part_start = _boundaries(sorted_ops[:n_part_ops], n, dev)
    peer_start = _boundaries(sorted_ops[:n_sort_ops], n, dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    part_start_idx = forward_fill_positions(part_start)
    peer_start_idx = forward_fill_positions(peer_start)
    last_flag = torch.roll(part_start, -1)
    last_flag[n - 1:] = True
    part_end_idx = backward_fill_positions(last_flag)
    part_size = part_end_idx - part_start_idx + 1
    peer_last = torch.roll(peer_start, -1)
    peer_last[n - 1:] = True
    peer_end_idx = backward_fill_positions(peer_last)

    out_cols = dict(zip(sblock.names, sblock.columns))
    frames: dict = {}

    def frame_lo_hi(f: WindowDesc) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each frame's (lo, hi) rows, computed once per (frame, type)."""
        key = (f.frame, f.frame_type)
        if key not in frames:
            frames[key] = _frame_bounds(f)
        return frames[key]

    def _frame_bounds(f: WindowDesc) -> Tuple[torch.Tensor, torch.Tensor]:
        prec, foll = f.frame
        if f.frame_type == "range":
            if len(order_by) != 1:
                raise NotImplementedError("RANGE frames require exactly one order key")
            lo, hi = _range_bounds(sorted_ops[n_part_ops:n_sort_ops],
                                   part_start_idx, part_end_idx, prec, foll)
            oc = sblock[order_by[0].name]
            if oc.validity is not None:
                # a NULL order key's frame is its whole NULL peer set,
                # whatever the offsets
                isn = ~oc.validity
                if prec is not None:
                    lo = torch.where(isn, peer_start_idx, lo)
                if foll is not None:
                    hi = torch.where(isn, peer_end_idx, hi)
            return lo, hi
        lo = part_start_idx if prec is None else torch.maximum(pos - prec, part_start_idx)
        hi = part_end_idx if foll is None else torch.minimum(pos + foll, part_end_idx)
        return lo, hi

    def valid_counts(c: Optional[Column]) -> torch.Tensor:
        ones = torch.ones(n, dtype=torch.int64, device=dev)
        if c is not None and c.validity is not None:
            ones = ones * c.validity.to(torch.int64)
        return ones

    def int_values(c: Column) -> torch.Tensor:
        vals = c.data.to(torch.int64)
        if c.validity is not None:
            vals = torch.where(c.validity, vals, torch.zeros_like(vals))
        return vals

    def float_prefix(c: Column) -> torch.Tensor:
        vals = c.data.to(torch.float64)
        if c.validity is not None:
            vals = torch.where(c.validity, vals, torch.zeros_like(vals))
        return _segmented_prefix("sum", vals, part_start)

    def frame_diff(prefix: torch.Tensor, lo, hi, reset_at_part: bool):
        """prefix[hi] - prefix[lo - 1] (0 before the frame's segment and
        for an empty frame)."""
        at_hi = _gather(prefix, hi)
        zero = torch.zeros((), dtype=prefix.dtype, device=dev)
        floor_ = part_start_idx if reset_at_part else torch.zeros_like(lo)
        at_lo = torch.where(lo > floor_, _gather(prefix, lo - 1), zero)
        return torch.where(hi < lo, zero, at_hi - at_lo)

    def running(prefix: torch.Tensor, reset_at_part: bool) -> torch.Tensor:
        """prefix at the peer group's end less the prefix before the
        partition (SQL's default frame includes the current row's peers)."""
        at_end = _gather(prefix, peer_end_idx)
        if reset_at_part:
            return at_end
        at_ps = torch.where(part_start_idx > 0, _gather(prefix, part_start_idx - 1),
                            torch.zeros((), dtype=prefix.dtype, device=dev))
        return at_end - at_ps

    for f in funcs:
        c = sblock[f.arg] if f.arg else None
        if f.func == "row_number":
            out_cols[f.name] = Column(pos - part_start_idx + 1, None, INT64)
        elif f.func == "rank":
            out_cols[f.name] = Column(peer_start_idx - part_start_idx + 1, None, INT64)
        elif f.func == "dense_rank":
            peers_cum = torch.cumsum(peer_start.to(torch.int64), 0)
            data = peers_cum - peers_cum[part_start_idx] + 1
            out_cols[f.name] = Column(data, None, INT64)
        elif f.func == "percent_rank":
            rank = (peer_start_idx - part_start_idx).to(torch.float64)
            denom = (part_size - 1).clamp(min=1).to(torch.float64)
            out_cols[f.name] = Column(rank / denom, None, DataType(TypeKind.FLOAT64))
        elif f.func == "cume_dist":
            le_peers = (peer_end_idx - part_start_idx + 1).to(torch.float64)
            out_cols[f.name] = Column(le_peers / part_size.to(torch.float64), None,
                                      DataType(TypeKind.FLOAT64))
        elif f.func == "ntile":
            k = int(f.offset)  # the bucket count rides in ``offset``
            rn0 = pos - part_start_idx
            # MySQL: the first (size % k) buckets take ceil(size / k) rows
            q, r = part_size // k, part_size % k
            big = (q + 1) * r
            bucket = torch.where(
                rn0 < big, rn0 // (q + 1).clamp(min=1),
                torch.where(q > 0, r + (rn0 - big) // q.clamp(min=1), rn0))
            out_cols[f.name] = Column(bucket + 1, None, INT64)
        elif f.func in ("lead", "lag"):
            shift = f.offset if f.func == "lag" else -f.offset
            src_raw = pos - shift
            in_range = (src_raw >= 0) & (src_raw < n)
            src = src_raw.clamp(0, n - 1)
            moved = c.data[src]
            moved_valid = None if c.validity is None else c.validity[src]
            ok = (part_start_idx[src] == part_start_idx) & in_range
            if f.default is not None:
                dflt = torch.tensor(f.default, dtype=c.data.dtype, device=dev)
                data = torch.where(ok, moved, dflt)
                validity = None if moved_valid is None else (moved_valid | ~ok)
                dt = c.dtype
            else:
                data = torch.where(ok, moved, torch.zeros_like(moved))
                validity = ok if moved_valid is None else (ok & moved_valid)
                dt = c.dtype.with_nullable(True)
            out_cols[f.name] = Column(data, validity, dt, c.dictionary)
        elif f.func in ("first_value", "last_value"):
            if f.frame is not None:
                # the first or last row of the frame; an empty frame is NULL
                lo, hi = frame_lo_hi(f)
                ok = lo <= hi
                idx = torch.where(ok, (lo if f.func == "first_value" else hi)
                                  .clamp(0, n - 1), torch.zeros_like(lo))
                data = c.data[idx]
                validity = ok if c.validity is None else (ok & c.validity[idx])
                out_cols[f.name] = Column(
                    torch.where(ok, data, torch.zeros_like(data)), validity,
                    c.dtype.with_nullable(True), c.dictionary)
            else:
                # the default frame ends at the current row's last peer
                idx = part_start_idx if f.func == "first_value" else peer_end_idx
                out_cols[f.name] = Column(
                    c.data[idx], None if c.validity is None else c.validity[idx],
                    c.dtype, c.dictionary)
        elif f.func == "nth_value":
            nth = max(int(f.offset), 1)
            lo, hi = frame_lo_hi(f) if f.frame is not None else (part_start_idx, pos)
            tgt = lo + (nth - 1)
            ok = tgt <= hi
            idx = tgt.clamp(0, n - 1)
            data = c.data[idx]
            validity = ok if c.validity is None else (ok & c.validity[idx])
            out_cols[f.name] = Column(
                torch.where(ok, data, torch.zeros_like(data)), validity,
                c.dtype.with_nullable(True), c.dictionary)
        elif f.func in ("min", "max") and f.frame is not None:
            out_cols[f.name] = _framed_extreme(f, c, frame_lo_hi(f), part_start,
                                               part_start_idx, n)
        elif f.func in ("sum", "count", "avg") and f.frame is not None:
            lo, hi = frame_lo_hi(f)
            cnt_f = frame_diff(torch.cumsum(valid_counts(c), 0), lo, hi, False)
            if f.func == "count":
                out_cols[f.name] = Column(cnt_f, None, INT64)
                continue
            is_float = c.dtype.is_float
            if is_float:
                sum_f = frame_diff(float_prefix(c), lo, hi, True)
            else:
                sum_f = frame_diff(torch.cumsum(int_values(c), 0), lo, hi, False)
            if f.func == "sum":
                rdt = _sum_dtype(c, is_float)
                out_cols[f.name] = Column(sum_f.to(rdt.torch_dtype), cnt_f > 0, rdt)
            else:
                out_cols[f.name] = _avg_column(sum_f, cnt_f, c)
        elif f.func == "count" or (f.func in ("sum", "avg") and not c.dtype.is_float):
            # running count, integer or decimal sum and avg
            run_cnt = running(torch.cumsum(valid_counts(c), 0), False)
            if f.func == "count":
                out_cols[f.name] = Column(run_cnt, None, INT64)
                continue
            run_sum = running(torch.cumsum(int_values(c), 0), False)
            if f.func == "avg":
                out_cols[f.name] = _avg_column(run_sum, run_cnt, c)
            else:
                rdt = _sum_dtype(c, False)
                seen = (run_cnt > 0) if c.validity is not None else None
                out_cols[f.name] = Column(run_sum.to(rdt.torch_dtype), seen, rdt,
                                          c.dictionary)
        elif f.func in ("sum", "min", "max"):
            # running float sum, running min and max
            acc_dt = (FLOAT64 if c.dtype.is_float else INT64) if f.func == "sum" \
                else c.dtype
            vals = c.data.to(acc_dt.torch_dtype)
            if c.validity is not None:
                ident = 0 if f.func == "sum" else _extreme(f.func, vals.dtype)
                vals = torch.where(c.validity, vals,
                                   torch.full((), ident, dtype=vals.dtype, device=dev))
            data = running(_segmented_prefix(f.func, vals, part_start), True)
            rdt = (_sum_dtype(c, c.dtype.is_float) if f.func == "sum" else c.dtype)
            seen = None
            if c.validity is not None:
                seen = running(_segmented_prefix("sum", c.validity.to(torch.int64),
                                                 part_start), True) > 0
            out_cols[f.name] = Column(data.to(rdt.torch_dtype), seen, rdt, c.dictionary)
        else:
            raise NotImplementedError(f.func)

    return Block.from_dict(out_cols, sel=sel)


def _framed_extreme(f: WindowDesc, c: Column, lo_hi, part_start: torch.Tensor,
                    part_start_idx: torch.Tensor, n: int) -> Column:
    """Min or max over a ROWS or RANGE frame by a sparse table: level j
    holds the reduction over [i, i + 2^j); a frame [lo, hi] (inside its
    partition) is two overlapping level-j blocks, j = floor(log2(len))."""
    lo, hi = lo_hi
    dev = lo.device
    length = hi - lo + 1
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    if c.validity is not None:
        ones = ones * c.validity.to(torch.int64)
    pc = _segmented_prefix("sum", ones, part_start)
    at_lo = torch.where(lo > part_start_idx, _gather(pc, lo - 1), torch.zeros_like(lo))
    cnt_f = _gather(pc, hi) - at_lo
    ident = _extreme(f.func, c.data.dtype)
    vals = c.data if c.validity is None else torch.where(
        c.validity, c.data, torch.full((), ident, dtype=c.data.dtype, device=dev))
    reduce2 = torch.minimum if f.func == "min" else torch.maximum
    prec, foll = f.frame
    if f.frame_type == "range" or prec is None or foll is None:
        width = n  # a value distance or an unbounded side: any length
    else:
        width = int(prec) + int(foll) + 1
    levels = max(min(width, n), 1).bit_length()
    tables = [vals]
    for j in range(1, levels):
        d = 1 << (j - 1)
        prev = tables[-1]
        pad = torch.full((min(d, n),), ident, dtype=prev.dtype, device=dev)
        shifted = torch.cat([prev[d:], pad])[:n]
        tables.append(reduce2(prev, shifted))
    flat = torch.stack(tables).reshape(-1)
    # floor(log2(len)) exactly: frexp's exponent of a positive integer
    j = torch.frexp(length.clamp(min=1).to(torch.float64)).exponent.to(torch.int64) - 1
    j = j.clamp(0, levels - 1)
    pw = torch.ones_like(j) << j
    ga = _gather(flat, j * n + lo)
    gb = _gather(flat, j * n + hi - pw + 1)
    red = reduce2(ga, gb)
    ok = (length > 0) & (cnt_f > 0)
    return Column(torch.where(ok, red, torch.zeros_like(red)), ok,
                  c.dtype.with_nullable(True), c.dictionary)


__all__ = ["WindowDesc", "window_block"]
