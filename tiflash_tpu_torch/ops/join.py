"""Hash join as a sorted build side and a range probe: inner, left
outer, semi and anti joins, and the cross join.

Counterpart of ``tiflash_tpu/ops/join.py``.  The build "hash table" is
the build keys sorted stably on (key, not matchable, position); a probe
row's matches are the range ``[lo, hi)`` that two ``torch.searchsorted``
calls give (``ops/merge.py``).

Ported here:

- key normalization (``normalize_join_keys``): int keys, string keys
  re-encoded into the build side's dictionary, multi-column keys packed
  into one int64 when they fit 63 bits, and past that hashed
  (``ops/hashing.py:hash_columns_u63``);
- ``build_join`` and ``JoinBuild.take_sorted``;
- the unique-build fast path (``probe_join_unique``) and the N:M path
  with a bounded output and a required-capacity overflow
  (``probe_join_general``), for every join kind of the reference:
  ``inner``, ``left``/``left_outer`` and ``right_as_probe_outer`` (every
  selected probe row stays in its place, with NULL build columns where
  it matched nothing; on the N:M path ``right_as_probe_outer`` expands
  as an inner join, as in the reference), ``semi`` and ``anti`` (they
  narrow the probe side's selection; a plain anti join keeps probe rows
  whose key is NULL), ``anti_null_aware`` (SQL's ``NOT IN``:
  ``_null_aware_anti_sel``), and ``left_outer_semi`` and
  ``left_outer_semi_null_aware`` (``EXISTS``/``IN`` in the select list:
  every probe row, with a bool ``__semi_matched`` column, NULL where
  ``IN`` is unknown);
- ``right_outer`` and ``full_outer`` (``hash_join_with_tail``): an inner
  or a left-outer pass, then the build rows no probe row matched
  (``scan_non_matched``), with NULL probe columns, appended in build key
  order;
- hashed keys always take the general path, which re-verifies each
  candidate match on the true keys (``_keys_equal``), so a hash
  collision never joins two different key tuples;
- ``hash_join``, whose unique inner and left paths report an overflow
  when the build keys were not unique after all, so the runner retries
  on the general path;
- ``cross_join``: every live probe row with every live build row, by
  the same prefix-sum expansion, with a required-capacity overflow.

The port adds direct addressing to the unique path (``join_method``):
where the one integer or DATE build key's range stats prove a span of at
most ``DENSE_SPAN_LIMIT`` values and ``DENSE_SPAN_PER_ROW`` per build
row (plus ``DENSE_SPAN_SLACK``), the build also gets a position table,
``table[key - lo]`` = the first sorted position of the key (the
``lo`` that ``searchsorted(left)`` gives), and ``probe_join_dense``
looks each probe key up in it and gathers the 1-D build columns in one
pass (``ops/cuda/join_probe.py``).  Every output tensor equals the
sorted path's, dead slots included.  Each ``hash_join`` records a span
``join.<method>`` (``dense``, ``sorted`` or ``general``; attributes
``rows`` and ``build``, the two capacities) and the counters
``join_calls_total_method_<method>`` and
``join_rows_total_method_<method>``.

NULL join keys never match.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.block import Block, Column
from ..core.dtypes import DataType, TypeKind
from ..runtime import tracing
from ..runtime.metrics import METRICS

_LEFT = ("left", "left_outer")
_SEMI_COLUMN = ("left_outer_semi", "left_outer_semi_null_aware")
_NO_EXPANSION = ("semi", "anti", "anti_null_aware") + _SEMI_COLUMN


# ---------------------------------------------------------------------------
# join-key normalization
# ---------------------------------------------------------------------------


def _translate_dictionary(col: Column, target_dict: Tuple[str, ...],
                          absent: int = -1) -> torch.Tensor:
    """Re-encode string codes into another dictionary's code space;
    strings absent from the target map to ``absent``."""
    src = col.dictionary or ()
    rank = {s: i for i, s in enumerate(target_dict)}
    table = torch.tensor([rank.get(s, absent) for s in src] or [absent],
                         dtype=torch.int64, device=col.data.device)
    return table[col.data.clamp(0, table.shape[0] - 1).long()]


def _key_bits(dt: DataType, dict_size: int) -> int:
    if dt.is_string:
        # ceil(log2(dict_size + 2)), exactly
        return max(1, (dict_size + 1).bit_length())
    if dt.kind is TypeKind.BOOL:
        return 1
    return dt.physical.itemsize * 8


def _pair_bits(lc: Column, rc: Column) -> int:
    if lc.dtype.is_string or rc.dtype.is_string:
        return _key_bits(rc.dtype, len(rc.dictionary or ()))
    return max(_key_bits(lc.dtype, 0), _key_bits(rc.dtype, 0))


def join_keys_need_verify(left_cols: Sequence[Column],
                          right_cols: Sequence[Column]) -> bool:
    """True when the keys do not pack into 63 bits (the reference then
    joins on hashed keys and re-verifies)."""
    if len(left_cols) == 1:
        return False
    return sum(_pair_bits(lc, rc) for lc, rc in zip(left_cols, right_cols)) > 63


def normalize_join_keys(
    left_cols: Sequence[Column], right_cols: Sequence[Column]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left_keys, left_null, right_keys, right_null): int64 keys equal
    iff the key tuples are equal.  Strings are reconciled into the right
    (build) side's dictionary; a probe string absent from it maps to
    ``len(dictionary)``, a real value with no match (not NULL)."""
    assert len(left_cols) == len(right_cols)
    l_null = torch.zeros(left_cols[0].capacity, dtype=torch.bool,
                         device=left_cols[0].data.device)
    r_null = torch.zeros(right_cols[0].capacity, dtype=torch.bool,
                         device=right_cols[0].data.device)
    l_parts: List[torch.Tensor] = []
    r_parts: List[torch.Tensor] = []
    bits: List[int] = []
    for lc, rc in zip(left_cols, right_cols):
        rv = rc.data.to(torch.int64)
        if lc.dtype.is_string or rc.dtype.is_string:
            rdict = rc.dictionary or ()
            lv = _translate_dictionary(lc, rdict, absent=len(rdict))
        else:
            lv = lc.data.to(torch.int64)
        if lc.validity is not None:
            l_null = l_null | ~lc.validity
        if rc.validity is not None:
            r_null = r_null | ~rc.validity
        l_parts.append(lv)
        r_parts.append(rv)
        bits.append(_pair_bits(lc, rc))
    if len(l_parts) == 1:
        return l_parts[0], l_null, r_parts[0], r_null
    if sum(bits) > 63:
        # a 62-bit hash of the key tuple is the sort and probe key; the
        # probe re-verifies the true keys of every candidate match
        from .hashing import hash_columns_u63

        return (hash_columns_u63(left_cols), l_null,
                hash_columns_u63(right_cols), r_null)
    lk = torch.zeros_like(l_parts[0])
    rk = torch.zeros_like(r_parts[0])
    for lv, rv, b in zip(l_parts, r_parts, bits):
        # bias signed values into unsigned sub-ranges so packing is injective
        bias, mask = 1 << (b - 1), (1 << b) - 1
        lk = (lk << b) | ((lv + bias) & mask)
        rk = (rk << b) | ((rv + bias) & mask)
    return lk, l_null, rk, r_null


def _keys_equal(probe_cols: Sequence[Column],
                build_cols: Sequence[Column]) -> torch.Tensor:
    """Row-wise equality of the true key tuples (hashed-key verification)."""
    eq = None
    for pc, bc in zip(probe_cols, build_cols):
        if pc.dtype.is_string or bc.dtype.is_string:
            pv = _translate_dictionary(pc, bc.dictionary or ())
        else:
            pv = pc.data.to(torch.int64)
        e = pv == bc.data.to(torch.int64)
        if pc.validity is not None:
            e = e & pc.validity
        if bc.validity is not None:
            e = e & bc.validity
        eq = e if eq is None else (eq & e)
    return eq


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JoinBuild:
    """Sorted build side.  Only the keys are sorted; payload columns stay
    in their original order and probes compose through ``perm``."""

    sorted_keys: torch.Tensor   # int64 (n,), NULL/dead rows last
    block: Block                # build payload, original row order
    perm: torch.Tensor          # sorted position -> original row
    sorted_sel: torch.Tensor    # selected flags in key order
    num_live: torch.Tensor      # 0-d int32: matchable rows (a prefix)
    unique: torch.Tensor        # 0-d bool: no duplicate live keys
    # the dense method's position table over the keys [table_lo,
    # table_lo + len(table)): a key's first sorted position, or -1
    table_lo: Optional[int] = None
    table: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return int(self.sorted_keys.shape[0])

    def take_sorted(self, sidx: torch.Tensor, fill_invalid: bool = False) -> Block:
        """Payload rows at sorted positions ``sidx`` (negative = NULL row
        with ``fill_invalid``).  The same two plans as the reference,
        chosen by capacities, so even dead rows carry the same payload."""
        if self.block.capacity <= int(sidx.shape[0]):
            return self.block.take(self.perm).take(sidx, fill_invalid=fill_invalid)
        comp = self.perm[sidx.clamp(min=0).long()]
        if fill_invalid:
            comp = torch.where(sidx >= 0, comp, torch.full_like(comp, -1))
        return self.block.take(comp, fill_invalid=fill_invalid)


_KEY_INF = 2 ** 63 - 1


def build_join(build_block: Block, build_keys: torch.Tensor,
               build_null: torch.Tensor) -> JoinBuild:
    """Sort the build keys stably on (key, not matchable, position).
    NULL-key and dead rows get the key 2^63-1 and sort after every real
    row of that key, so the matchable rows are exactly the first
    ``num_live`` sorted positions."""
    from .sort import lexsort_stable

    selected = build_block.sel_mask()
    matchable = selected & ~build_null
    keys = torch.where(matchable, build_keys.to(torch.int64),
                       torch.full_like(build_keys, _KEY_INF, dtype=torch.int64))
    perm = lexsort_stable([keys, ~matchable])
    skeys = keys[perm]
    sorted_sel = selected[perm]
    num_live = torch.sum(matchable, dtype=torch.int32)
    n = build_block.capacity
    pos = torch.arange(1, n, dtype=torch.int32, device=keys.device)
    dup = (skeys[1:] == skeys[:-1]) & (pos < num_live)
    return JoinBuild(skeys, build_block, perm.to(torch.int32), sorted_sel,
                     num_live, ~torch.any(dup))


# the dense method's caps on the build key's span (hi - lo + 1): a table
# of at most 2^26 int32 entries (256 MB), and at most 16 entries per
# build row past the first 2^16
DENSE_SPAN_LIMIT = 1 << 26
DENSE_SPAN_PER_ROW = 16
DENSE_SPAN_SLACK = 1 << 16
_DENSE_KEY_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
                    TypeKind.DATE)
# unflagged build positions scatter into this many trash entries past
# the table, by position, so they never pile onto one address
_TRASH_LANES = 1024


def dense_key_span(probe_cols: Sequence[Column],
                   build_cols: Sequence[Column]) -> Optional[Tuple[int, int]]:
    """(lo, span) of the build key when a unique probe can address a
    position table: one integer or DATE key a side, 1-D, the build key's
    range stats ``(lo, hi)`` giving ``span = hi - lo + 1`` within the
    caps.  None otherwise.  Host values only: nothing syncs."""
    if len(probe_cols) != 1 or len(build_cols) != 1:
        return None
    pc, bc = probe_cols[0], build_cols[0]
    if (pc.dtype.kind not in _DENSE_KEY_KINDS or bc.dtype.kind not in _DENSE_KEY_KINDS
            or pc.data.dim() != 1 or bc.data.dim() != 1
            or bc.stats is None or bc.capacity == 0):
        return None
    lo, hi = bc.stats
    span = hi - lo + 1
    cap = min(DENSE_SPAN_LIMIT, DENSE_SPAN_PER_ROW * bc.capacity + DENSE_SPAN_SLACK)
    return (lo, span) if 1 <= span <= cap else None


def join_method(probe_cols: Sequence[Column], build_cols: Sequence[Column],
                output_capacity: Optional[int]) -> str:
    """``dense`` (the unique path over a position table), ``sorted`` (the
    unique path's range searches) or ``general`` (the N:M expansion,
    hashed keys included)."""
    if output_capacity is not None or join_keys_need_verify(probe_cols, build_cols):
        return "general"
    return "dense" if dense_key_span(probe_cols, build_cols) is not None else "sorted"


def build_join_dense(build_block: Block, key: Column, lo: int, span: int) -> JoinBuild:
    """``build_join`` on one integer key, plus the position table of its
    ``span`` keys from ``lo``: each live key's first sorted position,
    which is the ``lo`` that ``searchsorted(left)`` gives.  A live key
    outside the span (no column's stats allow one) is left out."""
    null = (torch.zeros(key.capacity, dtype=torch.bool, device=key.data.device)
            if key.validity is None else ~key.validity)
    build = build_join(build_block, key.data.to(torch.int64), null)
    skeys = build.sorted_keys
    n = build.capacity
    pos = torch.arange(n, dtype=torch.int64, device=skeys.device)
    first = torch.ones(n, dtype=torch.bool, device=skeys.device)
    first[1:] = skeys[1:] != skeys[:-1]
    # the dead rows' sentinel keys may wrap here; they are not kept
    off = skeys - lo
    keep = first & (pos < build.num_live) & (off >= 0) & (off < span)
    table = torch.full((span + _TRASH_LANES,), -1, dtype=torch.int32, device=skeys.device)
    table.scatter_(0, torch.where(keep, off, span + pos % _TRASH_LANES), pos.to(torch.int32))
    return dataclasses.replace(build, table_lo=lo, table=table[:span])


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def _probe_ranges(build: JoinBuild, probe_keys: torch.Tensor):
    from .merge import probe_ranges_fast

    return probe_ranges_fast(build.sorted_keys, probe_keys, build.num_live)


def _merge_blocks(probe_block: Block, build_rows: Block) -> Block:
    """Column concat; a build column whose name the probe side has gets
    the ``_r`` suffix."""
    out: Dict[str, Column] = dict(zip(probe_block.names, probe_block.columns))
    for n, c in zip(build_rows.names, build_rows.columns):
        out[n if n not in out else n + "_r"] = c
    return Block.from_dict(out)


def _matched_flags(build: JoinBuild, build_idx: torch.Tensor) -> torch.Tensor:
    """Which sorted build positions were hit (a bool scatter; the
    reference's sort-based membership is a TPU scatter workaround)."""
    cap = build.capacity
    idx = torch.where(build_idx >= 0, build_idx.long(),
                      torch.full_like(build_idx, cap, dtype=torch.int64))
    flags = torch.zeros(cap + 1, dtype=torch.bool, device=idx.device)
    flags[idx] = True
    return flags[:cap]


def _build_null_state(build: JoinBuild) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the build side has a selected NULL-key row, it has no selected
    row): the matchable rows are the first ``num_live`` sorted positions,
    so a selected row past them has a NULL key."""
    selected = build.sorted_sel
    matchable = torch.arange(build.capacity, device=selected.device) < build.num_live
    return torch.any(selected & ~matchable), ~torch.any(selected)


def _null_aware_anti_sel(build: JoinBuild, matched: torch.Tensor,
                         probe_null: torch.Tensor) -> torch.Tensor:
    """NOT IN: an empty build keeps every probe row; otherwise a NULL
    probe key, a match, or a NULL key on the build side drops it."""
    has_null, empty = _build_null_state(build)
    keep = ~probe_null & ~matched & ~has_null
    return torch.where(empty, torch.ones_like(keep), keep)


def _no_expansion(kind: str, build: JoinBuild, probe_block: Block,
                  matched: torch.Tensor, probe_null: torch.Tensor) -> Block:
    """The probe rows of a semi-type join: narrowed (semi, anti, NOT IN)
    or all kept with a bool ``__semi_matched`` column (EXISTS, and IN with
    NULL where it is unknown: an unmatched row whose key is NULL or whose
    build side holds a NULL key, unless the build side is empty)."""
    from ..core.dtypes import BOOL

    if kind == "semi":
        return probe_block.and_sel(matched)
    if kind == "anti":
        # NOT EXISTS: a NULL-key row has no match, so it stays
        return probe_block.and_sel(~matched)
    if kind == "anti_null_aware":
        return probe_block.and_sel(_null_aware_anti_sel(build, matched, probe_null))
    if kind == "left_outer_semi":
        col = Column(matched, None, BOOL)
    else:
        has_null, empty = _build_null_state(build)
        unknown = ~matched & (probe_null | has_null) & ~empty
        col = Column(matched, ~unknown, BOOL.with_nullable(True))
    return probe_block.with_column("__semi_matched", col)


def probe_join_unique(build: JoinBuild, probe_block: Block,
                      probe_keys: torch.Tensor, probe_null: torch.Tensor,
                      kind: str = "inner") -> Tuple[Block, torch.Tensor]:
    """1:N fast path for unique build keys: output capacity == probe
    capacity, each probe row matches at most one build row.  Returns
    (joined block, matched build positions)."""
    probe_live = probe_block.sel_mask() & ~probe_null
    lo, hi = _probe_ranges(build, probe_keys)
    matched = probe_live & (hi > lo)
    bidx = torch.where(matched, lo, torch.full_like(lo, -1))
    if kind in _NO_EXPANSION:
        return (_no_expansion(kind, build, probe_block, matched, probe_null),
                _matched_flags(build, bidx))
    if kind not in ("inner", "right_as_probe_outer") + _LEFT:
        raise NotImplementedError(f"join kind {kind}")
    build_rows = build.take_sorted(bidx, fill_invalid=True)
    joined = _merge_blocks(probe_block, build_rows)
    # inner keeps the matched rows; the outer kinds every selected probe row
    joined = joined.with_sel(matched if kind == "inner" else probe_block.sel_mask())
    return joined, _matched_flags(build, bidx)


def probe_join_dense(build: JoinBuild, probe_block: Block, key: Column,
                     kind: str = "inner") -> Tuple[Block, torch.Tensor]:
    """``probe_join_unique`` through the build's position table: one
    lookup per probe row and the 1-D build columns gathered in the same
    pass (``ops/cuda/join_probe.py``); 2-D columns through
    ``take_sorted`` at the positions it gives.  The same outputs, tensor
    for tensor, as the range searches."""
    from .cuda.join_probe import join_probe

    if kind not in ("inner", "right_as_probe_outer") + _LEFT + _NO_EXPANSION:
        raise NotImplementedError(f"join kind {kind}")
    payload = () if kind in _NO_EXPANSION else build.block.columns
    flat = [c for c in payload if c.data.dim() == 1]
    wide = [n for n, c in zip(build.block.names, payload) if c.data.dim() != 1]
    keys = key.data if key.data.dtype in (torch.int32, torch.int64) \
        else key.data.to(torch.int32)
    matched, bidx, flags, outs = join_probe(
        keys.contiguous(), key.validity, probe_block.sel, build.table, build.table_lo,
        build.perm, build.block.capacity <= probe_block.capacity,
        [(c.data.contiguous(), None if c.validity is None else c.validity.contiguous())
         for c in flat], want_bidx=bool(wide))
    if kind in _NO_EXPANSION:
        probe_null = None
        if kind in ("anti_null_aware", "left_outer_semi_null_aware"):
            probe_null = (torch.zeros_like(matched) if key.validity is None
                          else ~key.validity)
        return _no_expansion(kind, build, probe_block, matched, probe_null), flags
    rows_wide = (dataclasses.replace(build, block=build.block.select(wide))
                 .take_sorted(bidx, fill_invalid=True) if wide else None)
    gathered = iter(outs)
    cols = []
    for name, c in zip(build.block.names, build.block.columns):
        if c.data.dim() == 1:
            data, valid = next(gathered)
            cols.append(c.with_data(data, valid, stats=c.stats))
        else:
            cols.append(rows_wide[name])
    joined = _merge_blocks(probe_block, Block(names=build.block.names, columns=tuple(cols)))
    # inner keeps the matched rows; the outer kinds every selected probe row
    joined = joined.with_sel(matched if kind == "inner" else probe_block.sel_mask())
    return joined, flags


def probe_join_general(
    build: JoinBuild,
    probe_block: Block,
    probe_keys: torch.Tensor,
    probe_null: torch.Tensor,
    kind: str,
    output_capacity: int,
    verify: Optional[Tuple[Sequence[str], Sequence[str]]] = None,
) -> Tuple[Block, torch.Tensor, torch.Tensor]:
    """N:M expansion by prefix-sum addressing into ``output_capacity``
    rows: output slot t takes probe row searchsorted(cum, t, right) and
    build row lo + (t - start).  A left join emits every selected probe
    row at least once.  ``verify`` = (probe key names, build key names)
    re-checks the true keys of each candidate of a hashed-key join.
    Returns (joined, matched build flags, required capacity or 0)."""
    from .merge import dense_inverse

    probe_live = probe_block.sel_mask() & ~probe_null
    lo, hi = _probe_ranges(build, probe_keys)
    # dead / NULL-key rows get an empty range
    zero = torch.zeros_like(lo)
    lo = torch.where(probe_live, lo, zero)
    hi = torch.where(probe_live, hi, zero)
    if verify is None and kind in _NO_EXPANSION:
        # no expansion: the probe rows, in the probe's capacity
        matched = probe_live & (hi > lo)
        bflags = _matched_flags(build, torch.where(matched, lo,
                                                   torch.full_like(lo, -1)))
        return (_no_expansion(kind, build, probe_block, matched, probe_null), bflags,
                torch.zeros((), dtype=torch.int64, device=lo.device))
    counts = (hi - lo).to(torch.int64)
    if kind in _LEFT:
        # every selected probe row emits at least once (NULL-key rows too)
        counts = torch.maximum(counts, probe_block.sel_mask().to(torch.int64))
    cum = torch.cumsum(counts, 0)
    total = cum[-1] if counts.shape[0] else torch.zeros((), dtype=torch.int64,
                                                          device=cum.device)
    start = cum - counts
    t = torch.arange(output_capacity, dtype=torch.int64, device=cum.device)
    prow = dense_inverse(cum, output_capacity)
    prow_safe = torch.clamp(prow, max=counts.shape[0] - 1).long()
    k = t - start[prow_safe]
    has_match = hi[prow_safe] > lo[prow_safe]
    brow = lo[prow_safe] + k.to(torch.int32)
    live_out = t < total
    brow = torch.where(live_out & has_match, brow, torch.full_like(brow, -1))
    needed = torch.where(total > output_capacity, total, torch.zeros_like(total))

    if verify is not None:
        probe_names, build_names = verify
        pvc = [probe_block[nm].take(prow_safe) for nm in probe_names]
        bcomp = build.perm[brow.clamp(min=0).long()]
        bvc = [build.block[nm].take(bcomp) for nm in build_names]
        verified = _keys_equal(pvc, bvc) & has_match & live_out
        if kind in ("semi", "anti"):
            n_probe = probe_block.capacity
            hit = torch.zeros(n_probe + 1, dtype=torch.bool, device=lo.device)
            hit[torch.where(verified, prow_safe, torch.full_like(prow_safe, n_probe))] = True
            hit = hit[:n_probe]
            bflags = _matched_flags(build, torch.where(verified, brow,
                                                       torch.full_like(brow, -1)))
            return (probe_block.and_sel(hit if kind == "semi" else ~hit), bflags,
                    needed)
        if kind != "inner":
            raise NotImplementedError(
                f"hashed wide join keys not supported for kind {kind!r}")
        live_out = verified

    probe_rows = probe_block.take(prow_safe)
    build_rows = build.take_sorted(brow, fill_invalid=True)
    joined = _merge_blocks(probe_rows, build_rows).with_sel(live_out)
    bflags = _matched_flags(build, torch.where(live_out, brow,
                                               torch.full_like(brow, -1)))
    return joined, bflags, needed


def scan_non_matched(build: JoinBuild, matched_flags: torch.Tensor,
                     probe_names, probe_block: Block) -> Block:
    """The right/full-outer tail: the selected build rows no probe row
    hit, in build key order, with NULL probe columns."""
    live = build.sorted_sel & ~matched_flags
    n = build.capacity
    dev = live.device
    cols: Dict[str, Column] = {}
    for name in probe_names:
        c = probe_block[name]
        data = torch.zeros((n,) + tuple(c.data.shape[1:]), dtype=c.data.dtype,
                           device=dev)
        cols[name] = Column(data, torch.zeros(n, dtype=torch.bool, device=dev),
                            c.dtype.with_nullable(True), c.dictionary)
    sorted_payload = build.block.take(build.perm)
    for name, c in zip(sorted_payload.names, sorted_payload.columns):
        cols[name if name not in cols else name + "_r"] = c
    return Block.from_dict(cols, sel=live)


def cross_join(probe_block: Block, build_block: Block,
               output_capacity: int) -> Tuple[Block, torch.Tensor]:
    """Cartesian product by the prefix-sum expansion of the N:M probe,
    every live probe row matching every live build row.  Returns
    (joined block, required capacity or 0)."""
    from .merge import dense_inverse

    build_c = build_block.compact()
    nb = build_c.num_rows().to(torch.int64)
    probe_live = probe_block.sel_mask()
    counts = torch.where(probe_live, nb, torch.zeros_like(nb))
    cum = torch.cumsum(counts, 0)
    total = cum[-1] if counts.shape[0] else torch.zeros((), dtype=torch.int64,
                                                          device=cum.device)
    start = cum - counts
    t = torch.arange(output_capacity, dtype=torch.int64, device=cum.device)
    prow = dense_inverse(cum, output_capacity)
    prow_safe = torch.clamp(prow, max=counts.shape[0] - 1).long()
    brow = t - start[prow_safe]
    live_out = t < total
    brow = torch.where(live_out, torch.clamp(brow, max=build_c.capacity - 1),
                       torch.zeros_like(brow))
    joined = _merge_blocks(probe_block.take(prow_safe),
                           build_c.take(brow)).with_sel(live_out)
    needed = torch.where(total > output_capacity, total, torch.zeros_like(total))
    return joined, needed


# ---------------------------------------------------------------------------
# one call
# ---------------------------------------------------------------------------


def hash_join(
    probe_block: Block,
    build_block: Block,
    probe_key_names: Sequence[str],
    build_key_names: Sequence[str],
    kind: str = "inner",
    output_capacity: Optional[int] = None,
    build_payload: Optional[Sequence[str]] = None,
):
    """Build + probe.  ``output_capacity is None`` is the caller's
    promise that the build keys are unique (the fast path); if the
    promise is false an inner join's overflow carries ``probe capacity +
    1`` so the runner retries on the general path (semi and anti joins
    do not care about duplicates).  ``build_payload`` narrows which
    build columns the join emits.

    Returns (joined block, {"build", "matched_flags", "overflow"})."""
    pk = [probe_block[k] for k in probe_key_names]
    bk = [build_block[k] for k in build_key_names]
    needs_verify = join_keys_need_verify(pk, bk)
    payload_block = build_block
    if build_payload is not None:
        want = set(build_payload)
        if needs_verify:
            want |= set(build_key_names)  # re-verification reads true keys
        keep = [n for n in build_block.names if n in want]
        if not keep:  # a block needs one column to carry its capacity
            keep = [build_key_names[0]]
        payload_block = Block(names=tuple(keep),
                              columns=tuple(build_block[n] for n in keep),
                              sel=build_block.sel)
    method = join_method(pk, bk, output_capacity)
    METRICS.counter(f"join_calls_total_method_{method}").inc()
    METRICS.counter(f"join_rows_total_method_{method}").inc(probe_block.capacity)
    with tracing.span("join." + method, rows=probe_block.capacity,
                      build=build_block.capacity):
        if method == "dense":
            build = build_join_dense(payload_block, bk[0], *dense_key_span(pk, bk))
            joined, bflags = probe_join_dense(build, probe_block, pk[0], kind)
        else:
            pkeys, pnull, bkeys, bnull = normalize_join_keys(pk, bk)
            build = build_join(payload_block, bkeys, bnull)
            if method == "sorted":
                joined, bflags = probe_join_unique(build, probe_block, pkeys, pnull, kind)
            elif needs_verify:
                # hashed keys: a collision makes the unique path unsound and
                # the candidate ranges approximate, so always expand and
                # re-verify
                if kind not in ("inner", "semi", "anti"):
                    raise NotImplementedError(
                        f"join keys wider than 63 bits not supported for kind {kind!r}")
                joined, bflags, overflow = probe_join_general(
                    build, probe_block, pkeys, pnull, kind,
                    output_capacity or probe_block.capacity,
                    verify=(list(probe_key_names), list(build_key_names)))
            else:
                joined, bflags, overflow = probe_join_general(
                    build, probe_block, pkeys, pnull, kind, output_capacity)
        if method != "general":
            # duplicate live build keys: the unique path kept only the first
            # match of each probe row; say so instead of dropping rows
            dev = probe_block.device
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            overflow = zero if kind not in ("inner", "right_as_probe_outer") + _LEFT \
                else torch.where(
                build.unique, zero,
                torch.full((), probe_block.capacity + 1, dtype=torch.int64, device=dev))
    return joined, {"build": build, "matched_flags": bflags, "overflow": overflow}


def hash_join_with_tail(
    probe_block: Block,
    build_block: Block,
    probe_key_names: Sequence[str],
    build_key_names: Sequence[str],
    kind: str,
    output_capacity: Optional[int],
    build_payload: Optional[Sequence[str]] = None,
):
    """``hash_join`` plus the right/full-outer tail of unmatched build
    rows: right outer is an inner pass and the tail, full outer a
    left-outer pass and the tail."""
    probe_kind = {"right_outer": "inner", "full_outer": "left_outer"}.get(kind, kind)
    joined, extras = hash_join(probe_block, build_block, probe_key_names,
                               build_key_names, kind=probe_kind,
                               output_capacity=output_capacity,
                               build_payload=build_payload)
    if kind in ("right_outer", "full_outer"):
        from ..exchange.skew import concat_blocks

        tail = scan_non_matched(extras["build"], extras["matched_flags"],
                                probe_block.names, probe_block)
        joined = concat_blocks(joined, tail)
    return joined, extras


__all__ = [
    "JoinBuild", "build_join", "build_join_dense", "probe_join_unique",
    "probe_join_dense", "probe_join_general", "dense_key_span", "join_method",
    "cross_join", "hash_join", "hash_join_with_tail", "normalize_join_keys",
    "scan_non_matched",
    "join_keys_need_verify",
]
