"""Fused scan->filter->project->aggregate compilation for the stream-agg
kernel (``ops/cuda/stream_agg.py``).

Counterpart of ``tiflash_tpu/ops/stream_fuse.py``.  When an Aggregation
sits on a Selection/Projection chain over one TableScan and every
aggregate argument is integer-family arithmetic with known value ranges
(column min/max stats), the whole chain compiles into one tile function
plus one grouped-sum kernel.

The plan-time half is python-int math, ported verbatim: the interval
("parts") compiler decomposes +,-,* expressions over ranged columns into
a signed sum of weighted non-negative int32 quantities

    expr(row) == sum_p  sign_p * 2**shift_p * part_p(row),  0 <= part < 2^31

(wide products split a factor into 16-bit halves), each part splits into
``ACC_LIMB_BITS``-wide limbs, small limbs share 31-bit planes (first-fit
decreasing), and the per-slot plane sums recombine once per (slot, part)
in int64 — or in two-limb wide decimals past the int64 bound.

The row-time half is data: every builder returns a node of a
``TileProgram`` (``ops/tile_program.py``), the int32 row ops that the
reference traces into its kernel as closures.  ``_fuse`` assembles the
program (live mask, key slot, planes) and hands it to
``ops/cuda/stream_tile.py``, which generates, builds and launches one
CUDA kernel for it on the card and evaluates it in torch on the CPU.
Every value stays int32: the interval bounds prove each part, product
and packed plane fits int31 (partial sums may wrap, as torch's do).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.block import Block, Column
from ..core.dtypes import BOOL, DataType, INT64, TypeKind
from ..expr.nodes import Call, ColumnRef, Expr, Literal
from . import tile_program as TP
from .cuda import stream_tile as ST

# Plan-time layout constants, equal to the reference's so both packages
# pick the same parts, limbs and packed planes.
MUL_SPLIT_BITS = 16    # wide-product factor split (grade-school multiply)
ACC_LIMB_BITS = 25     # accumulation limb width
# headroom bits above each packed field: the reference's per-element
# growth between its int32 flushes (log2 of 64 tiles).  The port's kernel
# uses it the same way: each lane adds 2^6 rows' whole planes in uint32
# before it extracts the fields (``stream_group_sums(..., headroom=)``).
FIELD_GROWTH_BITS = 6

_MUL_MASK = (1 << MUL_SPLIT_BITS) - 1
_ACC_MASK = (1 << ACC_LIMB_BITS) - 1
_I31 = 1 << 31

Tile = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# parts algebra
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Part:
    """One non-negative int32 per-row quantity with a weight and sign."""

    build: Optional[TP.Node]             # the row value (None: constant)
    shift: int
    sign: int
    lo: int
    hi: int
    const: Optional[int] = None          # constant part (build is None)
    valid_cols: Tuple[str, ...] = ()     # validity inputs ANDed into value


@dataclasses.dataclass
class Term:
    parts: List[Part]
    dtype: DataType


class Ineligible(Exception):
    pass


def _bits(v: int) -> int:
    return max(1, int(v).bit_length())


def _const_part(c: int, shift: int = 0) -> Part:
    sign = 1 if c >= 0 else -1
    return Part(None, shift, sign, abs(c), abs(c), const=abs(c))


def _part_node(p: Part) -> TP.Node:
    """The part's int32 row value: 0 on rows where a validity input is 0."""
    v = TP.const(p.const) if p.const is not None else p.build
    for vc in p.valid_cols:
        v = TP.where(TP.nz(TP.inp(vc)), v, TP.const(0))
    return v


def _part_value(p: Part, tile: Tile, like: torch.Tensor) -> torch.Tensor:
    """The part's int32 values for a chunk shaped like ``like``."""
    return TP.evaluate_nodes([_part_node(p)], tile, (), like)[0]


def _eff_lo(p: Part) -> int:
    """NULL rows yield 0, so a part with validity inputs has minimum 0."""
    return 0 if p.valid_cols else p.lo


def _materialize(parts: List[Part]) -> List[Part]:
    """Fold a multi-part list into one part when the combined interval is a
    valid single int32 quantity (cuts both build ops and limb count)."""
    if len(parts) <= 1:
        return parts
    smin = min(p.shift for p in parts)
    lo = sum(
        (_eff_lo(p) if p.sign > 0 else -p.hi) << (p.shift - smin)
        for p in parts
    )
    hi = sum(
        (p.hi if p.sign > 0 else -_eff_lo(p)) << (p.shift - smin)
        for p in parts
    )
    if lo < 0 or hi >= _I31:
        return parts
    build = None
    for q in parts:
        v = TP.shl(_part_node(q), q.shift - smin)
        if q.sign < 0:
            v = TP.neg(v)
        build = v if build is None else TP.add(build, v)

    valid = tuple(sorted({vc for p in parts for vc in p.valid_cols}))
    if all(p.const is not None for p in parts) and not valid:
        cval = sum(p.sign * (p.const << (p.shift - smin)) for p in parts)
        return [_const_part(cval, smin)]
    return [Part(build, smin, 1, lo, hi, valid_cols=valid)]


def _split_part(p: Part) -> List[Part]:
    """value = lo16 + hi<<16 — both halves non-negative int32."""
    assert p.const is None
    blo = TP.band(p.build, _MUL_MASK)
    bhi = TP.shr(p.build, MUL_SPLIT_BITS)
    return [
        Part(blo, p.shift, p.sign, 0, min(p.hi, _MUL_MASK),
             valid_cols=p.valid_cols),
        Part(bhi, p.shift + MUL_SPLIT_BITS, p.sign, p.lo >> MUL_SPLIT_BITS,
             p.hi >> MUL_SPLIT_BITS, valid_cols=p.valid_cols),
    ]


def _mul_const(parts: List[Part], c: int) -> List[Part]:
    if c == 0:
        return [_const_part(0)]
    sign = 1 if c > 0 else -1
    c = abs(c)
    # fold powers of two into shifts
    shift_extra = 0
    while c % 2 == 0:
        c //= 2
        shift_extra += 1
    out: List[Part] = []
    for p in parts:
        cand = [p]
        if p.const is None and p.hi * c >= _I31:
            cand = _split_part(p)
        for q in cand:
            if q.hi * c >= _I31:
                raise Ineligible("constant multiply overflows int32 parts")
            if q.const is not None:
                out.append(
                    _const_part(q.sign * sign * q.const * c,
                                q.shift + shift_extra)
                )
                continue
            nb = q.build if c == 1 else TP.mul(q.build, TP.const(c))
            out.append(Part(nb, q.shift + shift_extra, q.sign * sign,
                            _eff_lo(q) * c, q.hi * c,
                            valid_cols=q.valid_cols))
    return _materialize(out)


def _mul_parts(a: List[Part], b: List[Part]) -> List[Part]:
    # constant side folds
    if all(p.const is not None for p in a):
        c = sum(p.sign * (p.const << p.shift) for p in a)
        return _mul_const(b, c)
    if all(p.const is not None for p in b):
        c = sum(p.sign * (p.const << p.shift) for p in b)
        return _mul_const(a, c)
    out: List[Part] = []
    for pa in a:
        for pb in b:
            if pa.const is not None:
                out.extend(_mul_const([pb], pa.sign * (pa.const << pa.shift)))
                continue
            if pb.const is not None:
                out.extend(_mul_const([pa], pb.sign * (pb.const << pb.shift)))
                continue
            ca, cb = [pa], [pb]
            if pa.hi * pb.hi >= _I31:
                # split the wider factor (grade-school multiply)
                if pa.hi >= pb.hi:
                    ca = _split_part(pa)
                else:
                    cb = _split_part(pb)
            for qa in ca:
                for qb in cb:
                    if qa.hi * qb.hi >= _I31:
                        raise Ineligible("product too wide after one split")
                    out.append(Part(
                        TP.mul(qa.build, qb.build), qa.shift + qb.shift, qa.sign * qb.sign,
                        _eff_lo(qa) * _eff_lo(qb), qa.hi * qb.hi,
                        valid_cols=tuple(sorted(
                            set(qa.valid_cols) | set(qb.valid_cols))),
                    ))
    if len(out) > 6:
        raise Ineligible("part explosion")
    return _materialize(out)


# ---------------------------------------------------------------------------
# expression -> Term
# ---------------------------------------------------------------------------

_INT_KINDS = (
    TypeKind.INT64, TypeKind.INT32, TypeKind.BOOL,
    TypeKind.DATE, TypeKind.DATETIME, TypeKind.DECIMAL,
)


def _col_interval(col: Column) -> Tuple[int, int]:
    if col.dtype.is_string and col.dictionary is not None:
        return 0, max(0, len(col.dictionary) - 1)
    if col.dtype.kind is TypeKind.BOOL:
        return 0, 1
    if col.stats is None:
        raise Ineligible("column lacks min/max stats")
    return col.stats


def _term_column(name: str, col: Column) -> Term:
    """Narrow columns (hi < 2^31) arrive as one int32 input; wide columns
    as two non-negative int32 words ``name__w0`` (low 31 bits) and
    ``name__w1`` (value >> 31) — see the input staging in ``_fuse``."""
    if col.dtype.kind not in _INT_KINDS:
        raise Ineligible(f"non-integer column {name}")
    lo, hi = _col_interval(col)
    if lo < 0:
        raise Ineligible("negative value range")
    valid = (name + "__v",) if col.validity is not None else ()
    if hi < _I31:
        return Term([Part(TP.inp(name), 0, 1, lo, hi, valid_cols=valid)], col.dtype)
    if hi >= 1 << 62:
        raise Ineligible("column range too wide")
    return Term([
        Part(TP.inp(name + "__w0"), 0, 1, 0, min(hi, _I31 - 1), valid_cols=valid),
        Part(TP.inp(name + "__w1"), 31, 1, lo >> 31, hi >> 31, valid_cols=valid),
    ], col.dtype)


def _literal_scaled(value, ctx: DataType) -> Optional[Tuple[int, DataType]]:
    """Mirror ExprEvaluator._literal_column's numeric/temporal encodings."""
    from ..expr.compile import _float_to_decimal, _literal_days
    import datetime

    if value is None:
        return None
    if ctx.is_temporal and isinstance(value, (str, datetime.date)):
        days = _literal_days(value)
        if ctx.kind is TypeKind.DATETIME:
            return days * 86_400_000_000, DataType(TypeKind.DATETIME)
        return days, DataType(TypeKind.DATE)
    if isinstance(value, bool):
        return int(value), BOOL
    if isinstance(value, int):
        return value, INT64
    if ctx.is_decimal and isinstance(value, float):
        md = _float_to_decimal(value)
        if md is None:
            return None
        from ..core.dtypes import Decimal

        m, s = md
        return m, Decimal(18, s)
    return None


def compile_term(expr: Expr, base: Block) -> Term:
    """Expression over ranged base columns -> signed weighted parts,
    with the engine's decimal mantissa semantics: plus/minus align to
    the common scale; multiply concatenates scales."""
    from ..expr.functions import get_function

    if isinstance(expr, ColumnRef):
        return _term_column(expr.name, base[expr.name])
    if isinstance(expr, Literal):
        raise Ineligible("bare literal needs operand context")
    if not isinstance(expr, Call) or expr.func not in ("plus", "minus", "multiply"):
        raise Ineligible(f"unsupported expr {expr!r}")
    a_expr, b_expr = expr.args

    def sub(e: Expr, other: Optional[Term]) -> Term:
        if isinstance(e, Literal):
            assert other is not None
            enc = _literal_scaled(e.value, other.dtype)
            if enc is None:
                raise Ineligible(f"literal {e.value!r} not encodable")
            c, dt = enc
            return Term([_const_part(c)], dt)
        return compile_term(e, base)

    if isinstance(a_expr, Literal) and isinstance(b_expr, Literal):
        raise Ineligible("constant folding not needed here")
    if isinstance(a_expr, Literal):
        tb = sub(b_expr, None)
        ta = sub(a_expr, tb)
    else:
        ta = sub(a_expr, None)
        tb = sub(b_expr, ta)

    fn = get_function(expr.func)
    out_dt = fn.infer([ta.dtype, tb.dtype])
    if out_dt.is_float:
        raise Ineligible("float result")

    def scale_of(dt: DataType) -> int:
        return dt.scale if dt.is_decimal else 0

    def attach_validity(parts: List[Part]) -> List[Part]:
        # a NULL operand nullifies the WHOLE result, so every part (const
        # parts included) is zeroed on NULL rows
        vset = tuple(sorted(
            {vc for t in (ta, tb) for p in t.parts for vc in p.valid_cols}
        ))
        if not vset:
            return parts
        return [dataclasses.replace(p, valid_cols=vset) for p in parts]

    if expr.func in ("plus", "minus"):
        if out_dt.is_decimal:
            s = max(scale_of(ta.dtype), scale_of(tb.dtype))
            pa = _mul_const(ta.parts, 10 ** (s - scale_of(ta.dtype))
                            * 10 ** (out_dt.scale - s))
            pb = _mul_const(tb.parts, 10 ** (s - scale_of(tb.dtype))
                            * 10 ** (out_dt.scale - s))
        else:
            pa, pb = ta.parts, tb.parts
        if expr.func == "minus":
            pb = [dataclasses.replace(p, sign=-p.sign) for p in pb]
        return Term(_materialize(attach_validity(pa + pb)), out_dt)

    # multiply
    if out_dt.is_decimal:
        extra = scale_of(ta.dtype) + scale_of(tb.dtype) - out_dt.scale
        if extra > 0:
            raise Ineligible("decimal multiply with rounding")
    return Term(attach_validity(_mul_parts(ta.parts, tb.parts)), out_dt)


# ---------------------------------------------------------------------------
# predicate compiler (Selection conditions inside the tile function)
# ---------------------------------------------------------------------------

# the engine's compare functions -> tile program compares
_CMPS = {
    "equals": "eq",
    "not_equals": "ne",
    "less": "lt",
    "less_or_equals": "le",
    "greater": "gt",
    "greater_or_equals": "ge",
}


def _valid_and(m: TP.Node, vnames) -> TP.Node:
    for vn in vnames:  # NULL rows are never selected
        m = TP.land(m, TP.nz(TP.inp(vn)))
    return m


def _cmp(func: str, v: TP.Node, c: TP.Node, flip: bool) -> TP.Node:
    """``v <op> c``, or ``c <op> v`` where the literal was on the left."""
    return TP.cmp(_CMPS[func], c, v) if flip else TP.cmp(_CMPS[func], v, c)


def compile_pred(expr: Expr, base: Block, pb: TP.ProgramBuilder) -> TP.Node:
    """cond -> the row's bool (NULL condition == not selected).  Literal
    values become launch parameters of ``pb``."""
    if isinstance(expr, Call) and expr.func in ("and", "or"):
        op = TP.land if expr.func == "and" else TP.lor
        acc = compile_pred(expr.args[0], base, pb)
        for a in expr.args[1:]:
            acc = op(acc, compile_pred(a, base, pb))
        return acc
    if isinstance(expr, Call) and expr.func == "not":
        return TP.lnot(compile_pred(expr.args[0], base, pb))

    if isinstance(expr, Call) and expr.func == "in":
        colref = expr.args[0]
        if not isinstance(colref, ColumnRef):
            raise Ineligible("IN needs a column")
        col = base[colref.name]
        if not col.dtype.is_string and _col_interval(col)[1] >= _I31:
            raise Ineligible("IN over a column wider than int31")
        codes: List[int] = []
        for a in expr.args[1:]:
            if not isinstance(a, Literal):
                raise Ineligible("IN needs literals")
            c = _encode_cmp_literal(a.value, col)
            if c is not None and c[1]:  # member / exact
                codes.append(c[0])
        name = colref.name
        vnames = (name + "__v",) if col.validity is not None else ()
        members = [pb.param(v) for v in codes]
        return _valid_and(TP.isin(TP.inp(name), members), vnames)

    if isinstance(expr, Call) and expr.func in _CMPS:
        a, b = expr.args
        flip = False
        if isinstance(a, Literal):
            a, b = b, a
            flip = True
        if not isinstance(b, Literal):
            raise Ineligible("comparison needs a literal side")
        if isinstance(a, ColumnRef) and base[a.name].dtype.is_string:
            return _string_cmp_pred(expr.func, a.name, base[a.name], b.value, flip, pb)
        term = compile_term(a, base)
        parts = _materialize(term.parts)
        if len(parts) != 1 or parts[0].const is not None:
            raise Ineligible("comparison lhs not a narrow value")
        enc = _literal_scaled(b.value, term.dtype)
        if enc is None:
            raise Ineligible("comparison literal not encodable")
        cval, cdt = enc
        # align scales like the engine's decimal compare
        s = max(
            term.dtype.scale if term.dtype.is_decimal else 0,
            cdt.scale if cdt.is_decimal else 0,
        )
        tshift = s - (term.dtype.scale if term.dtype.is_decimal else 0)
        cval = cval * 10 ** (s - (cdt.scale if cdt.is_decimal else 0))
        p = _mul_const(parts, 10 ** tshift)[0]
        if p.shift or p.sign < 0:
            raise Ineligible("comparison lhs has nontrivial weight")
        if not (-_I31 <= cval < _I31):
            # literal outside the part's int31 interval: the comparison is
            # statically decidable per row — modulo NULLs
            above = cval > p.hi   # else cval < 0 <= every value
            if expr.func == "not_equals":
                res = True
            elif expr.func == "equals":
                res = False
            elif expr.func in ("less", "less_or_equals"):
                res = above if not flip else not above
            else:
                res = (not above) if not flip else above
            return _valid_and(TP.bconst(res), p.valid_cols)
        v = p.build if p.const is None else _part_node(p)
        return _valid_and(_cmp(expr.func, v, pb.param(cval), flip), p.valid_cols)
    raise Ineligible(f"unsupported predicate {expr!r}")


def _encode_cmp_literal(value, col: Column):
    """String literal -> (code, exact_member) in the column's dictionary."""
    if not col.dtype.is_string:
        return (int(value), True) if isinstance(value, (int, bool)) else None
    d = col.dictionary or ()
    lo = bisect.bisect_left(d, value)
    member = lo < len(d) and d[lo] == value
    return (lo, member)


def _string_cmp_pred(op: str, name: str, col: Column, value, flip: bool,
                     pb: TP.ProgramBuilder) -> TP.Node:
    """A compare of dictionary codes.  A literal outside the dictionary sits
    between two codes: compare doubled codes against 2 * rank - 1 (whether
    it is a member is structure; its rank is a launch parameter)."""
    if not isinstance(value, str):
        raise Ineligible("string compare needs a string literal")
    d = col.dictionary or ()
    lo = bisect.bisect_left(d, value)
    member = lo < len(d) and d[lo] == value
    vnames = (name + "__v",) if col.validity is not None else ()
    data = TP.inp(name)
    if member:
        a, c = data, pb.param(lo)
    else:
        a, c = TP.mul(data, TP.const(2)), pb.param(2 * lo - 1)
    return _valid_and(_cmp(op, a, c, flip), vnames)


# ---------------------------------------------------------------------------
# plan-chain resolution
# ---------------------------------------------------------------------------


def _subst(expr: Expr, mapping: Dict[str, Expr]) -> Expr:
    if isinstance(expr, ColumnRef):
        try:
            return mapping[expr.name]
        except KeyError:
            raise Ineligible(f"unknown column {expr.name}")
    if isinstance(expr, Call):
        return Call(expr.func, tuple(_subst(a, mapping) for a in expr.args))
    return expr


def resolve_scan_chain(plan):
    """Aggregation child chain -> (table, out-name->base-expr, [conds])."""
    from ..plan import nodes as P

    if isinstance(plan, P.TableScan):
        cols = plan.columns
        mapping = None if cols is None else {c: ColumnRef(c) for c in cols}
        return plan.table, mapping, []
    if isinstance(plan, P.Selection):
        t, mapping, conds = resolve_scan_chain(plan.child)
        cond = plan.cond if mapping is None else _subst(plan.cond, mapping)
        return t, mapping, conds + [cond]
    if isinstance(plan, P.Projection):
        t, mapping, conds = resolve_scan_chain(plan.child)
        newmap = {
            name: (e if mapping is None else _subst(e, mapping))
            for name, e in plan.exprs.items()
        }
        return t, newmap, conds
    raise Ineligible(f"unsupported chain node {type(plan).__name__}")


# ---------------------------------------------------------------------------
# top-level fuse
# ---------------------------------------------------------------------------

MAX_SLOTS = 64
MAX_PLANES = 240  # S * L cap (the kernel's shared-memory accumulator)

# how often the fuse engaged, and the last fuse's layout — read by tests
# and chip_smoke.py
FUSE_STATS = {"count": 0, "slots": 0, "limbs": 0, "fields": 0,
              "plane_fields": None, "field_hi": None}


def try_fuse_stream_agg(node, tables: Dict[str, Block]):
    """Compile Aggregation(+Selection/Projection chain) into the tile
    function + stream-agg kernel.  Returns an AggregateResult, or None if
    the chain is ineligible."""
    try:
        return _fuse(node, tables)
    except Ineligible:
        return None


def _fuse(node, tables):
    from .aggregate import (
        AggregateResult, agg_result_dtype, key_domain_size, unpack_keys_direct,
    )

    if node.mode is not None:
        raise Ineligible("distributed agg modes handled elsewhere")
    for a in node.aggs:
        if a.func not in ("sum", "avg", "count") or a.filter_col is not None:
            raise Ineligible(f"agg {a.func} unsupported")
        if getattr(a, "distinct", False):
            raise Ineligible("distinct")

    table, mapping, conds = resolve_scan_chain(node.child)
    base = tables[table]
    if mapping is None:
        mapping = {c: ColumnRef(c) for c in base.names}

    # keys: must be passthrough refs to small-domain base columns
    key_cols: List[Column] = []
    key_names: List[str] = []
    for k in node.keys:
        e = mapping.get(k)
        if not isinstance(e, ColumnRef):
            raise Ineligible("key is not a passthrough column")
        c = base[e.name]
        if key_domain_size(c) is None:
            raise Ineligible("key domain unknown")
        key_cols.append(c)
        key_names.append(e.name)
    domain = 1
    for c in key_cols:
        domain *= key_domain_size(c)
    if domain > MAX_SLOTS:
        raise Ineligible("domain too large")

    # aggregate arguments -> parts
    agg_terms: Dict[str, Term] = {}
    for a in node.aggs:
        if a.arg is None:
            continue
        if a.arg not in agg_terms:
            e = mapping.get(a.arg)
            if e is None:
                raise Ineligible(f"unknown agg arg {a.arg}")
            if a.func == "count" and isinstance(e, ColumnRef):
                continue  # count(col) needs only the validity input
            agg_terms[a.arg] = compile_term(e, base)

    pb = TP.ProgramBuilder()
    pred_nodes = [compile_pred(c, base, pb) for c in conds]

    # global limb plan: limbs for every part of every term + live count +
    # per-nullable-arg non-null counters
    part_list: List[Part] = []
    term_part_idx: Dict[str, List[int]] = {}
    for arg, term in agg_terms.items():
        idxs = []
        for p in term.parts:
            if p.lo < 0:
                raise Ineligible("negative part")
            idxs.append(len(part_list))
            part_list.append(p)
        term_part_idx[arg] = idxs

    # int64-exactness guard: recombined per-slot totals (and the avg
    # numerator after its 10^shift scale-up) must provably fit int64;
    # beyond that, wide-decimal results recombine the SAME plane sums into
    # two-limb values.  Non-decimal results past the bound stay ineligible.
    sum_bounds: Dict[str, int] = {}
    wide_out: set = set()
    for a in node.aggs:
        if a.arg is None or a.arg not in agg_terms:
            continue
        t = agg_terms[a.arg]
        bound = sum(p.hi << p.shift for p in t.parts) * base.capacity
        if a.func == "avg":
            dt = t.dtype
            rdt = agg_result_dtype(a.func, dt)
            bound *= 10 ** (rdt.scale - (dt.scale if dt.is_decimal else 0))
        if bound >= 1 << 62:
            rdt = agg_result_dtype(a.func, t.dtype)
            if not rdt.is_wide_decimal or bound >= int(9e36):
                raise Ineligible("sum bound exceeds int64")
            wide_out.add(a.name)
        else:
            sum_bounds[a.name] = bound

    # live-row counter part (also the occupancy signal)
    live_count_idx = len(part_list)
    part_list.append(_const_part(1))

    # non-null counters for nullable args used by avg/count(arg)
    nn_part_idx: Dict[str, int] = {}
    for a in node.aggs:
        if a.arg is None:
            continue
        e = mapping.get(a.arg)
        base_validity: Tuple[str, ...] = ()
        if isinstance(e, ColumnRef) and base[e.name].validity is not None:
            base_validity = (e.name + "__v",)
        elif a.arg in agg_terms:
            base_validity = tuple(sorted(
                {vc for p in agg_terms[a.arg].parts for vc in p.valid_cols}
            ))
        if not base_validity:
            nn_part_idx[a.arg] = live_count_idx
        elif a.arg not in nn_part_idx:
            nn_part_idx[a.arg] = len(part_list)
            build = None
            for vn in base_validity:
                m = TP.b2i(TP.nz(TP.inp(vn)))
                build = m if build is None else TP.mul(build, m)
            part_list.append(Part(build, 0, 1, 0, 1))

    # limb layout with plane packing: each part splits into
    # ACC_LIMB_BITS-wide pieces; small pieces (product high words, tiny
    # counters, the live flag) share one 31-bit plane at disjoint bit
    # offsets, each with FIELD_GROWTH_BITS of headroom.  For Q1 this
    # gives 6 planes holding 8 fields.
    growth = FIELD_GROWTH_BITS
    pieces: List[List[int]] = []  # (part_idx, limb_j, width_bits)
    piece_hi: List[int] = []      # each piece's largest value
    piece_of_part: List[List[int]] = []
    for pi, p in enumerate(part_list):
        nl = -(-_bits(p.hi) // ACC_LIMB_BITS) if p.hi else 1
        idxs = []
        for j in range(nl):
            hi_j = p.hi >> (ACC_LIMB_BITS * j)
            if j + 1 < nl:
                hi_j = min(hi_j, (1 << ACC_LIMB_BITS) - 1)
            idxs.append(len(pieces))
            pieces.append([pi, j, max(_bits(hi_j), 1)])
            piece_hi.append(hi_j)
        piece_of_part.append(idxs)
    # first-fit-decreasing into 31-bit planes
    order = sorted(range(len(pieces)), key=lambda i: -pieces[i][2])
    plane_layout: List[List] = []  # per plane: [(piece_i, offset, cap)]
    plane_used: List[int] = []
    for i in order:
        need = pieces[i][2] + growth
        for pl in range(len(plane_layout)):
            if plane_used[pl] + need <= 31:
                plane_layout[pl].append((i, plane_used[pl], need))
                plane_used[pl] += need
                break
        else:
            plane_layout.append([(i, 0, need)])
            plane_used.append(need)
    n_limbs = len(plane_layout)
    plane_fields = [[(off, cap, piece_i) for piece_i, off, cap in pl]
                    for pl in plane_layout]
    if domain * n_limbs > MAX_PLANES:
        raise Ineligible("accumulator budget exceeded")

    # kernel inputs: every referenced base column (+validity)
    input_names: List[str] = []

    def _want(name: str):
        if name not in input_names:
            input_names.append(name)

    for kn in key_names:
        _want(kn)
        if base[kn].validity is not None:
            _want(kn + "__v")
    refd = set(key_names)

    def walk(e: Expr):
        if isinstance(e, ColumnRef):
            refd.add(e.name)
        elif isinstance(e, Call):
            for x in e.args:
                walk(x)

    for arg in agg_terms:
        walk(mapping[arg])
    for a in node.aggs:
        if a.arg is not None and isinstance(mapping.get(a.arg), ColumnRef):
            refd.add(mapping[a.arg].name)
    for c in conds:
        walk(c)
    for name in sorted(refd):
        _want(name)
        if base[name].validity is not None:
            _want(name + "__v")
    if base.sel is not None:
        _want("__sel")

    # kernel inputs: each column at its own storage.  The program reads
    # int32 tile values: an int32 column (a ``narrow32`` shadow, dictionary
    # codes, dates) as it is, a bool (validity, ``sel``) as 0/1, a narrow
    # column without a shadow as its int64 narrowed, a wide column as two
    # non-negative words ``__w0`` (low 31 bits) and ``__w1`` (value >> 31).
    inputs: Dict[str, torch.Tensor] = {}

    def bind(key: str, arr: torch.Tensor, conversion: str = "id"):
        storage = TP.STORAGE_OF_DTYPE.get(arr.dtype)
        if storage is None:
            raise Ineligible(f"input {key} of dtype {arr.dtype}")
        name = key if conversion == "id" else key[:-4]
        inputs[name] = arr
        pb.bind(key, name, storage, conversion)

    for nm in input_names:
        if nm == "__sel":
            bind(nm, base.sel)
        elif nm.endswith("__v"):
            bind(nm, base[nm[:-3]].validity)
        else:
            col = base[nm]
            if col.dtype.is_string or col.dtype.kind is TypeKind.BOOL:
                bind(nm, col.narrow32 if col.narrow32 is not None else col.data)
                continue
            lo, hi = _col_interval(col)
            if lo < 0:
                raise Ineligible("negative value range")
            if hi < _I31:
                bind(nm, col.narrow32 if col.narrow32 is not None else col.data)
            elif hi < 1 << 62:
                bind(nm + "__w0", col.data, "w0")
                bind(nm + "__w1", col.data, "w1")
            else:
                raise Ineligible("column range too wide")

    S = domain
    pl_ = part_list
    pop_ = piece_of_part

    # the row program: live mask, key slot (mixed radix, mirrors
    # pack_keys_direct: a NULL key is 0, a nullable key adds 1), planes
    live = TP.bconst(True)
    if base.sel is not None:
        live = TP.land(live, TP.nz(TP.inp("__sel")))
    for pn in pred_nodes:
        live = TP.land(live, pn)
    key_slot = TP.const(0)
    for i, kn in enumerate(key_names):
        c = base[kn]
        v = TP.inp(kn)
        if c.validity is not None:
            v = TP.where(TP.nz(TP.inp(kn + "__v")), TP.add(v, TP.const(1)), TP.const(0))
        elif c.dtype.nullable:
            v = TP.add(v, TP.const(1))
        key_slot = v if i == 0 else TP.add(
            TP.mul(key_slot, TP.const(key_domain_size(c))), v)
    pvals: List = [None] * len(pieces)
    for p, pidx in zip(pl_, pop_):
        v = _part_node(p)
        if len(pidx) == 1:
            pvals[pidx[0]] = v
            continue
        for j, gi in enumerate(pidx):
            piece = TP.shr(v, ACC_LIMB_BITS * j)
            if j + 1 < len(pidx):
                piece = TP.band(piece, _ACC_MASK)
            pvals[gi] = piece
    planes: List[TP.Node] = []
    for plx in plane_layout:
        accv = None
        for gi, off, _cap in plx:
            x = TP.shl(pvals[gi], off)
            accv = x if accv is None else TP.add(accv, x)
        planes.append(accv)
    program = pb.build(live, key_slot, planes, S)

    FUSE_STATS["count"] += 1
    FUSE_STATS["slots"] = S
    FUSE_STATS["limbs"] = n_limbs
    FUSE_STATS["fields"] = len(pieces)
    FUSE_STATS["plane_fields"] = plane_fields
    FUSE_STATS["field_hi"] = piece_hi
    sums = ST.fused_group_sums(inputs, program, S, n_limbs, base.capacity,
                               plane_fields, growth, base.device)
    dev = sums.device

    # ---- recombination (S x L values) ----
    def part_total(pi: int) -> torch.Tensor:
        p = pl_[pi]
        acc = torch.zeros(S, dtype=torch.int64, device=dev)
        for j, li in enumerate(pop_[pi]):
            acc = acc + (sums[:, li] << (ACC_LIMB_BITS * j))
        if p.shift:
            acc = acc << p.shift
        return acc * p.sign

    def term_total(arg: str) -> torch.Tensor:
        acc = torch.zeros(S, dtype=torch.int64, device=dev)
        for pi in term_part_idx[arg]:
            acc = acc + part_total(pi)
        return acc

    def part_total_wide(pi: int) -> torch.Tensor:
        """Two-limb recombination: plane sums are <= n_rows * 2^25 (int64
        safe); the weighted shift runs in wide arithmetic."""
        from ..core import wide as W

        p = pl_[pi]
        acc = None
        for j, li in enumerate(pop_[pi]):
            w = W.widen_i64(sums[:, li])
            w, _ = W.wide_mul_pow2(w, ACC_LIMB_BITS * j + p.shift)
            acc = w if acc is None else W.wide_add(acc, w)
        if p.sign < 0:
            acc = W.wide_neg(acc)
        return acc

    def term_total_wide(arg: str) -> torch.Tensor:
        from ..core import wide as W

        acc = None
        for pi in term_part_idx[arg]:
            w = part_total_wide(pi)
            acc = w if acc is None else W.wide_add(acc, w)
        return acc

    live_counts = part_total(live_count_idx)
    out_cols: List[Tuple[str, Column]] = []
    for a in node.aggs:
        col_dt = None
        if a.arg is not None:
            e = mapping[a.arg]
            col_dt = (agg_terms[a.arg].dtype if a.arg in agg_terms
                      else base[e.name].dtype)
        rdt = agg_result_dtype(a.func, col_dt)
        if a.func == "count":
            cnt = live_counts if a.arg is None else part_total(nn_part_idx[a.arg])
            out_cols.append((a.name, Column(cnt, None, INT64)))
            continue
        cnt = part_total(nn_part_idx[a.arg])
        if a.name in wide_out:
            # two-limb recombination of the SAME kernel plane sums
            from ..core import wide as W

            w = term_total_wide(a.arg)
            if a.func == "avg":
                src = col_dt.scale if col_dt.is_decimal else 0
                shift = rdt.scale - src
                if shift:
                    w, _ = W.wide_mul_pow10(w, shift)
                w = W.wide_div_round_half_up(w, cnt.clamp(min=1))
            out_cols.append((a.name, Column(w, cnt > 0, rdt)))
            continue
        s = term_total(a.arg)
        bnd = sum_bounds.get(a.name)
        st = None if bnd is None else (-bnd, bnd)
        if a.func == "sum":
            out_cols.append((a.name, Column(s.to(rdt.torch_dtype), cnt > 0,
                                            rdt, stats=st)))
        else:  # avg — mirror _accumulate_masked exactly
            from ..expr.functions import _div_round_half_up

            if rdt.is_decimal:
                src = col_dt.scale if col_dt.is_decimal else 0
                num = s * (10 ** (rdt.scale - src))
                d = _div_round_half_up(num, cnt.clamp(min=1))
            else:
                d = s / cnt.clamp(min=1).to(torch.float64)
            out_cols.append((a.name, Column(d.to(rdt.torch_dtype), cnt > 0,
                                            rdt, stats=st)))

    # keyless aggregation ALWAYS yields one row (count over zero rows is 0,
    # sums are NULL); grouped aggregation emits slots that saw a live row
    if node.keys:
        occupied = live_counts > 0
    else:
        occupied = torch.ones(S, dtype=torch.bool, device=dev)
    kcols = unpack_keys_direct(torch.arange(S, dtype=torch.int32, device=dev),
                               key_cols)
    names = tuple(node.keys) + tuple(n for n, _ in out_cols)
    cols = tuple(kcols) + tuple(c for _, c in out_cols)
    out = Block(names=names, columns=cols, sel=occupied)
    return AggregateResult(out, torch.sum(occupied, dtype=torch.int32),
                           torch.zeros((), dtype=torch.int64, device=dev))


__all__ = ["try_fuse_stream_agg", "compile_term", "compile_pred",
           "resolve_scan_chain", "Ineligible", "FUSE_STATS"]
