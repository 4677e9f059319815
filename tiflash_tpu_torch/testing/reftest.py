"""The SQL front end: ``.test`` scripts (fullstack-test format) and SQL text
through the port.

Counterpart of ``tiflash_tpu/testing/reftest.py``.  It runs files of

    mysql> <statement>
    +-----+-----+
    | col | col |
    +-----+-----+
    | val | val |
    +-----+-----+

blocks and checks the engine's answer against the recorded table.  The
MySQL side is a small SQL front end: DDL builds host tables, INSERT
accumulates rows, and SELECT parses into the engine's expression AST and
plan nodes, which run through ``plan/compiler.py:compile_fragment`` on the
session's device, or, with ``TIFLASH_REFTEST_DISTRIBUTED=1``, through
``runtime/executor.py:run_query`` over an eight-shard mesh of that device.

Every entry point takes the device to run on and defaults to the card:
``RefTestSession(device="cuda")``, ``run_test_file(path, device="cuda")``.
Nothing falls back to the CPU.

    sess = RefTestSession(device="cpu")
    sess.run_statement("create table t (a int, b decimal(10,2))", None)
    sess.run_statement("insert into t values (1, 2.50), (2, NULL)", None)
    sess.run_statement("select a, b from t order by a",
                       ["a\tb", "1\t2.50", "2\tNULL"])
    sess.checked, sess.unsupported, sess.results[-1]

Comparison is value-parsed, not textual: each expected cell is decoded
using the engine's output dtype (decimals exactly, floats with relative
tolerance, dates/datetimes/durations parsed), so formatting differences
don't mask or manufacture mismatches.
"""

from __future__ import annotations

import datetime
import math
import re
import sys
from decimal import Decimal as D
from typing import Any, Dict, List, Optional, Tuple

# the corpus nests CASE ~100 deep (expr_tree_too_deep.test) — the
# recursive-descent parser needs ~15 frames per level; the engine's
# governed guard is Settings.max_ast_depth, not the python stack
sys.setrecursionlimit(max(sys.getrecursionlimit(), 50_000))

import torch

from ..core import dtypes as dt
from ..expr.nodes import Call, Cast, ColumnRef, Expr, Literal
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..plan import nodes as P


class Unsupported(Exception):
    """Statement/type/function outside this engine's surface — the file
    is reported as documented-unsupported, not failed."""


# ---------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<hex>0x[0-9a-fA-F]+|x'[0-9a-fA-F]*')
  | (?P<num>\d+\.\d*(e[+-]?\d+)?|\.\d+(e[+-]?\d+)?|\d+(e[+-]?\d+)?)
  | (?P<str>'(?:[^'\\]|\\.|'')*'|"(?:[^"\\]|\\.|"")*")
  | (?P<qident>`[^`]*`)
  | (?P<name>[A-Za-z_@][A-Za-z0-9_@$]*)
  | (?P<op><=>|->>|->|<<|>>|<=|>=|<>|!=|:=|\|\||&&|[-+*/%=<>(),.;|&^~!])
""", re.VERBOSE | re.IGNORECASE)


def tokenize(sql: str) -> List[Tuple[str, str]]:
    sql = re.sub(r"/\*.*?\*/", " ", sql, flags=re.S)  # optimizer hints
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise Unsupported(f"lex error at {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


def _unquote_str(tok: str) -> str:
    q = tok[0]
    body = tok[1:-1]
    body = body.replace(q * 2, q)
    # MySQL backslash escapes
    body = re.sub(r"\\(.)", lambda m: {
        "n": "\n", "t": "\t", "r": "\r", "0": "\0", "b": "\b",
        "Z": "\x1a", "\\": "\\", "'": "'", '"': '"', "%": "\\%",
        "_": "\\_",
    }.get(m.group(1), m.group(1)), body)
    return body


# --------------------------------------------------------------- parser

# MySQL operator names -> engine function names
_CMP = {"=": "equals", "<=>": "null_eq", "<>": "not_equals",
        "!=": "not_equals", "<": "less", "<=": "less_or_equals",
        ">": "greater", ">=": "greater_or_equals"}

_AGG_FUNCS = {"sum", "count", "avg", "min", "max", "group_concat",
              "approx_count_distinct", "bit_and", "bit_or", "bit_xor",
              "var_pop", "var_samp", "std", "stddev", "stddev_pop",
              "stddev_samp", "variance", "first_row", "any_value"}

_INTERVAL_UNITS = {"microsecond", "second", "minute", "hour", "day",
                   "week", "month", "quarter", "year"}


class SqlParser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    @classmethod
    def from_tokens(cls, toks) -> "SqlParser":
        p = cls.__new__(cls)
        p.toks = list(toks)
        p.i = 0
        return p

    # -- token helpers
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        k, v = self.peek()
        return k == "name" and v.lower() in kws

    def eat_kw(self, *kws) -> Optional[str]:
        if self.at_kw(*kws):
            return self.next()[1].lower()
        return None

    def expect_kw(self, kw):
        if not self.eat_kw(kw):
            raise Unsupported(f"expected {kw!r}, got {self.peek()[1]!r}")

    def at_op(self, *ops) -> bool:
        k, v = self.peek()
        return k == "op" and v in ops

    def eat_op(self, *ops) -> Optional[str]:
        if self.at_op(*ops):
            return self.next()[1]
        return None

    def expect_op(self, op):
        if not self.eat_op(op):
            raise Unsupported(f"expected {op!r}, got {self.peek()[1]!r}")

    # -- expression grammar (MySQL precedence, lowest first)
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_xor()
        while self.eat_kw("or") or self.eat_op("||"):
            e = Call("or", (e, self.parse_xor()))
        return e

    def parse_xor(self) -> Expr:
        e = self.parse_and()
        while self.eat_kw("xor"):
            e = Call("xor", (e, self.parse_and()))
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.eat_kw("and") or self.eat_op("&&"):
            e = Call("and", (e, self.parse_not()))
        return e

    def parse_not(self) -> Expr:
        if self.eat_kw("not"):
            return Call("not", (self.parse_not(),))
        return self.parse_comparison()

    def _at_row_or_paren(self) -> bool:
        return self.at_op("(")

    def _at_subselect(self) -> bool:
        return (self.at_op("(") and self.peek(1)[0] == "name"
                and self.peek(1)[1].lower() in ("select", "table"))

    def _capture_subquery(self) -> Expr:
        """Capture a parenthesized subselect as a token slice (balanced
        parens), registered on the session; lowered to engine semi/anti
        joins (or scalar folds) at plan-build time — the TiDB planner's
        subquery decorrelation, front-end edition."""
        if getattr(self, "sess", None) is None:
            raise Unsupported("subquery outside a session")
        self.expect_op("(")
        start = self.i
        depth = 0
        while True:
            k, v = self.peek()
            if k == "eof":
                raise Unsupported("unterminated subquery")
            if k == "op" and v == "(":
                depth += 1
            elif k == "op" and v == ")":
                if depth == 0:
                    break
                depth -= 1
            self.next()
        toks = self.toks[start:self.i] + [("eof", "")]
        self.expect_op(")")
        if toks and toks[0][0] == "name" and toks[0][1].lower() == "table":
            # TABLE t == SELECT * FROM t (MySQL 8 table statement)
            toks = [("name", "select"), ("op", "*"),
                    ("name", "from")] + toks[1:]
        sid = self.sess.register_subquery(toks)
        return Call("__subquery__", (Literal(sid),))

    def parse_comparison(self) -> Expr:
        e = self.parse_bitor()
        while True:
            k, v = self.peek()
            if k == "op" and v in _CMP:
                self.next()
                if isinstance(e, Call) and e.func == "__row__" \
                        and self._at_row_or_paren():
                    rhs = self.parse_bitor()
                    e = _expand_row_cmp(_CMP[v], e, rhs)
                    continue
                if self.at_kw("any", "some", "all") \
                        and self.peek(1)[0] == "op" \
                        and self.peek(1)[1] == "(":
                    quant = self.next()[1].lower()
                    quant = "any" if quant == "some" else quant
                    sub = self._capture_subquery()
                    fn = _CMP[v]
                    if fn == "equals" and quant == "any":
                        e = Call("__in_subq__", (e, sub))
                    elif fn == "not_equals" and quant == "all":
                        e = Call("__not_in_subq__", (e, sub))
                    else:
                        e = Call("__quant_subq__",
                                 (e, sub, Literal(fn), Literal(quant)))
                    continue
                e = Call(_CMP[v], (e, self.parse_bitor()))
            elif self.at_kw("is"):
                self.next()
                neg = bool(self.eat_kw("not"))
                if self.eat_kw("null"):
                    e = Call("is_not_null" if neg else "is_null", (e,))
                elif self.eat_kw("true"):
                    e = Call("is_not_true" if neg else "is_true", (e,))
                elif self.eat_kw("false"):
                    e = Call("is_not_false" if neg else "is_false", (e,))
                else:
                    raise Unsupported("IS <what?>")
            elif self.at_kw("like", "ilike", "in", "between", "regexp",
                            "rlike", "not"):
                neg = bool(self.eat_kw("not"))
                if self.at_kw("like", "ilike"):
                    ci = bool(self.eat_kw("ilike")) or not self.eat_kw("like")
                    pat = self.parse_bitor()
                    args = [e, pat]
                    if self.eat_kw("escape"):
                        args.append(self.parse_bitor())
                    e = Call("ilike" if ci else "like", tuple(args))
                elif self.eat_kw("regexp") or self.eat_kw("rlike"):
                    e = Call("regexp_like", (e, self.parse_bitor()))
                elif self.eat_kw("in"):
                    if self._at_subselect():
                        sub = self._capture_subquery()
                        e = Call("__in_subq__", (e, sub))
                        if neg:
                            e = Call("__not_in_subq__", (e.args[0], sub))
                            neg = False
                        continue
                    self.expect_op("(")
                    vals = [self.parse_expr()]
                    while self.eat_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    if isinstance(e, Call) and e.func == "__row__":
                        # (a,b) IN ((1,2),(3,4)) -> OR of per-row ANDs
                        ors = None
                        for v in vals:
                            if not (isinstance(v, Call)
                                    and v.func == "__row__"
                                    and len(v.args) == len(e.args)):
                                raise Unsupported(
                                    "row IN with non-row element")
                            conj = None
                            for le, re_ in zip(e.args, v.args):
                                c2 = Call("equals", (le, re_))
                                conj = c2 if conj is None else Call(
                                    "and", (conj, c2))
                            ors = conj if ors is None else Call(
                                "or", (ors, conj))
                        e = ors
                    else:
                        e = Call("in", (e, *vals))
                elif self.eat_kw("between"):
                    lo = self.parse_bitor()
                    self.expect_kw("and")
                    hi = self.parse_bitor()
                    e = Call("and", (Call("greater_or_equals", (e, lo)),
                                     Call("less_or_equals", (e, hi))))
                else:
                    raise Unsupported("NOT <what?>")
                if neg:
                    e = Call("not", (e,))
            else:
                return e

    def parse_bitor(self) -> Expr:
        e = self.parse_bitand()
        while self.at_op("|") and not self.at_op("||"):
            self.next()
            e = Call("bit_or2", (e, self.parse_bitand()))
        return e

    def parse_bitand(self) -> Expr:
        e = self.parse_shift()
        while self.at_op("&") and not self.at_op("&&"):
            self.next()
            e = Call("bit_and2", (e, self.parse_shift()))
        return e

    def parse_shift(self) -> Expr:
        e = self.parse_add()
        while True:
            if self.eat_op("<<"):
                e = Call("shift_left", (e, self.parse_add()))
            elif self.eat_op(">>"):
                e = Call("shift_right", (e, self.parse_add()))
            else:
                return e

    def parse_add(self) -> Expr:
        e = self.parse_mul()
        while True:
            if self.eat_op("+"):
                e = Call("plus", (e, self.parse_mul()))
            elif self.eat_op("-"):
                e = Call("minus", (e, self.parse_mul()))
            else:
                return e

    def parse_mul(self) -> Expr:
        e = self.parse_bitxor()
        while True:
            if self.eat_op("*"):
                e = Call("multiply", (e, self.parse_bitxor()))
            elif self.eat_op("/"):
                e = Call("divide", (e, self.parse_bitxor()))
            elif self.eat_op("%") or self.eat_kw("mod"):
                e = Call("modulo", (e, self.parse_bitxor()))
            elif self.eat_kw("div"):
                e = Call("intdiv", (e, self.parse_bitxor()))
            else:
                return e

    def parse_bitxor(self) -> Expr:
        e = self.parse_unary()
        while self.eat_op("^"):
            e = Call("bit_xor2", (e, self.parse_unary()))
        return e

    def parse_unary(self) -> Expr:
        if self.eat_op("-"):
            a = self.parse_unary()
            if isinstance(a, Literal) and isinstance(a.value, D):
                # unary minus on Decimal is CONTEXT-BOUND (prec 28 by
                # default) and silently rounds 65-digit literals;
                # copy_negate is exact
                return Literal(a.value.copy_negate())
            if isinstance(a, Literal) and isinstance(a.value, (int, float)):
                return Literal(-a.value)
            return Call("negate", (a,))
        if self.eat_op("+"):
            return self.parse_unary()
        if self.eat_op("~"):
            return Call("bit_not", (self.parse_unary(),))
        if self.eat_op("!"):
            return Call("not", (self.parse_unary(),))
        if self.eat_kw("binary"):  # BINARY expr: collation no-op here
            return self.parse_unary()
        e = self.parse_primary()
        # JSON path operators: a->'$.x' = json_extract,
        # a->>'$.x' = json_unquote(json_extract)
        while self.at_op("->", "->>"):
            op = self.next()[1]
            path = self.parse_primary()
            e = Call("json_extract", (e, path))
            if op == "->>":
                e = Call("json_unquote", (e,))
        return e

    def parse_primary(self) -> Expr:
        k, v = self.peek()
        if k == "num":
            self.next()
            if re.search(r"[.e]", v, re.I):
                # decimal literal unless exponent notation
                return Literal(float(v) if "e" in v.lower() else D(v))
            return Literal(int(v))
        if k == "hex":
            self.next()
            body = v[2:] if v.lower().startswith("0x") else v[2:-1]
            return Literal(int(body or "0", 16))
        if k == "str":
            self.next()
            return Literal(_unquote_str(v))
        if k == "name" and v.startswith("_") and self.peek(1)[0] == "str":
            # charset introducer: _utf8mb4'...' (everything is utf-8 here)
            self.next()
            return Literal(_unquote_str(self.next()[1]))
        if k == "qident":
            self.next()
            return ColumnRef(v[1:-1])
        if self._at_subselect():
            # scalar subquery: captured as a marker; the enclosing
            # SelectBuilder folds it (uncorrelated -> literal; correlated
            # aggregate -> the APPLY cross-decorrelation)
            if getattr(self, "sess", None) is None:
                raise Unsupported("scalar subquery outside a session")
            return Call("__scalar_subq__", (self._capture_subquery(),))
        if self.eat_op("("):
            e = self.parse_expr()
            if self.eat_op(","):
                # row constructor: (a, b[, ...]) — compared/IN-listed
                # rows expand to AND/OR forms at comparison sites
                elems = [e, self.parse_expr()]
                while self.eat_op(","):
                    elems.append(self.parse_expr())
                self.expect_op(")")
                return Call("__row__", tuple(elems))
            self.expect_op(")")
            return e
        if k != "name":
            raise Unsupported(f"unexpected token {v!r}")

        name = v.lower()
        # special forms
        if name == "exists" and self.peek(1)[0] == "op" \
                and self.peek(1)[1] == "(":
            self.next()
            return Call("__exists_subq__", (self._capture_subquery(),))
        if name == "null":
            self.next()
            return Literal(None)
        if name in ("true", "false"):
            self.next()
            return Literal(1 if name == "true" else 0)
        if name == "cast":
            self.next()
            self.expect_op("(")
            arg = self.parse_expr()
            self.expect_kw("as")
            target = self.parse_cast_type()
            self.expect_op(")")
            return self._mk_cast(arg, target)
        if name == "convert":
            self.next()
            self.expect_op("(")
            arg = self.parse_expr()
            self.expect_op(",")
            target = self.parse_cast_type()
            self.expect_op(")")
            return self._mk_cast(arg, target)
        if name == "case":
            return self.parse_case()
        if name in ("date", "time", "timestamp") and self.peek(1)[0] == "str":
            # typed literal: DATE 'yyyy-mm-dd' etc.
            self.next()
            s = _unquote_str(self.next()[1])
            return Literal(_parse_temporal_literal(name, s))
        if name == "interval":
            raise Unsupported("INTERVAL outside date_add/date_sub")

        # function call or bare column
        if self.peek(1) == ("op", "("):
            self.next()
            e = self.parse_call(name)
            if self.at_kw("over"):
                # window function: `over w` / `over (partition by ...)`
                self.next()
                if self.eat_op("("):
                    spec = self.parse_window_spec()
                    self.expect_op(")")
                else:
                    spec = self.next()[1].strip("`")
                return Call("__over__", (e, Literal(spec)))
            return e
        # dotted identifiers: db.t.c / t.c — resolve by the last
        # component; the immediate qualifier is kept for front-end join
        # alias resolution (enum.test t1.a != t2.a)
        self.next()
        parts = [v]
        while self.at_op(".") :
            self.next()
            nk, nv = self.next()
            if nk not in ("name", "qident"):
                raise Unsupported("bad dotted name")
            parts.append(nv[1:-1] if nk == "qident" else nv)
        qual = parts[-2] if len(parts) >= 2 else None
        return ColumnRef(parts[-1], qual=qual)

    def parse_window_spec(self):
        """(PARTITION BY e, ... ORDER BY e [desc], ... [frame]) -> a
        spec tuple (partition exprs, [(order expr, desc)], frame).
        frame = None or (type, lo, hi) with each bound one of
        ("unbounded",), ("current",), ("offset", Expr, side, unit)."""
        part: List[Expr] = []
        order: List[Tuple[Expr, bool]] = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            part.append(self.parse_expr())
            while self.eat_op(","):
                part.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = bool(self.eat_kw("desc"))
                if not desc:
                    self.eat_kw("asc")
                order.append((e, desc))
                if not self.eat_op(","):
                    break
        frame = None
        if self.at_kw("rows", "range"):
            ftype = self.next()[1].lower()

            def bound():
                if self.eat_kw("unbounded"):
                    if not self.eat_kw("preceding"):
                        self.expect_kw("following")
                    return ("unbounded",)
                if self.eat_kw("current"):
                    self.expect_kw("row")
                    return ("current",)
                unit = None
                if self.eat_kw("interval"):
                    e = self.parse_bitor()
                    unit = self.next()[1].lower()
                else:
                    e = self.parse_bitor()
                side = self.eat_kw("preceding", "following")
                if side is None:
                    raise Unsupported("frame bound side")
                return ("offset", e, side, unit)

            if self.eat_kw("between"):
                lo = bound()
                self.expect_kw("and")
                hi = bound()
            else:
                lo = bound()
                hi = ("current",)
            frame = (ftype, lo, hi)
        return ("__winspec__", tuple(part), tuple(order), frame)

    def parse_call(self, name: str) -> Expr:
        self.expect_op("(")
        if name == "extract":
            unit = self.next()[1].lower()
            self.expect_kw("from")
            arg = self.parse_expr()
            self.expect_op(")")
            return Call("extract", (Literal(unit), arg))
        if name in ("trim", "ltrim", "rtrim") and self.at_kw(
                "leading", "trailing", "both"):
            raise Unsupported("TRIM(LEADING/TRAILING/BOTH ...)")
        if name == "position":
            # POSITION(substr IN str) — parse below comparison level so
            # IN is the keyword, not the membership operator
            sub = self.parse_bitor()
            self.expect_kw("in")
            s = self.parse_bitor()
            self.expect_op(")")
            return Call("position", (sub, s))
        if name == "count" and self.eat_op("*"):
            self.expect_op(")")
            return Call("count", (Literal("*"),))
        distinct = bool(self.eat_kw("distinct"))
        args: List[Expr] = []
        if not self.at_op(")"):
            args.append(self.parse_call_arg(name))
            while self.eat_op(","):
                args.append(self.parse_call_arg(name))
        self.expect_op(")")
        if distinct:
            name = name + "__distinct"
        return Call(name, tuple(args))

    def parse_call_arg(self, fname: str) -> Expr:
        if self.at_kw("interval"):
            self.next()
            amount = self.parse_expr()
            unit = self.next()[1].lower()
            if unit not in _INTERVAL_UNITS:
                raise Unsupported(f"interval unit {unit}")
            return Call("__interval__", (amount, Literal(unit)))
        return self.parse_expr()

    def parse_case(self) -> Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        branches: List[Expr] = []
        while self.eat_kw("when"):
            cond = self.parse_expr()
            if operand is not None:
                cond = Call("equals", (operand, cond))
            self.expect_kw("then")
            branches += [cond, self.parse_expr()]
        if self.eat_kw("else"):
            branches.append(self.parse_expr())
        self.expect_kw("end")
        return Call("case_when", tuple(branches))

    def _mk_cast(self, arg: Expr, target: dt.DataType) -> Expr:
        """CAST with MySQL fsp semantics: TIME(n)/DATETIME(n) round the
        fractional seconds (default fsp 0)."""
        if getattr(self, "cast_json", False):
            self.cast_json = False
            return Call("cast_as_json", (arg,))
        e: Expr = Cast(arg, target)
        fsp = getattr(self, "cast_fsp", None)
        self.cast_fsp = None
        if fsp is not None and target.kind in (dt.TypeKind.DATETIME,
                                               dt.TypeKind.DURATION):
            e = Call("cast_fsp_round", (e, Literal(int(fsp))))
        clen = getattr(self, "cast_char_len", None)
        self.cast_char_len = None
        if clen is not None and target.is_string:
            e = Call("left", (e, Literal(int(clen))))
        return e

    def parse_cast_type(self) -> dt.DataType:
        self.cast_fsp = None
        self.cast_char_len = None
        self.cast_json = False
        name = self.next()[1].lower()
        params: List[int] = []
        if self.eat_op("("):
            while not self.at_op(")"):
                params.append(int(self.next()[1]))
                self.eat_op(",")
            self.expect_op(")")
        if name == "signed":
            self.eat_kw("integer", "int")
            return dt.INT64
        if name == "unsigned":
            self.eat_kw("integer", "int")
            return dt.UINT64
        if name == "decimal":
            p = params[0] if params else 10
            s = params[1] if len(params) > 1 else 0
            try:
                return dt.Decimal(p, s)
            except NotImplementedError as e:
                raise Unsupported(str(e))
        if name in ("double", "real"):
            return dt.FLOAT64
        if name == "float":
            return dt.FLOAT32
        if name in ("char", "nchar", "varchar"):
            # CAST(x AS CHAR(n)) truncates to n characters
            self.cast_char_len = params[0] if params else None
            return dt.STRING
        if name == "date":
            return dt.DATE
        if name == "datetime":
            self.cast_fsp = params[0] if params else 0
            return dt.DATETIME
        if name == "time":
            self.cast_fsp = params[0] if params else 0
            return dt.DURATION
        if name == "json":
            self.cast_json = True
            import dataclasses as _dc

            return _dc.replace(dt.STRING, mysql_json=True)
        raise Unsupported(f"cast target {name}")


def _parse_tz_offset(spec: str) -> int:
    """'+8:00' / '-05:30' / 'UTC' / named zone -> microseconds east of
    UTC (delegates to the engine parser)."""
    from ..expr.compile import parse_tz_offset_us

    try:
        return parse_tz_offset_us(spec)
    except ValueError as e:
        raise Unsupported(str(e))


def _parse_temporal_literal(kind: str, s: str):
    if kind == "date":
        # MySQL accepts a full datetime text in a DATE literal (time
        # part truncates): DATE'2026-03-01 00:00:00'
        return _parse_datetime_str(s).date()
    if kind == "timestamp":
        kind = "datetime"
    return _parse_datetime_str(s)


def _parse_datetime_str(s: str) -> datetime.datetime:
    """Lenient MySQL datetime text: '-', '/', or '.' date separators,
    optional time part, optional fractional seconds."""
    s = s.strip()
    m = re.match(r"^(\d{4})[-/.](\d{1,2})[-/.](\d{1,2})"
                 r"(?:[ T](\d{1,2}):(\d{1,2})(?::(\d{1,2})(\.\d+)?)?)?$", s)
    if not m:
        raise Unsupported(f"datetime literal {s!r}")
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    hh = int(m.group(4) or 0)
    mi = int(m.group(5) or 0)
    ss = int(m.group(6) or 0)
    us = int(float(m.group(7) or 0) * 1e6 + 0.5)
    if (y, mo, d) == (0, 0, 0):
        # TiDB zero date: storable, keeps any time-of-day (lead_lag.test)
        from ..core.dtypes import ZeroDateTime

        return ZeroDateTime(((hh * 3600 + mi * 60 + ss) * 1_000_000) + us)
    try:
        return datetime.datetime(y, mo, d, hh, mi, ss, us)
    except ValueError:
        if y == 0 and 1 <= mo <= 12 and 1 <= d <= 31:
            # year-0 dates are storable TiDB values ('0000-01-01')
            from ..core.dtypes import CivilDateTime

            return CivilDateTime(y, mo, d, hh, mi, ss, us)
        raise Unsupported(f"datetime literal {s!r}")


# ---------------------------------------------------- DDL / schema layer

_DDL_TYPE = re.compile(r"^\s*(\w+)\s*(\(([^)]*)\))?", re.I)

_INT_KINDS = {"tinyint": dt.INT8, "smallint": dt.INT16,
              "mediumint": dt.INT32, "int": dt.INT32, "integer": dt.INT32,
              "bigint": dt.INT64,
              "year": __import__("dataclasses").replace(dt.INT16,
                                                        mysql_year=True)}
_UINT_KINDS = {"tinyint": dt.UINT8, "smallint": dt.UINT32,
               "mediumint": dt.UINT32, "int": dt.UINT32,
               "integer": dt.UINT32, "bigint": dt.UINT64}


def parse_col_type(spec: str) -> Tuple[dt.DataType, Optional[int]]:
    """One column's type text (after the name) -> (engine dtype, fsp).
    fsp is the declared fractional-second precision for datetime/time
    columns (MySQL rounds inserted values to it), else None."""
    s = spec.strip().rstrip(",")
    m = _DDL_TYPE.match(s)
    if not m:
        raise Unsupported(f"ddl type {spec!r}")
    base = m.group(1).lower()
    params = [p.strip() for p in (m.group(3) or "").split(",") if p.strip()]
    fsp = None
    rest = s[m.end():].lower()
    unsigned = "unsigned" in rest
    nullable = "not null" not in rest
    if base in _INT_KINDS:
        t = (_UINT_KINDS if unsigned else _INT_KINDS)[base]
    elif base in ("float",):
        t = dt.FLOAT32
    elif base in ("double", "real"):
        t = dt.FLOAT64
    elif base in ("decimal", "numeric"):
        p = int(params[0]) if params else 10
        sc = int(params[1]) if len(params) > 1 else 0
        try:
            t = dt.Decimal(p, sc)
        except NotImplementedError as e:
            raise Unsupported(str(e))
    elif base in ("bool", "boolean"):
        t = dt.INT8
    elif base == "enum":
        # members in declaration order: the ENUM's numeric value is its
        # 1-based index (reference DataTypes/DataTypeEnum.h)
        import dataclasses as _dc

        members = tuple(p.strip().strip("'\"") for p in params)
        t = _dc.replace(dt.STRING, enum_values=members)
    elif base in ("binary", "varbinary", "blob", "tinyblob",
                  "mediumblob", "longblob"):
        # binary families carry their MySQL field-type code; BINARY(n)
        # zero-pads stored values to n bytes (cast_as_json.test)
        import dataclasses as _dc

        code = {"tinyblob": 249, "mediumblob": 250, "longblob": 251,
                "blob": 252, "binary": 254, "varbinary": 15}[base]
        t = _dc.replace(dt.STRING, mysql_blob=code)
        if base == "binary":
            fsp = None
            t = _dc.replace(t, precision=int(params[0]) if params else 1)
    elif base in ("varchar", "char", "text", "tinytext", "mediumtext",
                  "longtext", "set"):
        t = dt.STRING
    elif base == "date":
        t = dt.DATE
    elif base in ("datetime", "timestamp"):
        t = dt.DATETIME
        if base == "timestamp":  # UTC storage + session-tz reads
            t = dt.DATETIME.with_nullable(False)
            import dataclasses as _dc

            t = _dc.replace(t, tz_aware=True)
        fsp = int(params[0]) if params else 0
    elif base == "time":
        t = dt.DURATION
        fsp = int(params[0]) if params else 0
    elif base == "bit":
        t = dt.UINT64
    elif base == "json":
        # JSON columns ride the dictionary-encoded STRING representation
        # (normalized text); the JSON function family evaluates over the
        # dictionary LUT (expr/regexp_json.py)
        import dataclasses as _dc

        t = _dc.replace(dt.STRING, mysql_json=True)
    else:
        raise Unsupported(f"column type {base}")
    return (t.with_nullable(nullable) if nullable else t), fsp


def parse_create_table(sql: str):
    # partitioning is storage layout — the engine reads every partition;
    # strip the clause (incl. its parenthesized partition list) so the
    # body/tail split below stays balanced
    sql = re.sub(r"partition\s+by\s+(range|hash|list|key)\b.*$", "",
                 sql.strip().rstrip(";"), flags=re.I | re.S)
    m = re.match(
        r"create\s+table\s+(if\s+not\s+exists\s+)?([`\w.]+)\s*\((.*)\)\s*"
        r"([^)]*)$", sql.strip().rstrip(";"), re.I | re.S)
    if not m:
        raise Unsupported(f"cannot parse DDL: {sql[:60]}")
    table = m.group(2).split(".")[-1].strip("`")
    body = m.group(3)
    # split on commas not inside parens
    generated: Dict[str, str] = {}
    parts, depth, cur = [], 0, ""
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    schema: Dict[str, dt.DataType] = {}
    fsps: Dict[str, int] = {}
    for part in parts:
        p = part.strip()
        if not p:
            continue
        hm = re.match(r"[`\w]+", p)
        head = (hm.group(0) if hm else "").lower().strip("`")
        if head in ("primary", "unique", "key", "index", "constraint",
                    "fulltext", "foreign"):
            continue  # KEY(...) may have no space before the paren
        name = p.split()[0].strip("`")
        rest = p[len(p.split()[0]):]
        gen = re.search(r"\b(?:generated\s+always\s+)?as\s*\((.*)\)\s*"
                        r"(virtual|stored)?\s*$", rest, re.I | re.S)
        if gen:
            # generated column: type + generating expression (computed
            # on insert by _materialize_generated, as TiFlash computes
            # pushed-down generated reads)
            tpart = rest[:gen.start()]
            dtype, fsp = parse_col_type(
                tpart if tpart.strip() else " int")
            schema[name] = dtype.with_nullable(True)
            generated[name] = gen.group(1)
            if fsp is not None:
                fsps[name] = fsp
            continue
        schema[name], fsp = parse_col_type(rest)
        if fsp is not None:
            fsps[name] = fsp
    tail = m.group(4) or ""
    if re.search(r"collate\s*=?\s*binary", tail, re.I):
        # table-level binary collation: varchar/char become VAR_STRING
        # binary fields (type code 15 — cast_as_json.test)
        import dataclasses as _dc

        for cn, ct in list(schema.items()):
            if ct.is_string and not ct.mysql_blob:
                schema[cn] = _dc.replace(ct, mysql_blob=15)
    return table, schema, fsps, generated


def _split_tuples(s: str) -> List[str]:
    """Split 'values (..),(..)' bodies at top level."""
    out, depth, cur, quote, esc = [], 0, "", None, False
    for ch in s:
        if quote:
            cur += ch
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
            cur += ch
            continue
        if ch == "(":
            depth += 1
            if depth == 1:
                cur = ""
                continue
        if ch == ")":
            depth -= 1
            if depth == 0:
                out.append(cur)
                cur = ""
                continue
        if depth >= 1:
            cur += ch
    return out


def _split_args(s: str) -> List[str]:
    out, depth, cur, quote, esc = [], 0, "", None, False
    for ch in s:
        if quote:
            cur += ch
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
            cur += ch
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


# --------------------------------------------------------- the session

class RefTestSession:
    """Executes one .test file's statements against the engine on
    ``device``.  ``tests_root`` is the directory a ``SOURCE`` statement's
    path is relative to (the corpus's ``tests/``).  ``results`` holds
    each SELECT's rows in statement order."""

    def __init__(self, device="cuda", tests_root: Optional[str] = None):
        self.device = torch.device(device)
        self.tests_root = tests_root
        self.results: List[List[list]] = []
        self.distributed_runs = 0  # SELECTs that took the mesh
        self.tables: Dict[str, Tuple[Dict[str, dt.DataType],
                                     Dict[str, list]]] = {}
        self.fsps: Dict[str, Dict[str, int]] = {}
        self.generated: Dict[str, Dict[str, Expr]] = {}  # virtual cols
        self.checked = 0       # queries with expected output compared
        self.unsupported: List[str] = []
        self.tz_offset_us = 0  # SET time_zone (TIMESTAMP columns)
        self.cop_mode = False  # tiflash_cop vs MPP (FROM_DAYS tails)
        self.subq_tokens: Dict[int, list] = {}  # captured subselects
        # DBGInvoke-armed failpoints: name -> pause seconds (0 = throw)
        self.armed_failpoints: Dict[str, int] = {}
        self.replicated: set = set()  # tables with a tiflash replica

    def register_subquery(self, toks) -> int:
        sid = len(self.subq_tokens)
        self.subq_tokens[sid] = toks
        return sid

    # ---- statement dispatch
    def run_statement(self, sql: str, expected: Optional[List[str]]):
        # every `mysql>` line runs in a FRESH client connection
        # (reference tests/run-test.py spawns mysql per line), so
        # session variables only live within the line — and an open
        # transaction from a previous line rolled back on disconnect
        self.tz_offset_us = 0
        self.cop_mode = False
        if getattr(self, "_txn_snapshot", None) is not None:
            self.tables = self._txn_snapshot
            self._txn_snapshot = None
        # strip leading SET statements (session vars are TiDB routing
        # hints — tiflash replica / mpp mode — meaningless here)
        parts = [p.strip() for p in _split_semicolons(sql) if p.strip()]
        # a line with SEVERAL selects records one bordered table per
        # select (extra_physical_table_column.test's txn probes): queue
        # them in order
        exp_queue = None
        if expected is not None:
            blocks = _split_expected_tables(expected)
            if len(blocks) > 1:
                exp_queue = blocks
        if any(p.lower() == "show warnings" for p in parts):
            # warnings are client-protocol surface (documented
            # unsupported); verify the data table, drop the appended
            # warnings table from the expected block (return_warning.test)
            parts = [p for p in parts if p.lower() != "show warnings"]
            if expected is not None:
                borders = [i for i, ln in enumerate(expected)
                           if ln.strip().startswith("+-")]
                if len(borders) >= 4:
                    expected = expected[:borders[3]]
            self.unsupported.append("SHOW WARNINGS (client protocol)")
        for stmt in parts:
            stmt, n_unesc = re.subn(r"\s*#NO_UNESCAPE\s*$", "", stmt)
            if n_unesc:
                # the reference harness pipes every command through a
                # shell double-quoted string; normally it pre-doubles
                # backslashes so the shell pass is an identity, but
                # NO_UNESCAPE skips the doubling and the SHELL consumes
                # one escape level (run-test.py:98 to_unescaped_str) —
                # '\\\\' in the file reaches mysql as '\\'
                stmt = re.sub(r'\\([\\$`"])', r"\1", stmt)
            if stmt.startswith("#") or not stmt:
                continue  # directive/comment (#NO_UNESCAPE, #RETURN)
            low = stmt.lower()
            if low.startswith("set "):
                # honor SET time_zone (TIMESTAMP semantics); other
                # session vars are TiDB routing hints — meaningless here
                m = re.search(r"time_zone\s*=\s*'([^']*)'", stmt, re.I)
                if m:
                    self.tz_offset_us = _parse_tz_offset(m.group(1))
                if re.search(r"tidb_allow_tiflash_cop\s*=\s*on", low):
                    self.cop_mode = True
                if re.search(r"tidb_(enforce|allow)_mpp\s*=\s*1", low):
                    self.cop_mode = False
                continue
            if low.startswith("__dbg__"):
                # debug-DSL failpoint arming (reference DBGInvoke
                # __enable_fail_point; our registry accepts the
                # reference's names — Common/FailPoint.cpp analog)
                from ..runtime.failpoint import FailPoint

                md = re.match(r"__dbg__\s+DBGInvoke\s+__(enable|disable)"
                              r"(_pause)?_fail_point\((\w+)"
                              r"(?:\s*,\s*(\d+))?\)", stmt, re.I)
                if md:
                    name = md.group(3)
                    if md.group(1).lower() == "enable":
                        FailPoint.enable(name, pause=bool(md.group(2)))
                        self.armed_failpoints[name] = int(md.group(4)
                                                          or 0)
                    else:
                        FailPoint.disable(name)
                        self.armed_failpoints.pop(name, None)
                continue
            if low.startswith("source "):
                # mysql SOURCE: run the referenced .sql (paths are
                # relative to the corpus's tests/ root —
                # rollup_tpcds.test's tpcds schema)
                import os as _os

                rel = stmt.split(None, 1)[1].strip().rstrip(";")
                path = _os.path.join(self.tests_root or "", rel)
                if self.tests_root is None or not _os.path.exists(path):
                    raise Unsupported(f"source file missing: {rel}")
                for sub in _split_semicolons(open(path).read()):
                    sub = " ".join(ln for ln in sub.splitlines()
                                   if not ln.strip().startswith("--"))
                    if sub.strip():
                        self.run_statement(sub.strip(), None)
                continue
            if low.startswith(("use ", "split ")):
                continue  # database selection / region-split hints
            ma = re.match(r"alter\s+table\s+([`\w.]+)\s+add\s+column\s+"
                          r"`?(\w+)`?\s+(.*)$", stmt, re.I | re.S)
            if ma:
                self._alter_add_column(ma.group(1).split(".")[-1]
                                       .strip("`"), ma.group(2),
                                       ma.group(3))
                continue
            if re.match(r"alter\s+table\s+[`\w.]+\s+add\s+(index|key|"
                        r"unique|primary)", low):
                continue  # indexes are storage hints — no-ops here
            mr = re.match(r"alter\s+table\s+([`\w.]+)\s+set\s+tiflash"
                          r"\s+replica\s+(\d+)", stmt, re.I)
            if mr:
                t = mr.group(1).split(".")[-1].strip("`")
                if int(mr.group(2)) > 0:
                    self.replicated.add(t)
                else:
                    self.replicated.discard(t)
                continue
            mm = re.match(r"alter\s+table\s+([`\w.]+)\s+modify\s+"
                          r"(?:column\s+)?`?(\w+)`?\s+(.*)$", stmt,
                          re.I | re.S)
            if mm:
                t = mm.group(1).split(".")[-1].strip("`")
                cname = mm.group(2)
                if t in self.tables and cname in self.tables[t][0]:
                    newt, fsp = parse_col_type(mm.group(3))
                    schema, rows = self.tables[t]
                    schema[cname] = newt
                    if fsp is not None:
                        self.fsps.setdefault(t, {})[cname] = fsp

                    def _mod(v):
                        if v is None:
                            return None
                        v = self._coerce_inserted(v, newt)
                        if (fsp is not None
                                and newt.kind is dt.TypeKind.DURATION
                                and isinstance(v, int)):
                            # MODIFY TIME(n) rounds stored fractions
                            # (issue_8601: time(4) .1235 -> time(2) .12)
                            q = 10 ** (6 - fsp)
                            v = ((abs(v) + q // 2) // q * q
                                 * (1 if v >= 0 else -1))
                        return v

                    rows[cname] = [_mod(v) for v in rows[cname]]
                continue
            if low.startswith("alter table") and " add " in low:
                raise Unsupported(f"ALTER TABLE ADD form: {stmt[:60]}")
            if low.startswith(("drop table", "drop database",
                               "create database", "analyze table",
                               "alter table", "truncate")):
                if low.startswith(("drop table", "truncate")):
                    m = re.search(r"(?:table|truncate)\s+(?:if exists\s+)?"
                                  r"([`\w.]+)", stmt, re.I)
                    if m:
                        tn = m.group(1).split(".")[-1].strip("`")
                        self.tables.pop(tn, None)
                        self.replicated.discard(tn)
                continue
            if re.match(r"create\s+(unique\s+)?index\s", low):
                continue  # indexes are storage hints — no-ops here
            if low.startswith("create table"):
                name, schema, fsps, gens = parse_create_table(stmt)
                self.tables[name] = (schema, {c: [] for c in schema})
                self.fsps[name] = fsps
                if gens:
                    self.generated[name] = {
                        c: SqlParser(x).parse_expr()
                        for c, x in gens.items()}
                continue
            if low.startswith("insert into"):
                self._materialize_generated(self._insert(stmt))
                continue
            if low.startswith("delete from"):
                m = re.match(r"delete\s+from\s+([`\w.]+)\s*$", stmt, re.I)
                if not m:
                    raise Unsupported(f"conditional delete: {stmt[:50]}")
                t = m.group(1).split(".")[-1].strip("`")
                if t in self.tables:
                    schema, _ = self.tables[t]
                    self.tables[t] = (schema, {c: [] for c in schema})
                continue
            if low.startswith(("select", "with ", "with(")):
                for st in ("tiflash_replica", "tiflash_segments",
                           "tiflash_tables"):
                    if st in low:
                        self._register_system_table(st)
                if exp_queue:
                    expected = exp_queue.pop(0)
                if expected is not None and any(
                        "{#REGEXP}" in ln or "ERROR" in ln
                        for ln in expected):
                    # the recorded output is an ERROR (optionally as a
                    # {#REGEXP} pattern): the engine must RAISE, and
                    # the message must match (from_unixtime.test's
                    # non-constant-format rejection)
                    self._select_expect_error(stmt, expected)
                    continue
                try:
                    self._select(stmt, expected)
                except Unsupported as e:
                    # a select outside the surface doesn't corrupt the
                    # session — record it and keep checking the rest
                    self.unsupported.append(f"{e} in: {stmt[:80]}")
                except KeyError as e:
                    if "not registered" not in str(e):
                        raise
                    self.unsupported.append(
                        f"engine: unregistered function: {str(e)[:70]} "
                        f"in: {stmt[:80]}")
                except RecursionError:
                    self.unsupported.append(
                        f"expression tree too deep: {stmt[:60]}")
                except (NotImplementedError, ValueError) as e:
                    # engine-declared limitation (LUT-domain string
                    # producers, unimplemented cast pairs, ...): tracked
                    # as a documented-unsupported entry, not a pass
                    self.unsupported.append(
                        f"engine: {type(e).__name__}: {str(e)[:90]} "
                        f"in: {stmt[:80]}")
                continue
            if low == "begin" or low.startswith("begin;") \
                    or low.startswith("start transaction"):
                # snapshot txn: inserts apply immediately (the txn sees
                # its own writes); ROLLBACK or disconnect restores
                self._txn_snapshot = {
                    t: (s, {c: list(vs) for c, vs in r.items()})
                    for t, (s, r) in self.tables.items()}
                continue
            if low.startswith("rollback"):
                if getattr(self, "_txn_snapshot", None) is not None:
                    self.tables = self._txn_snapshot
                    self._txn_snapshot = None
                continue
            if low.startswith("commit"):
                self._txn_snapshot = None
                continue
            if low.startswith(("desc ", "show ", "update ")):
                raise Unsupported(f"statement: {stmt.split()[0]}")
            raise Unsupported(f"statement: {stmt[:50]}")

    # ---- INSERT
    def _register_system_table(self, st: str) -> None:
        """information_schema.tiflash_* over the session's tables (the
        engine's real system-table provider is storage/system.py; the
        corpus front-end mirrors the replica/segments/tables views over
        its own catalog — fault-inject/mpp_hang.test,
        system-table/read_system_table.test)."""
        user = [(n, r) for n, (s, r) in self.tables.items()
                if n in self.replicated]

        def nrows(r):
            return len(next(iter(r.values()))) if r else 0

        if st in ("tiflash_segments", "tiflash_tables"):
            # a segment exists only once data arrived (raftstore v1:
            # an empty replicated table has no TiFlash segment yet)
            user = [(n, r) for n, r in user if nrows(r) > 0]
        if st == "tiflash_replica":
            tab = {"table_schema": ["test"] * len(user),
                   "table_name": [n for n, _ in user],
                   "replica_count": [1] * len(user),
                   "location_labels": [""] * len(user),
                   "available": [1] * len(user),
                   "progress": [1] * len(user)}
            sch = {"table_schema": dt.STRING, "table_name": dt.STRING,
                   "replica_count": dt.INT64,
                   "location_labels": dt.STRING,
                   "available": dt.INT64, "progress": dt.INT64}
        elif st == "tiflash_segments":
            tab = {"tidb_database": ["test"] * len(user),
                   "tidb_table": [n for n, _ in user],
                   "rows": [nrows(r) for _, r in user],
                   "is_tombstone": [0] * len(user)}
            sch = {"tidb_database": dt.STRING, "tidb_table": dt.STRING,
                   "rows": dt.INT64, "is_tombstone": dt.INT64}
        else:  # tiflash_tables
            tab = {"tidb_database": ["test"] * len(user),
                   "tidb_table": [n for n, _ in user],
                   "total_rows": [nrows(r) for _, r in user],
                   "is_tombstone": [0] * len(user)}
            sch = {"tidb_database": dt.STRING, "tidb_table": dt.STRING,
                   "total_rows": dt.INT64, "is_tombstone": dt.INT64}
        self.tables[st] = (sch, tab)

    def _alter_add_column(self, t: str, name: str, spec: str):
        """ALTER TABLE .. ADD COLUMN, plain or ``AS (expr) VIRTUAL``
        (generated columns — TiDB computes these on read; here the
        ENGINE evaluates the generating expression over the base
        columns, the same pushed-down compute TiFlash performs.
        Reference: tests/fullstack-test/expr/generated_columns.test)."""
        if t not in self.tables:
            raise Unsupported(f"alter unknown table {t}")
        schema, rows = self.tables[t]
        gen = re.search(r"\bas\s*\((.*)\)\s*(virtual|stored)?\s*;?\s*$",
                        spec, re.I | re.S)
        type_part = spec[:gen.start()] if gen else spec
        dtype, fsp = parse_col_type(" " + type_part.strip().rstrip(";"))
        schema[name] = dtype.with_nullable(True)
        if fsp is not None:
            self.fsps.setdefault(t, {})[name] = fsp
        n = len(next(iter(rows.values()))) if rows else 0
        rows[name] = [None] * n
        if gen:
            self.generated.setdefault(t, {})[name] = \
                SqlParser(gen.group(1)).parse_expr()
            self._materialize_generated(t)

    def _materialize_generated(self, t: str):
        """Recompute every virtual column of ``t`` from the current base
        rows (tables here are tiny; full recompute keeps every insert
        form and DELETE consistent)."""
        gens = self.generated.get(t)
        if not gens or t not in self.tables:
            return
        from ..core.block import Block as _Block
        from ..expr.compile import evaluate_expr
        from . import oracle as O

        schema, rows = self.tables[t]
        base = {c: rows[c] for c in schema if c not in gens}
        n = len(next(iter(base.values()))) if base else 0
        if n == 0:
            for c in gens:
                rows[c] = []
            return
        blk = O.pytable_to_block(base, {c: schema[c] for c in base},
                                 self.device)
        for cname, expr in gens.items():
            col = evaluate_expr(expr, blk)
            vals = O.block_to_pytable(
                _Block(names=("r",), columns=(col,)))["r"]
            rows[cname] = [_coerce_host_value(v, schema[cname])
                           for v in vals]

    def _insert(self, stmt: str):
        ms = re.match(r"insert\s+into\s+([`\w.]+)\s*(?:\(([^)]*)\))?\s*"
                      r"((?:with\s.*?)?select\s+.*)$", stmt, re.I | re.S)
        if ms:
            t = ms.group(1).split(".")[-1].strip("`")
            if t not in self.tables:
                raise Unsupported(f"insert into unknown table {t}")
            schema, rows = self.tables[t]
            col_list = ([c.strip().strip("`") for c in
                         ms.group(2).split(",")] if ms.group(2) else None)
            select_sql = ms.group(3)
            mx = re.match(
                r"select\s+\*\s+from\s+([`\w.]+)(?:\s+as\s+\w+)?\s+"
                r"cross\s+join\s+([`\w.]+)(?:\s+as\s+\w+)?\s*$",
                select_sql, re.I)
            if mx and col_list is None:
                # pre-join setup step (host-side Cartesian product)
                a = mx.group(1).split(".")[-1].strip("`")
                b = mx.group(2).split(".")[-1].strip("`")
                if a not in self.tables or b not in self.tables:
                    raise Unsupported("cross join of unknown table")
                sa, ra = self.tables[a]
                sb, rb = self.tables[b]
                na = len(next(iter(ra.values()))) if ra else 0
                nb = len(next(iter(rb.values()))) if rb else 0
                names = list(schema)
                if len(names) != len(sa) + len(sb):
                    raise Unsupported("cross-join insert arity")
                for i in range(na):
                    for j in range(nb):
                        vals = ([ra[c][i] for c in sa]
                                + [rb[c][j] for c in sb])
                        for c, v in zip(names, vals):
                            rows[c].append(v)
                return t
            out = SelectBuilder(self, select_sql).run()
            got = _block_rows(out)
            names = col_list if col_list is not None else list(schema)
            unnamed = [c for c in schema
                       if names.count(c) == 0]  # NULL-filled
            for r in got:
                if len(r) != len(names):
                    raise Unsupported("insert-select arity")
                for c, v in zip(names, r):
                    rows[c].append(self._coerce_inserted(v, schema[c]))
                for c in unnamed:
                    rows[c].append(None)
            return t
        mset = re.match(r"insert\s+into\s+([`\w.]+)\s+set\s+(.*)$",
                        stmt, re.I | re.S)
        if mset:
            # INSERT ... SET a = v, b = v2 — unmentioned columns NULL
            t = mset.group(1).split(".")[-1].strip("`")
            if t not in self.tables:
                raise Unsupported(f"insert into unknown table {t}")
            schema, rows = self.tables[t]
            fsps = self.fsps.get(t, {})
            rowvals: Dict[str, str] = {}
            for assign in _split_args(mset.group(2)):
                ma = re.match(r"`?(\w+)`?\s*=\s*(.+)$", assign.strip(),
                              re.S)
                if not ma:
                    raise Unsupported(f"insert set form: {assign[:40]}")
                rowvals[ma.group(1)] = ma.group(2)
            for c in schema:
                raw = rowvals.get(c)
                v = (None if raw is None
                     else self._value(raw, schema[c], fsps.get(c)))
                if schema[c].tz_aware and isinstance(v, datetime.datetime):
                    v -= datetime.timedelta(
                        microseconds=self.tz_offset_us)
                rows[c].append(v)
            return t
        m = re.match(r"insert\s+into\s+([`\w.]+)\s*(\(([^)]*)\))?\s*values\s*(.*)$",
                     stmt, re.I | re.S)
        if not m:
            raise Unsupported(f"insert form: {stmt[:60]}")
        t = m.group(1).split(".")[-1].strip("`")
        if t not in self.tables:
            raise Unsupported(f"insert into unknown table {t}")
        schema, rows = self.tables[t]
        cols = ([c.strip().strip("`") for c in m.group(3).split(",")]
                if m.group(3) else list(schema))
        for tup in _split_tuples(m.group(4)):
            vals = _split_args(tup)
            if len(vals) != len(cols):
                raise Unsupported(f"insert arity at {tup[:40]}")
            rowvals = dict(zip(cols, vals))
            fsps = self.fsps.get(t, {})
            for c in schema:
                raw = rowvals.get(c)
                v = (None if raw is None
                     else self._value(raw, schema[c], fsps.get(c)))
                if schema[c].tz_aware and isinstance(v, datetime.datetime):
                    # TIMESTAMP stores UTC; the literal is session-local
                    v -= datetime.timedelta(
                        microseconds=self.tz_offset_us)
                rows[c].append(v)
        return t

    def _coerce_inserted(self, v, t: dt.DataType):
        """insert-select values pass through the engine's output types;
        coerce to the target column type (e.g. double -> time(6))."""
        try:
            return _coerce_host_value(v, t)
        except Exception:
            return v

    def _value(self, raw: str, t: dt.DataType, fsp: Optional[int] = None):
        """One INSERT literal -> host value for pytable_to_block.
        MySQL rounds datetime/time values to the column's declared fsp."""
        s = raw.strip()
        if s.lower() == "null":
            return None
        if t.is_string and re.fullmatch(r"0x[0-9a-fA-F]*", s):
            # hex literal into a string/binary column keeps its BYTES
            # (0x78 -> 'x'), not its numeric value
            body = s[2:]
            if len(body) % 2:
                body = "0" + body
            return _coerce_host_value(
                bytes.fromhex(body).decode("latin1"), t)
        expr = SqlParser(s).parse_expr()
        v = _eval_const(expr)
        if t.kind is dt.TypeKind.DURATION and isinstance(v, int):
            # a LITERAL numeric TIME is packed HHMMSS (111111 ->
            # '11:11:11'); insert-select ints stay microseconds and
            # take the passthrough in _coerce_host_value instead
            v = D(v)
        v = _coerce_host_value(v, t)
        if v is not None and fsp is not None \
                and isinstance(v, (datetime.datetime, int)):
            q = 10 ** (6 - fsp)
            if t.kind is dt.TypeKind.DATETIME \
                    and isinstance(v, datetime.datetime):
                us = round((v - datetime.datetime(1970, 1, 1))
                           .total_seconds() * 1e6)
                us = (abs(us) + q // 2) // q * q * (1 if us >= 0 else -1)
                v = (datetime.datetime(1970, 1, 1)
                     + datetime.timedelta(microseconds=us))
            elif t.kind is dt.TypeKind.DURATION:
                v = ((abs(v) + q // 2) // q * q) * (1 if v >= 0 else -1)
        return v

    # ---- SELECT
    def _select_expect_error(self, stmt: str, expected: List[str]):
        """Verify a query the reference corpus records as FAILING:
        the engine must raise, and the message must match the file's
        ``{#REGEXP}`` pattern / ERROR line (reference runner
        tests/run-test.py error-output matching)."""
        from ..expr.compile import query_timezone

        pats = []
        for ln in expected:
            if "{#REGEXP}" in ln:
                pats.append(ln.split("{#REGEXP}", 1)[1].strip())
            elif "ERROR" in ln:
                # 'ERROR 1582 (42000) at line 1: <message>' — the
                # mysql-client framing is the reference runner's; only
                # the message is engine behavior
                m = re.search(r"at line \d+:\s*(.*)$", ln)
                pats.append(re.escape(m.group(1).strip() if m
                                      else ln.strip()))
        try:
            sel = SelectBuilder(self, stmt)
            with query_timezone(self.tz_offset_us):
                sel.run()
        except Unsupported as e:
            # front-end gap: the statement never reached the engine, so
            # nothing about the engine's behavior was verified
            self.unsupported.append(f"{e} in: {stmt[:80]}")
            return
        except Exception as e:
            msg = str(e)
            if not any(re.search(p, msg) for p in pats):
                raise AssertionError(
                    f"error mismatch for: {stmt[:80]}\n"
                    f"got:  {msg[:160]}\nwant: {pats}")
            self.checked += 1
            return
        raise AssertionError(f"expected an error for: {stmt[:80]}")

    def _select(self, stmt: str, expected: Optional[List[str]]):
        from ..expr.compile import query_timezone

        sel = SelectBuilder(self, stmt)
        with query_timezone(self.tz_offset_us):
            out_block = sel.run()
        if expected is None:
            # no recorded output = the query returned EMPTY SET
            # (null_literal.test WHERE NULL predicates) — verify that
            got = _block_rows(out_block)
            self.results.append(got)
            if got:
                raise AssertionError(
                    f"row count: got {len(got)} want 0 (empty set)\n"
                    f"query: {stmt}\ngot: {got[:8]}")
            self.checked += 1
            return
        got = _block_rows(out_block)
        self.results.append(got)
        want, bordered = _parse_expected(expected)
        if not bordered and len(got) > len(want):
            # a row whose every cell renders as '' produces a blank line
            # the reference client output drops (hex('') etc.)
            got = [g for g in got
                   if not all(isinstance(v, str) and v == "" for v in g)]
        _compare(got, want, out_block, sel.order_sensitive, stmt)
        self.checked += 1


def _distributable(plan: "P.PlanNode") -> bool:
    """Distribute the shapes the MPP corpus exists to exercise: plans
    with a join / aggregation / window core (pure projections gain
    nothing and Expand/CTE compositions keep the single path)."""
    found = [False]

    def walk(n):
        if isinstance(n, (P.Join, P.CrossJoin, P.Aggregation, P.Window)):
            found[0] = True
        if isinstance(n, P.Window) and not n.partition_by \
                and n is not plan:
            # a MID-PLAN global window (the cross-decorrelation row-id
            # shape) would gather-replicate into downstream operators
            # that assume sharded inputs
            found[0] = False
            raise StopIteration
        if isinstance(n, (P.Expand, P.WithCTE, P.CTERef)):
            # grouping-set replication / CTE reuse distribute through
            # their own planner paths; keep the corpus single-device
            found[0] = False
            raise StopIteration
        for c in n.children:
            walk(c)

    try:
        walk(plan)
    except StopIteration:
        return False
    return found[0]


def _run_distributed(plan, blocks, device: torch.device):
    """Execute through the DISTRIBUTED query entry (run_query with a
    mesh): distribute_plan fragments the plan, the executor owns the
    capacity-retry loop, and runtime errors surface as EngineError —
    the same path the service uses.  The mesh is eight shards of the
    session's device (``Mesh([cuda:0] * 8)`` on a card, ``cpu_mesh(8)``
    on the CPU)."""
    from ..mpp.mesh import card_mesh, cpu_mesh
    from ..runtime.executor import run_query

    mesh = cpu_mesh(8) if device.type == "cpu" else card_mesh(8, device=str(device))
    out, _summary = run_query(plan, blocks, mesh=mesh)
    return out, {}


def _split_expected_tables(lines: List[str]) -> List[List[str]]:
    """Split recorded output into consecutive bordered tables (each has
    exactly three +- border lines: top, header separator, bottom)."""
    blocks: List[List[str]] = []
    cur: List[str] = []
    borders = 0
    for ln in lines:
        cur.append(ln)
        if ln.strip().startswith("+-"):
            borders += 1
            if borders == 3:
                blocks.append(cur)
                cur, borders = [], 0
    if cur:
        blocks.append(cur)
    return blocks


def _split_semicolons(sql: str) -> List[str]:
    out, cur, quote, esc = [], "", None, False
    for ch in sql:
        if quote:
            cur += ch
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
            cur += ch
            continue
        if ch == ";":
            out.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur)
    return out


def _eval_const(e: Expr):
    """Constant-fold an INSERT literal expression (numbers, strings,
    unary minus, simple arithmetic on literals)."""
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Call):
        args = [_eval_const(a) for a in e.args]
        if e.func == "negate":
            return -args[0]
        if e.func == "plus":
            return args[0] + args[1]
        if e.func == "minus":
            return args[0] - args[1]
        if e.func == "multiply":
            return args[0] * args[1]
        if e.func == "divide":
            return args[0] / args[1]
        # constant math calls appearing in the corpus's INSERTs
        if e.func == "pi" and not args:
            return math.pi
        if e.func == "exp":
            return math.exp(float(args[0]))
        if e.func == "sqrt":
            return math.sqrt(float(args[0]))
        if e.func in ("ln", "log") and len(args) == 1:
            return math.log(float(args[0]))
        if e.func in ("pow", "power"):
            return math.pow(float(args[0]), float(args[1]))
    raise Unsupported(f"non-constant insert value {e!r}")


def _coerce_host_value(v, t: dt.DataType):
    if v is None:
        return None
    if t.is_decimal:
        return D(str(v))
    if t.kind is dt.TypeKind.DATE:
        from ..core.dtypes import (CivilDate, CivilDateTime, ZeroDate,
                                   ZeroDateTime)

        if isinstance(v, str):
            v = _parse_datetime_str(v)
        if isinstance(v, (ZeroDate, ZeroDateTime)):
            return ZeroDate()
        if isinstance(v, CivilDateTime):
            return CivilDate(v.y, v.m, v.d)
        if isinstance(v, datetime.datetime):
            return v.date()
        return v
    if t.kind is dt.TypeKind.DATETIME:
        if isinstance(v, str):
            return _parse_datetime_str(v)
        if isinstance(v, datetime.date) and not isinstance(
                v, datetime.datetime):
            return datetime.datetime(v.year, v.month, v.day)
        return v
    if t.kind is dt.TypeKind.DURATION:
        if isinstance(v, str):
            return _parse_duration_us(v)
        if isinstance(v, (D, float)):
            # numeric HHMMSS[.ffffff] form -> microseconds
            d = D(str(v))
            neg = d < 0
            mag = abs(d)
            whole = int(mag)
            frac_us = int((mag - whole) * 1_000_000)
            h, m_, s = whole // 10_000, (whole // 100) % 100, whole % 100
            us = (h * 3600 + m_ * 60 + s) * 1_000_000 + frac_us
            return -us if neg else us
        return v
    if t.is_string:
        if t.mysql_blob == 254 and t.precision and isinstance(v, str):
            # BINARY(n) zero-pads stored values to n bytes
            return v.ljust(t.precision, "\x00")
        if t.mysql_json and isinstance(v, str):
            # store NORMALIZED JSON text (MySQL binary-JSON display:
            # ', ' / ': ' separators — cast_json_as_string.test)
            import json as _json

            from ..expr.regexp_json import json_dumps_mysql
            try:
                return json_dumps_mysql(_json.loads(v))
            except Exception:
                return str(v)
        return str(v)
    if t.kind in (dt.TypeKind.FLOAT32, dt.TypeKind.FLOAT64):
        return float(v)
    if isinstance(v, str):
        iv = int(D(v))  # MySQL coerces '123' etc.
    elif isinstance(v, (float, D)):
        iv = int(D(str(v)).to_integral_value(rounding="ROUND_HALF_UP"))
    else:
        iv = int(v)
    hi = (1 << 64) - 1 if t.kind is dt.TypeKind.UINT64 else (1 << 63) - 1
    if not (-(1 << 63) <= iv <= hi):
        raise Unsupported(f"integer literal outside 64-bit range: {iv}")
    return iv


def _parse_duration_us(s: str) -> int:
    neg = s.strip().startswith("-")
    body = s.strip().lstrip("-")
    m = re.match(r"^(\d+):(\d+):(\d+)(\.(\d+))?$", body)
    if not m:
        # bare seconds / hhmmss form
        raise Unsupported(f"duration literal {s!r}")
    h, mi, sec = int(m.group(1)), int(m.group(2)), int(m.group(3))
    frac = (m.group(5) or "").ljust(6, "0")[:6]
    us = ((h * 3600 + mi * 60 + sec) * 1_000_000 + int(frac))
    return -us if neg else us


# ----------------------------------------------------- SELECT -> plan

_FUNC_RENAME = {
    "bit_and2": "bit_and", "bit_or2": "bit_or", "bit_xor2": "bit_xor",
}


def _FP_PAUSED(sess, name) -> bool:
    from ..runtime.failpoint import FailPoint

    return FailPoint.get(name).pause


class _EngineFromUnsupported(Exception):
    """FROM shape outside the engine-join path (non-equi outer joins):
    fall back to the host nested-loop join."""


class _CrossCorrelated(Exception):
    """A subquery correlated beyond equality conjuncts: the caller
    lowers it via the generic cross-decorrelation (rid + CrossJoin +
    per-row match counting) instead of a hash semi join."""

    def __init__(self, table, items, where, aliases, has_agg=False):
        super().__init__("cross-correlated subquery")
        self.table = table
        self.items = items
        self.where = where
        self.aliases = aliases
        self.has_agg = has_agg


class SelectBuilder:
    def __init__(self, session: RefTestSession, sql, nested: bool = False,
                 outer_schema=None, outer_qualmap=None):
        self.sess = session
        self.p = sql if isinstance(sql, SqlParser) else SqlParser(sql)
        self.p.sess = session  # scalar subqueries run in-session
        self.nested = nested  # derived table: stop at the closing ')'
        self.order_sensitive = False
        self.schema: Dict[str, dt.DataType] = {}
        # (alias, column) -> internal column name, set by _join_on_host
        self.qualmap: Dict[Tuple[str, str], str] = {}
        # correlated-subquery scope: the OUTER query's schema/qualmap
        # (decorrelation pulls equality conjuncts up into join keys)
        self.outer_schema = outer_schema
        self.outer_qualmap = outer_qualmap or {}
        self.corr: List[Tuple[Expr, str]] = []  # (outer ref, local col)
        self.engine_from = None  # (plan, blocks, schema) from _from_engine
        self.outer_aliases = set()  # the outer query's FROM aliases
        self.from_aliases = set()  # this query's FROM aliases

    def _qualify(self, e: Expr) -> Expr:
        """Resolve ``t1.a``-style refs against the ON-join alias map,
        and unresolved names case-insensitively (MySQL column names are
        case-insensitive: late_materialization_generate_column.test
        mixes COL2/col2)."""
        if isinstance(e, ColumnRef):
            if e.qual is not None and (e.qual, e.name) in self.qualmap:
                return ColumnRef(self.qualmap[(e.qual, e.name)])
            if self.schema and e.name not in self.schema:
                lo = e.name.lower()
                hits = [c for c in self.schema if c.lower() == lo]
                if len(hits) == 1:
                    return ColumnRef(hits[0])
            return e
        if isinstance(e, Call):
            return Call(e.func, tuple(self._qualify(a) for a in e.args))
        if isinstance(e, Cast):
            return Cast(self._qualify(e.arg), e.target)
        return e

    def _rw(self, e: Expr) -> Expr:
        e = self._qualify(e)
        e = _coerce_temporal(_rewrite(e), self.schema,
                             getattr(self, "col_fsps", {}))
        if self.sess.cop_mode:
            e = _swap_fn(e, "from_days", "from_days_cop")
        return e

    def _build_window(self, plan, items, schema):
        """Lower ``f(...) OVER w`` items onto the engine's Window plan
        nodes (ops/window.py): ranks, lead/lag (defaults via a same-shift
        indicator over a constant column — they apply only OUTSIDE the
        partition), first/last/nth_value, ntile/percent_rank/cume_dist,
        and the aggregate family sum/count/avg/min/max with ROWS and
        RANGE frames.  OVER clauses with DIFFERENT (partition, order)
        specs chain one Window node per spec."""
        import math

        from ..ops.window import WindowDesc

        pre: Dict[str, Expr] = {}
        groups: List[list] = []  # [part_exprs, order_exprs, [descs]]
        n_descs = [0]

        def resolve_spec(v):
            if isinstance(v, str):
                if v not in self.windows:
                    raise Unsupported(f"unknown window {v!r}")
                return self.windows[v]
            return v

        def col_of(e):
            if isinstance(e, ColumnRef):
                return e.name
            n = f"__wc{len(pre)}"
            pre[n] = self._rw(e)
            return n

        def has_colref(e: Expr) -> bool:
            if isinstance(e, ColumnRef):
                return True
            if isinstance(e, Call):
                return any(has_colref(a) for a in e.args)
            if isinstance(e, Cast):
                return has_colref(e.arg)
            return False

        def descs_of(spec) -> List["WindowDesc"]:
            # constant partition/order expressions don't partition or
            # order anything — drop them (fuzz corpus: PARTITION BY
            # ('-1674028007') BETWEEN ... over literals only)
            part = tuple(e for e in spec[1] if has_colref(e))
            order = tuple((e, d) for e, d in spec[2] if has_colref(e))
            for g in groups:
                if g[0] == part and g[1] == order:
                    return g[2]
            groups.append([part, order, []])
            return groups[-1][2]

        def conv_frame(spec):
            """Spec frame -> (WindowDesc.frame, frame_type): offsets in
            the order key's physical unit (mantissa steps for decimals,
            days for dates, microseconds for datetimes — ops/window.py
            ``_range_bounds`` measures value distance in the
            ascending-transformed space)."""
            frame = spec[3] if len(spec) > 3 else None
            order = spec[2]
            if frame is None:
                if order:
                    return None, "rows"  # running default
                return (None, None), "rows"  # whole partition
            ftype, lo, hi = frame
            kdt = None
            if ftype == "range":
                if len(order) != 1:
                    raise Unsupported("RANGE frame needs one order key")
                oe = order[0][0]
                if isinstance(oe, ColumnRef):
                    kdt = schema.get(oe.name)
                if kdt is None:
                    raise Unsupported("RANGE frame over a computed key")

            def amount(b, pos_side):
                if b[0] == "unbounded":
                    return None
                if b[0] == "current":
                    return 0
                _k, e, side, unit = b
                if not isinstance(e, Literal) \
                        or isinstance(e.value, str):
                    raise Unsupported("frame offset must be numeric")
                v = e.value
                sign = 1 if side == pos_side else -1
                if ftype == "rows":
                    return sign * int(v)
                if unit is not None:
                    if kdt.kind is dt.TypeKind.DATE:
                        step = {"day": 1, "week": 7}.get(unit)
                    elif kdt.kind is dt.TypeKind.DATETIME:
                        step = {"microsecond": 1, "second": 10 ** 6,
                                "minute": 60 * 10 ** 6,
                                "hour": 3600 * 10 ** 6,
                                "day": 86400 * 10 ** 6,
                                "week": 7 * 86400 * 10 ** 6}.get(unit)
                    else:
                        step = None
                    if step is None:
                        raise Unsupported(
                            f"INTERVAL {unit} RANGE frame")
                    return sign * int(v) * step
                if kdt.is_decimal:
                    scaled = D(str(v)) * (10 ** kdt.scale)
                    return int(math.floor(sign * float(scaled))) \
                        if scaled != int(scaled) else sign * int(scaled)
                if kdt.is_float:
                    return sign * float(v)
                if kdt.kind in (dt.TypeKind.DATE, dt.TypeKind.DATETIME):
                    raise Unsupported(
                        "numeric RANGE offset over a temporal key")
                # integer key: value-space floor of the signed offset
                return int(math.floor(sign * float(v)))

            return (amount(lo, "preceding"), amount(hi, "following")), \
                ftype

        def walk(e):
            if isinstance(e, Call) and e.func == "__over__":
                inner, spec_l = e.args
                spec = resolve_spec(spec_l.value)
                descs = descs_of(spec)
                if not isinstance(inner, Call):
                    raise Unsupported("window over non-call")
                fname = {"lead": "lead", "lag": "lag",
                         "row_number": "row_number", "rank": "rank",
                         "dense_rank": "dense_rank",
                         "percent_rank": "percent_rank",
                         "cume_dist": "cume_dist", "ntile": "ntile",
                         "first_value": "first_value",
                         "last_value": "last_value",
                         "nth_value": "nth_value",
                         "sum": "sum", "count": "count", "avg": "avg",
                         "min": "min", "max": "max"}.get(inner.func)
                if fname is None:
                    raise Unsupported(f"window function {inner.func}")
                out_name = f"__wo{n_descs[0]}"
                n_descs[0] += 1
                if fname in ("row_number", "rank", "dense_rank",
                             "percent_rank", "cume_dist"):
                    descs.append(WindowDesc(fname, out_name))
                    return ColumnRef(out_name)
                if fname == "ntile":
                    o = inner.args[0]
                    if not isinstance(o, Literal):
                        raise Unsupported("ntile bucket must be literal")
                    descs.append(WindowDesc("ntile", out_name,
                                            offset=max(int(o.value), 1)))
                    return ColumnRef(out_name)
                if fname in ("sum", "count", "avg", "min", "max"):
                    fr, ft = conv_frame(spec)
                    a0 = inner.args[0] if inner.args else None
                    const_str = (isinstance(a0, Literal)
                                 and isinstance(a0.value, str)
                                 and a0.value != "*")
                    if const_str and fr in (None, (None, None)):
                        # aggregate of a CONSTANT over a never-empty
                        # frame (fuzz regressions): min/max fold to the
                        # constant; sum/avg via MySQL's lax double
                        # prefix; count becomes count(*)
                        if fname in ("min", "max"):
                            return Literal(a0.value)
                        m = re.match(r"\s*[+-]?\d*\.?\d*(?:[eE][+-]?\d+)?",
                                     a0.value)
                        num = float(m.group(0) or 0) if m else 0.0
                        if fname == "avg":
                            return Literal(num)
                        if fname == "sum":
                            if "__wone" not in pre:
                                pre["__wone"] = Literal(1)
                            descs.append(WindowDesc(
                                "count", out_name, arg="__wone",
                                frame=fr, frame_type=ft))
                            return Call("multiply",
                                        (Literal(num),
                                         ColumnRef(out_name)))
                        # count of a non-null constant == count(*)
                    if fname == "count" and (not inner.args or (
                            isinstance(a0, Literal)
                            and a0.value == "*") or const_str):
                        if "__wone" not in pre:
                            pre["__wone"] = Literal(1)
                        argn = "__wone"
                    else:
                        argn = col_of(inner.args[0])
                    descs.append(WindowDesc(fname, out_name, arg=argn,
                                            frame=fr, frame_type=ft))
                    return ColumnRef(out_name)
                argn = col_of(inner.args[0])
                if fname == "nth_value":
                    o = inner.args[1]
                    if not isinstance(o, Literal):
                        raise Unsupported("nth_value n must be literal")
                    fr, ft = conv_frame(spec)
                    if ft != "rows":
                        raise Unsupported("nth_value over a RANGE frame")
                    descs.append(WindowDesc("nth_value", out_name,
                                            arg=argn, frame=fr,
                                            offset=max(int(o.value), 1)))
                    return ColumnRef(out_name)
                if fname in ("first_value", "last_value"):
                    fr, ft = conv_frame(spec)
                    descs.append(WindowDesc(fname, out_name, arg=argn,
                                            frame=fr, frame_type=ft))
                    return ColumnRef(out_name)
                offset = 1
                if len(inner.args) > 1:
                    o = inner.args[1]
                    if not isinstance(o, Literal):
                        raise Unsupported("window offset must be literal")
                    from ..runtime.errors import EngineError

                    ov = int(o.value)
                    if ov < 0:
                        # MySQL's parser rejects negative offsets
                        # outright (lead_lag.test)
                        raise EngineError(
                            "You have an error in your SQL syntax: "
                            f"negative {inner.func} offset {ov}")
                    if ov >= 1 << 64:
                        # beyond BIGINT UNSIGNED: ER_WRONG_ARGUMENTS
                        raise EngineError(
                            f"Incorrect arguments to {inner.func}")
                    if ov >= 1 << 63:
                        # TiDB bit-casts the UNSIGNED offset to int64:
                        # 2^64-1 behaves as -1, flipping lead<->lag
                        # (lead_lag.test records lag-by-1 answers)
                        ov = (1 << 64) - ov
                        fname = "lag" if fname == "lead" else "lead"
                    # clamp: offsets beyond any table size (the corpus
                    # probes 2^63-ish) behave identically — all rows
                    # fall outside the partition
                    offset = min(ov, 1 << 40)
                descs.append(WindowDesc(fname, out_name, arg=argn,
                                        offset=offset))
                default = (inner.args[2] if len(inner.args) > 2 else None)
                arg_stringy = (
                    (argn in schema and schema[argn].is_string)
                    or (isinstance(inner.args[0], Literal)
                        and isinstance(inner.args[0].value, str)))
                if (arg_stringy and isinstance(default, Literal)
                        and default.value is not None
                        and not isinstance(default.value, str)):
                    # MySQL coerces the default to the ARG's type:
                    # lead(str_col, 1, 123) yields '123'
                    default = Literal(str(default.value))
                if (default is not None and fname in ("lead", "lag")
                        and not (isinstance(default, Literal)
                                 and default.value is None)):
                    if "__wone" not in pre:
                        pre["__wone"] = Literal(1)
                    ind = f"__wi{n_descs[0]}"
                    n_descs[0] += 1
                    descs.append(WindowDesc(fname, ind, arg="__wone",
                                            offset=offset))
                    out_ref: Expr = ColumnRef(out_name)
                    at = schema.get(argn)
                    if (at is not None
                            and at.kind in (dt.TypeKind.DATE,
                                            dt.TypeKind.DATETIME,
                                            dt.TypeKind.DURATION)
                            and isinstance(default, Literal)
                            and not isinstance(default.value, str)):
                        # temporal arg + numeric default: MySQL widens
                        # the result to VARCHAR ('88888' next to
                        # '2010-01-01 11:00:00')
                        out_ref = Cast(out_ref,
                                       dt.STRING.with_nullable(True))
                        default = Literal(str(default.value))
                    return Call("if", (Call("is_null", (ColumnRef(ind),)),
                                       default, out_ref))
                return ColumnRef(out_name)
            if isinstance(e, Call):
                return Call(e.func, tuple(walk(a) for a in e.args))
            if isinstance(e, Cast):
                return Cast(walk(e.arg), e.target)
            return e

        new_items = [(a, walk(e)) for a, e in items]
        if not groups:
            return plan, items
        part_names = [[col_of(e) for e in g[0]] for g in groups]
        okeys = [[SortKey(col_of(e), desc=d) for e, d in g[1]]
                 for g in groups]
        if pre:
            proj = {c: ColumnRef(c) for c in schema}
            proj.update(pre)
            plan = P.Projection(proj, plan)
        for g, pn, ok in zip(groups, part_names, okeys):
            plan = P.Window(pn, ok, g[2], plan)
        return plan, new_items

    def _from_engine(self, from_items):
        """Lower a FROM join chain onto the ENGINE's Join/CrossJoin plan
        nodes (reference: ``PhysicalJoin`` build+probe,
        ``Flash/Planner/Plans/PhysicalJoin.cpp``) — the MPP corpus
        exercises these as real engine operators; the host nested loop
        remains only for shapes the ladder can't express (outer joins
        with non-equi ON conjuncts).  Returns (plan, blocks, schema,
        fsps); raises _EngineFromUnsupported to fall back."""
        from . import oracle as O

        sides = []
        for t, alias, jt, cond in from_items:
            if t not in self.sess.tables:
                raise Unsupported(f"unknown table {t}")
            s, r = self.sess.tables[t]
            sides.append((t, alias, jt, cond, s, r))

        counts: Dict[str, int] = {}
        for _, _, _, _, s, _ in sides:
            for c in s:
                counts[c] = counts.get(c, 0) + 1
        qualmap: Dict[Tuple[str, str], str] = {}
        schema: Dict[str, dt.DataType] = {}
        fsps: Dict[str, int] = {}
        side_cols: List[List[str]] = []
        plans = []
        blocks: Dict[str, object] = {}
        rowns = []
        for i, (t, alias, jt, cond, s, r) in enumerate(sides):
            cols = []
            for c, ty in s.items():
                internal = c if counts[c] == 1 else f"{alias}.{c}"
                if internal in schema:
                    raise _EngineFromUnsupported(
                        f"ambiguous join column {internal}")
                qualmap[(alias, c)] = internal
                schema[internal] = ty
                if c in self.sess.fsps.get(t, {}):
                    fsps[internal] = self.sess.fsps[t][c]
                cols.append(internal)
            side_cols.append(cols)
            bname = f"__f{i}_{alias}"
            n = len(next(iter(r.values()))) if r else 0
            if n == 0:
                blk = _empty_block(s, self.sess.device)
            else:
                blk = O.pytable_to_block(r, s, self.sess.device)
            blocks[bname] = blk
            pl: P.PlanNode = P.TableScan(bname)
            pl = P.Projection(
                {internal: ColumnRef(orig)
                 for internal, orig in zip(cols, s)}, pl)
            plans.append(pl)
            rowns.append(n)

        def qualify(e: Expr) -> Expr:
            if isinstance(e, ColumnRef):
                if e.qual is not None and (e.qual, e.name) in qualmap:
                    return ColumnRef(qualmap[(e.qual, e.name)])
                return e
            if isinstance(e, Call):
                return Call(e.func, tuple(qualify(a) for a in e.args))
            if isinstance(e, Cast):
                return Cast(qualify(e.arg), e.target)
            return e

        def conjuncts(e: Expr) -> List[Expr]:
            if isinstance(e, Call) and e.func == "and":
                return conjuncts(e.args[0]) + conjuncts(e.args[1])
            return [e]

        acc = plans[0]
        acc_cols = set(side_cols[0])
        acc_rows = max(rowns[0], 1)
        for i in range(1, len(sides)):
            _, alias, jt, cond, s, r = sides[i]
            cur_cols = set(side_cols[i])
            equi: List[Tuple[str, str]] = []
            others: List[Expr] = []
            for c in (conjuncts(qualify(cond)) if cond is not None else []):
                if (isinstance(c, Call) and c.func == "equals"
                        and isinstance(c.args[0], ColumnRef)
                        and isinstance(c.args[1], ColumnRef)):
                    a, b = c.args[0].name, c.args[1].name
                    if a in acc_cols and b in cur_cols:
                        equi.append((a, b))
                        continue
                    if b in acc_cols and a in cur_cols:
                        equi.append((b, a))
                        continue
                others.append(c)
            cap = max(acc_rows * max(rowns[i], 1), acc_rows, 8)
            rw_local = lambda e: _as_bool(_coerce_temporal(  # noqa: E731
                _rewrite(e), schema, fsps))
            if jt in ("left", "right") and (others or not equi):
                raise _EngineFromUnsupported(
                    "outer join with non-equi ON condition")
            if jt == "left":
                acc = P.Join("left", [a for a, _ in equi],
                             [b for _, b in equi], acc, plans[i],
                             output_capacity=cap)
                for c in side_cols[i]:
                    schema[c] = schema[c].with_nullable(True)
            elif jt == "right":
                # A right join B == B left join A; the output schema
                # keeps FROM order (selection is by name downstream)
                acc = P.Join("left", [b for _, b in equi],
                             [a for a, _ in equi], plans[i], acc,
                             output_capacity=cap)
                for c in acc_cols:
                    schema[c] = schema[c].with_nullable(True)
            elif equi:
                acc = P.Join("inner", [a for a, _ in equi],
                             [b for _, b in equi], acc, plans[i],
                             output_capacity=cap)
                for o in others:
                    acc = P.Selection(rw_local(o), acc)
            else:
                acc = P.CrossJoin(probe=acc, build=plans[i],
                                  output_capacity=cap)
                for o in others:
                    acc = P.Selection(rw_local(o), acc)
            acc_cols |= cur_cols
            acc_rows = cap
        self.qualmap = qualmap
        return acc, blocks, schema, fsps

    def _cartesian(self, tables: List[str]) -> str:
        """Materialize a comma-join FROM list as one synthetic table
        (column names must be globally unique, as in the corpus)."""
        import itertools

        schema: Dict[str, dt.DataType] = {}
        rowsets = []
        for t in tables:
            if t not in self.sess.tables:
                raise Unsupported(f"unknown table {t}")
            s, r = self.sess.tables[t]
            for c in s:
                if c in schema:
                    raise Unsupported(f"ambiguous column {c} in comma join")
            schema.update(s)
            rowsets.append((s, r))
        cols: Dict[str, list] = {c: [] for c in schema}
        ns = [len(next(iter(r.values()))) if r else 0 for _, r in rowsets]
        for idxs in itertools.product(*(range(n) for n in ns)):
            for (s, r), i in zip(rowsets, idxs):
                for c in s:
                    cols[c].append(r[c][i])
        name = "__commajoin__"
        self.sess.tables[name] = (schema, cols)
        return name

    def _join_on_host(self, from_items) -> str:
        """ON / LEFT / RIGHT join chains over tiny corpus tables:
        host-side nested loop with MySQL three-valued ON semantics,
        registered as one synthetic session table.  Column names are
        alias-disambiguated only when two sides share a name
        (``t1.a`` / ``t2.a`` in enum.test's self right-join); the
        (alias, column) -> internal map feeds _qualify so later
        clauses resolve qualified refs.  Engine joins proper are
        exercised by tests/test_join*; this path exists so the corpus
        front-end covers the reference's mysql-client join queries
        (reference runner: tests/run-test.py) without teaching the
        tokenizer a planner's worth of scoping rules."""
        from . import oracle as O

        sides = []
        for t, alias, jt, cond in from_items:
            if t not in self.sess.tables:
                raise Unsupported(f"unknown table {t}")
            s, r = self.sess.tables[t]
            sides.append((alias, s, r, jt, cond))

        counts: Dict[str, int] = {}
        for _, s, _, _, _ in sides:
            for c in s:
                counts[c] = counts.get(c, 0) + 1
        schema: Dict[str, dt.DataType] = {}
        for alias, s, _, _, _ in sides:
            for c, ty in s.items():
                internal = c if counts[c] == 1 else f"{alias}.{c}"
                if internal in schema:
                    raise Unsupported(f"ambiguous join column {internal}")
                self.qualmap[(alias, c)] = internal
                schema[internal] = ty

        def rows_of(alias, s, r):
            n = len(next(iter(r.values()))) if r else 0
            return [{self.qualmap[(alias, c)]: r[c][i] for c in s}
                    for i in range(n)]

        alias0, s0, r0, _, _ = sides[0]
        acc = rows_of(alias0, s0, r0)
        acc_cols = [self.qualmap[(alias0, c)] for c in s0]
        for alias, s, r, jt, cond in sides[1:]:
            cur = rows_of(alias, s, r)
            cur_cols = [self.qualmap[(alias, c)] for c in s]
            cond_q = self._qualify(cond) if cond is not None else None
            out = []
            matched_right = [False] * len(cur)
            for lrow in acc:
                hit = False
                for j, rrow in enumerate(cur):
                    both = {**lrow, **rrow}
                    if cond_q is not None:
                        v = O.eval_expr_row(cond_q, both)
                        if v is None or not v:
                            continue
                    out.append(both)
                    hit = True
                    matched_right[j] = True
                if not hit and jt == "left":
                    out.append({**lrow, **{c: None for c in cur_cols}})
            if jt == "right":
                for j, rrow in enumerate(cur):
                    if not matched_right[j]:
                        out.append(
                            {**{c: None for c in acc_cols}, **rrow})
            acc = out
            acc_cols = acc_cols + cur_cols

        cols = {c: [row[c] for row in acc] for c in schema}
        # outer joins null-extend NOT NULL sides
        for c, vals in cols.items():
            if any(v is None for v in vals) and not schema[c].nullable:
                schema[c] = schema[c].with_nullable(True)
        name = "__onjoin__"
        self.sess.tables[name] = (schema, cols)
        return name

    def _union_combine(self, out, union):
        """UNION [ALL]: each side ran through the engine; rows combine
        by position, UNION DISTINCT dedupes (first occurrence wins)."""
        from . import oracle as O

        ua, rblk = union
        lt = O.block_to_pytable(out.compact())
        rt = O.block_to_pytable(rblk.compact())
        lnames = list(lt)
        if len(lnames) != len(list(rt)):
            raise Unsupported("UNION column count mismatch")
        schema = {n: c.dtype for n, c in zip(out.names, out.columns)}

        def join_types(a: dt.DataType, b: dt.DataType) -> dt.DataType:
            """MySQL UNION result typing (widest side; issue_8111:
            0.0 literal next to a decimal(30,2) sum keeps scale 2)."""
            if a.kind == b.kind and not a.is_decimal:
                return a
            if a.is_string or b.is_string:
                return a if a.is_string else b
            if a.is_float or b.is_float:
                return dt.FLOAT64.with_nullable(a.nullable or b.nullable)
            if a.is_decimal or b.is_decimal:
                sa = a.scale if a.is_decimal else 0
                sb = b.scale if b.is_decimal else 0
                pa = a.precision if a.is_decimal else 20
                pb = b.precision if b.is_decimal else 20
                return dt.Decimal(
                    min(max(pa - sa, pb - sb) + max(sa, sb), 65),
                    max(sa, sb),
                    nullable=a.nullable or b.nullable)
            return a

        merged = {n: list(lt[n]) for n in lnames}
        for n, old, rc in zip(lnames, list(rt), rblk.columns):
            merged[n] = merged[n] + list(rt[old])
            schema[n] = join_types(schema[n], rc.dtype)
            if any(v is None for v in merged[n]):
                schema[n] = schema[n].with_nullable(True)
        if not ua:
            seen = set()
            keep = []
            nrows = len(merged[lnames[0]]) if lnames else 0
            for i in range(nrows):
                key = tuple(repr(merged[n][i]) for n in lnames)
                if key not in seen:
                    seen.add(key)
                    keep.append(i)
            merged = {n: [merged[n][i] for i in keep] for n in lnames}
        if not lnames or not merged[lnames[0]]:
            return _empty_block(schema, self.sess.device)
        return O.pytable_to_block(merged, schema, self.sess.device)

    def _register_block(self, name: str, blk, cols=None) -> None:
        from . import oracle as O

        tab = O.block_to_pytable(blk.compact())
        schema = {n: c.dtype for n, c in zip(blk.names, blk.columns)}
        if cols:
            tab = {nc: tab[old] for nc, old in zip(cols, list(tab))}
            schema = {nc: schema[old]
                      for nc, old in zip(cols, list(schema))}
        self.sess.tables[name] = (schema, tab)

    def _run_ctes(self) -> None:
        """WITH [RECURSIVE] name [(cols)] AS (select ...) , ... —
        non-recursive CTEs materialize once (the engine's WithCTE
        materialize-once analog lives at the plan layer; the corpus
        front-end materializes to a session temp); recursive CTEs
        iterate seed UNION ALL step to a fixpoint (bounded)."""
        p = self.p
        if not p.at_kw("with"):
            return
        p.next()
        recursive = bool(p.eat_kw("recursive"))
        while True:
            cname = p.next()[1].strip("`")
            cols = None
            if p.at_op("("):
                p.next()
                cols = [p.next()[1].strip("`")]
                while p.eat_op(","):
                    cols.append(p.next()[1].strip("`"))
                p.expect_op(")")
            p.expect_kw("as")
            if not recursive:
                p.expect_op("(")
                sub = SelectBuilder(self.sess, p, nested=True)
                blk = sub.run()
                p.expect_op(")")
                self._register_block(cname, blk, cols)
            else:
                marker = p._capture_subquery()
                toks = self.sess.subq_tokens[marker.args[0].value]
                # split seed UNION ALL step at depth 0
                depth = 0
                split = None
                for ti, (k, v) in enumerate(toks):
                    if k == "op" and v == "(":
                        depth += 1
                    elif k == "op" and v == ")":
                        depth -= 1
                    elif (k == "name" and v.lower() == "union"
                          and depth == 0):
                        split = ti
                        break
                if split is None:
                    raise Unsupported("recursive CTE without UNION")
                seed_t = toks[:split] + [("eof", "")]
                step_t = toks[split + 1:]
                step_all = False
                if step_t and step_t[0][1].lower() == "all":
                    step_t = step_t[1:]
                    step_all = True
                sp = SqlParser.from_tokens(seed_t)
                sp.sess = self.sess
                blk = SelectBuilder(self.sess, sp).run()
                self._register_block(cname, blk, cols)
                from . import oracle as O

                schema0, seed_tab = self.sess.tables[cname]
                acc = {c: list(v) for c, v in seed_tab.items()}
                last = seed_tab  # the SQL recursive working table:
                # each step reads only the PREVIOUS iteration's rows.
                # The step evaluates HOST-side (one engine run per
                # iteration of a few rows each) — recursion here is DATA
                # SETUP, like the host Cartesian; verified outputs still
                # run engine-side
                sp = SqlParser.from_tokens(list(step_t) + [("eof", "")])
                sp.sess = self.sess
                sp.expect_kw("select")
                sitems = []
                while True:
                    se = sp.parse_expr()
                    if sp.eat_kw("as"):
                        sp.next()
                    elif sp.peek()[0] in ("name", "qident") \
                            and not sp.at_kw("from"):
                        sp.next()  # bare alias (c1+1 c1)
                    sitems.append(se)
                    if not sp.eat_op(","):
                        break
                sp.expect_kw("from")
                stbl = sp.next()[1].strip("`")
                while sp.at_op("."):
                    sp.next()
                    stbl = sp.next()[1].strip("`")
                swhere = sp.parse_expr() if sp.eat_kw("where") else None
                slimit = None
                if sp.eat_kw("limit"):
                    # LIMIT inside a recursive CTE caps the TOTAL rows
                    slimit = int(sp.next()[1])
                if stbl != cname or sp.peek()[0] != "eof":
                    raise Unsupported("recursive CTE step shape")
                names0 = list(acc)
                seen = None
                if not step_all:
                    # UNION DISTINCT recursion: only new distinct rows
                    # enter the next working table
                    seen = {tuple(repr(acc[c][i]) for c in names0)
                            for i in range(len(acc[names0[0]]))} \
                        if names0 else set()
                for _ in range(100000):
                    if slimit is not None \
                            and names0 and len(acc[names0[0]]) >= slimit:
                        for c in names0:
                            acc[c] = acc[c][:slimit]
                        break
                    nrows = []
                    n = (len(next(iter(last.values()))) if last else 0)
                    for i in range(n):
                        row = {c: last[c][i] for c in last}
                        if swhere is not None:
                            ok = O.eval_expr_row(swhere, row)
                            if ok is None or not ok:
                                continue
                        nrows.append([O.eval_expr_row(e, row)
                                      for e in sitems])
                    if seen is not None:
                        fresh = []
                        for r in nrows:
                            key = tuple(repr(v) for v in r)
                            if key not in seen:
                                seen.add(key)
                                fresh.append(r)
                        nrows = fresh
                    if not nrows:
                        break
                    last = {c: [r[j] for r in nrows]
                            for j, c in enumerate(names0)}
                    for c in names0:
                        acc[c] = acc[c] + last[c]
                else:
                    raise Unsupported("recursive CTE did not converge")
                self.sess.tables[cname] = (schema0, acc)
            if not p.eat_op(","):
                break

    def run(self):
        p = self.p
        self._run_ctes()
        p.expect_kw("select")
        distinct = bool(p.eat_kw("distinct"))
        if not distinct:
            p.eat_kw("all")
        # select list ('*' = all table columns, in schema order)
        items: List[Tuple[Optional[str], Expr]] = []
        star = False
        while True:
            if p.at_op("*"):
                p.next()
                star = True
                if not p.eat_op(","):
                    break
                continue
            expr = p.parse_expr()
            alias = None
            if p.eat_kw("as"):
                tk, tv = p.next()
                alias = tv[1:-1] if tk in ("qident", "str") else tv
            elif p.peek()[0] in ("name", "qident") and not p.at_kw(
                    "from", "where", "group", "order", "limit", "union",
                    "window", "having"):
                tk, tv = p.next()
                alias = tv[1:-1] if tk == "qident" else tv
            if alias is None and isinstance(expr, ColumnRef):
                alias = expr.name
            items.append((alias, expr))
            if not p.eat_op(","):
                break

        table = None
        if p.eat_kw("from"):
            from_items = []  # (table, alias, jointype, on_expr)
            pending_jt = None
            while True:
                alias = None
                if p.at_op("("):
                    # derived table: run the subselect, register the
                    # result as a session temp (json_contains_path.test)
                    p.next()
                    sub = SelectBuilder(self.sess, p, nested=True)
                    sub_block = sub.run()
                    p.expect_op(")")
                    alias = "__derived__"
                    if p.at_kw("as"):
                        p.next()
                        alias = p.next()[1].strip("`")
                    elif p.peek()[0] in ("name", "qident"):
                        alias = p.next()[1].strip("`")
                    sschema = {n: c.dtype for n, c in
                               zip(sub_block.names, sub_block.columns)}
                    from . import oracle as O

                    self.sess.tables[alias] = (
                        sschema, O.block_to_pytable(sub_block.compact()))
                    table = alias
                else:
                    tk, tv = p.next()
                    table = tv.strip("`")
                    while p.at_op("."):
                        p.next()
                        table = p.next()[1].strip("`")
                    # alias
                    if p.at_kw("as"):
                        p.next()
                        alias = p.next()[1].strip("`")
                    elif p.peek()[0] == "name" and not p.at_kw(
                            "where", "group", "order", "limit", "union",
                            "having", "window", "join", "cross", "inner",
                            "left", "right", "on"):
                        alias = p.next()[1].strip("`")
                cond = p.parse_expr() if p.eat_kw("on") else None
                from_items.append((table, alias or table,
                                   pending_jt, cond))
                pending_jt = None
                if p.eat_op(","):
                    pending_jt = "inner"
                    continue
                if p.at_kw("join"):
                    p.next()
                    pending_jt = "inner"
                elif p.at_kw("cross", "inner") \
                        and p.peek(1)[1].lower() == "join":
                    p.next()
                    p.expect_kw("join")
                    pending_jt = "inner"
                elif p.at_kw("left", "right") and \
                        p.peek(1)[1].lower() in ("join", "outer"):
                    pending_jt = p.next()[1].lower()
                    p.eat_kw("outer")
                    p.expect_kw("join")
                else:
                    break
            # an explicit alias SHADOWS the table name (MySQL scoping:
            # `from t t1` makes `t.a` resolve to an OUTER t, apply.test)
            self.from_aliases = {it[1] for it in from_items}
            if len(from_items) > 1:
                try:
                    self.engine_from = self._from_engine(from_items)
                    table = None
                except _EngineFromUnsupported:
                    self.qualmap = {}
                    if any(it[3] is not None or it[2] in ("left", "right")
                           for it in from_items):
                        # non-equi outer joins: host-side nested loop
                        # (enum.test right join on !=)
                        table = self._join_on_host(from_items)
                    else:
                        table = self._cartesian(
                            [it[0] for it in from_items])
        where = None
        if p.eat_kw("where"):
            where = p.parse_expr()
        group_by: List[Expr] = []
        self.rollup = False
        if p.eat_kw("group"):
            p.expect_kw("by")
            group_by.append(p.parse_expr())
            while p.eat_op(","):
                group_by.append(p.parse_expr())
            if p.eat_kw("with"):
                p.expect_kw("rollup")
                self.rollup = True
            # positional form: GROUP BY 1 = first select item; alias
            # form: GROUP BY <select alias> resolves to that item's expr
            alias_map = {a: e for a, e in items if a is not None}
            if self.engine_from is not None:
                cur_schema = self.engine_from[2]
            elif table is not None and table in self.sess.tables:
                cur_schema = self.sess.tables[table][0]
            else:
                cur_schema = {}
            def resolve_g(g):
                if isinstance(g, Literal) and isinstance(g.value, int) \
                        and 1 <= g.value <= len(items):
                    return items[g.value - 1][1]
                if isinstance(g, ColumnRef) and g.name in alias_map:
                    # MySQL: a real column wins over a select alias
                    if g.name not in cur_schema or not isinstance(
                            alias_map[g.name], ColumnRef):
                        return alias_map[g.name]
                return g
            group_by = [resolve_g(g) for g in group_by]
        having = None
        if p.eat_kw("having"):
            having = p.parse_expr()
        self.windows = {}
        if p.eat_kw("window"):
            while True:
                wname = p.next()[1].strip("`")
                p.expect_kw("as")
                p.expect_op("(")
                self.windows[wname] = p.parse_window_spec()
                p.expect_op(")")
                if not p.eat_op(","):
                    break
        order_by: List[Tuple[Expr, bool]] = []
        if p.eat_kw("order"):
            p.expect_kw("by")
            while True:
                e = p.parse_expr()
                desc = bool(p.eat_kw("desc"))
                if not desc:
                    p.eat_kw("asc")
                order_by.append((e, desc))
                if not p.eat_op(","):
                    break
            self.order_sensitive = True
        limit = None
        if p.eat_kw("limit"):
            limit = int(p.next()[1])
        union = None
        if p.eat_kw("union"):
            ua = bool(p.eat_kw("all"))
            if not ua:
                p.eat_kw("distinct")
            union = (ua,
                     SelectBuilder(self.sess, p, nested=self.nested,
                                   outer_schema=self.outer_schema,
                                   outer_qualmap=self.outer_qualmap).run())
        if p.peek()[0] != "eof" and not (self.nested and p.at_op(")")):
            raise Unsupported(f"trailing sql at {p.peek()[1]!r}")

        if star:
            if self.engine_from is not None:
                schema = self.engine_from[2]
            elif table is not None and table in self.sess.tables:
                schema, _ = self.sess.tables[table]
            else:
                raise Unsupported("SELECT * without a known table")
            items = [(c, ColumnRef(c)) for c in schema] + items
        if distinct and not group_by \
                and not any(_has_agg(e) for _, e in items):
            # SELECT DISTINCT == GROUP BY every output item
            group_by = [e for _, e in items]
        if union is not None:
            out = self.build_and_run(items, table, where, group_by,
                                     having, order_by, limit)
            return self._union_combine(out, union)
        if (self.outer_schema is not None and limit == 1
                and len(order_by) == 1 and len(items) == 1
                and not group_by and not star
                and _fingerprint(items[0][1])
                == _fingerprint(order_by[0][0])):
            # subquery `SELECT k .. ORDER BY k LIMIT 1` == MIN/MAX(k):
            # lets the APPLY decorrelation handle late-materialization
            # correlated top-1 probes (apply_with_late_materialization)
            fn = "max" if order_by[0][1] else "min"
            items = [(items[0][0], Call(fn, (items[0][1],)))]
            order_by, limit = [], None
            self.order_sensitive = False
        if self.outer_schema is not None and where is not None:
            where = self._split_correlation(
                where, table, items, group_by, limit)
            if self.corr:
                for i, (_outer, local) in enumerate(self.corr):
                    items.append((local, ColumnRef(local)))
        return self.build_and_run(items, table, where, group_by, having,
                                  order_by, limit)

    def _split_correlation(self, where, table, items, group_by, limit):
        """Pull equality conjuncts that reference the OUTER query's
        columns out of a subquery's WHERE (classic decorrelation: they
        become extra semi-join keys).  Only legal over a plain filtered
        scan — aggregation/limit under the correlation would change
        meaning."""
        if table is None or table not in self.sess.tables:
            return where
        local_schema = self.sess.tables[table][0]

        def refs_outer(e: Expr) -> bool:
            if isinstance(e, ColumnRef):
                if e.qual is not None:
                    # alias-qualified: OUR aliases shadow the outer scope
                    if e.qual in self.from_aliases:
                        return False
                    return ((e.qual, e.name) in self.outer_qualmap
                            or (e.qual in self.outer_aliases
                                and e.name in self.outer_schema))
                if e.name in local_schema:
                    return False
                return e.name in self.outer_schema
            if isinstance(e, Call):
                return any(refs_outer(a) for a in e.args)
            if isinstance(e, Cast):
                return refs_outer(e.arg)
            return False

        def conjuncts(e: Expr) -> List[Expr]:
            if isinstance(e, Call) and e.func == "and":
                return conjuncts(e.args[0]) + conjuncts(e.args[1])
            return [e]

        keep: List[Expr] = []
        corr: List[Tuple[Expr, str]] = []
        beyond_equality = False
        for c in conjuncts(where):
            if not refs_outer(c):
                keep.append(c)
                continue
            if (isinstance(c, Call) and c.func == "equals"
                    and isinstance(c.args[0], ColumnRef)
                    and isinstance(c.args[1], ColumnRef)):
                a, b = c.args
                if refs_outer(a) and not refs_outer(b) \
                        and b.name in local_schema:
                    corr.append((a, b.name))
                    continue
                if refs_outer(b) and not refs_outer(a) \
                        and a.name in local_schema:
                    corr.append((b, a.name))
                    continue
            beyond_equality = True
        if (corr or beyond_equality) and (group_by or limit is not None):
            raise Unsupported("correlated subquery with GROUP BY/LIMIT")
        if (corr or beyond_equality) \
                and any(_has_agg(e) for _, e in items):
            # correlated scalar aggregate (the APPLY shape): the caller
            # cross-decorrelates with the full WHERE as the pair filter
            raise _CrossCorrelated(table, items, where,
                                   self.from_aliases, has_agg=True)
        if beyond_equality:
            # the whole WHERE rides the cross-decorrelation predicate
            raise _CrossCorrelated(table, items, where,
                                   self.from_aliases)
        self.corr = corr
        if not keep:
            return None
        out = keep[0]
        for c in keep[1:]:
            out = Call("and", (out, c))
        return out

    # -- subquery predicate lowering (IN/EXISTS/ANY/ALL -> engine joins)
    def _run_subquery(self, sid: int):
        """Parse + execute a captured subselect, decorrelating equality
        conjuncts against THIS query's scope.  Returns (result block,
        [(outer ref, sub output column)] correlation pairs)."""
        sp = SqlParser.from_tokens(self.sess.subq_tokens[sid])
        sp.sess = self.sess
        sub = SelectBuilder(self.sess, sp, outer_schema=self.schema,
                            outer_qualmap=self.qualmap)
        sub.outer_aliases = self.from_aliases
        try:
            blk = sub.run()
        except _CrossCorrelated as cc:
            return ("cross", cc, None)
        return ("block", blk, sub.corr)

    def _lower_subqueries(self, plan, blocks, items, where, having):
        """Rewrite subquery predicate markers onto the engine's
        semi-join family (reference kinds: Semi/Anti/NullAware*/
        LeftOuterSemi, ``Interpreters/Join.h``): WHERE-conjunct IN/EXISTS
        become semi / null-aware-anti joins; markers inside expressions
        become LeftOuterSemi matched columns; quantified comparisons
        (> ANY, <> ALL, ...) fold through scalar aggregates of the
        engine-executed subquery."""
        from . import oracle as O

        cur_cols = list(self.schema)
        bound = 1
        for b in blocks.values():
            bound = min(bound * max(int(b.capacity), 1), 1 << 22)
        state = {"plan": plan, "n": 0, "rows": bound}
        has_agg = any(_has_agg(e) for _, e in items)

        def conjuncts(e: Expr) -> List[Expr]:
            if isinstance(e, Call) and e.func == "and":
                return conjuncts(e.args[0]) + conjuncts(e.args[1])
            return [e]

        def add_hidden(x: Expr) -> str:
            xq = self._qualify(x)
            if isinstance(xq, ColumnRef) and xq.name in cur_cols:
                return xq.name
            name = f"__sqa{state['n']}"
            state["n"] += 1
            proj = {c: ColumnRef(c) for c in cur_cols}
            proj[name] = self._rw(x)
            state["plan"] = P.Projection(proj, state["plan"])
            cur_cols.append(name)
            return name

        def outer_key(ref: Expr) -> str:
            q = self._qualify(ref)
            if isinstance(q, ColumnRef) and q.name in cur_cols:
                return q.name
            raise Unsupported("correlated outer column "
                              f"{getattr(ref, 'name', ref)!r} not in scope")

        def join(kind: str, x_expr, blk, corr) -> None:
            bname = f"__sqt{state['n']}"
            state["n"] += 1
            blocks[bname] = blk
            probe_keys, build_keys = [], []
            if x_expr is not None:
                if isinstance(x_expr, Call) and x_expr.func == "__row__":
                    # (a,b) IN (select x,y ...): composite-key semi join
                    if len(x_expr.args) > len(blk.names):
                        raise Unsupported("row IN arity mismatch")
                    for j, xe in enumerate(x_expr.args):
                        probe_keys.append(add_hidden(xe))
                        build_keys.append(blk.names[j])
                else:
                    probe_keys.append(add_hidden(x_expr))
                    build_keys.append(blk.names[0])
            for outer_ref, local in corr:
                probe_keys.append(outer_key(outer_ref))
                build_keys.append(local)
            if not probe_keys:
                raise Unsupported("subquery join without keys")
            state["plan"] = P.Join(kind, probe_keys, build_keys,
                                   state["plan"], P.TableScan(bname))

        def join_col(kind: str, x_expr, blk, corr) -> str:
            if has_agg:
                raise Unsupported(
                    "subquery predicate under aggregation")
            join(kind, x_expr, blk, corr)
            name = f"__sqm{state['n']}"
            state["n"] += 1
            proj = {c: ColumnRef(c) for c in cur_cols}
            proj[name] = ColumnRef("__semi_matched")
            state["plan"] = P.Projection(proj, state["plan"])
            cur_cols.append(name)
            return name

        def sid_of(marker: Expr) -> int:
            return marker.args[0].value

        def qualify_outer(e: Expr) -> Expr:
            return self._qualify(e)

        def cross_lower(cc: "_CrossCorrelated", x_expr, mode: str) -> Expr:
            """Generic decorrelation (arbitrary correlated conjuncts):
            number the probe rows, CrossJoin with the subquery's table,
            evaluate the full three-valued predicate per pair, count
            TRUE/UNKNOWN matches per row id, and join the counts back —
            the reference's cross-probe semi join with other-conditions
            (``Interpreters/Join.cpp`` CrossProbe*, null-aware design
            doc).  Exact for IN / NOT IN / EXISTS at O(n*m), which the
            corpus tables comfortably afford."""
            from ..ops.window import WindowDesc

            if cc.table not in self.sess.tables:
                raise Unsupported(f"unknown table {cc.table}")
            sub_schema, sub_rows = self.sess.tables[cc.table]
            k = state["n"]
            state["n"] += 1
            n = (len(next(iter(sub_rows.values()))) if sub_rows else 0)
            bname = f"__sqc{k}"
            if n == 0:
                blk = _empty_block(sub_schema, self.sess.device)
            else:
                blk = O.pytable_to_block(sub_rows, sub_schema,
                                         self.sess.device)
            blocks[bname] = blk
            colmap = {c: f"__sc{k}_{c}" for c in sub_schema}
            build_plan = P.Projection(
                {colmap[c]: ColumnRef(c) for c in sub_schema},
                P.TableScan(bname))

            def rwsub(e: Expr) -> Expr:
                if isinstance(e, ColumnRef):
                    if e.qual is not None:
                        if e.qual in cc.aliases and e.name in sub_schema:
                            return ColumnRef(colmap[e.name])
                        return qualify_outer(e)
                    if e.name in sub_schema:
                        return ColumnRef(colmap[e.name])
                    return e
                if isinstance(e, Call):
                    return Call(e.func, tuple(rwsub(a) for a in e.args))
                if isinstance(e, Cast):
                    return Cast(rwsub(e.arg), e.target)
                return e

            # the sub's WHERE is a TWO-valued filter (NULL rows leave the
            # subquery result); only the IN comparison itself is
            # three-valued over the surviving rows
            wpreds: List[Expr] = []
            if cc.where is not None:
                wpreds.extend(rwsub(c) for c in conjuncts(cc.where))
            wpred: Expr = wpreds[0] if wpreds else Literal(1)
            for c2 in wpreds[1:]:
                wpred = Call("and", (wpred, c2))
            match: Optional[Expr] = None
            if mode == "in":
                if not cc.items:
                    raise Unsupported("IN subquery without a column")
                if isinstance(x_expr, Call) and x_expr.func == "__row__":
                    for j, xe in enumerate(x_expr.args):
                        c2 = Call("equals", (qualify_outer(xe),
                                             rwsub(cc.items[j][1])))
                        match = c2 if match is None else Call(
                            "and", (match, c2))
                else:
                    match = Call("equals", (qualify_outer(x_expr),
                                            rwsub(cc.items[0][1])))
            comb = dict(self.schema)
            comb.update({colmap[c]: t for c, t in sub_schema.items()})

            def rw_full(e: Expr) -> Expr:
                return _coerce_temporal(_rewrite(e), comb,
                                        getattr(self, "col_fsps", {}))

            wpred = Call("is_true", (rw_full(wpred),))
            if match is not None:
                match = rw_full(match)

            rid = f"__rid{k}"
            rid_plan = P.Window([], [], [WindowDesc("row_number", rid)],
                                state["plan"])
            cap = state["rows"] * max(n, 1)
            if cap > 1 << 25:
                raise Unsupported("cross-decorrelation too large")
            cj = P.CrossJoin(probe=rid_plan, build=build_plan,
                             output_capacity=cap)
            tname, uname = f"__sqT{k}", f"__sqU{k}"
            if match is None:
                texpr: Expr = Call("if", (wpred, Literal(1), Literal(0)))
                uexpr: Expr = Literal(0)
            else:
                texpr = Call("if", (Call("and",
                                         (wpred,
                                          Call("is_true", (match,)))),
                                    Literal(1), Literal(0)))
                uexpr = Call("if", (Call("and",
                                         (wpred,
                                          Call("is_null", (match,)))),
                                    Literal(1), Literal(0)))
            pp = P.Projection(
                {rid: ColumnRef(rid), tname: texpr, uname: uexpr}, cj)
            ct_name, cu_name = f"__sqCT{k}", f"__sqCU{k}"
            agg = P.Aggregation(
                [rid], [AggDesc("sum", tname, ct_name),
                        AggDesc("sum", uname, cu_name)], pp)
            state["plan"] = P.Join(
                "left", [rid], [rid], rid_plan, agg, unique_build=True,
                build_payload=[ct_name, cu_name])
            cur_cols.extend([rid, ct_name, cu_name])
            ct = Call("coalesce", (ColumnRef(ct_name), Literal(0)))
            cu = Call("coalesce", (ColumnRef(cu_name), Literal(0)))
            matched = Call("greater", (ct, Literal(0)))
            if mode == "exists":
                return matched
            return Call("if", (matched, Literal(1),
                               Call("if", (Call("greater",
                                               (cu, Literal(0))),
                                           Literal(None), Literal(0)))))

        def cross_scalar(cc: "_CrossCorrelated") -> Expr:
            """Correlated scalar aggregate — the APPLY operator
            (reference: TiDB rewrites apply to a join when possible;
            here: rid + CrossJoin + two-valued WHERE filter + per-rid
            aggregation + unique join-back)."""
            from ..ops.window import WindowDesc

            if cc.table not in self.sess.tables:
                raise Unsupported(f"unknown table {cc.table}")
            if len(cc.items) != 1:
                raise Unsupported("correlated scalar with >1 column")
            agg_e = cc.items[0][1]
            if not (isinstance(agg_e, Call)
                    and agg_e.func.lower() in ("count", "sum", "avg",
                                               "min", "max")):
                raise Unsupported(
                    f"correlated scalar aggregate {agg_e!r}")
            func = agg_e.func.lower()
            sub_schema, sub_rows = self.sess.tables[cc.table]
            k = state["n"]
            state["n"] += 1
            n = (len(next(iter(sub_rows.values()))) if sub_rows else 0)
            bname = f"__sqc{k}"
            if n == 0:
                blk = _empty_block(sub_schema, self.sess.device)
            else:
                blk = O.pytable_to_block(sub_rows, sub_schema,
                                         self.sess.device)
            blocks[bname] = blk
            colmap = {c: f"__sc{k}_{c}" for c in sub_schema}
            build_plan = P.Projection(
                {colmap[c]: ColumnRef(c) for c in sub_schema},
                P.TableScan(bname))

            def rwsub(e2: Expr) -> Expr:
                if isinstance(e2, ColumnRef):
                    if e2.qual is not None:
                        if e2.qual in cc.aliases \
                                and e2.name in sub_schema:
                            return ColumnRef(colmap[e2.name])
                        return qualify_outer(e2)
                    if e2.name in sub_schema:
                        return ColumnRef(colmap[e2.name])
                    return e2
                if isinstance(e2, Call):
                    return Call(e2.func,
                                tuple(rwsub(a) for a in e2.args))
                if isinstance(e2, Cast):
                    return Cast(rwsub(e2.arg), e2.target)
                return e2

            comb = dict(self.schema)
            comb.update({colmap[c]: t for c, t in sub_schema.items()})

            def rw_full(e2: Expr) -> Expr:
                return _coerce_temporal(_rewrite(e2), comb,
                                        getattr(self, "col_fsps", {}))

            rid = f"__rid{k}"
            rid_plan = P.Window([], [], [WindowDesc("row_number", rid)],
                                state["plan"])
            cap = state["rows"] * max(n, 1)
            if cap > 1 << 25:
                raise Unsupported("cross-decorrelation too large")
            node: P.PlanNode = P.CrossJoin(
                probe=rid_plan, build=build_plan, output_capacity=cap)
            if cc.where is not None:
                wpred: Expr = None  # type: ignore[assignment]
                for c2 in conjuncts(cc.where):
                    r2 = rwsub(c2)
                    wpred = r2 if wpred is None \
                        else Call("and", (wpred, r2))
                node = P.Selection(
                    Call("is_true", (rw_full(wpred),)), node)
            vname = f"__sqV{k}"
            star = (isinstance(agg_e.args[0], Literal)
                    and agg_e.args[0].value == "*") \
                if agg_e.args else True
            if star and func == "count":
                agg = P.Aggregation(
                    [rid], [AggDesc("count", None, vname)], node)
            else:
                aname = f"__sqA{k}"
                node = P.Projection(
                    {rid: ColumnRef(rid),
                     aname: rw_full(rwsub(agg_e.args[0]))}, node)
                agg = P.Aggregation(
                    [rid], [AggDesc(func, aname, vname)], node)
            state["plan"] = P.Join(
                "left", [rid], [rid], rid_plan, agg, unique_build=True,
                build_payload=[vname])
            cur_cols.extend([rid, vname])
            if func == "count":
                # missing rid = zero matching rows, and COUNT is 0, not
                # NULL, over an empty group
                return Call("coalesce", (ColumnRef(vname), Literal(0)))
            return ColumnRef(vname)

        def scalar_lower(e: Expr) -> Expr:
            res = self._run_subquery(sid_of(e.args[0]))
            if res[0] == "cross":
                if not res[1].has_agg:
                    raise Unsupported("correlated scalar subquery")
                return cross_scalar(res[1])
            blk, corr = res[1], res[2]
            if corr:
                raise Unsupported("correlated scalar subquery")
            tab = O.block_to_pytable(blk.compact())
            col = tab[blk.names[0]]
            if len(blk.names) != 1 or len(col) > 1:
                raise Unsupported("subquery is not scalar")
            return Literal(col[0] if col else None)

        def block_as_cross(blk, corr, x_row):
            """Row-constructor [NOT] IN over a materialized subquery:
            composite NULL semantics are PER-ELEMENT (a NULL field only
            makes the row comparison UNKNOWN when every other field
            matches — MySQL row equality is a three-valued AND), which
            the hash semi-join kinds cannot express; the cross path
            evaluates the exact predicate per pair."""
            if corr:
                raise Unsupported("correlated row-IN subquery")
            nm = f"__sqb{state['n']}"
            state["n"] += 1
            self._register_block(nm, blk)
            cc = _CrossCorrelated(
                nm, [(None, ColumnRef(c)) for c in blk.names],
                None, set())
            return cross_lower(cc, x_row, "in")

        def walk_expr(e):
            if isinstance(e, Call):
                if e.func == "__scalar_subq__":
                    return scalar_lower(e)
                if e.func in ("__in_subq__", "__not_in_subq__"):
                    res = self._run_subquery(sid_of(e.args[1]))
                    is_row = (isinstance(e.args[0], Call)
                              and e.args[0].func == "__row__")
                    if res[0] == "cross" and res[1].has_agg:
                        r = Call("equals", (qualify_outer(e.args[0]),
                                            cross_scalar(res[1])))
                    elif res[0] == "cross":
                        r = cross_lower(res[1], e.args[0], "in")
                    elif is_row:
                        r = block_as_cross(res[1], res[2], e.args[0])
                    else:
                        m = join_col("left_outer_semi_null_aware",
                                     e.args[0], res[1], res[2])
                        r = ColumnRef(m)
                    return (Call("not", (r,))
                            if e.func == "__not_in_subq__" else r)
                if e.func == "__exists_subq__":
                    res = self._run_subquery(sid_of(e.args[0]))
                    if res[0] == "cross":
                        if res[1].has_agg:
                            # a scalar aggregate always yields one row
                            return Literal(1)
                        return cross_lower(res[1], None, "exists")
                    blk, corr = res[1], res[2]
                    if not corr:
                        live = int(blk.num_rows().item()) > 0
                        return Literal(1 if live else 0)
                    return ColumnRef(join_col("left_outer_semi", None,
                                              blk, corr))
                if e.func == "__quant_subq__":
                    return self._fold_quant(e, cross_scalar)
                if e.func == "__subquery__":
                    raise Unsupported("bare subquery expression")
                return Call(e.func, tuple(walk_expr(a) for a in e.args))
            if isinstance(e, Cast):
                return Cast(walk_expr(e.arg), e.target)
            return e

        def conj_lower(c: Expr):
            """One WHERE conjunct: absorbed into a join -> None."""
            neg, inner = False, c
            if (isinstance(c, Call) and c.func == "not"
                    and isinstance(c.args[0], Call)
                    and c.args[0].func in ("__in_subq__",
                                           "__exists_subq__")):
                neg, inner = True, c.args[0]
            if isinstance(inner, Call) and inner.func == "__in_subq__":
                res = self._run_subquery(sid_of(inner.args[1]))
                is_row = (isinstance(inner.args[0], Call)
                          and inner.args[0].func == "__row__")
                if res[0] == "cross":
                    if res[1].has_agg:
                        r = Call("equals", (qualify_outer(inner.args[0]),
                                            cross_scalar(res[1])))
                    else:
                        r = cross_lower(res[1], inner.args[0], "in")
                    return Call("not", (r,)) if neg else r
                if is_row and neg:
                    # composite NOT IN: exact per-pair three-valued eval
                    r = block_as_cross(res[1], res[2], inner.args[0])
                    return Call("not", (r,))
                join("anti_null_aware" if neg else "semi",
                     inner.args[0], res[1], res[2])
                return None
            if isinstance(inner, Call) \
                    and inner.func == "__not_in_subq__" and not neg:
                res = self._run_subquery(sid_of(inner.args[1]))
                is_row = (isinstance(inner.args[0], Call)
                          and inner.args[0].func == "__row__")
                if res[0] == "cross":
                    return Call("not",
                                (cross_lower(res[1], inner.args[0],
                                             "in"),))
                if is_row:
                    r = block_as_cross(res[1], res[2], inner.args[0])
                    return Call("not", (r,))
                join("anti_null_aware", inner.args[0], res[1], res[2])
                return None
            if isinstance(inner, Call) \
                    and inner.func == "__exists_subq__":
                res = self._run_subquery(sid_of(inner.args[0]))
                if res[0] == "cross":
                    r = (Literal(1) if res[1].has_agg
                         else cross_lower(res[1], None, "exists"))
                    return Call("not", (r,)) if neg else r
                blk, corr = res[1], res[2]
                if not corr:
                    live = int(blk.num_rows().item()) > 0
                    keep = (not live) if neg else live
                    return (None if keep
                            else Call("equals", (Literal(0), Literal(1))))
                join("anti" if neg else "semi", None, blk, corr)
                return None
            return walk_expr(c)

        if where is not None:
            remaining = [r for r in map(conj_lower, conjuncts(where))
                         if r is not None]
            where = None
            for r in remaining:
                where = r if where is None else Call("and", (where, r))
        items = [(a, walk_expr(e)) for a, e in items]
        if having is not None:
            having = walk_expr(having)
        # joined semi columns extend the working schema for later phases
        for c in cur_cols:
            if c not in self.schema:
                self.schema[c] = dt.BOOL.with_nullable(True)
        return state["plan"], blocks, items, where, having

    def _fold_quant(self, e: Expr, cross_scalar=None) -> Expr:
        """x <op> ANY/ALL (subquery): MySQL's min/max + distinct-count
        rewrites, three-valued-correct, over the engine-executed
        subquery's result."""
        from . import oracle as O

        x, marker, opl, quantl = e.args
        op, quant = opl.value, quantl.value
        res = self._run_subquery(marker.args[0].value)
        if res[0] == "cross":
            if res[1].has_agg and cross_scalar is not None:
                # single-row scalar sub: ANY == ALL == plain comparison
                return Call(op, (x, cross_scalar(res[1])))
            raise Unsupported("correlated quantified subquery")
        if res[2]:
            raise Unsupported("correlated quantified subquery")
        blk = res[1]
        tab = O.block_to_pytable(blk.compact())
        if len(blk.names) != 1:
            raise Unsupported("quantified subquery with >1 column")
        vals = tab[blk.names[0]]
        nn = [v for v in vals if v is not None]
        has_null = len(nn) < len(vals)

        def or_null(expr: Expr) -> Expr:
            return Call("or", (expr, Literal(None))) if has_null else expr

        def and_null(expr: Expr) -> Expr:
            return Call("and", (expr, Literal(None))) if has_null else expr

        if op in ("greater", "greater_or_equals", "less",
                  "less_or_equals"):
            if not vals:
                return Literal(0 if quant == "any" else 1)
            if not nn:
                return Literal(None)
            lo, hi = min(nn), max(nn)
            if quant == "any":
                bound = lo if op.startswith("greater") else hi
                return or_null(Call(op, (x, Literal(bound))))
            bound = hi if op.startswith("greater") else lo
            return and_null(Call(op, (x, Literal(bound))))
        if op == "equals" and quant == "all":
            if not vals:
                return Literal(1)
            d = sorted(set(nn))
            if len(d) >= 2:
                return Literal(0)
            if not d:
                return Literal(None)
            return and_null(Call("equals", (x, Literal(d[0]))))
        if op == "not_equals" and quant == "any":
            if not vals:
                return Literal(0)
            d = sorted(set(nn))
            if len(d) >= 2:
                # x <> v1 OR x <> v2 (v1 != v2): TRUE unless x is NULL
                return Call("or",
                            (Call("not_equals", (x, Literal(d[0]))),
                             Call("not_equals", (x, Literal(d[1])))))
            if not d:
                return Literal(None)
            return or_null(Call("not_equals", (x, Literal(d[0]))))
        raise Unsupported(f"quantified {op} {quant} subquery")

    # -- plan construction
    def build_and_run(self, items, table, where, group_by, having,
                      order_by, limit):
        from ..plan.compiler import compile_fragment
        from . import oracle as O

        if self.engine_from is not None:
            plan, blocks, schema, fsps = self.engine_from
            self.schema = dict(schema)  # a COPY: lowering adds columns
            table_schema = self.schema
            self.col_fsps = fsps
        elif table is None:
            # SELECT <constants>: evaluate on a one-row dummy table
            schema = {"__one__": dt.INT64}
            blocks = {"dual": O.pytable_to_block({"__one__": [1]}, schema,
                                                 self.sess.device)}
            plan: P.PlanNode = P.TableScan("dual")
            table_schema = schema
        else:
            if table not in self.sess.tables:
                raise Unsupported(f"unknown table {table}")
            schema, rows = self.sess.tables[table]
            if not rows or not next(iter(rows.values()), None):
                # empty input: engine blocks need >=1 row; run with a
                # dummy row and then drop everything via a false filter
                pad = {c: [_dummy_value(schema[c])] for c in schema}
                blk = O.pytable_to_block(pad, schema, self.sess.device)
                blocks = {table: blk}
                plan = P.Selection(
                    Call("equals", (Literal(0), Literal(1))),
                    P.TableScan(table))
            else:
                blocks = {table: O.pytable_to_block(rows, schema,
                                                    self.sess.device)}
                plan = P.TableScan(table)
            # a COPY: subquery lowering extends the working schema and
            # must not leak phantom columns into the session table
            self.schema = dict(schema)
            table_schema = self.schema
            self.col_fsps = self.sess.fsps.get(table, {})

        # subquery predicates -> engine semi-family joins / scalar folds
        if _any_subq(where) or _any_subq(having) \
                or any(_any_subq(e) for _, e in items):
            plan, blocks, items, where, having = self._lower_subqueries(
                plan, blocks, items, where, having)
        if where is not None and (table is not None
                                  or self.engine_from is not None):
            plan = P.Selection(_as_bool(self._rw(where)), plan)

        if any(_has_over(e) for _, e in items):
            plan, items = self._build_window(plan, items, table_schema)

        agg_items = [(a, e) for a, e in items if _has_agg(e)]
        # resolve ORDER BY keys first: expressions/base columns become
        # hidden projection columns computed WITH the select list (base
        # columns are still in scope there)
        keys: List[SortKey] = []
        hidden: Dict[str, Expr] = {}
        out_names = [(alias or (e.name if isinstance(e, ColumnRef)
                                else f"c{i}"))
                     for i, (alias, e) in enumerate(items)]
        for si, (e, desc) in enumerate(order_by):
            if isinstance(e, ColumnRef) and e.name in out_names:
                keys.append(SortKey(e.name, desc=desc))
            elif isinstance(e, Literal) and isinstance(e.value, int) \
                    and 1 <= e.value <= len(out_names):
                keys.append(SortKey(out_names[e.value - 1], desc=desc))
            else:
                sn = f"__s{si}"
                hidden[sn] = e
                keys.append(SortKey(sn, desc=desc))

        if agg_items or group_by:
            if hidden:
                items = items + [(sn, he) for sn, he in hidden.items()]
            plan, names = self._build_agg(plan, items, group_by, having,
                                          table_schema)
            names = [n for n in names if not n.startswith("__s")]
        else:
            if having is not None:
                raise Unsupported("HAVING without aggregation")
            exprs: Dict[str, Expr] = {}
            names = []
            for i, (alias, e) in enumerate(items):
                # same naming rule as out_names above, so ORDER BY
                # position/name resolution agrees with the projection
                name = alias or (e.name if isinstance(e, ColumnRef)
                                 else f"c{i}")
                if name in exprs:  # duplicate output name: positionally
                    name = f"{name}#{i}"  # distinct (header is dropped)
                exprs[name] = self._rw(e)
                names.append(name)
            for sn, he in hidden.items():
                exprs[sn] = self._rw(he)
            plan = P.Projection(exprs, plan)

        if order_by:
            plan = (P.TopN(keys, limit, plan) if limit is not None
                    else P.Sort(keys, plan))
        elif limit is not None:
            plan = P.Limit(limit, plan)

        from ..plan.compiler import compile_fragment

        # fault injection: the reference's MPP failpoints fire at task
        # launch / mid-run (Flash/Mpp/MPPTask.cpp) — here the fragment
        # boundary is the analogous host orchestration point
        from ..runtime.failpoint import fail_point as _fp

        armed = [n for n in sorted(self.sess.armed_failpoints)
                 if (n.startswith("exception") or "failure" in n)
                 and not _FP_PAUSED(self.sess, n)]
        # only exception_* / *_failure points THROW; force_/ tuning
        # points (minimum_block_size_for_cross_join) alter behavior
        # without raising (reference FailPointHelper).  PAUSE points
        # (and hang_in_execution) block the task: run the pause under
        # the engine's cancel machinery with a watchdog — the reference
        # cancels a non-activating task from the alarm ("Can't find
        # task") and a hanging one from the hang monitor
        import threading as _th

        from ..runtime.cancel import (CancelFlag, QueryCancelled,
                                      cancel_scope)
        from ..runtime.errors import EngineError
        from ..runtime.failpoint import FailPoint as _FP

        # the reference's task alarm / hang monitor threshold is 10s
        # (mpp task monitor): a pause SHORTER than that just delays and
        # the query succeeds (async_server_alarm.test pauses 5 vs 15)
        ALARM_S = 10
        paused = [n for n, secs in sorted(
                      self.sess.armed_failpoints.items())
                  if (_FP.get(n).pause and secs > ALARM_S)
                  or n == "hang_in_execution"]
        for name in paused:
            flag = CancelFlag()
            timer = _th.Timer(0.5, flag.set)
            timer.start()
            try:
                with cancel_scope(flag):
                    if _FP.get(name).pause:
                        _fp(name)
                    else:
                        # hang_in_execution: a plain-enabled point that
                        # HANGS the task; spin on the engine's cancel
                        # checkpoint until the watchdog fires
                        import time as _time

                        from ..runtime.cancel import checkpoint as _ck

                        while True:
                            _ck()
                            _time.sleep(0.01)
            except QueryCancelled:
                if "register" in name or "make" in name:
                    raise EngineError(
                        f"Can't find task: the MPP task never became "
                        f"active under fail point {name}") from None
                raise EngineError(
                    "other error for mpp stream: MPP Task canceled "
                    "because it seems hangs") from None
            finally:
                timer.cancel()
        for name in armed:
            if "before" in name or "register" in name or "make" in name:
                _fp(name)
        import os as _os

        if _os.environ.get("TIFLASH_REFTEST_DISTRIBUTED") == "1" \
                and _distributable(plan) and not self.sess.tz_offset_us:
            # KNOWN GAP: tz-aware TIMESTAMP columns crossing distributed
            # fragments miss the session-timezone shift the evaluator
            # applies on read (group keys come back in raw UTC) — those
            # queries stay single-device until the shift rides the plan
            # run the corpus query through the REAL distributed path:
            # distribute_plan fragments it (shuffle/broadcast/skew
            # joins, split aggregation, laned windows) and it executes
            # over the session mesh — the reference's fullstack MPP
            # tests run against a multi-node cluster the same way
            out, flags = _run_distributed(plan, blocks, self.sess.device)
            self.sess.distributed_runs += 1
        else:
            out, flags = compile_fragment(plan)(blocks)
        for name in armed:
            if not ("before" in name or "register" in name
                    or "make" in name):
                _fp(name)
        from ..runtime.errors import (raise_runtime_errors,
                                      split_runtime_errors)

        from ..runtime.executor import read_flags

        overflows, rterrs = split_runtime_errors(flags)
        raise_runtime_errors(rterrs)
        for k, v in read_flags(overflows).items():
            assert not v, f"overflow at {k}"
        # keep only the selected output columns, in order
        return _project_names(out, names)

    def _build_agg(self, plan, items, group_by, having, schema):
        # pre-project: group keys + aggregate arguments become columns
        pre: Dict[str, Expr] = {}
        key_names: List[str] = []
        key_fp: Dict[str, str] = {}
        rollup = bool(getattr(self, "rollup", False))
        group_by = [self._qualify(g) for g in group_by]
        for i, g in enumerate(group_by):
            if isinstance(g, ColumnRef) and not rollup:
                key_names.append(g.name)
                pre[g.name] = g
            else:
                # under ROLLUP every key is a CLONE: Expand NULLs the
                # clone per grouping set while aggregate args keep
                # reading the original column (TiDB's Expand semantics —
                # the grand-total row still has sum(a) over real a)
                kn = f"__k{i}"
                pre[kn] = self._rw(g)
                key_names.append(kn)
                key_fp[_fingerprint(g)] = kn

        def sub_keys(e: Expr) -> Expr:
            """Rewrite select-list subtrees equal to a GROUP BY expression
            into refs to the key column (MySQL name resolution).  Under
            ROLLUP, references inside aggregate calls bind the ORIGINAL
            column, not the NULLed key clone."""
            if key_fp:
                kn = key_fp.get(_fingerprint(e))
                if kn is not None:
                    return ColumnRef(kn)
            if isinstance(e, Call):
                if rollup and _base_agg_name(e.func) in _AGG_FUNCS:
                    return e
                return Call(e.func, tuple(sub_keys(a) for a in e.args))
            if isinstance(e, Cast):
                return Cast(sub_keys(e.arg), e.target)
            return e

        items = [(alias, sub_keys(self._qualify(e)))
                 for alias, e in items]
        if having is not None:
            having = self._qualify(having)
        if rollup:
            # GROUP BY ... WITH ROLLUP -> Expand over the rollup grouping
            # sets + gid in the agg keys (reference: TiDB's Expand
            # executor feeding FunctionsGrouping, ops/expand.py).
            # grouping(k) lowers onto the engine's ModeNumericSet form:
            # 1 when the gid is NOT among the sets materializing k.
            member = {k: len(key_names) - i
                      for i, k in enumerate(key_names)}

            def rw_grouping(e: Expr) -> Expr:
                if isinstance(e, Call) and e.func == "grouping":
                    if len(e.args) != 1:
                        raise Unsupported("grouping() with several args")
                    a = sub_keys(e.args[0])
                    if not isinstance(a, ColumnRef) \
                            or a.name not in member:
                        raise Unsupported("grouping() of a non-key")
                    return Call("grouping",
                                (ColumnRef("groupingID"),
                                 *[Literal(j) for j in
                                   range(1, member[a.name] + 1)]))
                if isinstance(e, Call):
                    return Call(e.func,
                                tuple(rw_grouping(a) for a in e.args))
                if isinstance(e, Cast):
                    return Cast(rw_grouping(e.arg), e.target)
                return e

            items = [(alias, rw_grouping(e)) for alias, e in items]
            if having is not None:
                having = rw_grouping(having)
        aggs: List[AggDesc] = []
        post: Dict[str, Expr] = {}
        names: List[str] = []

        def lower_agg(e: Expr) -> Expr:
            """Replace aggregate calls inside e with refs to agg outputs."""
            if isinstance(e, Call) and _base_agg_name(e.func) in _AGG_FUNCS:
                fname = _base_agg_name(e.func)
                distinct = e.func.endswith("__distinct")
                if fname == "count" and (not e.args or (
                        isinstance(e.args[0], Literal)
                        and e.args[0].value == "*")):
                    an = f"__a{len(aggs)}"
                    aggs.append(AggDesc("count", None, an))
                    return ColumnRef(an)
                arg = e.args[0]
                if len(e.args) > 1:
                    raise Unsupported(f"multi-arg aggregate {fname}")
                if fname in ("sum", "avg") and isinstance(arg, ColumnRef):
                    at = schema.get(arg.name)
                    if at is not None and at.is_string:
                        # MySQL SUM/AVG over strings is double arithmetic;
                        # for ENUM the cast yields the 1-based index
                        # (sum_of_enum_pushdown.test)
                        arg = Cast(arg, dt.FLOAT64.with_nullable(True))
                if isinstance(arg, ColumnRef):
                    argn = arg.name
                else:
                    argn = f"__p{len(pre)}"
                    pre[argn] = self._rw(arg)
                func = {"stddev": "std", "stddev_pop": "std",
                        "variance": "var_pop", "stddev_samp": "std_samp",
                        "first_row": "any_value"}.get(fname, fname)
                if distinct:
                    if func == "count":
                        func = "count_distinct"
                    elif func == "group_concat":
                        func = "group_concat_distinct"
                    elif func in ("sum", "avg"):
                        func = func + "_distinct"
                    else:
                        raise Unsupported(f"{fname} DISTINCT")
                an = f"__a{len(aggs)}"
                aggs.append(AggDesc(func, argn, an))
                return ColumnRef(an)
            if isinstance(e, Call):
                return Call(e.func,
                            tuple(lower_agg(a) for a in e.args))
            if isinstance(e, Cast):
                return Cast(lower_agg(e.arg), e.target)
            return e

        any_cache: Dict[str, str] = {}

        def fix_bare(e: Expr) -> Expr:
            """Bare base-column refs alongside aggregates: MySQL (with
            ONLY_FULL_GROUP_BY off) returns any value from the group."""
            if isinstance(e, ColumnRef):
                if e.name in key_names or re.match(r"__a\d+$", e.name) \
                        or (rollup and e.name == "groupingID"):
                    return e
                an = any_cache.get(e.name)
                if an is None:
                    if e.name not in pre:
                        pre[e.name] = ColumnRef(e.name)
                    an = f"__a{len(aggs)}"
                    aggs.append(AggDesc("any_value", e.name, an))
                    any_cache[e.name] = an
                return ColumnRef(an)
            if isinstance(e, Call):
                return Call(e.func, tuple(fix_bare(a) for a in e.args))
            if isinstance(e, Cast):
                return Cast(fix_bare(e.arg), e.target)
            return e

        for i, (alias, e) in enumerate(items):
            name = alias or f"c{i}"
            if name in post:
                name = f"{name}#{i}"
            names.append(name)
            post[name] = self._rw(fix_bare(lower_agg(e)))

        for c in list(pre):
            if isinstance(pre[c], ColumnRef) and pre[c].name == c:
                pre[c] = ColumnRef(c)
        having_expr = None
        if having is not None:
            # HAVING resolves select aliases first (MySQL), then group
            # keys; aggregates it mentions lower into the same agg list
            # (before P.Aggregation is built), so `having sum(x) > 0`
            # works even when sum(x) is not selected.
            alias_post = dict(zip(names, (post[n] for n in names)))

            def sub_alias(e: Expr) -> Expr:
                if isinstance(e, ColumnRef) and e.name in alias_post \
                        and e.name not in key_names:
                    return alias_post[e.name]
                if isinstance(e, Call):
                    return Call(e.func,
                                tuple(sub_alias(a) for a in e.args))
                if isinstance(e, Cast):
                    return Cast(sub_alias(e.arg), e.target)
                return e

            having_expr = _as_bool(self._rw(
                fix_bare(lower_agg(sub_keys(sub_alias(having))))))
        # pass every base column the pre-projection mentions through —
        # AFTER having lowering, whose aggregates add pre args too
        needed = set()

        def cols_of(e: Expr):
            if isinstance(e, ColumnRef):
                needed.add(e.name)
            elif isinstance(e, Call):
                for a in e.args:
                    cols_of(a)
            elif isinstance(e, Cast):
                cols_of(e.arg)

        for e in pre.values():
            cols_of(e)
        for an in [a.arg for a in aggs if a.arg]:
            needed.add(an)
        for c in needed - set(pre):
            if c in schema:
                pre[c] = ColumnRef(c)
        plan = P.Projection(pre, plan) if pre else plan
        agg_keys = list(key_names)
        if rollup:
            sets = [key_names[:j]
                    for j in range(len(key_names), -1, -1)]
            plan = P.Expand([list(s) for s in sets], plan)
            agg_keys.append("groupingID")
        plan = P.Aggregation(agg_keys, aggs, plan)
        if having_expr is not None:
            plan = P.Selection(having_expr, plan)
        plan = P.Projection(post, plan)
        return plan, names


def _fingerprint(e: Expr) -> str:
    if isinstance(e, ColumnRef):
        return f"col:{e.name}"
    if isinstance(e, Literal):
        return f"lit:{type(e.value).__name__}:{e.value!r}"
    if isinstance(e, Cast):
        return f"cast:{e.target!r}:{_fingerprint(e.arg)}"
    if isinstance(e, Call):
        return f"{e.func}({','.join(_fingerprint(a) for a in e.args)})"
    return repr(e)


def _dummy_value(t: dt.DataType):
    if t.is_decimal:
        return D(0)
    if t.kind is dt.TypeKind.DATE:
        return datetime.date(2000, 1, 1)
    if t.kind is dt.TypeKind.DATETIME:
        return datetime.datetime(2000, 1, 1)
    if t.is_string:
        return ""
    if t.kind in (dt.TypeKind.FLOAT32, dt.TypeKind.FLOAT64):
        return 0.0
    return 0


def _empty_block(schema: Dict[str, dt.DataType], device):
    """A table with no rows as the engine takes it: one dummy row, dead."""
    from . import oracle as O

    pad = {c: [_dummy_value(t)] for c, t in schema.items()}
    return O.pytable_to_block(pad, schema, device).and_sel(
        torch.zeros(1, dtype=torch.bool, device=device))


def _base_agg_name(f: str) -> str:
    return f[:-len("__distinct")] if f.endswith("__distinct") else f


def _has_agg(e: Expr) -> bool:
    if isinstance(e, Call):
        if _base_agg_name(e.func) in _AGG_FUNCS:
            return True
        return any(_has_agg(a) for a in e.args)
    if isinstance(e, Cast):
        return _has_agg(e.arg)
    return False


# functions whose date/datetime arguments MySQL implicitly parses from
# strings; (name match, which args are temporal)
_TEMPORAL_PREFIXES = ("date_add_", "date_sub_")
_TEMPORAL_ARG0 = {"date", "last_day", "to_days", "to_seconds", "day",
                  "day_of_month", "dayofmonth", "day_of_week", "dayofweek",
                  "day_of_year", "dayofyear", "month", "year", "quarter",
                  "week", "weekofyear", "week_of_year", "weekday",
                  "yearweek", "unix_timestamp", "hour", "minute", "second",
                  "microsecond", "date_format"}
# dayname/monthname take their STRING argument raw: the engine's text
# LUT handles partial-zero dates a DATE cast cannot carry
_TEMPORAL_ALL_ARGS = {"datediff"}


def _expand_row_cmp(fn: str, lhs, rhs):
    """Row-constructor comparison: (a,b) = (c,d) is the conjunction of
    element equalities; != the negation; ordered comparisons use the
    lexicographic expansion."""
    if not (isinstance(rhs, Call) and rhs.func == "__row__"
            and len(rhs.args) == len(lhs.args)):
        raise Unsupported("row comparison with non-row operand")
    la, ra = lhs.args, rhs.args
    if fn in ("equals", "not_equals", "null_eq"):
        base = fn if fn != "not_equals" else "equals"
        conj = None
        for x, y in zip(la, ra):
            c = Call(base, (x, y))
            conj = c if conj is None else Call("and", (conj, c))
        return Call("not", (conj,)) if fn == "not_equals" else conj
    # lexicographic: (a,b) < (c,d) == a<c OR (a=c AND b<d)
    strict = fn.rstrip("_or_equals") if fn.endswith("_or_equals") else fn
    out = None
    for i in range(len(la)):
        conj = None
        for j in range(i):
            c = Call("equals", (la[j], ra[j]))
            conj = c if conj is None else Call("and", (conj, c))
        last = Call(fn if i == len(la) - 1 else strict, (la[i], ra[i]))
        term = last if conj is None else Call("and", (conj, last))
        out = term if out is None else Call("or", (out, term))
    return out


_SUBQ_MARKERS = {"__in_subq__", "__not_in_subq__", "__exists_subq__",
                 "__quant_subq__", "__subquery__"}


def _any_subq(e) -> bool:
    if e is None:
        return False
    if isinstance(e, Call):
        return (e.func in _SUBQ_MARKERS
                or any(_any_subq(a) for a in e.args))
    if isinstance(e, Cast):
        return _any_subq(e.arg)
    return False


def _has_over(e: Expr) -> bool:
    if isinstance(e, Call):
        return e.func == "__over__" or any(_has_over(a) for a in e.args)
    if isinstance(e, Cast):
        return _has_over(e.arg)
    return False


def _is_temporal_fn(f: str) -> bool:
    return f in _TEMPORAL_ARG0 or f in _TEMPORAL_ALL_ARGS or \
        f.startswith(_TEMPORAL_PREFIXES)


def _swap_fn(e: Expr, frm: str, to: str) -> Expr:
    if isinstance(e, Call):
        args = tuple(_swap_fn(a, frm, to) for a in e.args)
        return Call(to if e.func == frm else e.func, args)
    if isinstance(e, Cast):
        return Cast(_swap_fn(e.arg, frm, to), e.target)
    return e


def _coerce_temporal(e: Expr, schema: Dict[str, dt.DataType],
                     col_fsps: Optional[Dict[str, int]] = None) -> Expr:
    """Insert the implicit string->temporal casts MySQL performs when a
    date function receives string input, and round REAL interval
    amounts to integers (MySQL ADDDATE(d, 1.6) adds 2 days)."""

    def col_type(x: Expr):
        if isinstance(x, ColumnRef):
            return schema.get(x.name)
        if isinstance(x, Cast):
            return x.target
        return None

    def fix_arg(x: Expr) -> Expr:
        if isinstance(x, Literal) and x.value is None:
            return Literal(None, dt.DATETIME.with_nullable(True))
        if isinstance(x, Literal) and isinstance(x.value, str):
            from ..core.dtypes import ZeroDateTime as _ZDT
            from ..expr.functions import mysql_str_to_datetime

            v = mysql_str_to_datetime(x.value)
            if v is None:
                # MySQL: an unparseable datetime string argument -> NULL
                return Literal(None, dt.DATETIME.with_nullable(True))
            if isinstance(v, _ZDT):
                return Literal(v, dt.DATETIME.with_nullable(True))
            if (v.hour, v.minute, v.second, v.microsecond) == (0, 0, 0, 0) \
                    and len(x.value.strip()) <= 10:
                return Literal(v.date())
            return Literal(v)
        t = col_type(x)
        if t is not None and (t.is_string or t.is_integer or t.is_decimal
                              or t.is_float):
            return Cast(x, dt.DATETIME.with_nullable(True))
        if isinstance(x, Literal) and isinstance(x.value, int):
            return Cast(x, dt.DATETIME.with_nullable(True))
        return x

    def walk(x: Expr) -> Expr:
        if isinstance(x, Cast):
            return Cast(walk(x.arg), x.target)
        if not isinstance(x, Call):
            return x
        args = [walk(a) for a in x.args]
        f = x.func
        if f in ("equals", "not_equals", "less", "less_or_equals",
                 "greater", "greater_or_equals") and len(args) == 2:
            ts = [col_type(a) for a in args]
            for i in (0, 1):
                o = 1 - i
                if (ts[i] is not None and ts[i].mysql_year
                        and ts[o] is not None and ts[o].is_temporal):
                    # YEAR vs DATE compares as year-01-01
                    # (compare_year_with_date.test)
                    args[i] = Call("makedate", (args[i], Literal(1)))
        if f in ("plus", "minus", "multiply", "divide") and len(args) == 2:
            # TIME in numeric arithmetic uses its MySQL numeric form
            # HHMMSS.ffffff ('00:10:10.123456' + 0.001 = 1010.124456) —
            # TiDB wraps the TIME operand in a cast; this front-end
            # plays TiDB's role (reference: generated_columns2.test)
            for i in (0, 1):
                t = col_type(args[i])
                if t is not None and t.kind is dt.TypeKind.DURATION:
                    args[i] = Cast(args[i],
                                   dt.Decimal(18, 6, nullable=True))
        if (f == "unix_timestamp" and len(args) == 1
                and isinstance(args[0], ColumnRef)
                and (col_fsps or {}).get(args[0].name, 0) > 0):
            # DATETIME(fsp>0): UNIX_TIMESTAMP types DECIMAL(.., fsp)
            # (unixTimeStamp.test)
            fsp = (col_fsps or {})[args[0].name]
            return Cast(Call("unix_timestamp_decimal", (args[0],)),
                        dt.Decimal(10 + fsp, fsp, nullable=True))
        if _is_temporal_fn(f) and args:
            # zero-arg calls fall through: the engine rejects them with
            # 'Incorrect parameter count' (day_of_month.test)
            args[0] = fix_arg(args[0])
            if f in _TEMPORAL_ALL_ARGS and len(args) > 1:
                args[1] = fix_arg(args[1])
            if f.startswith(_TEMPORAL_PREFIXES) and len(args) > 1:
                at = col_type(args[1])
                if (at is not None and (at.is_float or at.is_decimal)) or (
                        isinstance(args[1], Literal)
                        and isinstance(args[1].value, (float, D))):
                    args[1] = Call("round", (args[1],))
        return Call(f, tuple(args))

    return walk(e)


_BOOL_FUNCS = {"equals", "not_equals", "less", "less_or_equals", "greater",
               "greater_or_equals", "null_eq", "and", "or", "not", "xor",
               "like", "ilike", "regexp_like", "in", "is_null",
               "is_not_null", "is_true", "is_not_true", "is_false",
               "is_not_false", "isnull"}


def _as_bool(e: Expr) -> Expr:
    """MySQL WHERE truthiness: a non-boolean expression is true iff
    non-zero (and non-NULL)."""
    if isinstance(e, Call) and e.func in _BOOL_FUNCS:
        if e.func in ("and", "or"):
            return Call(e.func, tuple(_as_bool(a) for a in e.args))
        return e
    return Call("not_equals", (e, Literal(0)))


def _rewrite(e: Expr) -> Expr:
    """Post-parse fixups: operator aliases, interval lowering."""
    if isinstance(e, Cast):
        return Cast(_rewrite(e.arg), e.target)
    if not isinstance(e, Call):
        return e
    args = tuple(_rewrite(a) for a in e.args)
    f = _FUNC_RENAME.get(e.func, e.func)
    # date_add(x, interval n unit) -> date_add_<unit>s(x, n)
    if f in ("date_add", "date_sub", "adddate", "subdate") and len(args) == 2:
        iv = args[1]
        if isinstance(iv, Call) and iv.func == "__interval__":
            unit = iv.args[1].value
            op = "date_add" if f in ("date_add", "adddate") else "date_sub"
            return Call(f"{op}_{unit}s", (args[0], iv.args[0]))
        if f in ("adddate", "subdate"):
            # adddate(d, n) = add n days
            op = "date_add" if f == "adddate" else "date_sub"
            return Call(f"{op}_days", args)
    if f == "timestampdiff" and len(args) == 3:
        # first argument is a bare unit keyword, not a column
        u = args[0]
        if isinstance(u, ColumnRef):
            args = (Literal(u.name),) + args[1:]
    return Call(f, args)


# ------------------------------------------------- output comparison

def _project_names(block, names: List[str]):
    from ..core.block import Block

    cols = dict(zip(block.names, block.columns))
    missing = [n for n in names if n not in cols]
    if missing:
        raise AssertionError(f"output missing columns {missing}; "
                             f"has {block.names}")
    return Block(names=tuple(names),
                 columns=tuple(cols[n] for n in names),
                 sel=block.sel, clustered_by=())


def _block_rows(block) -> List[list]:
    from . import oracle as O

    t = O.block_to_pytable(block.compact())
    cols = [t[n] for n in block.names]
    return [list(r) for r in zip(*cols)] if cols else []


def _parse_expected(lines: List[str]) -> List[List[str]]:
    """Expected output -> rows of cell strings (header dropped).

    Two client formats (same as run-test.py's MySQLCompare): bordered
    ``+--|--+`` tables, and borderless tab-separated output.  Returns
    (rows, bordered)."""
    bordered = any(ln.lstrip().startswith("+") for ln in lines)
    rows = []
    if bordered:
        for ln in lines:
            ln = ln.rstrip()
            if not ln or ln.lstrip().startswith("+"):
                continue
            if not ln.lstrip().startswith("|"):
                continue
            cells = [c.strip() for c in ln.strip().strip("|").split("|")]
            rows.append(cells)
    else:
        for ln in lines:
            if not ln.strip():
                continue
            rows.append([c.strip() for c in ln.split("\t")])
    return (rows[1:] if rows else []), bordered  # first row = header


def _cell_matches(got, cell: str, dtype: dt.DataType) -> bool:
    if cell == "NULL":
        return got is None
    if got is None:
        return False
    if dtype.is_decimal:
        try:
            return D(cell) == got
        except Exception:
            return False
    k = dtype.kind
    if k in (dt.TypeKind.FLOAT32, dt.TypeKind.FLOAT64):
        try:
            want = float(cell)
        except ValueError:
            return False
        g = float(got)
        if want == 0:
            return abs(g) < 1e-9
        if abs(want) < 2.2250738585072014e-308 and g == 0.0:
            # recorded answer is an f64 DENORMAL: the reference engine
            # flushes f64 denormals to +-0 (its documented deviation);
            # the recorded tables are held the same way here
            return True
        tol = 1e-5 if k is dt.TypeKind.FLOAT32 else 1e-9
        return abs(g - want) <= tol * max(abs(want), abs(g))
    if k is dt.TypeKind.DATE:
        return str(got) == cell
    if k is dt.TypeKind.DATETIME:
        from ..core.dtypes import CivilDateTime as _CDT
        from ..core.dtypes import ZeroDateTime as _ZDT

        if isinstance(got, _CDT):
            got_s = str(got)
            if got_s == cell or got_s.split(".")[0] == cell:
                return True
            return (got.hh, got.mi, got.ss, got.us) == (0, 0, 0, 0) \
                and f"{got.y:04d}-{got.m:02d}-{got.d:02d}" == cell

        if isinstance(got, _ZDT):
            got_s = str(got)
            # a DATE-parsed source prints the bare zero date; the
            # front-end types everything DATETIME, so accept both forms
            return (got_s == cell or got_s.split(".")[0] == cell
                    or (got.tod_us == 0 and cell == "0000-00-00"))
        # normalize fractional seconds (strip trailing zeros of the
        # fraction ONLY — naive rstrip eats the seconds' zeros)
        def norm(s: str) -> str:
            if "." not in s:
                return s
            head, frac = s.rsplit(".", 1)
            frac = frac.rstrip("0")
            return head + ("." + frac if frac else "")
        # f-strings, not strftime: glibc %Y prints year 7 as "7", the
        # corpus records "0007" (date_add.test 0007-11-26)
        base = (f"{got.year:04d}-{got.month:02d}-{got.day:02d}")
        if got.microsecond:
            gs = (f"{base} {got.hour:02d}:{got.minute:02d}:"
                  f"{got.second:02d}.{got.microsecond:06d}")
        else:
            gs = (f"{base} {got.hour:02d}:{got.minute:02d}:"
                  f"{got.second:02d}")
            if got.time() == datetime.time(0) and " " not in cell:
                # MySQL string-in/string-out date functions print the
                # date-only form; a midnight datetime matches it
                return base == cell
        return norm(gs) == norm(cell)
    if k is dt.TypeKind.DURATION:
        try:
            return _parse_duration_us(cell) == int(got)
        except Unsupported:
            return False
    if dtype.is_string:
        if str(got) == cell:
            return True
        # the reference's expected files hold client-escaped text
        if str(got) == cell.replace("\\\\", "\\"):
            return True
        # table borders cannot represent a value's outer whitespace —
        # the expected cell arrives pre-stripped (str_to_date.test
        # ' 1/Apr/2016 ')
        return str(got).strip() == cell
    if k is dt.TypeKind.BOOL:
        return str(int(got)) == cell
    try:
        return int(cell) == int(got)
    except ValueError:
        return False


def _compare(got_rows: List[list], want_rows: List[List[str]],
             block, ordered: bool, stmt: str):
    dtypes = [c.dtype for c in block.columns]
    if len(got_rows) != len(want_rows):
        raise AssertionError(
            f"row count: got {len(got_rows)} want {len(want_rows)}\n"
            f"query: {stmt}\ngot: {got_rows[:8]}\nwant: {want_rows[:8]}")

    def row_ok(g, w):
        if len(w) < len(g) and all(isinstance(x, str) for x in w):
            # borderless recordings lose TRAILING empty cells (the tab
            # separators get whitespace-stripped in the reference files:
            # remote_read_virtual_column.test row `2\t\t` recorded `2`)
            w = w + [""] * (len(g) - len(w))
        return len(g) == len(w) and all(
            _cell_matches(gv, wc, t) for gv, wc, t in zip(g, w, dtypes))

    def match_unordered():
        remaining = list(want_rows)
        for g in got_rows:
            for i, w in enumerate(remaining):
                if row_ok(g, w):
                    remaining.pop(i)
                    break
            else:
                raise AssertionError(
                    f"unmatched row\nquery: {stmt}\ngot: {g}\n"
                    f"want one of: {remaining[:8]}")

    if ordered:
        if all(row_ok(g, w) for g, w in zip(got_rows, want_rows)):
            return
        # the reference's run-test.py compares rows SORTED (its fuzz
        # mode) — compare_null.test records two contradictory orders for
        # the same ORDER BY query — so fall back to unordered matching
        match_unordered()
    else:
        match_unordered()


# ------------------------------------------------------- .test files

def parse_test_file(path: str) -> List[Tuple[str, Optional[List[str]]]]:
    """-> [(statement, expected_lines|None)] in file order."""
    out = []
    cur: Optional[str] = None
    cur_expected: List[str] = []
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            s = line.strip()
            if s.startswith("#") or not s:
                continue
            if s.startswith("mysql>"):
                if cur is not None:
                    out.append((cur, cur_expected or None))
                cur = s[len("mysql>"):].strip()
                cur_expected = []
            elif s.startswith(("func>", ">> ", "=> ", "SLEEP", "curl>",
                               "mysql_bin_as_hex>")):
                if cur is not None:
                    out.append((cur, cur_expected or None))
                    cur, cur_expected = None, []
                if s.startswith("mysql_bin_as_hex>"):
                    raise Unsupported("binary-as-hex client mode")
                if s.startswith(("=> DBGInvoke __", ">> DBGInvoke __")):
                    # debug-DSL failpoint arming rides the statement
                    # stream (mpp_fail.test fault injection)
                    out.append(("__dbg__ " + s[3:], None))
            else:
                if cur is not None:
                    # multi-line INSERT ... VALUES continuation: the
                    # statement so far dangles on 'values'/',' and the
                    # line looks like a tuple (json_object.test)
                    dangling = re.sub(r"\s*#NO_UNESCAPE\s*$", "",
                                      cur.rstrip())
                    if (not cur_expected and s.startswith("(")
                            and (dangling.lower().endswith("values")
                                 or dangling.endswith(","))):
                        cur = cur + " " + s
                        continue
                    # bordered table rows OR tab-separated client output
                    cur_expected.append(line)
    if cur is not None:
        out.append((cur, cur_expected or None))
    return out


def tests_root_of(path: str) -> Optional[str]:
    """The corpus's ``tests/`` directory above a ``.test`` file (the one
    holding ``fullstack-test``), which SOURCE paths are relative to."""
    import os

    parts = os.path.abspath(path).split(os.sep)
    if "fullstack-test" not in parts:
        return None
    return os.sep.join(parts[:len(parts) - 1 - parts[::-1].index("fullstack-test")])


def run_test_file(path: str, device="cuda") -> int:
    """Run one .test file on ``device``; returns the number of checked
    queries.  Raises Unsupported for out-of-surface files,
    AssertionError for real mismatches."""
    sess = RefTestSession(device, tests_root_of(path))
    for stmt, expected in parse_test_file(path):
        sess.run_statement(stmt, expected)
    return sess.checked
