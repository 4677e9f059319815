"""The fused scan's row function as data: a small tree of int32 row ops.

Counterpart of the closures that the reference traces into its Pallas
kernel (``tiflash_tpu/ops/stream_fuse.py``, ``make_tile_values``, called
per (64, 128) tile at ``ops/pallas/stream_agg.py:88``).  ``stream_fuse``
builds one ``TileProgram`` per fused aggregation:

- ``live``: the row's live mask (``__sel`` and every predicate);
- ``key_slot``: the mixed-radix slot of the group keys (``pack_keys_direct``);
  dead rows take slot ``n_slots`` outside the program;
- ``planes``: the packed int31 accumulation planes (parts, limb split and
  first-fit plane packing already applied).

Two back ends read the same nodes.  ``evaluate`` runs the program in
torch over a tile of int32 columns and gives exactly what the closures
gave.  ``emit_cuda`` writes the row functions as plain C++ on scalars;
the generated kernel (``csrc/stream_tile.cu.in``) loads the raw columns
and accumulates, and the same text compiles with a host compiler.

Integer semantics: every int value is an int32 that wraps, as torch's
int32 ops do (C++ side: ``unsigned`` arithmetic); ``shr`` is arithmetic;
compares are signed.  Python scalars meeting an int32 tensor wrap to
int32 in torch, so constants and launch parameters are stored wrapped.

Launch parameters (``param``) carry the literal values of predicates:
compare constants, IN-set members, dictionary codes.  They are not part
of the generated source, so a plan that differs only in those literals
reuses the built kernel.  Everything else (operators, shifts, constant
multipliers, S, L, input storage) is structure.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Tile = Dict[str, torch.Tensor]

_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}
_SWAP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
_ARITH = {"add": "+", "sub": "-", "mul": "*"}
_PY_CMP = {"eq": operator.eq, "ne": operator.ne, "lt": operator.lt, "le": operator.le,
           "gt": operator.gt, "ge": operator.ge}
_PY_ARITH = {"add": operator.add, "sub": operator.sub, "mul": operator.mul}

# how a tile input is read from its array: the value itself (int32 or
# bool as 0/1, an int64 narrowed to its low 32 bits), or an int64's low
# 31 bits / its bits 31..62
CONVERSIONS = ("id", "w0", "w1")
# array storage -> the C++ type the kernel loads
STORAGE_CTYPE = {"i32": "int", "u8": "unsigned char", "i64": "long long"}
STORAGE_OF_DTYPE = {torch.int32: "i32", torch.bool: "u8", torch.int64: "i64"}


def wrap32(v: int) -> int:
    """``v`` modulo 2^32 as a signed int32."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


@dataclasses.dataclass(frozen=True, eq=False)
class Node:
    """One row operation: compares, ``land``/``lor``/``lnot``, ``isin``,
    ``nz`` and ``bconst`` yield a bool, the others an int32.  ``value``:
    the constant (wrapped int32), the shift amount, the mask of ``and``,
    or the launch parameter's index; ``key``: the tile input of ``in``."""

    op: str
    args: Tuple["Node", ...] = ()
    value: int = 0
    key: str = ""

    # structural hash and equality; the hash is computed once (from the
    # operands' own), so walking a program costs O(nodes)
    def __post_init__(self):
        object.__setattr__(self, "_hash", hash((self.op, self.value, self.key, self.args)))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, Node) or self._hash != other._hash:
            return False
        return (self.op, self.value, self.key, self.args) == (
            other.op, other.value, other.key, other.args)


# every node the builders made, so that equal nodes are one object: a
# program's structure then compares and hashes in O(1) per node, and the
# kernel cache (``ops/cuda/stream_tile.py``) finds a plan shape seen before
# without walking it
_INTERNED: Dict[Node, Node] = {}


def _node(op: str, args: Tuple[Node, ...] = (), value: int = 0, key: str = "") -> Node:
    n = Node(op, args, value, key)
    return _INTERNED.setdefault(n, n)


# ---------------------------------------------------------------------------
# builders (constant-fold where both sides are constants)
# ---------------------------------------------------------------------------


def inp(key: str) -> Node:
    return _node("in", key=key)


def const(v: int) -> Node:
    return _node("const", value=wrap32(v))


def bconst(b: bool) -> Node:
    return _node("bconst", value=int(bool(b)))


def _is_const(n: Node) -> bool:
    return n.op == "const"


def add(a: Node, b: Node) -> Node:
    if _is_const(a) and _is_const(b):
        return const(a.value + b.value)
    return _node("add", (a, b))


def sub(a: Node, b: Node) -> Node:
    if _is_const(a) and _is_const(b):
        return const(a.value - b.value)
    return _node("sub", (a, b))


def mul(a: Node, b: Node) -> Node:
    if _is_const(a) and _is_const(b):
        return const(a.value * b.value)
    return _node("mul", (a, b))


def neg(a: Node) -> Node:
    return const(-a.value) if _is_const(a) else _node("neg", (a,))


def shl(a: Node, k: int) -> Node:
    """``a << k``; as torch's int32 shift, 0 from k = 32 on."""
    if k < 0:
        raise ValueError(f"negative shift {k}")
    if k == 0:
        return a
    if k >= 32:
        return const(0)
    return const(a.value << k) if _is_const(a) else _node("shl", (a,), k)


def shr(a: Node, k: int) -> Node:
    """Arithmetic ``a >> k``; as torch's int32 shift, the sign from k = 31 on."""
    if k < 0:
        raise ValueError(f"negative shift {k}")
    if k == 0:
        return a
    k = min(k, 31)
    return const(a.value >> k) if _is_const(a) else _node("shr", (a,), k)


def band(a: Node, mask: int) -> Node:
    return const(a.value & mask) if _is_const(a) else _node("and", (a,), wrap32(mask))


def cmp(op: str, a: Node, b: Node) -> Node:
    if op not in _CMP:
        raise ValueError(f"unknown compare {op}")
    return _node(op, (a, b))


def land(a: Node, b: Node) -> Node:
    if a.op == "bconst":
        return b if a.value else a
    if b.op == "bconst":
        return a if b.value else b
    return _node("land", (a, b))


def lor(a: Node, b: Node) -> Node:
    if a.op == "bconst":
        return a if a.value else b
    if b.op == "bconst":
        return b if b.value else a
    return _node("lor", (a, b))


def lnot(a: Node) -> Node:
    return bconst(not a.value) if a.op == "bconst" else _node("lnot", (a,))


def where(c: Node, a: Node, b: Node) -> Node:
    if c.op == "bconst":
        return a if c.value else b
    return _node("where", (c, a, b))


def isin(a: Node, members: Sequence[Node]) -> Node:
    return _node("isin", (a, *members))


def nz(a: Node) -> Node:
    return _node("nz", (a,))


def b2i(c: Node) -> Node:
    return const(c.value) if c.op == "bconst" else _node("b2i", (c,))


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Array:
    """One column the kernel reads: its name in the input dict and its
    storage (``i32``, ``u8`` for bool, ``i64``)."""

    name: str
    storage: str


@dataclasses.dataclass(frozen=True)
class TileInput:
    """A tile input ``key`` read from array ``array`` by ``conversion``."""

    key: str
    array: int
    conversion: str


@dataclasses.dataclass
class TileProgram:
    arrays: Tuple[Array, ...]
    inputs: Tuple[TileInput, ...]
    live: Node
    key_slot: Node
    planes: Tuple[Node, ...]
    n_slots: int
    params: Tuple[int, ...]   # launch parameter values, wrapped int32

    def as_tile_function(self):
        """The old ``make_tile_values(tile, in_bounds)`` contract."""
        def make_tile_values(tile: Tile, in_bounds: torch.Tensor):
            return evaluate(self, tile, in_bounds)
        return make_tile_values

    def arrays_read(self, roots: Sequence[Node]) -> List[int]:
        """The arrays the nodes ``roots`` read, by index."""
        return _arrays_of(self, roots)

    def mask_arrays(self) -> List[int]:
        """The arrays ``live`` and ``key_slot`` read: every row loads them."""
        return _arrays_of(self, [self.live, self.key_slot])

    def agg_arrays(self) -> List[int]:
        """The arrays only the planes read: loaded where a row is live."""
        mask = set(self.mask_arrays())
        return [a for a in _arrays_of(self, list(self.planes)) if a not in mask]


class ProgramBuilder:
    """Collects arrays, tile inputs and launch parameters while the fuse
    compiles its plan."""

    def __init__(self):
        self.arrays: List[Array] = []
        self.inputs: Dict[str, TileInput] = {}
        self.params: List[int] = []

    def array(self, name: str, storage: str) -> int:
        if storage not in STORAGE_CTYPE:
            raise ValueError(f"unknown storage {storage}")
        for i, a in enumerate(self.arrays):
            if a.name == name:
                if a.storage != storage:
                    raise ValueError(f"array {name} read as {a.storage} and {storage}")
                return i
        self.arrays.append(Array(name, storage))
        return len(self.arrays) - 1

    def bind(self, key: str, array: str, storage: str, conversion: str = "id") -> None:
        """Tile input ``key`` reads ``array`` (``storage``) by ``conversion``."""
        if conversion not in CONVERSIONS:
            raise ValueError(f"unknown conversion {conversion}")
        if conversion != "id" and storage != "i64":
            raise ValueError(f"{conversion} splits an int64 array, not {storage}")
        self.inputs[key] = TileInput(key, self.array(array, storage), conversion)

    def param(self, v: int) -> Node:
        self.params.append(wrap32(v))
        return _node("param", value=len(self.params) - 1)

    def build(self, live: Node, key_slot: Node, planes: Sequence[Node],
              n_slots: int) -> TileProgram:
        prog = TileProgram(tuple(self.arrays), tuple(self.inputs.values()), live,
                           key_slot, tuple(planes), int(n_slots), tuple(self.params))
        missing = sorted({n.key for n in _walk([live, key_slot, *planes])
                          if n.op == "in"} - set(self.inputs))
        if missing:
            raise ValueError(f"tile inputs without an array: {missing}")
        return prog


def conjuncts(n: Node) -> List[Node]:
    """The terms of ``n`` as a chain of ``land``: a row is live where
    every one holds."""
    if n.op == "land":
        return conjuncts(n.args[0]) + conjuncts(n.args[1])
    return [n]


def _walk(roots: Sequence[Node]) -> List[Node]:
    """Every distinct node under ``roots``, operands before users."""
    seen: Dict[Node, None] = {}

    def visit(n: Node):
        if n in seen:
            return
        for a in n.args:
            visit(a)
        seen[n] = None

    for r in roots:
        visit(r)
    return list(seen)


def _arrays_of(prog: TileProgram, roots: Sequence[Node]) -> List[int]:
    by_key = {t.key: t.array for t in prog.inputs}
    out: List[int] = []
    for n in _walk(roots):
        if n.op == "in" and by_key[n.key] not in out:
            out.append(by_key[n.key])
    return sorted(out)


# ---------------------------------------------------------------------------
# torch back end
# ---------------------------------------------------------------------------


def stage(prog: TileProgram, arrays: Dict[str, torch.Tensor]) -> Tile:
    """The tile of int32 columns the program reads, from its raw arrays."""
    tile: Tile = {}
    for t in prog.inputs:
        a = prog.arrays[t.array]
        x = arrays[a.name]
        if STORAGE_OF_DTYPE.get(x.dtype) != a.storage:
            raise TypeError(f"array {a.name} is {x.dtype}, the program reads {a.storage}")
        if t.conversion == "w0":
            x = x & ((1 << 31) - 1)
        elif t.conversion == "w1":
            x = x >> 31
        tile[t.key] = x if x.dtype == torch.int32 else x.to(torch.int32)
    return tile


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, bool):
        return torch.full(like.shape, v, dtype=torch.bool, device=like.device)
    return torch.full(like.shape, v, dtype=torch.int32, device=like.device)


def evaluate_nodes(roots: Sequence[Node], tile: Tile, params: Sequence[int],
                   like: torch.Tensor) -> List[torch.Tensor]:
    """Each root's value over the tile: int32 or bool tensors shaped like
    ``like``.  Constants stay Python scalars until they meet a tensor
    (torch wraps them to int32 there, as ``wrap32`` does here)."""
    memo: Dict[Node, object] = {}

    def both_py(a, b):
        return not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor)

    for n in _walk(roots):
        op, args = n.op, [memo[a] for a in n.args]
        if op == "in":
            v = tile[n.key]
        elif op == "const":
            v = n.value
        elif op == "bconst":
            v = bool(n.value)
        elif op == "param":
            v = params[n.value]
        elif op in _ARITH:
            a, b = args
            v = _PY_ARITH[op](a, b)
            if both_py(a, b):
                v = wrap32(v)
        elif op == "neg":
            v = -args[0] if isinstance(args[0], torch.Tensor) else wrap32(-args[0])
        elif op == "shl":
            v = (args[0] << n.value if isinstance(args[0], torch.Tensor)
                 else wrap32(args[0] << n.value))
        elif op == "shr":
            v = args[0] >> n.value
        elif op == "and":
            v = args[0] & n.value
        elif op in _CMP:
            a, b = args
            if not isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
                a, b, op = b, a, _SWAP[op]
            v = _PY_CMP[op](a, b)
        elif op == "land":
            v = args[0] & args[1]
        elif op == "lor":
            v = args[0] | args[1]
        elif op == "lnot":
            v = ~args[0] if isinstance(args[0], torch.Tensor) else not args[0]
        elif op == "where":
            c, a, b = args
            if not isinstance(c, torch.Tensor):
                v = a if c else b
            else:
                if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
                    a = _as_tensor(a, like)
                v = torch.where(c, a, b)
        elif op == "isin":
            x = args[0]
            v = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
            for m in args[1:]:
                v = v | (x == m)
        elif op == "nz":
            v = args[0] != 0
        elif op == "b2i":
            c = args[0]
            v = c.to(torch.int32) if isinstance(c, torch.Tensor) else int(c)
        else:
            raise ValueError(f"unknown op {op}")
        memo[n] = v
    return [_as_tensor(memo[r], like) for r in roots]


def evaluate(prog: TileProgram, tile: Tile,
             in_bounds: Optional[torch.Tensor] = None):
    """(slots int32, [planes int32]) of the tile's rows: the slot is
    ``n_slots`` wherever the row is not live (or out of bounds)."""
    like = in_bounds if in_bounds is not None else next(iter(tile.values()))
    live, key_slot, *planes = evaluate_nodes(
        [prog.live, prog.key_slot, *prog.planes], tile, prog.params, like)
    if in_bounds is not None:
        live = live & in_bounds
    slot = torch.where(live, key_slot, torch.full_like(key_slot, prog.n_slots))
    return slot, planes


# ---------------------------------------------------------------------------
# C++ back end
# ---------------------------------------------------------------------------

_CONV_EXPR = {
    ("i32", "id"): "(unsigned){x}",
    ("u8", "id"): "(unsigned)({x} != 0)",
    ("i64", "id"): "(unsigned)(unsigned long long){x}",
    ("i64", "w0"): "(unsigned)({x} & 0x7fffffffLL)",
    ("i64", "w1"): "(unsigned)((unsigned long long){x} >> 31)",
}


def _emit_function(prog: TileProgram, roots: Sequence[Node], mask: Sequence[int],
                   lines: List[str]) -> List[str]:
    """Statements computing ``roots``; returns their expressions."""
    by_key = {t.key: t for t in prog.inputs}
    names: Dict[Node, str] = {}

    def ref(n: Node) -> str:
        return names[n]

    for n in _walk(roots):
        op, a = n.op, n.args
        if op == "const":
            names[n] = f"0x{n.value & 0xFFFFFFFF:08x}u"
            continue
        if op == "bconst":
            names[n] = "true" if n.value else "false"
            continue
        if op == "param":
            names[n] = f"(unsigned)prm[{n.value}]"
            continue
        if op == "in":
            t = by_key[n.key]
            src = "m" if t.array in mask else "a"
            expr = _CONV_EXPR[(prog.arrays[t.array].storage, t.conversion)].format(
                x=f"{src}.a{t.array}")
            ctype = "unsigned"
        elif op in _ARITH:
            expr, ctype = f"{ref(a[0])} {_ARITH[op]} {ref(a[1])}", "unsigned"
        elif op == "neg":
            expr, ctype = f"0u - {ref(a[0])}", "unsigned"
        elif op == "shl":
            expr, ctype = f"{ref(a[0])} << {n.value}", "unsigned"
        elif op == "shr":
            expr, ctype = f"(unsigned)((int){ref(a[0])} >> {n.value})", "unsigned"
        elif op == "and":
            expr, ctype = f"{ref(a[0])} & 0x{n.value & 0xFFFFFFFF:08x}u", "unsigned"
        elif op in ("eq", "ne"):
            expr, ctype = f"{ref(a[0])} {_CMP[op]} {ref(a[1])}", "bool"
        elif op in _CMP:
            expr, ctype = f"(int){ref(a[0])} {_CMP[op]} (int){ref(a[1])}", "bool"
        elif op == "land":
            expr, ctype = f"{ref(a[0])} & {ref(a[1])}", "bool"
        elif op == "lor":
            expr, ctype = f"{ref(a[0])} | {ref(a[1])}", "bool"
        elif op == "lnot":
            expr, ctype = f"!{ref(a[0])}", "bool"
        elif op == "where":
            expr, ctype = f"{ref(a[0])} ? {ref(a[1])} : {ref(a[2])}", "unsigned"
        elif op == "isin":
            terms = [f"({ref(a[0])} == {ref(x)})" for x in a[1:]]
            expr, ctype = (" | ".join(terms) if terms else "false"), "bool"
        elif op == "nz":
            expr, ctype = f"{ref(a[0])} != 0u", "bool"
        elif op == "b2i":
            expr, ctype = f"(unsigned){ref(a[0])}", "unsigned"
        else:
            raise ValueError(f"unknown op {op}")
        name = f"v{len(names)}"
        lines.append(f"  const {ctype} {name} = {expr};")
        names[n] = name
    return [ref(r) for r in roots]


def emit_cuda(prog: TileProgram) -> str:
    """The program's row functions as C++ on scalars.

    Defines ``TILE_S``, ``TILE_L``, ``TILE_N_ARRAYS``, ``TILE_N_PARAMS``;
    the row structs ``TileMask`` (arrays every row reads) and ``TileAgg``
    (arrays read only where a row is live) with one raw member ``a<k>``
    per array ``k``; the lists ``TILE_MASK_ARRAYS(X)`` and
    ``TILE_AGG_ARRAYS(X)`` of ``X(k, ctype)``; and

        unsigned tile_slot(const TileMask& m, const int* prm)
            -> the row's slot, TILE_S where it is not live;
        void tile_planes(const TileMask& m, const TileAgg& a, const int* prm,
                         unsigned* out)   -> the TILE_L planes.

    No literal value of a launch parameter appears in the text."""
    mask, agg = prog.mask_arrays(), prog.agg_arrays()
    L = len(prog.planes)

    def struct(name, idxs):
        members = " ".join(f"{STORAGE_CTYPE[prog.arrays[k].storage]} a{k};" for k in idxs)
        return f"struct {name} {{ {members} }};"

    def xlist(name, idxs):
        items = " ".join(f"X({k}, {STORAGE_CTYPE[prog.arrays[k].storage]})" for k in idxs)
        return f"#define {name}(X) {items}".rstrip()

    out = [
        f"// tile program: {prog.n_slots} slots, {L} planes, "
        f"{len(prog.arrays)} arrays, {len(prog.params)} launch parameters",
    ]
    for k, a in enumerate(prog.arrays):
        role = "mask" if k in mask else "agg" if k in agg else "unused"
        out.append(f"//   array {k}: {a.name} ({a.storage}, {role})")
    out += [
        f"constexpr int TILE_S = {prog.n_slots};",
        f"constexpr int TILE_L = {L};",
        f"constexpr int TILE_N_ARRAYS = {len(prog.arrays)};",
        f"constexpr int TILE_N_PARAMS = {len(prog.params)};",
        struct("TileMask", mask),
        struct("TileAgg", agg),
        xlist("TILE_MASK_ARRAYS", mask),
        xlist("TILE_AGG_ARRAYS", agg),
        "",
        "__device__ __forceinline__ unsigned tile_slot(const TileMask& m, const int* prm) {",
        "  (void)m; (void)prm;",
    ]
    live, slot = _emit_function(prog, [prog.live, prog.key_slot], mask, out)
    out += [f"  return {live} ? (unsigned)({slot}) : {prog.n_slots}u;", "}", ""]
    out += [
        "__device__ __forceinline__ void tile_planes(const TileMask& m, const TileAgg& a,",
        "                                            const int* prm, unsigned* out) {",
        "  (void)m; (void)a; (void)prm;",
    ]
    exprs = _emit_function(prog, list(prog.planes), mask, out)
    out += [f"  out[{i}] = {e};" for i, e in enumerate(exprs)]
    out += ["}", ""]
    return "\n".join(out)


__all__ = ["Node", "TileProgram", "ProgramBuilder", "Array", "TileInput", "evaluate",
           "conjuncts",
           "evaluate_nodes", "stage", "emit_cuda", "wrap32", "inp", "const", "bconst",
           "add", "sub", "mul", "neg", "shl", "shr", "band", "cmp", "land", "lor",
           "lnot", "where", "isin", "nz", "b2i", "STORAGE_OF_DTYPE"]
