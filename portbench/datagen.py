"""TPC-H data from a seed, as plain numpy arrays.

Every column of the eight tables of the TPC-H Standard Specification (v3,
clause 4.2.3), by the clause's rules, from one seed: keys, the sparse
order keys, partsupp's four suppliers per part and lineitem's supplier
among them, prices from the part's retail price, dates between
STARTDATE and ENDDATE less 151 days, flags and statuses from
CURRENTDATE, names, phones, p_name's five colours, types and containers.
One departure, listed under ``reduced`` in the configuration files: the
free-text columns (every ``*_comment``) are random v-strings (4.2.2.7)
of the clause's lengths instead of sentences of the text grammar
(4.2.2.10), whose word lists are not in the repository; the supplier
comments that Q16's text looks for still hold "Customer...Complaints"
and "Customer...Recommends" in SF x 5 rows each.

Numbers are drawn with numpy; strings are made and dictionary-encoded
with torch on the run's device (``Text``), in a few large calls, since
at SF10 there are about 93M of them.  The benchmark hands these arrays
to the system under test (``system.py`` builds its catalog from them)
and to the plain reference alike.  DECIMAL columns are int64 mantissas
at scale 2, DATE columns int32 days since 1970-01-01, STRING columns
int32 codes into a sorted dictionary.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _days(1992, 1, 1)
ENDDATE = _days(1998, 12, 31)
CURRENTDATE = _days(1995, 6, 17)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA", "FRANCE",
    "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA",
    "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
    "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES",
]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4,
                 2, 3, 3, 1]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_SYLLABLES = (["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"],
                  ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"],
                  ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"])
CONTAINER_SYLLABLES = (["SM", "LG", "MED", "JUMBO", "WRAP"],
                       ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"])
COLOURS = """almond antique aquamarine azure beige bisque black blanched blue blush
brown burlywood burnished chartreuse chiffon chocolate coral cornflower cornsilk
cream cyan dark deep dim dodger drab firebrick floral forest frosted gainsboro
ghost goldenrod green grey honeydew hot indian ivory khaki lace lavender lawn
lemon light lime linen magenta maroon medium metallic midnight mint misty
moccasin navajo navy olive orange orchid pale papaya peach peru pink plum powder
puff purple red rose rosy royal saddle salmon sandy seashell sienna sky slate
smoke snow spring steel tan thistle tomato turquoise violet wheat white
yellow""".split()
# a v-string's symbols (4.2.2.7: at least 64), in byte order
VSTRING_SYMBOLS = np.frombuffer(
    b" ,0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz", np.uint8)
# (min, max) length of each free-text column (clause 4.2.3)
COMMENT_LENGTHS = {"r_comment": (31, 115), "n_comment": (31, 114),
                   "s_comment": (25, 100), "c_comment": (29, 116),
                   "p_comment": (5, 22), "ps_comment": (49, 198),
                   "o_comment": (19, 78), "l_comment": (10, 43)}

BRANDS = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]

TABLE_ORDER = ("region", "nation", "supplier", "customer", "part", "partsupp",
               "orders", "lineitem")


@dataclasses.dataclass
class Col:
    """One column: ``kind`` is ``INT64``, ``DECIMAL`` (scale 2, precision
    15), ``DATE`` or ``STRING`` (``data`` holds codes into ``dictionary``)
    here; another configuration's generator may give any kind that
    ``system.py`` maps to the port's types, such as ``DECIMAL(12,4)``."""
    data: np.ndarray
    kind: str
    dictionary: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class Table:
    columns: Dict[str, Col]
    unique_keys: List[List[str]]
    clustered_by: List[str]


class Text:
    """Strings made and encoded with torch on ``device``: random v-strings
    from a ``torch.Generator`` seeded by the run's seed, in large calls,
    and the sort-order dictionary encoding of zero-padded ASCII rows
    (byte order is string order)."""

    CHUNK = 1 << 22

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % (1 << 63))
        self.symbols = torch.from_numpy(VSTRING_SYMBOLS.copy()).to(self.device)

    def vstrings(self, n: int, lo: int, hi: int) -> torch.Tensor:
        """``n`` random v-strings of ``lo``..``hi`` symbols, as zero-padded
        uint8 rows ``-(-hi // 8) * 8`` wide."""
        rows = torch.zeros((n, -(-hi // 8) * 8), dtype=torch.uint8, device=self.device)
        lens = torch.randint(lo, hi + 1, (n, 1), generator=self.gen, device=self.device)
        pos = torch.arange(hi, device=self.device)
        for a in range(0, n, self.CHUNK):
            b = min(n, a + self.CHUNK)
            sym = torch.randint(0, len(self.symbols), (b - a, hi), generator=self.gen,
                                device=self.device)
            rows[a:b, :hi] = self.symbols[sym] * (pos < lens[a:b])
        return rows

    def encode(self, rows: torch.Tensor) -> Col:
        """Dictionary-encode zero-padded ASCII rows: a stable sort by each
        eight-byte word, the last first."""
        n, w = rows.shape
        shifts = torch.arange(56, -8, -8, device=self.device)
        order = torch.arange(n, device=self.device)
        for j in reversed(range(w // 8)):
            key = (rows[order, 8 * j:8 * j + 8].long() << shifts).sum(1)
            order = order[torch.sort(key, stable=True).indices]
        starts = torch.ones(n, dtype=torch.bool, device=self.device)
        for a in range(1, n, self.CHUNK):
            b = min(n, a + self.CHUNK)
            starts[a:b] = (rows[order[a:b]] != rows[order[a - 1:b - 1]]).any(1)
        codes = torch.empty(n, dtype=torch.int32, device=self.device)
        codes[order] = (torch.cumsum(starts, 0) - 1).int()
        return Col(codes.cpu().numpy(), "STRING", self._strings(order[starts], rows))

    def _strings(self, picked: torch.Tensor, rows: torch.Tensor) -> Tuple[str, ...]:
        out: List[str] = []
        sep = torch.full((1, 1), ord("\n"), dtype=torch.uint8, device=self.device)
        for a in range(0, len(picked), self.CHUNK):
            r = rows[picked[a:a + self.CHUNK]]
            flat = torch.cat([r, sep.expand(len(r), 1)], 1)
            keep = torch.cat([r != 0, torch.ones_like(r[:, :1], dtype=torch.bool)], 1)
            out.extend(flat[keep].cpu().numpy().tobytes().decode("ascii").split("\n")[:-1])
        return tuple(out)

    def comments(self, name: str, n: int) -> Col:
        return self.encode(self.vstrings(n, *COMMENT_LENGTHS[name]))

    def digits(self, nums: np.ndarray, prefix: str, groups: Tuple[int, ...]) -> Col:
        """``prefix`` and the decimal digits of each number, zero-padded
        and cut into ``groups`` joined by '-': fixed widths, so numeric
        order is string order."""
        uniq, codes = np.unique(nums, return_inverse=True)
        layout = prefix + "-".join("0" * g for g in groups)
        rows = torch.zeros((len(uniq), -(-len(layout) // 8) * 8), dtype=torch.uint8,
                           device=self.device)
        rows[:, :len(layout)] = torch.tensor(list(layout.encode()), dtype=torch.uint8,
                                             device=self.device)
        u = torch.from_numpy(uniq).to(self.device)
        slots = [i for i, ch in enumerate(layout) if i >= len(prefix) and ch == "0"]
        for k, pos in enumerate(reversed(slots)):
            rows[:, pos] = (u // 10 ** k % 10 + 48).to(torch.uint8)
        picked = torch.arange(len(uniq), device=self.device)
        return Col(codes.reshape(-1).astype(np.int32), "STRING", self._strings(picked, rows))

    def names(self, idx: np.ndarray, words: List[str]) -> Col:
        """Rows of ``words[idx[r, 0]] + " " + ... + words[idx[r, -1]]``."""
        n, k = idx.shape
        most = max(map(len, words))
        table = torch.zeros((len(words), most), dtype=torch.uint8)
        for i, w in enumerate(words):
            table[i, :len(w)] = torch.tensor(list(w.encode()), dtype=torch.uint8)
        table = table.to(self.device)
        lens = torch.tensor([len(w) for w in words], device=self.device)
        i = torch.from_numpy(idx).to(self.device)
        wl = lens[i]
        start = torch.cumsum(wl + 1, 1) - (wl + 1)
        width = -(-(k * (most + 1)) // 8) * 8
        rows = torch.zeros((n, width + 8), dtype=torch.uint8, device=self.device)
        cols = start[:, :, None] + torch.arange(most, device=self.device)
        cols = torch.where(torch.arange(most, device=self.device) < wl[:, :, None], cols,
                           width)     # past the last word: a column dropped below
        rows.scatter_(1, cols.reshape(n, -1), table[i].reshape(n, -1))
        rows.scatter_(1, (start + wl)[:, :-1], 32)
        return self.encode(rows[:, :width].contiguous())


def categorical(words: List[str], idx: np.ndarray) -> Col:
    """The strings ``words[idx]``, encoded over the words that occur."""
    used = np.flatnonzero(np.bincount(idx, minlength=len(words)))
    names = sorted(words[u] for u in used.tolist())
    rank = np.full(len(words), -1, dtype=np.int32)
    rank[used] = [names.index(words[u]) for u in used.tolist()]
    return Col(rank[idx.astype(np.intp, copy=False)], "STRING", tuple(names))


def pick(rng, words: List[str], n: int) -> Col:
    """``n`` words drawn uniformly from ``words``."""
    return categorical(words, rng.integers(0, len(words), n, dtype=np.int16))


def supplier_comments(rng, text: Text, n: int, per: int) -> Col:
    """s_comment: v-strings, ``per`` rows of them holding
    "Customer...Complaints" and ``per`` others "Customer...Recommends" at
    random places (4.2.3)."""
    rows = text.vstrings(n, *COMMENT_LENGTHS["s_comment"]).cpu().numpy()
    lens = (rows != 0).sum(axis=1)
    chosen = rng.choice(n, 2 * per, replace=False)
    for i, r in enumerate(chosen.tolist()):
        tail = b"Complaints" if i < per else b"Recommends"
        room = int(lens[r]) - 8 - len(tail)
        gap = int(rng.integers(0, room + 1))
        at = int(rng.integers(0, room - gap + 1))
        rows[r, at:at + 8] = np.frombuffer(b"Customer", np.uint8)
        rows[r, at + 8 + gap:at + 8 + gap + len(tail)] = np.frombuffer(tail, np.uint8)
    return text.encode(torch.from_numpy(rows).to(text.device))


def phones(rng, text: Text, nation: np.ndarray) -> Col:
    """Phone numbers 'CC-LLL-LLL-LLLL', CC the nation key + 10 (4.2.2.9)."""
    n = len(nation)
    num = (((nation + 10) * 1000 + rng.integers(100, 1000, n)) * 1000
           + rng.integers(100, 1000, n)) * 10000 + rng.integers(1000, 10000, n)
    return text.digits(num, "", (2, 3, 3, 4))


def part_names(rng, text: Text, n: int) -> Col:
    """p_name: five distinct colours, space-separated."""
    idx = rng.integers(0, len(COLOURS), (n, 5))
    while True:
        s = np.sort(idx, axis=1)
        dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup.any():
            break
        idx[dup] = rng.integers(0, len(COLOURS), (int(dup.sum()), 5))
    return text.names(idx, COLOURS)


def _linenumbers(counts: np.ndarray) -> np.ndarray:
    """[3,2] -> [1,2,3,1,2]."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.arange(total) - np.repeat(starts, counts) + 1


def supplier_of(partkey: np.ndarray, i: np.ndarray, n_supp: int) -> np.ndarray:
    """The i-th (0..3) supplier of a part (4.2.3, PS_SUPPKEY)."""
    return (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1


def generate(sf: float, seed: int, device="cpu") -> Dict[str, Table]:
    """All eight TPC-H tables at scale factor ``sf`` from ``seed``: numbers
    with numpy, free text (``Text``) with torch on ``device``."""
    rng = np.random.default_rng(seed)
    text = Text(seed, device)
    out: Dict[str, Table] = {}
    n_orders = int(1_500_000 * sf)
    n_cust = int(150_000 * sf)
    n_part = int(200_000 * sf)
    n_supp = max(1, int(10_000 * sf))

    out["region"] = Table({
        "r_regionkey": Col(np.arange(5, dtype=np.int64), "INT64"),
        "r_name": categorical(REGIONS, np.arange(5)),
        "r_comment": text.comments("r_comment", 5),
    }, [["r_regionkey"]], [])
    out["nation"] = Table({
        "n_nationkey": Col(np.arange(25, dtype=np.int64), "INT64"),
        "n_name": categorical(NATIONS, np.arange(25)),
        "n_regionkey": Col(np.array(NATION_REGION, dtype=np.int64), "INT64"),
        "n_comment": text.comments("n_comment", 25),
    }, [["n_nationkey"]], [])

    s_key = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nation = rng.integers(0, 25, n_supp, dtype=np.int64)
    out["supplier"] = Table({
        "s_suppkey": Col(s_key, "INT64"),
        "s_name": text.digits(s_key, "Supplier#", (9,)),
        "s_address": text.encode(text.vstrings(n_supp, 10, 40)),
        "s_nationkey": Col(s_nation, "INT64"),
        "s_phone": phones(rng, text, s_nation),
        "s_acctbal": Col(rng.integers(-99999, 999999, n_supp, dtype=np.int64,
                                      endpoint=True), "DECIMAL"),
        "s_comment": supplier_comments(rng, text, n_supp, max(1, int(5 * sf))),
    }, [["s_suppkey"]], [])

    c_key = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, n_cust, dtype=np.int64)
    out["customer"] = Table({
        "c_custkey": Col(c_key, "INT64"),
        "c_name": text.digits(c_key, "Customer#", (9,)),
        "c_address": text.encode(text.vstrings(n_cust, 10, 40)),
        "c_nationkey": Col(c_nation, "INT64"),
        "c_phone": phones(rng, text, c_nation),
        "c_acctbal": Col(rng.integers(-99999, 999999, n_cust, dtype=np.int64,
                                      endpoint=True), "DECIMAL"),
        "c_mktsegment": pick(rng, SEGMENTS, n_cust),
        "c_comment": text.comments("c_comment", n_cust),
    }, [["c_custkey"]], [])

    p_key = np.arange(1, n_part + 1, dtype=np.int64)
    mfgr = rng.integers(1, 6, n_part)
    brand = (mfgr - 1) * 5 + rng.integers(0, 5, n_part)
    retail = 90000 + (p_key // 10) % 20001 + 100 * (p_key % 1000)
    types = [" ".join((a, b, c)) for a in TYPE_SYLLABLES[0] for b in TYPE_SYLLABLES[1]
             for c in TYPE_SYLLABLES[2]]
    containers = [f"{a} {b}" for a in CONTAINER_SYLLABLES[0] for b in CONTAINER_SYLLABLES[1]]
    out["part"] = Table({
        "p_partkey": Col(p_key, "INT64"),
        "p_name": part_names(rng, text, n_part),
        "p_mfgr": categorical([f"Manufacturer#{m}" for m in range(1, 6)], mfgr - 1),
        "p_brand": categorical(BRANDS, brand),
        "p_type": pick(rng, types, n_part),
        "p_size": Col(rng.integers(1, 51, n_part, dtype=np.int64), "INT64"),
        "p_container": pick(rng, containers, n_part),
        "p_retailprice": Col(retail.astype(np.int64), "DECIMAL"),
        "p_comment": text.comments("p_comment", n_part),
    }, [["p_partkey"]], [])

    ps_part = np.repeat(p_key, 4)
    ps_supp = supplier_of(ps_part, np.tile(np.arange(4, dtype=np.int64), n_part), n_supp)
    out["partsupp"] = Table({
        "ps_partkey": Col(ps_part, "INT64"),
        "ps_suppkey": Col(ps_supp, "INT64"),
        "ps_availqty": Col(rng.integers(1, 10000, len(ps_part), dtype=np.int64), "INT64"),
        "ps_supplycost": Col(rng.integers(100, 100001, len(ps_part), dtype=np.int64),
                             "DECIMAL"),
        "ps_comment": text.comments("ps_comment", len(ps_part)),
    }, [["ps_partkey", "ps_suppkey"]], [])

    # sparse keys as dbgen's: 1..7, 32..39, 64..71, ... (8 of each 32)
    i = np.arange(1, n_orders + 1, dtype=np.int64)
    o_key = (i // 8) * 32 + i % 8
    # a third of the customers (keys divisible by 3) place no order
    o_cust = rng.integers(0, n_cust - n_cust // 3, n_orders, dtype=np.int64)
    o_cust = o_cust // 2 * 3 + o_cust % 2 + 1
    o_date = rng.integers(STARTDATE, ENDDATE - 151, n_orders, dtype=np.int32,
                          endpoint=True)

    per_order = rng.integers(1, 8, n_orders, dtype=np.int8).astype(np.int64)
    nl = int(per_order.sum())
    l_odate = np.repeat(o_date, per_order)
    l_part = rng.integers(1, n_part + 1, nl, dtype=np.int32).astype(np.int64)
    l_supp = supplier_of(l_part, rng.integers(0, 4, nl, dtype=np.int8), n_supp)
    l_qty = rng.integers(1, 51, nl, dtype=np.int8).astype(np.int64)
    l_price = l_qty * retail[l_part - 1]
    l_disc = rng.integers(0, 11, nl, dtype=np.int8).astype(np.int64)
    l_tax = rng.integers(0, 9, nl, dtype=np.int8).astype(np.int64)
    l_ship = l_odate + rng.integers(1, 122, nl, dtype=np.int8)
    l_commit = l_odate + rng.integers(30, 91, nl, dtype=np.int8)
    l_receipt = l_ship + rng.integers(1, 31, nl, dtype=np.int8)
    l_flag = np.where(l_receipt <= CURRENTDATE, rng.integers(0, 2, nl, dtype=np.int8),
                      np.int8(2))  # R, A; N
    shipped = l_ship <= CURRENTDATE
    first = np.concatenate([[0], np.cumsum(per_order)[:-1]])
    n_shipped = np.add.reduceat(shipped.astype(np.int64), first)
    o_status = np.where(n_shipped == per_order, 0, np.where(n_shipped == 0, 1, 2))  # F, O; P
    # dbgen's sum, truncating each line's discounted price and charge
    charge = (l_price * (100 - l_disc) // 100) * (100 + l_tax) // 100
    out["orders"] = Table({
        "o_orderkey": Col(o_key, "INT64"),
        "o_custkey": Col(o_cust, "INT64"),
        "o_orderstatus": categorical(["F", "O", "P"], o_status),
        "o_totalprice": Col(np.add.reduceat(charge, first), "DECIMAL"),
        "o_orderdate": Col(o_date, "DATE"),
        "o_orderpriority": pick(rng, PRIORITIES, n_orders),
        "o_clerk": text.digits(rng.integers(1, max(1, int(1000 * sf)) + 1, n_orders), "Clerk#",
                               (9,)),
        "o_shippriority": Col(np.zeros(n_orders, dtype=np.int64), "INT64"),
        "o_comment": text.comments("o_comment", n_orders),
    }, [["o_orderkey"]], ["o_orderkey"])
    out["lineitem"] = Table({
        "l_orderkey": Col(np.repeat(o_key, per_order), "INT64"),
        "l_partkey": Col(l_part, "INT64"),
        "l_suppkey": Col(l_supp, "INT64"),
        "l_linenumber": Col(_linenumbers(per_order).astype(np.int64), "INT64"),
        "l_quantity": Col(l_qty * 100, "DECIMAL"),
        "l_extendedprice": Col(l_price, "DECIMAL"),
        "l_discount": Col(l_disc, "DECIMAL"),
        "l_tax": Col(l_tax, "DECIMAL"),
        "l_returnflag": categorical(["R", "A", "N"], l_flag),
        "l_linestatus": categorical(["F", "O"], (~shipped).astype(np.int64)),
        "l_shipdate": Col(l_ship, "DATE"),
        "l_commitdate": Col(l_commit, "DATE"),
        "l_receiptdate": Col(l_receipt, "DATE"),
        "l_shipinstruct": pick(rng, INSTRUCTIONS, nl),
        "l_shipmode": pick(rng, MODES, nl),
        "l_comment": text.comments("l_comment", nl),
    }, [["l_orderkey", "l_linenumber"]], ["l_orderkey", "l_linenumber"])
    return {t: out[t] for t in TABLE_ORDER}


def total_bytes(tables: Dict[str, Table]) -> int:
    return sum(c.data.nbytes for t in tables.values() for c in t.columns.values())
