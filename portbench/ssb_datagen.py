"""The Star Schema Benchmark's data from a seed, as plain numpy arrays.

The five tables of the SSB specification (O'Neil, O'Neil, Chen and
Revilak, revision 3) by ``ssb-dbgen``'s rules: ``lineorder``, TPC-H's
lineitem and orders merged into one row per line (SF x 1,500,000 orders
of 1-7 lines each), ``customer`` (SF x 30,000), ``supplier`` (SF x
2,000), ``part`` (200,000 x floor(1 + log2 SF)) and ``date``, one row
per day of 1992-1998.

- Keys: ``lo_orderdate``, ``lo_commitdate`` and ``d_datekey`` are
  integers yyyymmdd; the order keys are TPC-H's sparse ones.
- Money is integer cents, as ``ssb-dbgen`` writes it:
  ``lo_extendedprice`` is the quantity times the part's TPC-H retail
  price, ``lo_revenue`` floor(extendedprice x (100 - discount) / 100),
  ``lo_supplycost`` floor(6 x retail price / 10), ``lo_ordtotalprice``
  the order's sum of TPC-H's truncated charges.
- ``p_mfgr`` is MFGR#1-5, ``p_category`` the mfgr and a digit 1-5 (25
  values), ``p_brand1`` the category and 1-40 (1,000 values).
- ``c_city``/``s_city``: the first 9 characters of the nation's name,
  padded with blanks, and a digit 0-9 (250 values); nations and regions
  are TPC-H's.

Every value without a public rule is listed under ``assumed`` in
``configs/ssb_sf10.json`` and set here by that entry.  Every number
column is INT32, strings are dictionary codes (``datagen.Col``), and
each dimension declares its key unique.  Numbers are drawn with numpy,
strings made and encoded by ``datagen.Text`` on the run's device.
"""

from __future__ import annotations

import calendar
import datetime
import math
from typing import Dict

import numpy as np

from portbench.datagen import (  # noqa: F401  (total_bytes is this generator's too)
    COLOURS, CONTAINER_SYLLABLES, MODES, NATION_REGION, NATIONS, PRIORITIES, REGIONS,
    SEGMENTS, TYPE_SYLLABLES, Col, Table, Text, _linenumbers, categorical, phones, pick,
    supplier_of, total_bytes,
)

FIRST_DAY = datetime.date(1992, 1, 1)
LAST_DAY = datetime.date(1998, 12, 31)
# orders are dated up to LAST_DAY less 151 days, as TPC-H's
LAST_ORDER_DAY = LAST_DAY - datetime.timedelta(days=151)

MFGRS = [f"MFGR#{m}" for m in range(1, 6)]
CATEGORIES = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
BRANDS1 = [f"MFGR#{m}{c}{b}" for m in range(1, 6) for c in range(1, 6) for b in range(1, 41)]
CITIES = [f"{n[:9]:<9}{d}" for n in NATIONS for d in range(10)]
SEASONS = ["Christmas", "Fall", "Spring", "Summer", "Winter"]
TYPES = [" ".join((a, b, c)) for a in TYPE_SYLLABLES[0] for b in TYPE_SYLLABLES[1]
         for c in TYPE_SYLLABLES[2]]
CONTAINERS = [f"{a} {b}" for a in CONTAINER_SYLLABLES[0] for b in CONTAINER_SYLLABLES[1]]
HOLIDAYS = {(1, 1), (7, 4), (12, 25)}


def n_parts(sf: float) -> int:
    """200,000 x floor(1 + log2 SF); 200,000 x SF where that is not
    positive (below SF 1: assumed)."""
    k = math.floor(1 + math.log2(sf))
    return 200_000 * k if k > 0 else max(1, int(200_000 * sf))


def _season(month: int) -> str:
    if month == 12:
        return "Christmas"
    if month in (6, 7, 8):
        return "Summer"
    if month in (1, 2):
        return "Winter"
    if month in (3, 4, 5):
        return "Spring"
    return "Fall"


def datekey(days: np.ndarray) -> np.ndarray:
    """yyyymmdd of day numbers counted from 1992-01-01."""
    table = np.array([int((FIRST_DAY + datetime.timedelta(days=int(d))).strftime("%Y%m%d"))
                      for d in range((LAST_DAY - FIRST_DAY).days + 1)], dtype=np.int32)
    return table[days]


def _date_table() -> Table:
    days = [FIRST_DAY + datetime.timedelta(days=d)
            for d in range((LAST_DAY - FIRST_DAY).days + 1)]
    n = len(days)

    def ints(f):
        return Col(np.array([f(d) for d in days], dtype=np.int32), "INT32")

    def words(f, vocab):
        return categorical(vocab, np.array([vocab.index(f(d)) for d in days]))

    date_text = [f"{calendar.month_name[d.month]} {d.day}, {d.year}" for d in days]
    months = list(calendar.month_name[1:])
    weekdays = list(calendar.day_name)
    yearmonths = sorted({f"{calendar.month_abbr[d.month]}{d.year}" for d in days})
    return Table({
        "d_datekey": Col(datekey(np.arange(n)), "INT32"),
        "d_date": categorical(date_text, np.arange(n)),
        "d_dayofweek": words(lambda d: calendar.day_name[d.weekday()], weekdays),
        "d_month": words(lambda d: calendar.month_name[d.month], months),
        "d_year": ints(lambda d: d.year),
        "d_yearmonthnum": ints(lambda d: d.year * 100 + d.month),
        "d_yearmonth": words(lambda d: f"{calendar.month_abbr[d.month]}{d.year}", yearmonths),
        # Sunday is day 1 of the week
        "d_daynuminweek": ints(lambda d: (d.weekday() + 1) % 7 + 1),
        "d_daynuminmonth": ints(lambda d: d.day),
        "d_daynuminyear": ints(lambda d: d.timetuple().tm_yday),
        "d_monthnuminyear": ints(lambda d: d.month),
        "d_weeknuminyear": ints(lambda d: (d.timetuple().tm_yday - 1) // 7 + 1),
        "d_sellingseason": words(lambda d: _season(d.month), SEASONS),
        "d_lastdayinweekfl": ints(lambda d: int(d.weekday() == 5)),
        "d_lastdayinmonthfl": ints(
            lambda d: int(d.day == calendar.monthrange(d.year, d.month)[1])),
        "d_holidayfl": ints(lambda d: int((d.month, d.day) in HOLIDAYS)),
        "d_weekdayfl": ints(lambda d: int(d.weekday() < 5)),
    }, [["d_datekey"]], [])


def _place(rng, text: Text, prefix: str, key_name: str, n: int,
           name_prefix: str) -> Dict[str, Col]:
    """Key, name, address, city, nation, region and phone of ``n`` customers
    or suppliers (columns ``<prefix>_...``)."""
    key = np.arange(1, n + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n, dtype=np.int64)
    city = nation * 10 + rng.integers(0, 10, n, dtype=np.int64)
    return {
        f"{prefix}_{key_name}": Col(key.astype(np.int32), "INT32"),
        f"{prefix}_name": text.digits(key, name_prefix, (9,)),
        f"{prefix}_address": text.encode(text.vstrings(n, 10, 25)),
        f"{prefix}_city": categorical(CITIES, city),
        f"{prefix}_nation": categorical(NATIONS, nation),
        f"{prefix}_region": categorical(REGIONS, np.array(NATION_REGION)[nation]),
        f"{prefix}_phone": phones(rng, text, nation),
    }


def generate(sf: float, seed: int, device="cpu") -> Dict[str, Table]:
    """SSB's five tables at scale factor ``sf`` from ``seed``."""
    seed = seed % (1 << 63)
    rng = np.random.default_rng(seed)
    text = Text(seed, device)
    n_orders = max(1, int(1_500_000 * sf))
    n_cust = max(3, int(30_000 * sf))
    n_supp = max(4, int(2_000 * sf))
    n_part = n_parts(sf)

    cust = _place(rng, text, "c", "custkey", n_cust, "Customer#")
    cust["c_mktsegment"] = pick(rng, SEGMENTS, n_cust)
    supp = _place(rng, text, "s", "suppkey", n_supp, "Supplier#")

    p_key = np.arange(1, n_part + 1, dtype=np.int64)
    mfgr = rng.integers(0, 5, n_part)
    category = mfgr * 5 + rng.integers(0, 5, n_part)
    brand = category * 40 + rng.integers(0, 40, n_part)
    colours = rng.integers(0, len(COLOURS), (n_part, 2))
    same = colours[:, 0] == colours[:, 1]
    colours[same, 1] = (colours[same, 1] + 1) % len(COLOURS)
    retail = 90000 + (p_key // 10) % 20001 + 100 * (p_key % 1000)
    part = {
        "p_partkey": Col(p_key.astype(np.int32), "INT32"),
        "p_name": text.names(colours, COLOURS),
        "p_mfgr": categorical(MFGRS, mfgr),
        "p_category": categorical(CATEGORIES, category),
        "p_brand1": categorical(BRANDS1, brand),
        "p_color": pick(rng, COLOURS, n_part),
        "p_type": pick(rng, TYPES, n_part),
        "p_size": Col(rng.integers(1, 51, n_part, dtype=np.int32), "INT32"),
        "p_container": pick(rng, CONTAINERS, n_part),
    }

    # orders as TPC-H's dbgen makes them: sparse keys, no customer whose
    # key is a multiple of 3, dates up to LAST_ORDER_DAY
    i = np.arange(1, n_orders + 1, dtype=np.int64)
    o_key = (i // 8) * 32 + i % 8
    o_cust = rng.integers(0, n_cust - n_cust // 3, n_orders, dtype=np.int64)
    o_cust = o_cust // 2 * 3 + o_cust % 2 + 1
    o_day = rng.integers(0, (LAST_ORDER_DAY - FIRST_DAY).days, n_orders, dtype=np.int32,
                         endpoint=True)
    o_prio = rng.integers(0, len(PRIORITIES), n_orders, dtype=np.int8)

    per_order = rng.integers(1, 8, n_orders, dtype=np.int8).astype(np.int64)
    nl = int(per_order.sum())
    l_day = np.repeat(o_day, per_order)
    l_part = rng.integers(1, n_part + 1, nl, dtype=np.int32).astype(np.int64)
    l_supp = supplier_of(l_part, rng.integers(0, 4, nl, dtype=np.int8), n_supp)
    qty = rng.integers(1, 51, nl, dtype=np.int8).astype(np.int64)
    price = retail[l_part - 1]
    ext = qty * price
    disc = rng.integers(0, 11, nl, dtype=np.int8).astype(np.int64)
    tax = rng.integers(0, 9, nl, dtype=np.int8).astype(np.int64)
    commit = l_day + rng.integers(30, 91, nl, dtype=np.int8)
    first = np.concatenate([[0], np.cumsum(per_order)[:-1]])
    charge = (ext * (100 - disc) // 100) * (100 + tax) // 100
    total = np.repeat(np.add.reduceat(charge, first), per_order)

    def i32(a):
        return Col(a.astype(np.int32), "INT32")

    lineorder = {
        "lo_orderkey": i32(np.repeat(o_key, per_order)),
        "lo_linenumber": i32(_linenumbers(per_order)),
        "lo_custkey": i32(np.repeat(o_cust, per_order)),
        "lo_partkey": i32(l_part),
        "lo_suppkey": i32(l_supp),
        "lo_orderdate": Col(datekey(l_day), "INT32"),
        "lo_orderpriority": categorical(PRIORITIES, np.repeat(o_prio, per_order)),
        "lo_shippriority": i32(np.zeros(nl, dtype=np.int32)),
        "lo_quantity": i32(qty),
        "lo_extendedprice": i32(ext),
        "lo_ordtotalprice": i32(total),
        "lo_discount": i32(disc),
        "lo_revenue": i32(ext * (100 - disc) // 100),
        "lo_supplycost": i32(6 * price // 10),
        "lo_tax": i32(tax),
        "lo_commitdate": Col(datekey(commit), "INT32"),
        "lo_shipmode": pick(rng, MODES, nl),
    }
    return {
        "lineorder": Table(lineorder, [["lo_orderkey", "lo_linenumber"]],
                           ["lo_orderkey", "lo_linenumber"]),
        "customer": Table(cust, [["c_custkey"]], []),
        "supplier": Table(supp, [["s_suppkey"]], []),
        "part": Table(part, [["p_partkey"]], []),
        "date": _date_table(),
    }
