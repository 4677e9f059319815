"""Vectorized TPC-H-style data generator.

Counterpart of ``tiflash_tpu/storage/tpch.py``: the same seeds and the
same numpy call order, so every column's bytes equal the reference's.
Distributions follow the TPC-H spec shapes; decimal columns are int64
mantissas at scale 2.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np

from ..core import dtypes as dt
from .catalog import Catalog, column_from_arrays, encode_strings

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _days(1992, 1, 1)
ENDDATE = _days(1998, 8, 2)
CURRENTDATE_MINUS_90 = _days(1995, 6, 17)

MKT_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "CHINA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "ROMANIA",
    "RUSSIA", "SAUDI ARABIA", "UNITED KINGDOM", "UNITED STATES", "VIETNAM",
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATION_REGION = [0, 1, 1, 1, 2, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 3, 3, 4, 3, 1, 2]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]


def generate_tpch(
    sf: float,
    seed: int = 0,
    tables: Optional[list] = None,
    column_subset: Optional[dict] = None,
) -> Catalog:
    """``column_subset``: optional {table: [col, ...]} filter applied at
    register time — at SF10+ staging every column would waste most of the
    chip's HBM on columns the query never reads (the reference only reads
    the requested column packs, ``Storages/DeltaMerge/DMFileReader``)."""
    rng = np.random.default_rng(seed)
    cat = Catalog()
    want = set(tables) if tables is not None else None
    if column_subset:
        _register = cat.register

        def register(name, columns, **kw):
            keep = column_subset.get(name)
            if keep:
                columns = {k: v for k, v in columns.items() if k in keep}
                kw["unique_keys"] = [u for u in kw.get("unique_keys", ())
                                     if all(c in columns for c in u)]
                cb = []  # clustering is a PREFIX property
                for c in kw.get("clustered_by", ()):
                    if c not in columns:
                        break
                    cb.append(c)
                kw["clustered_by"] = cb
            return _register(name, columns, **kw)

        cat.register = register

    n_orders = int(1_500_000 * sf)
    n_cust = int(150_000 * sf)
    n_part = int(200_000 * sf)
    n_supp = max(1, int(10_000 * sf))

    def wanted(t):
        return want is None or t in want

    # ---- region / nation ----
    if wanted("region"):
        codes, d = encode_strings(np.array(REGIONS))
        cat.register(
            "region",
            {
                "r_regionkey": column_from_arrays(np.arange(5, dtype=np.int64), dt.INT64),
                "r_name": column_from_arrays(codes, dt.STRING, dictionary=d),
            },
            unique_keys=[["r_regionkey"]],
        )
    if wanted("nation"):
        codes, d = encode_strings(np.array(NATIONS))
        cat.register(
            "nation",
            {
                "n_nationkey": column_from_arrays(np.arange(25, dtype=np.int64), dt.INT64),
                "n_name": column_from_arrays(codes, dt.STRING, dictionary=d),
                "n_regionkey": column_from_arrays(np.array(NATION_REGION, dtype=np.int64), dt.INT64),
            },
            unique_keys=[["n_nationkey"]],
        )

    # ---- supplier ----
    if wanted("supplier"):
        cat.register(
            "supplier",
            {
                "s_suppkey": column_from_arrays(np.arange(1, n_supp + 1, dtype=np.int64), dt.INT64),
                "s_nationkey": column_from_arrays(
                    rng.integers(0, 25, n_supp, dtype=np.int64), dt.INT64
                ),
                "s_acctbal": column_from_arrays(
                    rng.integers(-99999, 999999, n_supp, dtype=np.int64), dt.Decimal(15, 2)
                ),
            },
            unique_keys=[["s_suppkey"]],
        )

    # ---- customer ----
    if wanted("customer"):
        seg_codes = rng.integers(0, 5, n_cust).astype(np.int32)
        _, seg_dict = encode_strings(np.array(MKT_SEGMENTS))
        cat.register(
            "customer",
            {
                "c_custkey": column_from_arrays(np.arange(1, n_cust + 1, dtype=np.int64), dt.INT64),
                "c_nationkey": column_from_arrays(
                    rng.integers(0, 25, n_cust, dtype=np.int64), dt.INT64
                ),
                "c_mktsegment": column_from_arrays(seg_codes, dt.STRING, dictionary=seg_dict),
                "c_acctbal": column_from_arrays(
                    rng.integers(-99999, 999999, n_cust, dtype=np.int64), dt.Decimal(15, 2)
                ),
            },
            unique_keys=[["c_custkey"]],
        )

    # ---- part ----
    if wanted("part"):
        retail = 90000 + ((np.arange(1, n_part + 1) * 100) % 20001) + (
            (np.arange(1, n_part + 1) % 1000) * 100
        )
        brand = rng.integers(11, 56, n_part)
        brand_strs = np.array([f"Brand#{b}" for b in range(11, 56)])
        _, brand_dict = encode_strings(brand_strs)
        brand_codes = np.searchsorted(np.array(brand_dict), np.char.add("Brand#", brand.astype(str))).astype(np.int32)
        cat.register(
            "part",
            {
                "p_partkey": column_from_arrays(np.arange(1, n_part + 1, dtype=np.int64), dt.INT64),
                "p_retailprice": column_from_arrays(retail.astype(np.int64), dt.Decimal(15, 2)),
                "p_brand": column_from_arrays(brand_codes, dt.STRING, dictionary=brand_dict),
                "p_size": column_from_arrays(rng.integers(1, 51, n_part, dtype=np.int64), dt.INT64),
            },
            unique_keys=[["p_partkey"]],
        )

    # ---- partsupp ----
    if wanted("partsupp"):
        pk = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
        sk = rng.integers(1, n_supp + 1, len(pk), dtype=np.int64)
        cat.register(
            "partsupp",
            {
                "ps_partkey": column_from_arrays(pk, dt.INT64),
                "ps_suppkey": column_from_arrays(sk, dt.INT64),
                "ps_availqty": column_from_arrays(
                    rng.integers(1, 10000, len(pk), dtype=np.int64), dt.INT64
                ),
                "ps_supplycost": column_from_arrays(
                    rng.integers(100, 100001, len(pk), dtype=np.int64), dt.Decimal(15, 2)
                ),
            },
        )

    # ---- orders / lineitem ----
    need_orders = wanted("orders") or wanted("lineitem")
    if need_orders:
        o_orderkey = (np.arange(n_orders, dtype=np.int64) // 8) * 32 + (
            np.arange(n_orders, dtype=np.int64) % 8
        )  # sparse keys like dbgen (8 of each 32)
        o_custkey = rng.integers(1, max(2, n_cust + 1), n_orders, dtype=np.int64)
        o_orderdate = rng.integers(STARTDATE, ENDDATE - 151, n_orders, dtype=np.int32)
        o_prio = rng.integers(0, 5, n_orders).astype(np.int32)
        _, prio_dict = encode_strings(np.array(PRIORITIES))

        if wanted("orders"):
            cat.register(
                "orders",
                {
                    "o_orderkey": column_from_arrays(o_orderkey, dt.INT64),
                    "o_custkey": column_from_arrays(o_custkey, dt.INT64),
                    "o_orderdate": column_from_arrays(o_orderdate, dt.DATE),
                    "o_orderpriority": column_from_arrays(o_prio, dt.STRING, dictionary=prio_dict),
                    "o_shippriority": column_from_arrays(
                        np.zeros(n_orders, dtype=np.int64), dt.INT64
                    ),
                },
                unique_keys=[["o_orderkey"]],
                clustered_by=["o_orderkey"],
            )

        if wanted("lineitem"):
            n_lines_per = rng.integers(1, 8, n_orders)
            l_orderkey = np.repeat(o_orderkey, n_lines_per)
            l_odate = np.repeat(o_orderdate, n_lines_per)
            nl = len(l_orderkey)
            l_linenumber = np.concatenate(
                [np.arange(1, k + 1) for k in (7,)]
            ) if False else _linenumbers(n_lines_per)
            l_quantity = rng.integers(1, 51, nl, dtype=np.int64) * 100
            l_partkey = rng.integers(1, max(2, n_part + 1), nl, dtype=np.int64)
            l_suppkey = rng.integers(1, n_supp + 1, nl, dtype=np.int64)
            # extendedprice = quantity * retail-ish unit price
            unit = rng.integers(90001, 200001, nl, dtype=np.int64)  # cents
            l_extendedprice = (l_quantity // 100) * unit
            l_discount = rng.integers(0, 11, nl, dtype=np.int64)  # 0.00-0.10
            l_tax = rng.integers(0, 9, nl, dtype=np.int64)
            l_shipdate = (l_odate + rng.integers(1, 122, nl)).astype(np.int32)
            l_commitdate = (l_odate + rng.integers(30, 91, nl)).astype(np.int32)
            l_receiptdate = (l_shipdate + rng.integers(1, 31, nl)).astype(np.int32)
            shipped = l_shipdate <= CURRENTDATE_MINUS_90
            rf = np.where(shipped, rng.integers(0, 2, nl) * 2, 1).astype(np.int32)  # A/R else N
            ls = np.where(shipped, 0, 1).astype(np.int32)  # F else O
            _, rf_dict = encode_strings(np.array(RETURNFLAGS))
            _, ls_dict = encode_strings(np.array(LINESTATUS))
            mode_codes = rng.integers(0, len(SHIPMODES), nl).astype(np.int32)
            _, mode_dict = encode_strings(np.array(SHIPMODES))
            cat.register(
                "lineitem",
                {
                    "l_orderkey": column_from_arrays(l_orderkey, dt.INT64),
                    "l_partkey": column_from_arrays(l_partkey, dt.INT64),
                    "l_suppkey": column_from_arrays(l_suppkey, dt.INT64),
                    "l_linenumber": column_from_arrays(
                        l_linenumber.astype(np.int64), dt.INT64
                    ),
                    "l_quantity": column_from_arrays(l_quantity, dt.Decimal(15, 2)),
                    "l_extendedprice": column_from_arrays(l_extendedprice, dt.Decimal(15, 2)),
                    "l_discount": column_from_arrays(l_discount, dt.Decimal(15, 2)),
                    "l_tax": column_from_arrays(l_tax, dt.Decimal(15, 2)),
                    "l_returnflag": column_from_arrays(rf, dt.STRING, dictionary=rf_dict),
                    "l_linestatus": column_from_arrays(ls, dt.STRING, dictionary=ls_dict),
                    "l_shipdate": column_from_arrays(l_shipdate, dt.DATE),
                    "l_commitdate": column_from_arrays(l_commitdate, dt.DATE),
                    "l_receiptdate": column_from_arrays(l_receiptdate, dt.DATE),
                    "l_shipmode": column_from_arrays(mode_codes, dt.STRING, dictionary=mode_dict),
                },
                unique_keys=[["l_orderkey", "l_linenumber"]],
                clustered_by=["l_orderkey", "l_linenumber"],
            )
    return cat


def _linenumbers(counts: np.ndarray) -> np.ndarray:
    """[3,2] -> [1,2,3,1,2]."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.arange(total) - np.repeat(starts, counts) + 1


__all__ = ["generate_tpch"]
