"""SSB Q3.1: lineorders between customers and suppliers in ASIA, 1992-1997;
the sum of revenue per customer nation, supplier nation and order year,
by year ascending and revenue descending."""

from ..ssb_reference import grouped_sum, is_, star, within

ORDER_BY = ["d_year", "revenue"]
LIMIT = None
DENSE = {"values": ["lo_revenue"]}


def _star(t):
    return star(t, None, [
        ("c_custkey", "lo_custkey", is_(t, "c_region", "ASIA")),
        ("s_suppkey", "lo_suppkey", is_(t, "s_region", "ASIA")),
        ("d_datekey", "lo_orderdate", within(t["d_year"], 1992, 1997)),
    ])


def live(t, params):
    return _star(t)["live"]


def answer(t, params, control=False):
    s = _star(t)
    keys = [("c_nation", t["c_nation"][s["c_custkey"]], "c_nation"),
            ("s_nation", t["s_nation"][s["s_suppkey"]], "s_nation"),
            ("d_year", t["d_year"][s["d_datekey"]], None)]
    return grouped_sum(t, keys, t["lo_revenue"][s["live"]], "revenue",
                       [("d_year", False), ("revenue", True)], control)
