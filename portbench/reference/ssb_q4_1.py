"""SSB Q4.1: lineorders between customers and suppliers in AMERICA, of
parts by MFGR#1 or MFGR#2; the sum of revenue less supply cost per order
year and customer nation, by those."""

from ..ssb_reference import grouped_sum, is_, star

ORDER_BY = ["d_year", "c_nation"]
LIMIT = None
DENSE = {"values": ["profit"]}


def _star(t):
    return star(t, None, [
        ("c_custkey", "lo_custkey", is_(t, "c_region", "AMERICA")),
        ("s_suppkey", "lo_suppkey", is_(t, "s_region", "AMERICA")),
        ("p_partkey", "lo_partkey", is_(t, "p_mfgr", "MFGR#1", "MFGR#2")),
        ("d_datekey", "lo_orderdate", None),
    ])


def live(t, params):
    return _star(t)["live"]


def answer(t, params, control=False):
    s = _star(t)
    m = s["live"]
    keys = [("d_year", t["d_year"][s["d_datekey"]], None),
            ("c_nation", t["c_nation"][s["c_custkey"]], "c_nation")]
    return grouped_sum(t, keys, t["lo_revenue"][m] - t["lo_supplycost"][m], "profit",
                       [("d_year", False), ("c_nation", False)], control)
