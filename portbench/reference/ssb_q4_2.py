"""SSB Q4.2: lineorders between customers and suppliers in AMERICA, of
parts by MFGR#1 or MFGR#2, ordered in 1997 or 1998; the sum of revenue
less supply cost per order year, supplier nation and part category, by
those."""

from ..ssb_reference import grouped_sum, is_, star

ORDER_BY = ["d_year", "s_nation", "p_category"]
LIMIT = None
DENSE = {"values": ["profit"]}


def _star(t):
    years = (t["d_year"] == 1997) | (t["d_year"] == 1998)
    return star(t, None, [
        ("c_custkey", "lo_custkey", is_(t, "c_region", "AMERICA")),
        ("s_suppkey", "lo_suppkey", is_(t, "s_region", "AMERICA")),
        ("p_partkey", "lo_partkey", is_(t, "p_mfgr", "MFGR#1", "MFGR#2")),
        ("d_datekey", "lo_orderdate", years),
    ])


def live(t, params):
    return _star(t)["live"]


def answer(t, params, control=False):
    s = _star(t)
    m = s["live"]
    keys = [("d_year", t["d_year"][s["d_datekey"]], None),
            ("s_nation", t["s_nation"][s["s_suppkey"]], "s_nation"),
            ("p_category", t["p_category"][s["p_partkey"]], "p_category")]
    return grouped_sum(t, keys, t["lo_revenue"][m] - t["lo_supplycost"][m], "profit",
                       [("d_year", False), ("s_nation", False), ("p_category", False)],
                       control)
