"""SSB Q4.3: lineorders between customers in AMERICA and suppliers in the
UNITED STATES, of parts of category MFGR#14, ordered in 1997 or 1998;
the sum of revenue less supply cost per order year, supplier city and
brand, by those."""

from ..ssb_reference import grouped_sum, is_, star

ORDER_BY = ["d_year", "s_city", "p_brand1"]
LIMIT = None
DENSE = {"values": ["profit"]}


def _star(t):
    years = (t["d_year"] == 1997) | (t["d_year"] == 1998)
    return star(t, None, [
        ("c_custkey", "lo_custkey", is_(t, "c_region", "AMERICA")),
        ("s_suppkey", "lo_suppkey", is_(t, "s_nation", "UNITED STATES")),
        ("p_partkey", "lo_partkey", is_(t, "p_category", "MFGR#14")),
        ("d_datekey", "lo_orderdate", years),
    ])


def live(t, params):
    return _star(t)["live"]


def answer(t, params, control=False):
    s = _star(t)
    m = s["live"]
    keys = [("d_year", t["d_year"][s["d_datekey"]], None),
            ("s_city", t["s_city"][s["s_suppkey"]], "s_city"),
            ("p_brand1", t["p_brand1"][s["p_partkey"]], "p_brand1")]
    return grouped_sum(t, keys, t["lo_revenue"][m] - t["lo_supplycost"][m], "profit",
                       [("d_year", False), ("s_city", False), ("p_brand1", False)], control)
