"""SSB Q2.2: lineorders of parts of brands MFGR#2221 to MFGR#2228 (in
string order) from suppliers in ASIA; the sum of revenue per order year
and brand, by year and brand."""

from ..ssb_reference import grouped_sum, is_, star, words

ORDER_BY = ["d_year", "p_brand1"]
LIMIT = None
DENSE = {"values": ["lo_revenue"]}


def _star(t):
    return star(t, None, [
        ("p_partkey", "lo_partkey",
         words(t, "p_brand1", lambda s: "MFGR#2221" <= s <= "MFGR#2228")),
        ("s_suppkey", "lo_suppkey", is_(t, "s_region", "ASIA")),
        ("d_datekey", "lo_orderdate", None),
    ])


def live(t, params):
    return _star(t)["live"]


def answer(t, params, control=False):
    s = _star(t)
    keys = [("d_year", t["d_year"][s["d_datekey"]], None),
            ("p_brand1", t["p_brand1"][s["p_partkey"]], "p_brand1")]
    return grouped_sum(t, keys, t["lo_revenue"][s["live"]], "revenue",
                       [("d_year", False), ("p_brand1", False)], control)
