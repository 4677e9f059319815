"""SSB Q1.2: lineorders of January 1994 with discount 4-6 and quantity
26-35; the sum of extendedprice x discount, NULL over no row."""

from ..ssb_reference import keyless_sum, star, within

ORDER_BY = []
LIMIT = None


def live(t, params):
    fact = within(t["lo_discount"], 4, 6) & within(t["lo_quantity"], 26, 35)
    month = t["d_yearmonthnum"] == 199401
    return star(t, fact, [("d_datekey", "lo_orderdate", month)])["live"]


def answer(t, params, control=False):
    m = live(t, params)
    return keyless_sum(t["lo_extendedprice"][m] * t["lo_discount"][m], "revenue", control)
