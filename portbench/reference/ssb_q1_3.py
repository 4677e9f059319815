"""SSB Q1.3: lineorders of week 6 of 1994 with discount 5-7 and quantity
26-35; the sum of extendedprice x discount, NULL over no row."""

from ..ssb_reference import keyless_sum, star, within

ORDER_BY = []
LIMIT = None


def live(t, params):
    fact = within(t["lo_discount"], 5, 7) & within(t["lo_quantity"], 26, 35)
    week = (t["d_weeknuminyear"] == 6) & (t["d_year"] == 1994)
    return star(t, fact, [("d_datekey", "lo_orderdate", week)])["live"]


def answer(t, params, control=False):
    m = live(t, params)
    return keyless_sum(t["lo_extendedprice"][m] * t["lo_discount"][m], "revenue", control)
