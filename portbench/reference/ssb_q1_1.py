"""SSB Q1.1: lineorders of 1993 with discount 1-3 and quantity under 25;
the sum of extendedprice x discount (cents x percent), NULL over no row."""

from ..ssb_reference import keyless_sum, star, within

ORDER_BY = []
LIMIT = None


def live(t, params):
    fact = within(t["lo_discount"], 1, 3) & (t["lo_quantity"] < 25)
    return star(t, fact, [("d_datekey", "lo_orderdate", t["d_year"] == 1993)])["live"]


def answer(t, params, control=False):
    m = live(t, params)
    return keyless_sum(t["lo_extendedprice"][m] * t["lo_discount"][m], "revenue", control)
