"""TPC-H Q6, forecasting revenue change: lines shipped in YEAR, with
discount within DISCOUNT +- 0.01 and quantity under QUANTITY; the sum of
price x discount (scale 4), NULL over no row."""

from ._common import days, exact_sum

ORDER_BY = []
LIMIT = None
SCAN = {"predicates": ["l_shipdate", "l_discount", "l_quantity"],
        "values": ["l_extendedprice"]}


def _bounds(params):
    year = int(params["YEAR"])
    disc = round(float(params["DISCOUNT"]) * 100)
    return year, disc - 1, disc + 1, int(params["QUANTITY"]) * 100


def live(t, params):
    year, d_lo, d_hi, qty = _bounds(params)
    d = t["l_shipdate"]
    return ((d >= days(f"{year:04d}-01-01")) & (d < days(f"{year + 1:04d}-01-01"))
            & (t["l_discount"] >= d_lo) & (t["l_discount"] <= d_hi)
            & (t["l_quantity"] < qty))


def answer(t, params, control=False):
    m = live(t, params)
    if not bool(m.any()):
        return {"revenue": [None]}
    ext, disc = t["l_extendedprice"][m], t["l_discount"][m]
    if control:
        rev = (ext.double() / 100 * (disc.double() / 100)).sum()
        return {"revenue": [round(float(rev) * 10 ** 4)]}
    return {"revenue": [exact_sum(ext * disc)]}
