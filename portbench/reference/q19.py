"""TPC-H Q19's shape, discounted revenue: lines joined to their part that
meet one of three (brand, quantity, size, ship mode) clauses; the sum
of price x (1 - discount) (scale 4), NULL over no line.  The plan's
integer quantity literals compare as whole quantities (1100 is
1100.00), so they keep every line."""


from ._common import exact_sum, lookup, row_of

ORDER_BY = []
LIMIT = None


def answer(t, params, control=False):
    prow = lookup(row_of(t["p_partkey"]), t["l_partkey"])
    m = prow >= 0
    pr = prow.clamp(min=0)
    brand, size = t["p_brand"][pr], t["p_size"][pr]
    q, mode = t["l_quantity"], t["l_shipmode"]

    def b(name):
        return brand == t.code("p_brand", name)

    cond = (
        (b("Brand#12") & (q <= 1100 * 100) & (size <= 5)
         & (mode == t.code("l_shipmode", "AIR")))
        | (b("Brand#23") & (q <= 2000 * 100) & (size <= 10)
           & (mode == t.code("l_shipmode", "SHIP")))
        | (b("Brand#34") & (q <= 3000 * 100) & (size <= 15)))
    m &= cond
    if not bool(m.any()):
        return {"revenue": [None]}
    return {"revenue": [exact_sum(t["l_extendedprice"][m] * (100 - t["l_discount"][m]))]}
