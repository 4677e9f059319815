"""TPC-H Q18, large volume customer, at TPC-H's own threshold of 300:
orders whose lines' quantities sum past 300, with their order and
customer; top 100 by (sum_qty desc, o_orderdate)."""

import torch

from ._common import top_with_ties

ORDER_BY = ["sum_qty", "o_orderdate"]
LIMIT = 100
MIN_QTY = 300


def answer(t, params, control=False):
    okeys, inv = torch.unique(t["l_orderkey"], return_inverse=True)
    # no order has more than 7 lines of at most 50.00: an int64 sum is exact
    sums = torch.zeros(len(okeys), dtype=torch.int64, device=inv.device).index_add_(
        0, inv, t["l_quantity"])
    big = sums > MIN_QTY * 100
    okeys, sums = okeys[big], sums[big]
    o = t["o_orderkey"]
    pos = torch.searchsorted(o, okeys).clamp(max=len(o) - 1)
    ok = o[pos] == okeys
    okeys, sums, pos = okeys[ok], sums[ok], pos[ok]
    cust = t["o_custkey"][pos]
    has_c = torch.isin(cust, t["c_custkey"])
    okeys, sums, pos, cust = okeys[has_c], sums[has_c], pos[has_c], cust[has_c]
    odate = t["o_orderdate"][pos]
    top = top_with_ties([(sums, True), (odate, False)], LIMIT)
    return {"o_orderkey": okeys[top].tolist(), "o_custkey": cust[top].tolist(),
            "o_orderdate": odate[top].tolist(), "l_orderkey": okeys[top].tolist(),
            "sum_qty": sums[top].tolist(), "c_custkey": cust[top].tolist()}
