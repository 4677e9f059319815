"""TPC-H Q3, shipping priority: BUILDING customers' orders before
1995-03-15, their lines shipped after it, revenue per order (scale 4);
top 10 by (revenue desc, o_orderdate)."""

import torch

from ._common import days, group_sums, key_table, top_with_ties

ORDER_BY = ["revenue", "o_orderdate"]
LIMIT = 10


def order_of_line(t):
    """Per lineitem row, the row of its order (o_orderkey is sorted), or -1."""
    okeys = t["o_orderkey"]
    pos = torch.searchsorted(okeys, t["l_orderkey"]).clamp(max=len(okeys) - 1)
    return torch.where(okeys[pos] == t["l_orderkey"], pos, torch.full_like(pos, -1))


def answer(t, params, control=False):
    cut = days("1995-03-15")
    building = t.code("c_mktsegment", "BUILDING")
    cust_ok = key_table(t["c_custkey"], (t["c_mktsegment"] == building).long(), 0)
    order_ok = (t["o_orderdate"] < cut) & (cust_ok[t["o_custkey"].clamp(max=len(cust_ok) - 1)] == 1)
    orow = order_of_line(t)
    m = (t["l_shipdate"] > cut) & (orow >= 0)
    m &= order_ok[orow.clamp(min=0)]
    rev = t["l_extendedprice"][m] * (100 - t["l_discount"][m])
    okeys, inv = torch.unique(t["l_orderkey"][m], return_inverse=True)
    sums = torch.tensor(group_sums(inv, rev, len(okeys)), dtype=torch.int64,
                        device=rev.device) if len(okeys) else okeys
    orow_g = torch.searchsorted(t["o_orderkey"], okeys)
    odate = t["o_orderdate"][orow_g]
    top = top_with_ties([(sums, True), (odate, False)], LIMIT)
    return {"l_orderkey": okeys[top].tolist(), "o_orderdate": odate[top].tolist(),
            "o_shippriority": t["o_shippriority"][orow_g][top].tolist(),
            "revenue": sums[top].tolist()}
