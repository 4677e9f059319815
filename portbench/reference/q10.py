"""TPC-H Q10, returned item reporting: returned lines of orders from
1993-10-01 to 1994-01-01, revenue (scale 4) per customer with its
balance; top 20 by (revenue desc, c_custkey)."""

import torch

from ._common import days, group_sums, key_table, top_with_ties
from .q3 import order_of_line

ORDER_BY = ["revenue", "c_custkey"]
LIMIT = 20


def answer(t, params, control=False):
    lo, hi = days("1993-10-01"), days("1994-01-01")
    order_ok = (t["o_orderdate"] >= lo) & (t["o_orderdate"] < hi)
    orow = order_of_line(t)
    m = (t["l_returnflag"] == t.code("l_returnflag", "R")) & (orow >= 0)
    m &= order_ok[orow.clamp(min=0)]
    rev = t["l_extendedprice"][m] * (100 - t["l_discount"][m])
    cust, inv = torch.unique(t["o_custkey"][orow[m]], return_inverse=True)
    sums = torch.tensor(group_sums(inv, rev, len(cust)), dtype=torch.int64,
                        device=rev.device) if len(cust) else cust
    acctbal = key_table(t["c_custkey"], t["c_acctbal"], 0)
    top = top_with_ties([(sums, True), (cust, False)], LIMIT)
    return {"c_custkey": cust[top].tolist(), "c_acctbal": acctbal[cust[top]].tolist(),
            "revenue": sums[top].tolist()}
