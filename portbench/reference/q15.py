"""TPC-H Q15, top supplier: revenue (scale 4) per supplier over lines
shipped 1996-01-01..1996-04-01, the suppliers that reach the maximum,
by s_suppkey."""

import torch

from ._common import days, group_sums

ORDER_BY = ["s_suppkey"]
LIMIT = None


def answer(t, params, control=False):
    d = t["l_shipdate"]
    m = (d >= days("1996-01-01")) & (d < days("1996-04-01"))
    rev = t["l_extendedprice"][m] * (100 - t["l_discount"][m])
    supp, inv = torch.unique(t["l_suppkey"][m], return_inverse=True)
    sums = group_sums(inv, rev, len(supp))
    if not sums:
        return {"s_suppkey": [], "total_revenue": []}
    best = max(sums)
    known = set(t["s_suppkey"].tolist())
    keys = supp.tolist()
    rows = sorted(k for k, s in zip(keys, sums) if s == best and k in known)
    return {"s_suppkey": rows, "total_revenue": [best] * len(rows)}
