"""TPC-H Q21's shape, suppliers who kept orders waiting: orders with more
than one distinct supplier of which exactly one delivered a line late
(receipt after commit); that supplier's late lines of those orders,
counted per supplier; top 100 by (numwait desc, l_suppkey)."""

import torch

from ._common import top_with_ties

ORDER_BY = ["numwait", "l_suppkey"]
LIMIT = 100


def distinct_per_order(okey, skey):
    """(order keys, count of distinct suppliers) over the given lines."""
    pairs = torch.unique(okey * (1 << 32) + skey)
    return torch.unique(pairs >> 32, return_counts=True)


def answer(t, params, control=False):
    ok, sk = t["l_orderkey"], t["l_suppkey"]
    late = t["l_receiptdate"] > t["l_commitdate"]
    orders, n_supp = distinct_per_order(ok, sk)
    late_orders, n_late = distinct_per_order(ok[late], sk[late])
    pos = torch.searchsorted(orders, late_orders)
    target = late_orders[(n_supp[pos] > 1) & (n_late == 1)]
    culprit = late & torch.isin(ok, target)
    supp, numwait = torch.unique(sk[culprit], return_counts=True)
    top = top_with_ties([(numwait, True), (supp, False)], LIMIT)
    return {"l_suppkey": supp[top].tolist(), "numwait": numwait[top].tolist()}
