"""TPC-H Q4, order priority checking: orders of 1993-07-01..1993-10-01
with a line committed before it was received, counted per priority."""

import torch

from ._common import days

ORDER_BY = ["o_orderpriority"]
LIMIT = None


def answer(t, params, control=False):
    lo, hi = days("1993-07-01"), days("1993-10-01")
    late = t["l_orderkey"][t["l_commitdate"] < t["l_receiptdate"]]
    m = ((t["o_orderdate"] >= lo) & (t["o_orderdate"] < hi)
         & torch.isin(t["o_orderkey"], late))
    names = t.dict("o_orderpriority")
    counts = torch.bincount(t["o_orderpriority"][m], minlength=len(names)).tolist()
    return {"o_orderpriority": [names[i] for i, c in enumerate(counts) if c],
            "order_count": [c for c in counts if c]}
