"""TPC-H Q22's shape, global sales opportunity: customers with a positive
balance and no order; their count, balance sum (scale 2) and average
(scale 6, half up)."""

import torch

from ._common import exact_sum, half_up_div

ORDER_BY = []
LIMIT = None


def answer(t, params, control=False):
    m = (t["c_acctbal"] > 0) & ~torch.isin(t["c_custkey"], t["o_custkey"])
    n = int(m.sum())
    s = exact_sum(t["c_acctbal"][m])
    return {"numcust": [n], "totacctbal": [s if n else None],
            "avgbal": [half_up_div(s * 10 ** 4, n) if n else None]}
