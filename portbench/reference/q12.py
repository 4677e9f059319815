"""TPC-H Q12, shipping modes and order priority: MAIL and SHIP lines
received in 1994, committed before received and shipped before
committed; per ship mode, how many belong to 1-URGENT or 2-HIGH orders
and how many to the others."""

import torch

from ._common import days

ORDER_BY = ["l_shipmode"]
LIMIT = None


def answer(t, params, control=False):
    r, c, s = t["l_receiptdate"], t["l_commitdate"], t["l_shipdate"]
    mode = t["l_shipmode"]
    m = ((r >= days("1994-01-01")) & (r < days("1995-01-01")) & (c < r) & (s < c)
         & ((mode == t.code("l_shipmode", "MAIL")) | (mode == t.code("l_shipmode", "SHIP"))))
    okeys = t["o_orderkey"]
    pos = torch.searchsorted(okeys, t["l_orderkey"]).clamp(max=len(okeys) - 1)
    m &= okeys[pos] == t["l_orderkey"]
    prio = t["o_orderpriority"][pos[m]]
    high = (prio == t.code("o_orderpriority", "1-URGENT")) | (
        prio == t.code("o_orderpriority", "2-HIGH"))
    n_modes = len(t.dict("l_shipmode"))
    all_ = torch.bincount(mode[m], minlength=n_modes).tolist()
    hi = torch.bincount(mode[m][high], minlength=n_modes).tolist()
    names = t.dict("l_shipmode")
    present = [i for i in range(n_modes) if all_[i]]
    return {"l_shipmode": [names[i] for i in present],
            "high_line_count": [hi[i] for i in present],
            "low_line_count": [all_[i] - hi[i] for i in present]}
