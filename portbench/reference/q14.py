"""TPC-H Q14's shape, promotion effect: revenue (scale 4) of lines
shipped in September 1995, the share of parts whose brand is LIKE
'Brand#2%', as a decimal at scale 8, half up."""

import torch

from ._common import days, exact_sum, half_up_div, lookup, row_of

ORDER_BY = []
LIMIT = None


def answer(t, params, control=False):
    d = t["l_shipdate"]
    prow = lookup(row_of(t["p_partkey"]), t["l_partkey"])
    m = (d >= days("1995-09-01")) & (d < days("1995-10-01")) & (prow >= 0)
    rev = t["l_extendedprice"] * (100 - t["l_discount"])
    promo_code = torch.tensor([b.startswith("Brand#2") for b in t.dict("p_brand")],
                              device=d.device)
    promo = m & promo_code[t["p_brand"][prow.clamp(min=0)]]
    if not bool(m.any()) or not bool(promo.any()):
        return {"promo_share": [None]}
    total, p = exact_sum(rev[m]), exact_sum(rev[promo])
    return {"promo_share": [half_up_div(p * 10 ** 8, total) if total else None]}
