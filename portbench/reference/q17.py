"""TPC-H Q17's shape, small-quantity-order revenue: lines of Brand#23
parts whose quantity is under 0.2 x the part's average quantity (the
average at scale 6, half up); the sum of their prices (scale 2), NULL
over no line."""

import torch

from ._common import exact_sum, key_table, lookup

ORDER_BY = []
LIMIT = None


def answer(t, params, control=False):
    pk, q = t["l_partkey"], t["l_quantity"]
    n = int(pk.max()) + 1
    s = torch.zeros(n, dtype=torch.int64, device=pk.device).index_add_(0, pk, q)
    c = torch.bincount(pk, minlength=n)
    # avg at scale 6, half up, from the scale-2 sum: (s x 10^4) / c
    num, den = s * 10 ** 4, c.clamp(min=1)
    avg = torch.div(num, den, rounding_mode="floor")
    avg += (2 * (num - avg * den) >= den).long()
    brand = key_table(t["p_partkey"], (t["p_brand"] == t.code("p_brand", "Brand#23")).long(), 0)
    # quantity (scale 2) < avg (scale 6) x 0.2: q x 10^5 < avg x 2
    m = (lookup(brand, pk) == 1) & (q * 10 ** 5 < avg[pk] * 2)
    if not bool(m.any()):
        return {"total_price": [None]}
    return {"total_price": [exact_sum(t["l_extendedprice"][m])]}
