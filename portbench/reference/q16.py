"""TPC-H Q16's shape, parts/supplier relationship: distinct suppliers per
brand over the partsupp rows of parts of size at most 25; by
(supplier_cnt desc, p_brand)."""

import torch

from ._common import lookup, row_of

ORDER_BY = ["supplier_cnt", "p_brand"]
LIMIT = None


def answer(t, params, control=False):
    prow = lookup(row_of(t["p_partkey"]), t["ps_partkey"])
    m = prow >= 0
    m &= t["p_size"][prow.clamp(min=0)] <= 25
    brand = t["p_brand"][prow[m]]
    pairs = torch.unique(torch.stack([brand, t["ps_suppkey"][m]], 1), dim=0)
    brands, cnt = torch.unique(pairs[:, 0], return_counts=True)
    names = t.names("p_brand", brands)
    cnt = cnt.tolist()
    order = sorted(range(len(names)), key=lambda i: (-cnt[i], names[i]))
    return {"p_brand": [names[i] for i in order], "supplier_cnt": [cnt[i] for i in order]}
