"""TPC-H Q13's shape, customer distribution: per customer the number of
its orders whose priority is not 1-URGENT (0 for none: a left outer
join and count(o_orderkey)), then customers per count; by (custdist
desc, c_count desc)."""

import torch

ORDER_BY = ["custdist", "c_count"]
LIMIT = None


def answer(t, params, control=False):
    keep = t["o_orderpriority"] != t.code("o_orderpriority", "1-URGENT")
    per = torch.bincount(t["o_custkey"][keep], minlength=int(t["c_custkey"].max()) + 1)
    c_count = per[t["c_custkey"]]
    counts, dist = torch.unique(c_count, return_counts=True)
    order = sorted(range(len(counts)), key=lambda i: (-int(dist[i]), -int(counts[i])))
    return {"c_count": [int(counts[i]) for i in order],
            "custdist": [int(dist[i]) for i in order]}
