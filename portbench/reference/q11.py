"""TPC-H Q11's shape, important stock identification: partsupp rows of
GERMANY's suppliers, value = supplycost x availqty (scale 2) per part,
kept where it exceeds 0.0001 of the total value; by value descending."""

import torch

from ._common import exact_sum, group_sums, key_table, lookup

ORDER_BY = ["value"]
LIMIT = None


def answer(t, params, control=False):
    germany = t.code("n_name", "GERMANY")
    supp_nation = key_table(t["s_suppkey"], t["s_nationkey"])
    nation_name = key_table(t["n_nationkey"], t["n_name"])
    m = lookup(nation_name, lookup(supp_nation, t["ps_suppkey"])) == germany
    value = t["ps_supplycost"][m] * t["ps_availqty"][m]
    total = exact_sum(value)
    parts, inv = torch.unique(t["ps_partkey"][m], return_inverse=True)
    sums = group_sums(inv, value, len(parts))
    # value > total x 0.0001, both at scale 2: value x 10^4 > total
    keep = [i for i, s in enumerate(sums) if s * 10 ** 4 > total]
    keep.sort(key=lambda i: -sums[i])
    pk = parts.tolist()
    return {"ps_partkey": [pk[i] for i in keep], "value": [sums[i] for i in keep]}
