"""TPC-H Q5's shape, local supplier volume: lines of 1994's orders by
customers of ASIA's nations, revenue (scale 4) per the customer's nation,
by revenue descending (the plan has no supplier-nation condition)."""

import torch

from ._common import days, group_sums, key_table, lookup, row_of

ORDER_BY = ["revenue"]
LIMIT = None


def answer(t, params, control=False):
    asia = t.code("r_name", "ASIA")
    region_name = key_table(t["r_regionkey"], t["r_name"])
    nation_ok = lookup(region_name, t["n_regionkey"]) == asia
    # the nation row of each customer, if the nation is in ASIA
    nrow = lookup(row_of(t["n_nationkey"]), t["c_nationkey"])
    c_nation = torch.where((nrow >= 0) & nation_ok[nrow.clamp(min=0)], nrow,
                           torch.full_like(nrow, -1))
    nation_of_cust = key_table(t["c_custkey"], c_nation)
    lo, hi = days("1994-01-01"), days("1995-01-01")
    o_nation = lookup(nation_of_cust, t["o_custkey"])
    o_nation = torch.where((t["o_orderdate"] >= lo) & (t["o_orderdate"] < hi), o_nation,
                           torch.full_like(o_nation, -1))
    okeys = t["o_orderkey"]
    pos = torch.searchsorted(okeys, t["l_orderkey"]).clamp(max=len(okeys) - 1)
    l_nation = torch.where(okeys[pos] == t["l_orderkey"], o_nation[pos],
                           torch.full_like(pos, -1))
    m = l_nation >= 0
    rev = t["l_extendedprice"][m] * (100 - t["l_discount"][m])
    name = t["n_name"][l_nation[m]]
    codes, inv = torch.unique(name, return_inverse=True)
    sums = group_sums(inv, rev, len(codes))
    names = t.names("n_name", codes)
    order = sorted(range(len(sums)), key=lambda i: -sums[i])
    return {"n_name": [names[i] for i in order], "revenue": [sums[i] for i in order]}
