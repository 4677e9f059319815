"""TPC-H Q2's shape, minimum-cost supplier: partsupp rows of EUROPE's
suppliers, the minimum supply cost per part, the rows that reach it for
parts of size 15; top 100 by (s_acctbal desc, ps_partkey), every column
the plan emits."""

import torch

from ._common import key_table, lookup, row_of, top_with_ties

ORDER_BY = ["s_acctbal", "ps_partkey"]
LIMIT = 100


def answer(t, params, control=False):
    europe = t.code("r_name", "EUROPE")
    region_of_nation = key_table(t["n_nationkey"], t["n_regionkey"])
    s_ok = lookup(key_table(t["r_regionkey"], t["r_name"]),
                  region_of_nation[t["s_nationkey"]]) == europe
    srow = lookup(row_of(t["s_suppkey"]), t["ps_suppkey"])
    m = srow >= 0
    m &= s_ok[srow.clamp(min=0)]
    pk, cost = t["ps_partkey"], t["ps_supplycost"]
    big = torch.iinfo(torch.int64).max
    min_cost = torch.full((int(pk.max()) + 1,), big, dtype=torch.int64, device=pk.device)
    min_cost.scatter_reduce_(0, pk[m], cost[m], reduce="amin")
    prow = lookup(row_of(t["p_partkey"]), pk)
    best = m & (cost == min_cost[pk]) & (prow >= 0)
    best &= t["p_size"][prow.clamp(min=0)] == 15
    rows = torch.nonzero(best).reshape(-1)
    acct = t["s_acctbal"][srow[rows]]
    rows = rows[top_with_ties([(acct, True), (pk[rows], False)], LIMIT)]
    sr, pr = srow[rows], prow[rows]
    nk = t["s_nationkey"][sr]
    nrow = row_of(t["n_nationkey"])[nk]
    rk = t["n_regionkey"][nrow]
    rrow = row_of(t["r_regionkey"])[rk]
    return {
        "ps_partkey": pk[rows].tolist(), "ps_suppkey": t["ps_suppkey"][rows].tolist(),
        "ps_availqty": t["ps_availqty"][rows].tolist(),
        "ps_supplycost": cost[rows].tolist(),
        "s_suppkey": t["s_suppkey"][sr].tolist(), "s_nationkey": nk.tolist(),
        "s_acctbal": t["s_acctbal"][sr].tolist(),
        "n_nationkey": t["n_nationkey"][nrow].tolist(),
        "n_name": t.names("n_name", t["n_name"][nrow]),
        "n_regionkey": rk.tolist(), "r_regionkey": t["r_regionkey"][rrow].tolist(),
        "r_name": t.names("r_name", t["r_name"][rrow]),
        "ps_partkey_m": pk[rows].tolist(), "min_cost": cost[rows].tolist(),
        "p_partkey": t["p_partkey"][pr].tolist(), "p_size": t["p_size"][pr].tolist(),
        "p_brand": t.names("p_brand", t["p_brand"][pr]),
    }
