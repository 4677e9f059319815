"""TPC-H Q9's shape, product type profit: lines of parts of size at most
25, joined to every partsupp row with the same (partkey, suppkey), to the
supplier's nation and the order; profit = price x (1 - discount) -
supplycost x quantity (scale 4) per (nation, order year)."""

import torch

from ._common import group_sums, key_table, lookup

ORDER_BY = ["nation", "o_year"]
LIMIT = None


def answer(t, params, control=False):
    size = lookup(key_table(t["p_partkey"], t["p_size"]), t["l_partkey"])
    li_ok = (size >= 0) & (size <= 25)
    ps_key = t["ps_partkey"] * (1 << 32) + t["ps_suppkey"]
    skey, order = torch.sort(ps_key, stable=True)
    l_key = t["l_partkey"] * (1 << 32) + t["l_suppkey"]
    lo = torch.searchsorted(skey, l_key, right=False)
    hi = torch.searchsorted(skey, l_key, right=True)
    cnt = torch.where(li_ok, hi - lo, torch.zeros_like(lo))
    li = torch.repeat_interleave(torch.arange(len(l_key), device=cnt.device), cnt)
    first = torch.repeat_interleave(lo, cnt)
    offs = torch.arange(len(li), device=cnt.device) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    ps = order[first + offs]
    nation = lookup(key_table(t["s_suppkey"], t["s_nationkey"]), t["l_suppkey"][li])
    okeys = t["o_orderkey"]
    pos = torch.searchsorted(okeys, t["l_orderkey"][li]).clamp(max=len(okeys) - 1)
    found = (okeys[pos] == t["l_orderkey"][li]) & (nation >= 0)
    li, ps, nation, pos = li[found], ps[found], nation[found], pos[found]
    amount = (t["l_extendedprice"][li] * (100 - t["l_discount"][li])
              - t["ps_supplycost"][ps] * t["l_quantity"][li])
    year = t.year(t["o_orderdate"][pos])
    name = t["n_name"][key_table(t["n_nationkey"], torch.arange(
        len(t["n_nationkey"]), device=pos.device))[nation]]
    keys, inv = torch.unique(torch.stack([name, -year], 1), dim=0, return_inverse=True)
    sums = group_sums(inv.reshape(-1), amount, len(keys))
    return {"nation": t.names("n_name", keys[:, 0]), "o_year": (-keys[:, 1]).tolist(),
            "sum_profit": sums}
