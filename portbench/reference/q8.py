"""TPC-H Q8's shape, national market share: lines of Brand#34 parts in
orders of 1995-01-01..1996-12-31 by customers in AMERICA; per order year
the volume (scale 4) of BRAZIL's suppliers over all volume, as a
decimal at scale 8, half up (NULL where BRAZIL supplied nothing)."""

import torch

from ._common import days, group_sums, half_up_div, key_table, lookup

ORDER_BY = ["o_year"]
LIMIT = None


def answer(t, params, control=False):
    america = t.code("r_name", "AMERICA")
    brazil = t.code("n_name", "BRAZIL")
    nation_in_america = lookup(key_table(t["r_regionkey"], t["r_name"]),
                               t["n_regionkey"]) == america
    america_nation = key_table(t["n_nationkey"], nation_in_america.long(), 0)
    cust_ok = key_table(t["c_custkey"], lookup(america_nation, t["c_nationkey"]).clamp(min=0), 0)
    d = t["o_orderdate"]
    order_ok = ((d >= days("1995-01-01")) & (d <= days("1996-12-31"))
                & (lookup(cust_ok, t["o_custkey"]) == 1))
    part_ok = key_table(t["p_partkey"], (t["p_brand"] == t.code("p_brand", "Brand#34")).long(), 0)
    supp_nation = lookup(key_table(t["n_nationkey"], t["n_name"]),
                         lookup(key_table(t["s_suppkey"], t["s_nationkey"]), t["l_suppkey"]))
    okeys = t["o_orderkey"]
    pos = torch.searchsorted(okeys, t["l_orderkey"]).clamp(max=len(okeys) - 1)
    m = ((okeys[pos] == t["l_orderkey"]) & order_ok[pos]
         & (lookup(part_ok, t["l_partkey"]) == 1) & (supp_nation >= 0))
    volume = t["l_extendedprice"][m] * (100 - t["l_discount"][m])
    year = t.year(d[pos[m]])
    is_brazil = supp_nation[m] == brazil
    years, inv = torch.unique(year, return_inverse=True)
    total = group_sums(inv, volume, len(years))
    nation = group_sums(inv[is_brazil], volume[is_brazil], len(years))
    any_brazil = torch.bincount(inv[is_brazil], minlength=len(years)).tolist()
    share = [half_up_div(nv * 10 ** 8, tv) if k and tv else None
             for nv, tv, k in zip(nation, total, any_brazil)]
    return {"o_year": years.tolist(), "mkt_share": share}
