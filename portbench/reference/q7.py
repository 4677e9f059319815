"""TPC-H Q7, volume shipping: lines shipped 1995-01-01..1996-12-31 whose
supplier's and customer's nations are FRANCE and GERMANY either way
round, revenue (scale 4) per (supp_nation, cust_nation, l_year)."""

import torch

from ._common import days, group_sums, key_table, lookup

ORDER_BY = ["supp_nation", "cust_nation", "l_year"]
LIMIT = None


def join_graph(t):
    """Per lineitem row: whether it ships in 1995-1996 and joins through
    supplier and orders -> customer, and both nation-name codes."""
    name_of_nation = key_table(t["n_nationkey"], t["n_name"])
    supp_nation = lookup(name_of_nation, lookup(key_table(t["s_suppkey"], t["s_nationkey"]),
                                                t["l_suppkey"]))
    okeys = t["o_orderkey"]
    pos = torch.searchsorted(okeys, t["l_orderkey"]).clamp(max=len(okeys) - 1)
    custkey = torch.where(okeys[pos] == t["l_orderkey"], t["o_custkey"][pos],
                          torch.full_like(pos, -1))
    cust_nation = lookup(name_of_nation, lookup(key_table(t["c_custkey"], t["c_nationkey"]),
                                                custkey))
    d = t["l_shipdate"]
    live = ((d >= days("1995-01-01")) & (d <= days("1996-12-31"))
            & (supp_nation >= 0) & (cust_nation >= 0))
    volume = t["l_extendedprice"] * (100 - t["l_discount"])
    return live, supp_nation, cust_nation, volume


def answer(t, params, control=False):
    live, sn, cn, volume = join_graph(t)
    fr, de = t.code("n_name", "FRANCE"), t.code("n_name", "GERMANY")
    m = live & (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr)))
    year = t.year(t["l_shipdate"][m])
    keys, inv = torch.unique(torch.stack([sn[m], cn[m], year], 1), dim=0,
                             return_inverse=True)
    sums = group_sums(inv.reshape(-1), volume[m], len(keys))
    return {"supp_nation": t.names("n_name", keys[:, 0]),
            "cust_nation": t.names("n_name", keys[:, 1]),
            "l_year": keys[:, 2].tolist(), "revenue": sums}
