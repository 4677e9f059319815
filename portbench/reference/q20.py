"""TPC-H Q20's shape, potential part promotion: quantity shipped in 1994
per (partkey, suppkey); the partsupp rows with such shipments whose
availqty x 200 exceeds it (an integer against a scale-2 sum, compared as
whole units); CANADA's suppliers among them, by s_suppkey."""

import torch

from ._common import days, key_table, lookup

ORDER_BY = ["s_suppkey"]
LIMIT = None


def answer(t, params, control=False):
    d = t["l_shipdate"]
    m = (d >= days("1994-01-01")) & (d < days("1995-01-01"))
    key = t["l_partkey"][m] * (1 << 32) + t["l_suppkey"][m]
    pairs, inv = torch.unique(key, return_inverse=True)
    # at most a few lines share a pair: an int64 sum of quantities is exact
    shipped = torch.zeros(len(pairs), dtype=torch.int64, device=key.device).index_add_(
        0, inv, t["l_quantity"][m])
    ps_key = t["ps_partkey"] * (1 << 32) + t["ps_suppkey"]
    if not len(pairs):
        return {"s_suppkey": []}
    pos = torch.searchsorted(pairs, ps_key).clamp(max=len(pairs) - 1)
    excess = (pairs[pos] == ps_key) & (t["ps_availqty"] * 200 * 100 > shipped[pos])
    supp = torch.unique(t["ps_suppkey"][excess])
    canada = t.code("n_name", "CANADA")
    nation = lookup(key_table(t["n_nationkey"], t["n_name"]), t["s_nationkey"])
    s_ok = (nation == canada) & torch.isin(t["s_suppkey"], supp)
    return {"s_suppkey": sorted(t["s_suppkey"][s_ok].tolist())}
