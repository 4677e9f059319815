"""TPC-H Q1, pricing summary report: lines shipped by 1998-12-01 less
DELTA days, grouped by (l_returnflag, l_linestatus): sums of quantity,
price, discounted price (scale 4) and charge (scale 6), averages of
quantity, price and discount (scale 6, half up) and the count."""

import torch

from ._common import days, group_counts, group_sums, half_up_div

ORDER_BY = ["l_returnflag", "l_linestatus"]
LIMIT = None
SCAN = {"predicates": ["l_shipdate"],
        "values": ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                   "l_returnflag", "l_linestatus"]}


def cutoff(params) -> int:
    return days("1998-12-01") - int(params["DELTA"])


def live(t, params):
    return t["l_shipdate"] <= cutoff(params)


def _values(t, m):
    qty, ext = t["l_quantity"][m], t["l_extendedprice"][m]
    disc, tax = t["l_discount"][m], t["l_tax"][m]
    disc_price = ext * (100 - disc)
    return qty, ext, disc, disc_price, disc_price * (100 + tax)


_OUT = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
        "avg_price", "avg_disc", "count_order")


def answer(t, params, control=False):
    m = live(t, params)
    rf, ls = t["l_returnflag"][m], t["l_linestatus"][m]
    n_ls = len(t.dict("l_linestatus"))
    inv = rf * n_ls + ls
    n_groups = len(t.dict("l_returnflag")) * n_ls
    counts = group_counts(inv, n_groups)
    if control:
        sums = _float_sums(inv, n_groups, *_values(t, m)[:2], t["l_discount"][m],
                           t["l_tax"][m])
    else:
        sums = [group_sums(inv, v, n_groups) for v in _values(t, m)]
    return _rows(t, n_ls, counts, sums, control)


def _rows(t, n_ls, counts, sums, control):
    out = {k: [] for k in ORDER_BY + list(_OUT)}
    for g, n in enumerate(counts):
        if not n:
            continue
        sq, se, sd, sdp, sc = (s[g] for s in sums)
        out["l_returnflag"].append(t.dict("l_returnflag")[g // n_ls])
        out["l_linestatus"].append(t.dict("l_linestatus")[g % n_ls])
        out["sum_qty"].append(sq)
        out["sum_base_price"].append(se)
        out["sum_disc_price"].append(sdp)
        out["sum_charge"].append(sc)
        if control:
            out["avg_qty"].append(round(sq / 100 / n * 1e6))
            out["avg_price"].append(round(se / 100 / n * 1e6))
            out["avg_disc"].append(round(sd / 100 / n * 1e6))
            continue
        out["avg_qty"].append(half_up_div(sq * 10 ** 4, n))
        out["avg_price"].append(half_up_div(se * 10 ** 4, n))
        out["avg_disc"].append(half_up_div(sd * 10 ** 4, n))
    out["count_order"] = [n for n in counts if n]
    return out


def _float_sums(inv, n_groups, qty, ext, disc, tax):
    """The control: DECIMAL as float64, each sum rounded back to its
    scale at the end (sum_qty, sum_base_price and the discount sum at 2,
    the discounted price at 4, the charge at 6)."""
    q, e, d, x = (v.double() / 100 for v in (qty, ext, disc, tax))
    dp = e * (1 - d)
    ch = dp * (1 + x)

    def fsum(v):
        return torch.zeros(n_groups, dtype=torch.float64, device=v.device).index_add_(
            0, inv, v).tolist()

    sums = [fsum(v) for v in (q, e, d, dp, ch)]
    scales = (2, 2, 2, 4, 6)
    return [[round(s * 10 ** sc) for s in col] for col, sc in zip(sums, scales)]
