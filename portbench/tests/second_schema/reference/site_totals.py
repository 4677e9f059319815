"""site_totals: readings from January 1 of YEAR on, joined to their site;
per region, the sum of the values (DECIMAL(12,4) mantissas) and the
count, by region."""

from ._common import days, group_counts, group_sums, lookup, row_of

ORDER_BY = ["st_region"]
LIMIT = None


def answer(t, params, control=False):
    m = t["rd_day"] >= days(f"{int(params['YEAR']):04d}-01-01")
    site = lookup(row_of(t["st_sitekey"]), t["rd_sitekey"][m])
    region = t["st_region"][site]
    codes, inv = region.unique(return_inverse=True)
    n = len(codes)
    if control:
        vals = t["rd_value"][m].double() / 10 ** 4
        sums = [round(float(v) * 10 ** 4) for v in
                vals.new_zeros(n).index_add_(0, inv, vals).tolist()]
    else:
        sums = group_sums(inv, t["rd_value"][m], n)
    return {"st_region": t.names("st_region", codes), "total": sums,
            "n": group_counts(inv, n)}
