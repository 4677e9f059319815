"""The share of the grouped aggregations' input rows that took a dense
method (%): over the requests completed in the profiled slice, the
``rows`` of the program's ``agg.masked``, ``agg.direct`` and
``agg.direct_segment`` spans over the ``rows`` of every grouped
aggregation's span (``agg.<method>`` but ``agg.scalar``: ``stream`` and
``sort`` besides).  A program that records no ``agg.*`` span reads
nothing."""

from portbench import spans

DENSE = ("agg.masked", "agg.direct", "agg.direct_segment")


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    dense = total = 0
    for q in reqs:
        for s in q.spans:
            if s["name"].startswith("agg.") and s["name"] != "agg.scalar":
                total += s["attrs"]["rows"]
                if s["name"] in DENSE:
                    dense += s["attrs"]["rows"]
    return 100.0 * dense / total if total else None
