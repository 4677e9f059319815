"""The dense aggregations' share of their byte roofline (%): over the
requests completed in the profiled slice whose reference declares
``DENSE = {"values": [...]}`` and that ran an ``agg.direct`` or
``agg.masked`` span, the bytes the aggregation must read over 3.35 TB/s,
divided by the device time of the kernels those spans launched
(``trace.kernel_s``, by the profiler's correlation id, as
``scan_roofline``).  The need is the bound of
``ops/cuda/direct_agg.py``'s docstring counted on the reference's live
rows (``live(t, params)``, the fact rows that reach the aggregation):
4 B of slot and 8 B per value column of each, whatever implements it.
A request whose spans do not lie wholly inside the slice is left out.
Read only where no two requests of the slice overlap, and where the
program records ``agg.*`` spans.  Prints its sums to standard error."""

import sys

from portbench import spans, trace
from portbench.bytes_model import HBM_BYTES_PER_S

SLOT_BYTES = 4
VALUE_BYTES = 8


def need_bytes(run, record, ref) -> int:
    """The bytes one request's dense aggregation must read, once per
    distinct request."""
    memo = run.__dict__.setdefault("dense_bytes", {})
    if record["key"] not in memo:
        live = int(ref.live(run.tables, record["params"]).sum())
        memo[record["key"]] = live * (SLOT_BYTES + VALUE_BYTES * len(ref.DENSE["values"]))
    return memo[record["key"]]


def read(run):
    reqs = spans.requests(run)
    if not reqs or run.trace["overlap"]:
        return None
    need = busy = 0.0
    n = 0
    for q in reqs:
        r = q.record
        ref = run.references[r["shape"]]
        if r["status"] != 200 or not hasattr(ref, "DENSE"):
            continue
        own = [trace.kernel_s(run.trace, s["start_ns"], s["end_ns"]) for s in q.spans
               if s["name"] in ("agg.direct", "agg.masked")]
        if not own or None in own:
            continue
        need += need_bytes(run, r, ref) / HBM_BYTES_PER_S
        busy += sum(own)
        n += 1
    print(f"dense_agg_roofline: {n} dense requests, {need * 1e6:.3f} us at 3.35 TB/s over "
          f"{busy * 1e6:.3f} us of their dense aggregations' kernels", file=sys.stderr)
    return 100.0 * need / busy if busy > 0 else None
