"""The joins' device time per request (ms): over the requests completed
in the profiled slice, the device time of the kernels launched inside
the program's ``join.<method>`` spans (``join.dense``, ``join.sorted``,
``join.general``: one per hash join, around its build and probe), by
the profiler's correlation id (``trace.kernel_s``, as
``dense_agg_roofline``), summed over the request and averaged over the
requests; a request with no join counts 0.  A request whose join spans
do not lie wholly inside the slice is left out.  Read only where no two
requests of the slice overlap, and where the program records ``join.*``
spans.  Prints its sums to standard error."""

import sys

from portbench import spans, trace


def read(run):
    reqs = spans.requests(run)
    if not reqs or run.trace["overlap"]:
        return None
    if not any(s["name"].startswith("join.") for q in reqs for s in q.spans):
        return None
    total, n, joins = 0.0, 0, 0
    for q in reqs:
        if q.record["status"] != 200:
            continue
        own = [trace.kernel_s(run.trace, s["start_ns"], s["end_ns"]) for s in q.spans
               if s["name"].startswith("join.")]
        if None in own:
            continue
        total += sum(own)
        joins += len(own)
        n += 1
    if not n:
        return None
    print(f"join_device_ms: {n} requests, {joins} joins, {total * 1e3:.3f} ms of their "
          f"kernels", file=sys.stderr)
    return total * 1e3 / n
