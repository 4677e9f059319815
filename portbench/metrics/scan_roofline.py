"""The fused scans' share of their byte roofline (%): over the requests
completed in the profiled slice whose reference declares a scan
(``bytes_model.py``: Q1 and Q6), the bytes each must read over 3.35 TB/s,
divided by the device time of the kernels that the request's own
``runner.attempt`` spans launched (the plan's execution and the read of
its flags; ``trace.kernel_s`` finds each kernel's launch by the
profiler's correlation id, and ``spans.py`` matches the spans to the
load generator's records).  The request's decoding, auto-sizing and
result gather are left out, and so is every kernel another request
launched, wherever the trace puts it in time.  A request whose attempts
do not lie wholly inside the slice is left out.  Read only where no two
requests of the slice overlap (a one-client mix), and where the program
records spans.  Prints its sums to standard error, for the reckoning by
hand."""

import sys

from portbench import spans, trace
from portbench.bytes_model import HBM_BYTES_PER_S


def read(run):
    reqs = spans.requests(run)
    if not reqs or run.trace["overlap"]:
        return None
    need = busy = 0.0
    n = 0
    for q in reqs:
        r = q.record
        ref = run.references[r["shape"]]
        if r["status"] != 200 or not hasattr(ref, "SCAN"):
            continue
        own = [trace.kernel_s(run.trace, s["start_ns"], s["end_ns"])
               for s in q.children if s["name"] == "runner.attempt"]
        if not own or None in own:
            continue
        need += run.scan_bytes.bytes(r["key"], ref, run.tables, r["params"]) / HBM_BYTES_PER_S
        busy += sum(own)
        n += 1
    print(f"scan_roofline: {n} scan requests, {need * 1e3:.4f} ms at 3.35 TB/s over "
          f"{busy * 1e3:.4f} ms of their attempts' kernels", file=sys.stderr)
    return 100.0 * need / busy if busy > 0 else None
