"""The fused scans' share of their byte roofline (%): over the requests
completed in the profiled slice whose reference declares a scan
(``bytes_model.py``: Q1 and Q6), the bytes each must read over 3.35 TB/s,
divided by the kernel time inside those requests' own intervals.
Read only where no two requests of the slice overlap (a one-client mix),
so that the device time inside an interval is that request's."""

from portbench.bytes_model import HBM_BYTES_PER_S


def read(run):
    tr = run.trace
    if not tr or not tr["own_busy"]:
        return None
    need = busy = 0.0
    for r, own in tr["own_busy"]:
        ref = run.references[r["shape"]]
        if r["status"] == 200 and hasattr(ref, "SCAN"):
            need += run.scan_bytes.bytes(r["key"], ref, run.tables, r["params"]) / HBM_BYTES_PER_S
            busy += own
    return 100.0 * need / busy if busy > 0 else None
