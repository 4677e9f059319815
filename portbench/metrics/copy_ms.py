"""Device copy time per request (ms): the union of the copies and sets
(``Memcpy ...``, ``Memset ...``) in the profiled slice, over the
requests completed in it.  Apart from the kernels' time, which
``device_busy_ms`` reads."""


def read(run):
    tr = run.trace
    if not tr or tr["copy_s"] <= 0 or not tr["requests_done"]:
        return None
    return tr["copy_s"] * 1e3 / len(tr["requests_done"])
