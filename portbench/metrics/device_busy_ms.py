"""Kernel time per request (ms): the union of the kernels' activity in the
profiled slice, over the requests completed in it.  Copies and sets are
``copy_ms``'s."""


def read(run):
    tr = run.trace
    if not tr or tr["busy_s"] <= 0 or not tr["requests_done"]:
        return None
    return tr["busy_s"] * 1e3 / len(tr["requests_done"])
