"""The share of the profiled slice with no kernel running on the device (%)."""


def read(run):
    tr = run.trace
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
