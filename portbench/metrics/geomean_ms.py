"""The geometric mean of every request's latency (ms), as TPC-H's
Power@Size weighs its queries."""

import math


def read(run):
    lat = run.latencies_ms()
    if not lat:
        return None
    return math.exp(sum(math.log(x) for x in lat) / len(lat))
