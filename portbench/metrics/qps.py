"""Queries answered per second: the sum over the clients of each one's
answers over its own window, from the opening to its last reply.  A
client of a stream mix stops at the end of a pass, so each rate is taken
over whole passes, and a client that finishes first does not count the
others' last pass as its idle time."""


def read(run):
    ends, counts = {}, {}
    for r in run.records:
        k = r["client"]
        ends[k] = max(ends.get(k, run.t0), r["t_done"])
        counts[k] = counts.get(k, 0) + (r["status"] == 200)
    rates = [counts[k] / (ends[k] - run.t0) for k in counts if ends[k] > run.t0]
    return sum(rates) if rates and sum(counts.values()) else None
