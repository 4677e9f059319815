"""The service layer's share of a request (ms): the client's latency less
the engine's own ``summary.wall_seconds``, averaged over every answered
request.  It covers HTTP, the plan's JSON decode, ``to_pylists`` and the
JSON out, and the wait for an admission slot."""


def read(run):
    ok = run.answered
    if not ok:
        return None
    return sum((r["t_done"] - r["t_send"] - r["wall_seconds"]) * 1e3 for r in ok) / len(ok)
