"""The service's work on a request's answer (ms), per request completed
in the profiled slice: its spans ``service.result`` (the result block to
Python lists, ``to_pylists``) and ``service.encode`` (the reply's JSON
and its write)."""

from portbench import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    return sum(q.total_ms("service.result", "service.encode") for q in reqs) / len(reqs)
