"""The runner's work before a request's first attempt (ms), per request
completed in the profiled slice: its spans ``runner.prepare`` (the plan
rewrites), ``runner.autosize`` (capacities from statistics and samples)
and ``runner.checks`` (the pre-flight limits and the memory estimate)."""

from portbench import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    names = ("runner.prepare", "runner.autosize", "runner.checks")
    return sum(q.total_ms(*names) for q in reqs) / len(reqs)
