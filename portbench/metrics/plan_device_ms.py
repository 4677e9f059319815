"""The device's time on a request's plan (ms), per request completed in
the profiled slice: the root ``op.*`` span's ``device_ms`` (the stream's
time between CUDA event marks at the plan's entry and exit, unsynchronised),
summed over the request's attempts.  The program's own counterpart of
``device_busy_ms``: above it by the stretches inside the plan in which the
stream waited for the host."""

from portbench import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    per = [q.plan_device_ms() for q in reqs]
    if any(v is None for v in per):
        return None
    return sum(per) / len(per)
