"""The runner's retries (``summary.retries``: a capacity that overflowed
and was grown) per answered request."""


def read(run):
    ok = run.answered
    return sum(r["retries"] for r in ok) / len(ok) if ok else None
