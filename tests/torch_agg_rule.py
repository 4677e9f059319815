"""The one place where the port's aggregation methods depart from the
reference's: an integer or date group key whose range stats prove a span
of at most ``DIRECT_DOMAIN_LIMIT`` values has a dense domain in the port
(``ops/aggregate.py:key_range``), so where the reference, which gives a
domain only to dictionary strings and bools, sorts, the port aggregates
by the direct method.  Tests that hold the port's methods to the
reference's call by call hold them to this rule."""

from tiflash_tpu_torch.ops import aggregate as TA


def ranged(block, keys) -> bool:
    """Whether the port's dense domain for ``keys`` rests on a key's
    range stats (no static domain without them)."""
    return any(TA.key_domain_size(block[k], ranged=False) is None for k in keys)


def record_ranged(monkeypatch, seen):
    """Wrap the port's ``aggregate_direct`` so that ``seen`` gets
    (keys, domain, whether it took the ``direct_agg`` kernel branch) of
    every call whose domain rests on range stats."""
    real = TA.aggregate_direct

    def spy(b, k, a, sd, use_kernel=None):
        if ranged(b, k):
            seen.append((tuple(k), sd[1],
                         TA.direct_submethod(b, a, sd[1], use_kernel) == "direct"))
        return real(b, k, a, sd, use_kernel)

    monkeypatch.setattr(TA, "aggregate_direct", spy)


def by_rule(j_calls, seen):
    """The reference's calls ``(method, keys, ...)`` as the port must make
    them: a sort whose keys the port ran on a ranged dense domain becomes
    ``direct``."""
    keys = {k for k, _, _ in seen}
    return [("direct",) + tuple(c[1:]) if c[0] == "sort" and tuple(c[1]) in keys else c
            for c in j_calls]


def kernel_calls(seen) -> int:
    """How many of the ranged calls took the ``direct_agg`` kernel branch."""
    return sum(kernel for _, _, kernel in seen)
