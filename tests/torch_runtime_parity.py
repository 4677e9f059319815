"""Shared helpers of the runtime-slice parity tests (``test_torch_*``):
carry the reference's tables into the port, run one plan through both
packages' ``QueryRunner`` at the same settings, and count the pieces an
out-of-core run of the reference made.

Not a test module: the parity test files import it.
"""

import contextlib
import dataclasses

from tiflash_tpu.runtime import outofcore as JOC
from tiflash_tpu.runtime.executor import QueryRunner as JRunner
from tiflash_tpu.runtime.metrics import METRICS as J_METRICS
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.runtime.executor import QueryRunner as TRunner
from tiflash_tpu_torch.runtime.settings import Settings as TSettings
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks


def to_port(j_tables):
    """The reference's blocks as port blocks on the CPU."""
    return blocks_from_numpy(export_blocks(j_tables), "cpu")


def rows(block):
    """A block's live rows as a row-sorted pytable (both packages)."""
    return O.sort_pytable(block.compact().to_pylists())


# float aggregates (variance) add in another order in each package
FLOAT_REL = 1e-12


def assert_rows_equal(got, want):
    """Row-sorted pytables equal: exact, floats within ``FLOAT_REL``."""
    assert got.keys() == want.keys()
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float) and a is not None and b is not None:
                assert abs(a - b) <= FLOAT_REL * max(1.0, abs(b)), (k, a, b)
            else:
                assert a == b, (k, a, b)


def port_settings(j_settings: JSettings) -> TSettings:
    """The port's Settings with every field of the reference's."""
    return TSettings(**dataclasses.asdict(j_settings))


@contextlib.contextmanager
def reference_pieces():
    """Counts what the reference's out-of-core run did: ``pieces`` (the
    grace/groupagg partition count, the sliced run count, or the chunk
    count) and ``merge_buckets`` of a bucketed final merge."""
    got = {"partitions": [], "stored": 0, "merge_tries": []}
    real_part, real_store, real_merge = (JOC._partition_block, JOC._store_add,
                                         JOC._device_bucket_merge)

    def part(block, pid, P_, cap):
        got["partitions"].append(P_)
        return real_part(block, pid, P_, cap)

    def store(s, p, partition):
        got["stored"] += 1
        return real_store(s, p, partition)

    def merge(builder, partials, key_idx, P_):
        got["merge_tries"].append(P_)
        return real_merge(builder, partials, key_idx, P_)

    chunks0 = J_METRICS.dump()["ooc_chunks_total"]
    JOC._partition_block, JOC._store_add, JOC._device_bucket_merge = part, store, merge
    try:
        yield got
    finally:
        JOC._partition_block, JOC._store_add, JOC._device_bucket_merge = (
            real_part, real_store, real_merge)
        got["chunks"] = int(J_METRICS.dump()["ooc_chunks_total"] - chunks0)


def ref_pieces(got: dict, mode: str) -> int:
    if mode == "chunked":
        return got["chunks"]
    if mode in ("grace", "groupagg"):
        return got["partitions"][0]
    return got["stored"]


def run_both(j_plan, t_plan, j_tables, j_settings: JSettings, t_tables=None,
             t_kwargs=None):
    """Run one plan through both runners at the same settings.  Returns
    (reference out, reference summary, reference pieces, port out, port
    summary)."""
    t_tables = to_port(j_tables) if t_tables is None else t_tables
    with reference_pieces() as got:
        want, js = JRunner(j_plan, settings=j_settings).run(j_tables)
    out, ts = TRunner(t_plan, settings=port_settings(j_settings),
                      **(t_kwargs or {})).run(t_tables)
    return want, js, got, out, ts


def assert_same_out_of_core(make_j, make_t, j_tables, j_settings, mode,
                            t_tables=None):
    """``make_j``/``make_t`` build the same plan in each package.  At
    ``j_settings`` the port takes the reference's out-of-core ``mode``
    with the same piece count (and the same final-merge bucket tries),
    prints the same plan text and returns the reference's rows; they are
    also the port's in-memory rows (the types may widen out of core, as
    the reference's do).  Returns the port's summary."""
    t_tables = to_port(j_tables) if t_tables is None else t_tables
    want, js, got, out, ts = run_both(make_j(), make_t(), j_tables, j_settings,
                                      t_tables)
    assert f"[{mode} out-of-core]" in js.plan_text
    assert ts.plan_text == js.plan_text
    assert ts.out_of_core["mode"] == mode
    assert ts.out_of_core["pieces"] == ref_pieces(got, mode)
    assert ts.out_of_core.get("merge_tries", []) == got["merge_tries"]
    assert_rows_equal(rows(out), rows(want))
    assert [repr(c.dtype) for c in out.columns] == [repr(c.dtype) for c in want.columns]
    in_memory, mem_summary = TRunner(make_t()).run(t_tables)
    assert "out-of-core" not in mem_summary.plan_text
    assert_rows_equal(rows(out), rows(in_memory))
    return ts
