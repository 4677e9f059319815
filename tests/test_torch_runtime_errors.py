"""The runtime error channel of the port against the JAX package's.

A host table entry that is an ``EvalError`` (text that is not JSON under
CAST(AS JSON), an invalid escape under JSON_UNQUOTE, a NULL JSON_OBJECT
key, a document past MySQL's nesting cap) becomes a per-row mask; the
fragment compiler folds the masks of live rows into flags, and the
runner raises ``EngineError`` (code ``RUNTIME_EVAL``) once a run is
capacity-clean.  The cases are ``tests/test_runtime_errors.py``'s that
reach a LUT, each run through both packages' ``run_query``: a live-row
error raises the same message in both, a filtered-out row raises in
neither, and an error flag never causes a capacity retry.
"""

import pytest
import torch

import tiflash_tpu.core.dtypes as JD
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops import sort as JS
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.plan.compiler import compile_fragment as j_compile
from tiflash_tpu.runtime.errors import EngineError as JEngineError
from tiflash_tpu.runtime.executor import run_query as j_run
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops import sort as TS
from tiflash_tpu_torch.plan import compiler as TCmp
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime import errors as TR
from tiflash_tpu_torch.runtime import executor as TX
from tiflash_tpu_torch.storage.catalog import blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks

SCHEMA = {"flag": JD.INT64, "s": JD.STRING.with_nullable(True)}
ROWS = {"flag": [0, 1, 2], "s": [None, "not json", '{"a": 1}']}
BAD_JSON = "Invalid JSON text: The document root must not be followed by other values."


def _tables(rows, schema=SCHEMA):
    j = {"t": O.pytable_to_block(rows, schema)}
    return j, blocks_from_numpy(export_blocks(j), "cpu")


def _json_cast_plan(E, P, pred=None):
    child = P.TableScan("t")
    if pred is not None:
        child = P.Selection(pred(E), child)
    return P.Projection({"r": E.call("cast_as_json", E.col("s"))}, child)


def _unquote_plan(E, P, keep=None):
    child = P.TableScan("t")
    if keep is not None:
        child = P.Selection(E.call("not_equals", E.col("flag"), E.lit(keep)), child)
    return P.Projection({"r": E.call("json_unquote", E.col("s"))}, child)


def run_both(make_plan, rows, schema=SCHEMA):
    """Both packages' run_query: (outcome, value) each, where the outcome
    is "ok" with the rows, or "error" with (message, code)."""
    j_tables, t_tables = _tables(rows, schema)
    out = []
    for run, E, P, tables, err in ((j_run, JE, JP, j_tables, JEngineError),
                                   (TX.run_query, TE, TP, t_tables, TR.EngineError)):
        try:
            res, _ = run(make_plan(E, P), tables)
        except err as e:
            out.append(("error", (str(e), e.code)))
        else:
            out.append(("ok", res.to_pylists()))
    return out


CASES = {
    "cast_invalid_json": (lambda E, P: _json_cast_plan(E, P), ROWS),
    "cast_invalid_json_filtered": (
        lambda E, P: _json_cast_plan(
            E, P, lambda E: E.call("not_equals", E.col("flag"), E.lit(1))), ROWS),
    "cast_null_rows": (lambda E, P: _json_cast_plan(E, P),
                       {"flag": [0, 1], "s": [None, '"ok"']}),
    "json_depth_cap": (lambda E, P: _json_cast_plan(E, P),
                       {"flag": [0], "s": ["[" * 110 + "]" * 110]}),
    "unquote_invalid_escape": (lambda E, P: _unquote_plan(E, P),
                               {"flag": [0, 1], "s": ['"hello world"', '"hello\\ "']}),
    "unquote_bad_row_dropped": (lambda E, P: _unquote_plan(E, P, keep=1),
                                {"flag": [0, 1], "s": ['"hello world"', '"hello\\ "']}),
    "error_survives_topn": (
        lambda E, P: P.TopN([(JS if P is JP else TS).SortKey("flag")], 1,
                            P.Projection({"flag": E.col("flag"),
                                          "r": E.call("json_unquote", E.col("s"))},
                                         P.TableScan("t"))),
        {"flag": [0, 1], "s": ['"ok"', '"bad\\ "']}),
    "selection_error_on_live_row": (
        lambda E, P: P.Selection(E.call("json_valid", E.call("cast_as_json",
                                                             E.col("s"))),
                                 P.TableScan("t")), ROWS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_error_channel_matches_reference(case):
    make, rows = CASES[case]
    (jk, jv), (tk, tv) = run_both(make, rows)
    assert (tk, tv) == (jk, jv)
    if tk == "error":
        assert tv[1] == TR.RUNTIME_EVAL


def test_expected_outcomes():
    """What the reference's own tests pin, seen through the port."""
    assert run_both(*CASES["cast_invalid_json"])[1] == ("error", (BAD_JSON, TR.RUNTIME_EVAL))
    assert run_both(*CASES["cast_invalid_json_filtered"])[1] == (
        "ok", {"r": [None, '{"a": 1}']})
    assert run_both(*CASES["unquote_bad_row_dropped"])[1] == (
        "ok", {"r": ["hello world"]})
    assert "maximum depth" in run_both(*CASES["json_depth_cap"])[1][1][0]


def test_json_object_keys():
    schema = {"k": JD.STRING.with_nullable(True), "v": JD.INT64}

    def plan(E, P):
        return P.Projection({"r": E.call("json_object", E.col("k"), E.col("v"))},
                            P.TableScan("t"))

    (jk, jv), (tk, tv) = run_both(plan, {"k": [None, "a"], "v": [1, 2]}, schema)
    assert (tk, tv) == (jk, jv) and "NULL member names" in tv[0]
    schema = {"k1": JD.STRING, "v1": JD.INT64, "k2": JD.STRING, "v2": JD.STRING}

    def plan2(E, P):
        return P.Projection({"r": E.call("json_object", E.col("k1"), E.col("v1"),
                                          E.col("k2"), E.col("v2"))},
                            P.TableScan("t"))

    rows = {"k1": ["b", "dup"], "v1": [1, 2], "k2": ["a", "dup"], "v2": ["x", "last"]}
    both = run_both(plan2, rows, schema)
    assert both[0] == both[1] == ("ok", {"r": ['{"a": "x", "b": 1}', '{"dup": "last"}']})


def test_zero_arg_call_rejected_alike():
    def plan(E, P):
        return P.Projection({"r": E.call("least")}, P.TableScan("t"))

    (jk, jv), (tk, tv) = run_both(plan, ROWS)
    assert jk == tk == "error" and tv[0] == jv[0]


def test_compile_fragment_flags_match_reference():
    """The fragment's flag dict: overflow keys and, under RTERR_PREFIX, one
    flag per error message, set only for a live row."""
    j_tables, t_tables = _tables(ROWS)
    for pred, want in ((None, 1), (lambda E: E.call("not_equals", E.col("flag"),
                                                    E.lit(1)), 0)):
        _, jf = j_compile(_json_cast_plan(JE, JP, pred))(j_tables)
        _, tf = TCmp.compile_fragment(_json_cast_plan(TE, TP, pred))(t_tables)
        assert sorted(tf) == sorted(jf) == [TR.RTERR_PREFIX + BAD_JSON]
        assert int(tf[TR.RTERR_PREFIX + BAD_JSON]) == int(jf[TR.RTERR_PREFIX + BAD_JSON]) \
            == want


def _spy_runs(monkeypatch, overflow_first=False):
    """Counts the runner's executions; with ``overflow_first`` the first
    Aggregation reports an overflow."""
    from tiflash_tpu_torch.ops.aggregate import AggregateResult

    runs, aggs = [], []
    real_exec, real_agg = TX.execute_plan, TCmp.hash_aggregate

    def execute(*a, **k):
        runs.append(1)
        return real_exec(*a, **k)

    def agg(*args):
        res = real_agg(*args)
        aggs.append(1)
        if overflow_first and len(aggs) == 1:
            return AggregateResult(res.block, res.num_groups, torch.tensor(100))
        return res

    monkeypatch.setattr(TX, "execute_plan", execute)
    monkeypatch.setattr(TCmp, "hash_aggregate", agg)
    return runs


def _agg_over_error_plan():
    from tiflash_tpu_torch.ops.aggregate import AggDesc

    proj = TP.Projection({"flag": TE.col("flag"),
                          "r": TE.call("cast_as_json", TE.col("s"))},
                         TP.TableScan("t"))
    return TP.Aggregation(["r"], [AggDesc("count", None, "n")], proj)


def test_error_never_triggers_a_retry(monkeypatch):
    runs = _spy_runs(monkeypatch)
    _, t_tables = _tables(ROWS)
    with pytest.raises(TR.EngineError, match="Invalid JSON text"):
        TX.run_query(_agg_over_error_plan(), t_tables, fuse_stream_agg=False)
    assert runs == [1]


def test_capacity_overflow_wins_over_an_error(monkeypatch):
    """A run with an overflow is retried, error or not; the error raises
    from the capacity-clean run."""
    runs = _spy_runs(monkeypatch, overflow_first=True)
    _, t_tables = _tables(ROWS)
    with pytest.raises(TR.EngineError, match="Invalid JSON text"):
        TX.run_query(_agg_over_error_plan(), t_tables, fuse_stream_agg=False)
    assert runs == [1, 1]


def test_flags_are_read_in_one_host_read(monkeypatch):
    """``read_flags`` stacks every flag and reads them with one
    ``tolist``: a retry-clean run with an error reads once."""
    calls = []
    real = TX.read_flags

    def spy(flags):
        calls.append(sorted(flags))
        return real(flags)

    monkeypatch.setattr(TX, "read_flags", spy)
    _, t_tables = _tables(ROWS)
    with pytest.raises(TR.EngineError):
        TX.run_query(_agg_over_error_plan(), t_tables, fuse_stream_agg=False)
    assert calls == [["Aggregation_1", TR.RTERR_PREFIX + BAD_JSON]]
    assert TX.read_flags({"a": torch.tensor([0, 3]), "b": torch.tensor(True)}) == \
        {"a": 3, "b": 1}
