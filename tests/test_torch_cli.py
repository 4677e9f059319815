"""The PyTorch port's CLI against the JAX package's.

Mirrors ``tests/test_cli.py``: a REPL session (tables, explain, a plan,
summary, a bad line, quit) prints the reference REPL's rows, and the
``tables`` and ``metrics`` commands run, here on ``--device cpu``.  Also:
``query`` on a plan file prints the rows ``run_query`` gives, and
``--distributed`` raises naming the distribution slice.
"""

import io
import json

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.cli import _repl as j_repl
from tiflash_tpu.storage.catalog import Catalog as JCatalog
from tiflash_tpu.testing import oracle as O

from tiflash_tpu_torch.cli import _repl, main
from tiflash_tpu_torch.storage.catalog import Catalog, blocks_from_numpy
from tiflash_tpu_torch.testing.bridge import export_blocks


def _catalogs():
    schema = {"k": jdt.INT64, "v": jdt.INT64}
    table = O.random_pytable(np.random.default_rng(1), 50, schema, null_prob=0)
    b = O.pytable_to_block(table, schema)
    jcat = JCatalog()
    jcat.register("t", dict(zip(b.names, b.columns)))
    cat = Catalog()
    cat.register("t", blocks_from_numpy(export_blocks({"t": b}), "cpu")["t"].as_dict())
    return cat, jcat, table


PLAN = {"exec": "Aggregation", "keys": ["k"],
        "aggs": [{"func": "sum", "arg": "v", "name": "s",
                  "filter_col": None, "param": None}],
        "num_slots": None, "mode": None,
        "child": {"exec": "TableScan", "table": "t", "columns": None}}


def _rows(text):
    """The tab-separated result lines of a REPL transcript, sorted."""
    return sorted(line.split("> ")[-1] for line in text.splitlines()
                  if "\t" in line and not line.startswith("k\t"))


def test_repl_session():
    cat, jcat, table = _catalogs()
    cmds = "\n".join([
        "tables",
        "explain " + json.dumps(PLAN),
        json.dumps(PLAN),
        "summary",
        "not json at all",
        "quit",
    ]) + "\n"
    out, jout = io.StringIO(), io.StringIO()
    assert _repl(cat, None, limit=100, inp=io.StringIO(cmds), outp=out, device="cpu") == 0
    assert j_repl(jcat, None, limit=100, inp=io.StringIO(cmds), outp=jout) == 0
    text = out.getvalue()
    assert "t  rows=50" in text
    assert "Aggregation" in text          # explain output
    assert "k\ts" in text                  # result header
    assert "TableScan" in text             # summary plan text
    assert "error:" in text                # bad input reported, loop survived
    want = O.o_aggregate(table, ["k"], [("sum", "v", "s")])
    assert f"{want['k'][0]}\t{want['s'][0]}" in text
    assert _rows(text) == _rows(jout.getvalue())


def test_cli_tables_and_metrics(capsys):
    main(["--tpch-sf", "0.001", "--tables", "region", "--device", "cpu", "tables"])
    out = capsys.readouterr().out
    assert "region" in out and "rows=5" in out
    main(["metrics"])
    assert json.loads(capsys.readouterr().out)


def test_cli_query_prints_run_query_rows(tmp_path, capsys):
    from tiflash_tpu_torch.bench.tpch_queries import q1_plan
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.runtime.executor import run_query
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    plan_file = tmp_path / "q1.json"
    plan_file.write_text(serde.dumps(q1_plan()))
    main(["--tpch-sf", "0.001", "--tables", "lineitem", "--device", "cpu",
          "query", str(plan_file)])
    lines = capsys.readouterr().out.splitlines()
    cols = run_query(q1_plan(), generate_tpch(sf=0.001, seed=0, tables=["lineitem"])
                     .blocks("cpu"))[0].to_pylists()
    names = list(cols)
    assert lines[0] == "\t".join(names)
    assert lines[1:] == ["\t".join(str(cols[c][i]) for c in names)
                         for i in range(len(cols[names[0]]))]
    with pytest.raises(NotImplementedError, match="distribution slice"):
        main(["--tpch-sf", "0.001", "--distributed", "--device", "cpu", "tables"])
