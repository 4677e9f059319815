"""A configuration of another schema than TPC-H is added as files alone.

A copy of ``portbench/`` and ``BENCHMARK.json`` gets the files of
``second_schema/``: a two-table schema with its generator, one query
shape in the port's plan JSON with its plain reference, a one-client
mix, and in the copy's ``BENCHMARK.json`` a configuration and a cell.
``run.py --rehearse`` is correct over the cell, ``control.py
--rehearse`` runs over it, and no file of the harness differs between
the copy and the tree."""

import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
TOY = Path(__file__).resolve().parent / "second_schema"
CELL = "sensors_toy.totals_1client"


def _files(top: Path):
    return {p.relative_to(top) for p in top.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("second_schema")
    shutil.copytree(PKG, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for rel in sorted(_files(TOY) - {Path("benchmark.json")}):
        dst = root / "portbench" / rel
        assert not dst.exists(), rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(TOY / rel, dst)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in json.loads((TOY / "benchmark.json").read_text()).items():
        bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "tiflash_tpu_torch").symlink_to(ROOT / "tiflash_tpu_torch")
    return root


def _run(copy, *argv):
    out = subprocess.run([sys.executable, *argv], cwd=copy, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_run_is_correct_over_the_second_schema(copy):
    out = _run(copy, "portbench/run.py", "--workload", CELL, "--seed", str(2 ** 31 + 7),
               "--seconds", "2", "--trace", "0", "--rehearse", "1")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0, out.stderr[-3000:]
    assert res["limits"]["wrong_answers"]["value"] == 0
    assert {"qps", "setup_s"} <= set(res["metrics"])


def test_control_runs_over_the_second_schema(copy):
    out = _run(copy, "portbench/control.py", "--workload", CELL, "--seeds", "1,2",
               "--requests", "3", "--rehearse", "1")
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["requests"] for x in lines[:-1]] == [3, 3]
    assert lines[-1]["control_least_wrong_answers"] is not None


def test_no_harness_file_differs(copy):
    theirs = _files(copy / "portbench")
    ours = _files(PKG)
    assert theirs - ours == _files(TOY) - {Path("benchmark.json")}
    assert ours <= theirs
    same, differ, errors = filecmp.cmpfiles(PKG, copy / "portbench", sorted(map(str, ours)),
                                            shallow=False)
    assert not differ and not errors
