"""A whole run on the CPU (``run.py --rehearse``) with the timed path
broken underneath: each fault a cell can have makes ``correct`` false,
and the unbroken run is correct."""

import json

import pytest

from portbench import run, system
from tiflash_tpu_torch.mpp import service as S

SF = 0.01


def result(capsys, cell, seed, seconds=2.0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "0", "--rehearse", str(SF)])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tpch_sf10.shapes22_1client"])
def test_sound_run_is_correct(capsys, cell):
    res = result(capsys, cell, 2 ** 31 + 5)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "limits"
    assert {"setup_s", "qps"} <= set(res["metrics"])


@pytest.mark.parametrize("cell", ["tpch_sf10.shapes22_1client"])
def test_altered_answer(capsys, monkeypatch, cell):
    """An answer altered where it is produced: one value of every answer
    of Q1 moves by one."""
    real = S.QueryService.execute

    def altered(self, plan_json, *a, **k):
        out = real(self, plan_json, *a, **k)
        cols = out["columns"]
        if "sum_qty" in cols and cols["sum_qty"]:
            cols["sum_qty"][0] += 1
        return out

    monkeypatch.setattr(S.QueryService, "execute", altered)
    res = result(capsys, cell, 11)
    assert not res["correct"] and res["limits"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["tpch_sf10.shapes22_1client"])
def test_half_the_rows_left_out(capsys, monkeypatch, cell):
    """Half of the batch left out: the service is given lineitem's first
    half, the reference the whole table."""
    real = system.build_catalog

    def halved(tables):
        import copy

        t = copy.copy(tables)
        li = copy.copy(tables["lineitem"])
        li.columns = {c: copy.copy(col) for c, col in li.columns.items()}
        n = len(li.columns["l_orderkey"].data) // 2
        for col in li.columns.values():
            col.data = col.data[:n]
        t["lineitem"] = li
        return real(t)

    monkeypatch.setattr(system, "build_catalog", halved)
    res = result(capsys, cell, 12)
    assert not res["correct"]


def test_failed_request(capsys, monkeypatch):
    """A request that fails counts in ``failed`` and makes the run wrong."""
    real = S.QueryService.execute
    calls = {"n": 0}

    def failing(self, plan_json, *a, **k):
        calls["n"] += 1
        if calls["n"] == 40:
            raise RuntimeError("planted failure")
        return real(self, plan_json, *a, **k)

    monkeypatch.setattr(S.QueryService, "execute", failing)
    res = result(capsys, "tpch_sf10.shapes22_1client", 14)
    assert res["failed"] == 1 and not res["correct"]


def test_no_card_no_result(capsys):
    """Without ``--rehearse`` and without a card, no result and a
    non-zero exit."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "tpch_sf10.shapes22_1client", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
