"""The configuration's data generator, found by name: a configuration
with no ``generator`` key is TPC-H's, ``datagen.py``, with the data
pinned by ``test_datagen.py``; a name that is not a generator fails
set-up with the run's error, which names it.  The reference's tables
take a column by its table where two tables share its name."""

import json

import numpy as np
import pytest

from portbench import dataset, datagen, run
from portbench.datagen import Col, Table
from portbench.reference._common import Tables
from portbench.tests.test_datagen import PINNED, digest


@pytest.mark.parametrize("name", ["tpch_sf10", "tpch_sf1"])
def test_tpch_configurations_resolve_to_datagen(name):
    conf = json.loads((dataset.ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    assert "generator" not in conf
    assert dataset.generator(conf) is datagen
    if name == "tpch_sf10":
        assert dataset.config(name) == conf


def test_no_generator_key_gives_tpch_tables():
    tables = dataset.generator({"scale_factor": 10}).generate(0.01, 0, "cpu")
    assert digest(tables) == PINNED


@pytest.mark.parametrize("name", ["no_such_generator", "../datagen", "check", 7])
def test_unknown_generator_is_refused(name):
    with pytest.raises(dataset.RunError, match=str(name).replace(".", r"\.")):
        dataset.generator({"generator": name})


def _renamed(module, monkeypatch, generator):
    """``module.load_cell`` with the configuration's generator renamed."""
    real = module.load_cell

    def load_cell(name):
        cell, conf, e2e, per_layer = real(name)
        return cell, dict(conf, generator=generator), e2e, per_layer

    monkeypatch.setattr(module, "load_cell", load_cell)


def test_unknown_generator_fails_setup(capsys, monkeypatch):
    """Through ``run.py``: no result, a non-zero exit, and one line that
    names the generator, with no traceback; ``control.py`` alike."""
    from portbench import control

    _renamed(run, monkeypatch, "tpch_by_another_name")
    rc = run.main(["--workload", "tpch_sf10.shapes22_1client", "--seed", "3", "--seconds", "1",
                   "--rehearse", "0.01"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "tpch_by_another_name" in out.err and "Traceback" not in out.err

    _renamed(control, monkeypatch, "nothing_here")
    rc = control.main(["--workload", "tpch_sf10.shapes22_1client", "--seeds", "1",
                       "--rehearse", "0.01"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "nothing_here" in out.err and "Traceback" not in out.err


def test_tables_with_a_shared_column_name():
    ints = np.array([3, 1, 2], dtype=np.int64)
    tables = {"a": Table({"k": Col(ints, "INT64"), "x": Col(ints * 10, "INT64")}, [], []),
              "b": Table({"k": Col(ints + 100, "INT64")}, [], [])}
    t = Tables(tables, "cpu")
    assert t["a.k"].tolist() == [3, 1, 2] and t["b.k"].tolist() == [103, 101, 102]
    assert t["x"].tolist() == t["a.x"].tolist() == [30, 10, 20]
    with pytest.raises(KeyError, match="more than one table"):
        t["k"]
    assert sorted(t.host) == ["a.k", "a.x", "b.k", "x"]
