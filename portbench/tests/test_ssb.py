"""The Star Schema Benchmark's configuration, added as files alone
(``dataset.py``'s route): its generator follows the specification's
rules, the cell is correct over a CPU rehearsal and its control reads
wrong answers, no harness file names it, and its two metric readers
read synthetic runs."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from portbench import dataset, spans, ssb_datagen, trace, traffic
from portbench.bytes_model import HBM_BYTES_PER_S
from portbench.metrics import dense_agg_roofline, dense_agg_share
from portbench.tests.test_spans import MS, _rec, _run, _span
from portbench.tests.test_trace import Event, launched, reduced

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
CELL = "ssb_sf10.flights13_1client"
HARNESS = ("run.py", "dataset.py", "system.py", "check.py", "control.py", "traffic.py",
           "client.py", "trace.py", "spans.py", "bytes_model.py", "datagen.py")


@pytest.fixture(scope="module")
def tables():
    return ssb_datagen.generate(0.01, 2 ** 33 + 3, "cpu")


def test_the_configuration_resolves():
    conf = dataset.config("ssb_sf10")
    assert dataset.generator(conf) is ssb_datagen
    assert conf["scale_factor"] == 10 and conf["reduced"] == {}
    fixed = {k: v for k, v in conf["rows"].items() if isinstance(v, int)}
    assert fixed == {"customer": 30_000 * 10, "supplier": 2_000 * 10,
                     "part": ssb_datagen.n_parts(10), "date": 2557}
    assert ssb_datagen.n_parts(10) == 800_000 and ssb_datagen.n_parts(0.01) == 2_000
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert traffic.Mix(cell["traffic"], 1).queries.keys() == {
        p.stem for p in (PKG / "queries").glob("ssb_q*.json")}


def test_the_generator_follows_the_rules(tables):
    lo = {k: c.data.astype(np.int64) for k, c in tables["lineorder"].columns.items()}
    part = tables["part"].columns
    assert len(tables["lineorder"].columns) == 17 and len(tables["date"].columns) == 17
    assert [len(next(iter(tables[t].columns.values())).data)
            for t in ("customer", "supplier", "part", "date")] == [300, 20, 2000, 2557]
    p_key = part["p_partkey"].data.astype(np.int64)
    retail = 90000 + (p_key // 10) % 20001 + 100 * (p_key % 1000)
    price = retail[lo["lo_partkey"] - 1]
    assert (lo["lo_extendedprice"] == lo["lo_quantity"] * price).all()
    assert (lo["lo_revenue"] == lo["lo_extendedprice"] * (100 - lo["lo_discount"]) // 100).all()
    assert (lo["lo_supplycost"] == 6 * price // 10).all()
    dates = set(tables["date"].columns["d_datekey"].data.tolist())
    assert set(lo["lo_orderdate"].tolist()) <= dates and set(lo["lo_commitdate"].tolist()) <= dates
    assert min(dates) == 19920101 and max(dates) == 19981231

    def strings(t, c):
        col = tables[t].columns[c]
        return [col.dictionary[i] for i in col.data.tolist()]

    for m, c, b in zip(strings("part", "p_mfgr"), strings("part", "p_category"),
                       strings("part", "p_brand1")):
        assert c.startswith(m) and len(c) == len(m) + 1 and b.startswith(c)
        assert 1 <= int(b[len(c):]) <= 40
    for n, city in zip(strings("customer", "c_nation"), strings("customer", "c_city")):
        assert len(city) == 10 and city[:9] == f"{n[:9]:<9}" and city[9].isdigit()
    assert "Dec1997" in tables["date"].columns["d_yearmonth"].dictionary


def _run_py(*argv, cwd=ROOT):
    out = subprocess.run([sys.executable, *argv], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_the_cell_is_correct_over_a_rehearsal():
    out = _run_py("portbench/run.py", "--workload", CELL, "--seed", str(2 ** 31 + 11),
                  "--seconds", "2", "--trace", "0", "--rehearse", "0.01")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 13 and res["failed"] == 0, out.stderr[-3000:]
    assert {"qps", "setup_s"} <= set(res["metrics"])


def test_the_control_reads_wrong_answers():
    out = _run_py("portbench/control.py", "--workload", CELL, "--seeds", "5",
                  "--requests", "13", "--rehearse", "0.01")
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert lines[0]["requests"] == 13
    assert lines[-1]["control_least_wrong_answers"] >= 1


def test_no_harness_file_names_the_schema():
    for name in HARNESS:
        assert "ssb" not in (PKG / name).read_text().lower(), name


@pytest.fixture(autouse=True)
def recorder_off():
    spans.spans_off()


def _agg_request(base, qid, t_ms, method, rows, slots, keys=2):
    """One request: its attempt at ``t_ms`` + 1 holds an op.Aggregation
    with an ``agg.<method>`` span from 4 to 6 ms into the attempt."""
    a = t_ms + 1
    return [_span(base, "service.request", None, qid, t_ms, t_ms + 10),
            _span(base + 1, "runner.attempt", base, qid, a, a + 8, attempt=0),
            _span(base + 2, "op.Aggregation", base + 1, qid, a + 3, a + 7, nid="Aggregation_2"),
            _span(base + 3, f"agg.{method}", base + 2, qid, a + 4, a + 6, rows=rows,
                  slots=slots, keys=keys)]


def test_dense_agg_share_weighs_the_grouped_rows():
    recorded = (_agg_request(100, 1, 0.0, "direct", 600, 208)
                + _agg_request(200, 2, 20.0, "sort", 300, 4096)
                + _agg_request(300, 3, 40.0, "scalar", 900, 1, keys=0))
    run = _run([_rec(-0.5, 10.5), _rec(19.5, 30.5), _rec(39.5, 50.5)], recorded)
    assert dense_agg_share.read(run) == pytest.approx(100.0 * 600 / 900)
    only_sort = _run([_rec(19.5, 30.5)], _agg_request(200, 2, 20.0, "sort", 300, 4096))
    assert dense_agg_share.read(only_sort) == 0.0
    no_agg = _run([_rec(39.5, 50.5)], _agg_request(300, 3, 40.0, "scalar", 900, 1, keys=0))
    assert dense_agg_share.read(no_agg) is None
    assert dense_agg_share.read(_run([_rec(-0.5, 10.5)], [])) is None


def _dense_run(records_extra=()):
    """A 100-ms slice: Q4.1 (dense, 1,000 live rows, one value column) sent
    at 10 ms, its agg.direct span from 15 to 17 ms launching kernels of
    0.25 and 0.15 ms; a kernel its attempt launched outside that span;
    Q3.2 (sort) sent at 40 ms."""
    ev = [Event(trace.SLICE_RANGE, 0, 100 * MS, DeviceType.CPU)]
    for k, (t, a, b) in enumerate(((15.5, 16.0, 16.25), (16.5, 16.4, 16.55),
                                   (12.5, 13.0, 14.0), (45.0, 45.0, 46.0))):
        ev += launched("kernel", int(t * MS), int(a * MS), int(b * MS), k + 1)
    records = [dict(_rec(10.0, 22.0), shape="ssb_q4_1", key="q41", params={}),
               dict(_rec(40.0, 52.0), shape="ssb_q3_2", key="q32", params={})]
    records += list(records_extra)
    recorded = (_agg_request(100, 1, 10.0, "direct", 60_000, 208)
                + _agg_request(200, 2, 40.0, "sort", 60_000, 437_500, keys=3))
    run = _run(records, recorded)
    run.trace = reduced(ev, records)
    live = SimpleNamespace(sum=lambda: 1000)
    dense = SimpleNamespace(DENSE={"values": ["profit"]}, live=lambda t, p: live)
    run.references = {"ssb_q4_1": dense,
                      "ssb_q3_2": SimpleNamespace(DENSE={"values": ["lo_revenue"]},
                                                  live=lambda t, p: live)}
    run.tables = None
    return run


def test_dense_agg_roofline_counts_the_dense_spans_kernels():
    """1,000 rows x (4 + 8) B at 3.35 TB/s over the 0.4 ms its agg.direct
    span launched; the sort request and the attempt's other kernel are
    left out."""
    need = 1000 * 12 / HBM_BYTES_PER_S
    assert dense_agg_roofline.read(_dense_run()) == pytest.approx(100.0 * need / 0.4e-3,
                                                                rel=1e-5)


def test_dense_agg_roofline_reads_nothing_without_its_own_time():
    overlapping = dict(_rec(15.0, 30.0), shape="ssb_q1_1", key="q11", params={})
    assert dense_agg_roofline.read(_dense_run([overlapping])) is None
    run = _dense_run()
    for q in run.span_requests:
        q.spans = [s for s in q.spans if not s["name"].startswith("agg.")]
    assert dense_agg_roofline.read(run) is None
    assert dense_agg_roofline.read(SimpleNamespace(trace=None)) is None
