"""The disk spill tier and the spill-backed out-of-core paths: the
PyTorch port against the JAX package.

Mirrors ``tests/test_spill.py``: the port's own spiller
(``tiflash_tpu_torch/native/spiller.cpp``, built by ``g++`` into
``tiflash_tpu_torch/build/``) round-trips every dtype, detects a
corrupted chunk and removes its files at close; its chunk files are the
reference's format (each package reads the other's); and the grace,
chunked and bucketed-merge paths give the reference's rows, mode and
piece counts at the same ``Settings``, equal to the in-memory run.
"""

import glob

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.ops.sort import SortKey as JSortKey
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.testing import oracle as O

from torch_runtime_parity import assert_same_out_of_core, rows, to_port
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.ops.sort import SortKey as TSortKey
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime import outofcore as TOC
from tiflash_tpu_torch.runtime.failpoint import FailPoint
from tiflash_tpu_torch.runtime.spill import Spiller


@pytest.fixture(autouse=True)
def clean_failpoints():
    yield
    FailPoint.disable_all()


ARRAYS = [
    lambda rng: rng.integers(-2**60, 2**60, 10_000).astype(np.int64),
    lambda rng: rng.integers(0, 2**30, 3_333).astype(np.int32),
    lambda rng: rng.normal(size=5_000).astype(np.float64),
    lambda rng: rng.random(7_000) < 0.5,
    lambda rng: rng.integers(0, 100, (500, 8)).astype(np.int32),  # 2-D (group_concat)
    lambda rng: np.zeros(0, dtype=np.int64),                      # empty
]


def test_spiller_roundtrip_all_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [f(rng) for f in ARRAYS]
    with Spiller(str(tmp_path / "s")) as sp:
        ids = [sp.spill_array(a, partition=i % 3) for i, a in enumerate(arrays)]
        sp.sync()
        raw, comp = sp.stats()
        assert raw == sum(a.nbytes for a in arrays)
        assert 0 < comp
        for a, cid in zip(arrays, ids):
            got = sp.restore_array(cid)
            assert got.dtype == a.dtype and got.shape == a.shape
            np.testing.assert_array_equal(got, a)


def test_spiller_detects_corruption(tmp_path):
    sp = Spiller(str(tmp_path / "c"))
    cid = sp.spill_array(np.arange(50_000, dtype=np.int64))
    sp.sync()
    path = glob.glob(str(tmp_path / "c" / "*.spl"))[0]
    blob = bytearray(open(path, "rb").read())
    blob[40] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        sp.restore_array(cid)
    sp.close()


def test_spiller_removes_files_on_close(tmp_path):
    d = str(tmp_path / "rm")
    sp = Spiller(d)
    sp.spill_array(np.arange(1000))
    sp.sync()
    assert glob.glob(d + "/*.spl")
    sp.close(remove_files=True)
    assert not glob.glob(d + "/*.spl")


def test_chunk_files_are_the_reference_format(tmp_path):
    """Each package's spiller writes the same chunk file (magic, sizes,
    CRC, zlib level 1) for the same array, byte for byte."""
    from tiflash_tpu.runtime.spill import Spiller as JSpiller

    a = np.random.default_rng(4).integers(0, 1000, 20_000).astype(np.int64)
    blobs = []
    for S, d in ((Spiller, tmp_path / "t"), (JSpiller, tmp_path / "j")):
        sp = S(str(d))
        sp.spill_array(a, partition=7)
        sp.sync()
        (path,) = glob.glob(str(d / "*.spl"))
        assert path.endswith("p0007_c000000.spl")
        blobs.append(open(path, "rb").read())
        sp.close(remove_files=False)
    assert blobs[0] == blobs[1]


def _grace_setup():
    rng = np.random.default_rng(17)
    n, m = 6000, 900
    lsch = {"fk": jdt.INT64, "v": jdt.INT64}
    rsch = {"pk": jdt.INT64, "w": jdt.INT64.with_nullable(True)}
    lt = O.random_pytable(rng, n, lsch, null_prob=0.0, int_range=(0, m - 1))
    rt = {"pk": list(range(m)),
          "w": [None if rng.random() < 0.1 else int(rng.integers(0, 50))
                for _ in range(m)]}

    def plan(NP, Agg, SortKey):
        return lambda: NP.TopN(
            [SortKey("s", desc=True), SortKey("fk")], 7,
            NP.Aggregation(
                ["fk"], [Agg("sum", "w", "s")],
                NP.Join(kind="inner", probe_keys=["fk"], build_keys=["pk"],
                        probe=NP.TableScan("L"), build=NP.TableScan("R"),
                        unique_build=True)))

    j_tables = {"L": O.pytable_to_block(lt, lsch), "R": O.pytable_to_block(rt, rsch)}
    return plan(JP, JAgg, JSortKey), plan(TP, TAgg, TSortKey), j_tables


def test_grace_join_with_disk_spill_matches_in_ram(tmp_path):
    _, make_t, j_tables = _grace_setup()
    t_tables = to_port(j_tables)
    budget = 400_000  # several partitions
    in_ram = TOC.run_grace_join(make_t(), t_tables, budget)
    info = {}
    on_disk = TOC.run_grace_join(make_t(), t_tables, budget,
                                 spill_dir=str(tmp_path / "spl"), info=info)
    assert info["pieces"] > 1
    assert rows(in_ram) == rows(on_disk)
    assert glob.glob(str(tmp_path / "spl" / "*"))  # the store's directory
    assert not glob.glob(str(tmp_path / "spl" / "*" / "*.spl"))  # removed at close


def test_runner_spill_dir_setting(tmp_path):
    """The runner routes out-of-core staging through spill_dir: chunk
    files are written, and removed at the end."""
    from tiflash_tpu_torch.runtime.metrics import METRICS

    make_j, make_t, j_tables = _grace_setup()
    files0 = METRICS.dump()["spill_chunk_files_total"]
    s = JSettings(max_bytes_per_device=400_000, spill_dir=str(tmp_path / "q"))
    assert_same_out_of_core(make_j, make_t, j_tables, s, "grace")
    assert METRICS.dump()["spill_chunk_files_total"] > files0
    assert not glob.glob(str(tmp_path / "q" / "*" / "*.spl"))


def test_per_operator_external_join_threshold():
    """max_bytes_before_external_join forces the grace path under no
    global quota: the join's own working set is compared."""
    make_j, make_t, j_tables = _grace_setup()
    assert_same_out_of_core(make_j, make_t, j_tables,
                            JSettings(max_bytes_before_external_join=200_000), "grace")


def _group_tables(seed, key_mod, sch=None, null_prob=0.0, int_range=(-100, 100)):
    rng = np.random.default_rng(seed)
    n = 20_000
    sch = sch or {"g": jdt.INT64, "v": jdt.INT64}
    pt = O.random_pytable(rng, n, sch, null_prob=null_prob, int_range=int_range)
    pt["g"] = [1 if x is None else abs(x) % key_mod for x in pt["g"]]
    return {"t": O.pytable_to_block(pt, sch)}


def _check_chunked(specs, j_tables, threshold=200_000):
    def make(NP, Agg):
        return lambda: NP.Aggregation(["g"], [Agg(*a) for a in specs], NP.TableScan("t"))

    return assert_same_out_of_core(
        make(JP, JAgg), make(TP, TAgg), j_tables,
        JSettings(max_bytes_before_external_group_by=threshold), "chunked")


def test_per_operator_external_group_by_threshold():
    _check_chunked([("sum", "v", "s"), ("count", None, "c")], _group_tables(7, 8))


def test_bucketed_final_merge_parity(monkeypatch):
    """The bucketed final merge (group-key-hash buckets, one small final
    plan each), forced by a small ``_FINAL_MERGE_ROWS``, in both packages."""
    from tiflash_tpu.runtime import outofcore as JOC

    monkeypatch.setattr(JOC, "_FINAL_MERGE_ROWS", 2048)
    monkeypatch.setattr(TOC, "_FINAL_MERGE_ROWS", 2048)
    specs = [("sum", "v", "s"), ("count", None, "c"), ("avg", "v", "a"), ("min", "v", "lo")]
    ts = _check_chunked(specs, _group_tables(11, 4096, int_range=(-1000, 1000)))
    assert ts.out_of_core["merge_buckets"] > 1


def test_final_merge_compile_failure_ladder(monkeypatch):
    """With the failpoint armed both device rungs fail and the host merge
    answers: the same rungs and rows as the reference's ladder, equal to
    the in-memory run."""
    from tiflash_tpu.runtime import outofcore as JOC
    from tiflash_tpu.runtime.failpoint import FailPoint as JFailPoint

    monkeypatch.setattr(JOC, "_FINAL_MERGE_ROWS", 2048)
    monkeypatch.setattr(TOC, "_FINAL_MERGE_ROWS", 2048)
    sch = {"g": jdt.INT64, "v": jdt.INT64, "d": jdt.Decimal(15, 2), "f": jdt.FLOAT64}
    j_tables = _group_tables(13, 4096, sch, null_prob=0.1, int_range=(-1000, 1000))
    specs = [("sum", "v", "s"), ("count", None, "c"), ("avg", "v", "a"),
             ("min", "v", "lo"), ("max", "f", "hi"), ("sum", "d", "ds"),
             ("first", "v", "fv")]
    FailPoint.enable("compile_failure_in_final_merge")
    JFailPoint.enable("compile_failure_in_final_merge")
    try:
        ts = _check_chunked(specs, j_tables)
    finally:
        JFailPoint.disable("compile_failure_in_final_merge")
    assert ts.out_of_core["merge_buckets"] == 0  # the host merge answered
    assert len(ts.out_of_core["merge_tries"]) == 2
    assert FailPoint.get("compile_failure_in_final_merge").hits == 2
