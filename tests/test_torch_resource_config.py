"""Settings, TOML and environment layering, resource groups and the
memory quota of the PyTorch port, against the JAX package.

Mirrors ``tests/test_resource_config.py``: the token bucket, resource
group admission, ``to_ru``, ``from_toml``/``from_env``/
``with_overrides``, the memory limit and its chunked fallback,
per-aggregate defaults, ``max_execution_time_ms``,
``query_timestamp_us``, ``enable_spill``, the service's
``service_queue_timeout_s`` and the config template.  The
port's ``Settings`` has every field of the reference's, with its
defaults, so one deployment's settings steer both alike.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

import tiflash_tpu.core.dtypes as jdt
from tiflash_tpu.expr import nodes as JE
from tiflash_tpu.ops.aggregate import AggDesc as JAgg
from tiflash_tpu.plan import nodes as JP
from tiflash_tpu.runtime.settings import Settings as JSettings
from tiflash_tpu.testing import oracle as O

from torch_runtime_parity import assert_same_out_of_core, to_port
from tiflash_tpu_torch.expr import nodes as TE
from tiflash_tpu_torch.ops.aggregate import AggDesc as TAgg
from tiflash_tpu_torch.plan import nodes as TP
from tiflash_tpu_torch.runtime.errors import MEMORY_LIMIT, classify
from tiflash_tpu_torch.runtime.executor import QueryRunner, run_query
from tiflash_tpu_torch.runtime.failpoint import FailPoint
from tiflash_tpu_torch.runtime.memory import MemoryLimitError
from tiflash_tpu_torch.runtime.resource import RESOURCE_GROUPS, TokenBucket, to_ru
from tiflash_tpu_torch.runtime.settings import Settings

TEMPLATE = os.path.join(os.path.dirname(__file__), "..", "etc", "config-template.toml")


def _keys(n):
    return to_port({"t": O.pytable_to_block({"k": list(range(n))}, {"k": jdt.INT64})})


def test_settings_fields_are_the_reference_fields():
    mine = [(f.name, f.default) for f in dataclasses.fields(Settings)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JSettings)]
    assert mine == ref


def test_token_bucket_refill_and_limit():
    b = TokenBucket(fill_rate=1000.0, capacity=100.0, tokens=100.0)
    assert b.try_consume(60)
    assert b.try_consume(40)
    assert not b.try_consume(50)  # empty now
    time.sleep(0.06)
    assert b.try_consume(50)  # refilled ~60


def test_resource_group_rejects_when_exhausted(monkeypatch):
    import functools

    # the admission wait is 30 s by default; half a second shows the same
    # rejection
    monkeypatch.setattr(RESOURCE_GROUPS, "admit",
                        functools.partial(RESOURCE_GROUPS.admit, timeout=0.5))
    RESOURCE_GROUPS.configure("tiny", fill_rate=0.001, capacity=0.001)
    tables = _keys(200_000)
    with pytest.raises(RuntimeError, match="resource group"):
        run_query(TP.TableScan("t"), tables, settings=Settings(resource_group="tiny"))
    # an unconfigured group admits freely
    out, _ = run_query(TP.TableScan("t"), tables, settings=Settings(resource_group="other"))
    assert out.capacity == 200_000


def test_to_ru_scales():
    assert to_ru(1_000_000, 0.0) == pytest.approx(10.0)
    assert to_ru(0, 0.1) == pytest.approx(10.0)


def test_settings_from_toml(tmp_path):
    p = tmp_path / "engine.toml"
    p.write_text('[engine]\ndefault_shuffle_factor = 3.5\nmax_capacity_retries = 7\n'
                 'resource_group = "batch"\n')
    s, j = Settings.from_toml(str(p)), JSettings.from_toml(str(p))
    assert dataclasses.asdict(s) == dataclasses.asdict(j)
    assert (s.default_shuffle_factor, s.max_capacity_retries, s.resource_group) == \
        (3.5, 7, "batch")


def test_settings_env_override(monkeypatch):
    """The same TIFLASH_TPU_<NAME> variables steer both packages."""
    monkeypatch.setenv("TIFLASH_TPU_MAX_CAPACITY_RETRIES", "9")
    monkeypatch.setenv("TIFLASH_TPU_TOPN_FAST_PATH", "false")
    monkeypatch.setenv("TIFLASH_TPU_MAX_BYTES_BEFORE_EXTERNAL_JOIN", "4096")
    s = Settings.from_env()
    assert s.max_capacity_retries == 9 and s.topn_fast_path is False
    assert dataclasses.asdict(s) == dataclasses.asdict(JSettings.from_env())


def test_settings_with_overrides():
    s = Settings().with_overrides({"max_result_rows": "5", "enable_spill": "false",
                                   "max_bytes_per_device": 1 << 20})
    assert (s.max_result_rows, s.enable_spill, s.max_bytes_per_device) == (5, False, 1 << 20)
    with pytest.raises(ValueError, match="unknown setting"):
        Settings().with_overrides({"no_such": 1})
    with pytest.raises(ValueError, match="bad value"):
        Settings().with_overrides({"max_result_rows": "many"})


def test_memory_limit_enforced():
    tables = _keys(10_000)
    with pytest.raises(MemoryLimitError, match="exceed limit") as ei:
        run_query(TP.TableScan("t"), tables, settings=Settings(max_bytes_per_device=1000))
    assert classify(ei.value) == MEMORY_LIMIT
    out, _ = run_query(TP.TableScan("t"), tables,
                       settings=Settings(max_bytes_per_device=10**9))
    assert out.capacity == 10_000


def test_out_of_core_chunked_aggregation():
    """A memory-quota breach falls back to chunked partial/final
    execution: the reference's chunk count and rows, the in-memory rows."""
    rng = np.random.default_rng(5)
    n = 50_000
    t = {"k": [int(x) for x in rng.integers(0, 20, n)],
         "v": [int(x) for x in rng.integers(-100, 100, n)]}
    j_tables = {"t": O.pytable_to_block(t, {"k": jdt.INT32, "v": jdt.INT64})}

    def plan(NP, E, Agg):
        return lambda: NP.Aggregation(
            ["k"], [Agg("sum", "v", "s"), Agg("count", None, "c"), Agg("avg", "v", "a"),
                    Agg("min", "v", "mn")],
            NP.Selection(E.col("v") > -90, NP.TableScan("t")))

    ts = assert_same_out_of_core(plan(JP, JE, JAgg), plan(TP, TE, TAgg), j_tables,
                                 JSettings(max_bytes_per_device=300_000), "chunked")
    assert ts.out_of_core["pieces"] > 1


def _walk_aggs(node):
    out = list(getattr(node, "aggs", ()))
    for c in node.children:
        out.extend(_walk_aggs(c))
    return out


def test_settings_agg_defaults_applied():
    """Session settings become per-aggregate knobs the plan left unset."""
    schema = {"k": jdt.INT32, "s": jdt.STRING, "v": jdt.INT64}
    rng = np.random.default_rng(3)
    table = O.random_pytable(rng, 60, schema, null_prob=0.0, int_range=(0, 3))
    tables = to_port({"t": O.pytable_to_block(table, schema)})
    plan = TP.Aggregation(["k"], [TAgg("group_concat", "s", "gc"),
                                  TAgg("approx_count_distinct", "v", "acd")],
                          TP.TableScan("t"))
    runner = QueryRunner(plan, settings=Settings(group_concat_max_items=2,
                                                 approx_distinct_sketch_k=256))
    aggs = {a.name: a for a in _walk_aggs(runner.plan)}
    assert aggs["gc"].param == 2.0 and aggs["acd"].param == 256.0
    out, _ = runner.run(tables)
    assert all(g is None or g.count(",") <= 1 for g in out.to_pylists()["gc"])


def test_max_execution_time_setting():
    """The deadline fires at a cancellation checkpoint (here inside a
    paused failpoint) and raises QueryTimeout."""
    from tiflash_tpu_torch.runtime.cancel import QueryTimeout

    tables = _keys(100)
    FailPoint.enable("exception_before_fragment_run", pause=True)
    try:
        t0 = time.time()
        with pytest.raises(QueryTimeout):
            run_query(TP.TableScan("t"), tables,
                      settings=Settings(max_execution_time_ms=200))
        assert time.time() - t0 < 10
    finally:
        FailPoint.disable_all()
    out, _ = run_query(TP.TableScan("t"), tables, settings=Settings())
    assert out.capacity == 100


def test_query_timestamp_setting():
    """query_timestamp_us pins NOW() for reproducible runs, as in the
    reference."""
    from tiflash_tpu.runtime.executor import run_query as j_run

    j_tables = {"t": O.pytable_to_block({"k": [1, 2, 3]}, {"k": jdt.INT64})}
    us = 1_600_000_000_000_000

    def plan(NP, E):
        return NP.Projection({"k": E.col("k"), "now": E.call("now")}, NP.TableScan("t"))

    out, _ = run_query(plan(TP, TE), to_port(j_tables),
                       settings=Settings(query_timestamp_us=us))
    want, _ = j_run(plan(JP, JE), j_tables, settings=JSettings(query_timestamp_us=us))
    assert out.to_pylists() == want.to_pylists()
    assert out.to_pylists()["now"][0] == us  # DATETIME as its microseconds


def test_enable_spill_off_raises():
    """enable_spill=False turns the out-of-core fallback into a hard
    memory error."""
    rng = np.random.default_rng(11)
    t = {"g": [int(x) for x in rng.integers(0, 8, 30_000)],
         "v": [int(x) for x in rng.integers(0, 100, 30_000)]}
    tables = to_port({"t": O.pytable_to_block(t, {"g": jdt.INT64, "v": jdt.INT64})})
    plan = TP.Aggregation(keys=["g"], aggs=[TAgg("sum", "v", "s")], child=TP.TableScan("t"))
    small = 200_000
    with pytest.raises(MemoryLimitError):
        run_query(plan, tables, settings=Settings(max_bytes_per_device=small,
                                                  enable_spill=False))
    out, _ = run_query(plan, tables, settings=Settings(max_bytes_per_device=small))
    assert sorted(out.to_pylists()["g"]) == list(range(8))


def test_service_queue_timeout():
    """service_queue_timeout_s: a QUEUED query gives up its wait and
    answers 499 with a CANCELLED code, as the reference's does."""
    import json
    import urllib.error
    import urllib.request

    from tiflash_tpu_torch.bench.tpch_queries import q6_plan
    from tiflash_tpu_torch.mpp.service import QueryService, serve_background
    from tiflash_tpu_torch.plan import serde
    from tiflash_tpu_torch.storage.tpch import generate_tpch

    svc = QueryService(generate_tpch(sf=0.001, seed=5), mesh=None, max_concurrency=1,
                       settings=Settings(service_queue_timeout_s=0.4), device="cpu")
    httpd, port = serve_background(svc)
    url = f"http://127.0.0.1:{port}"

    def post(path, obj):
        req = urllib.request.Request(
            url + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    plan_json = serde.plan_to_json(q6_plan())
    try:
        post("/failpoint", {"name": "exception_before_fragment_run", "action": "pause"})
        _, sub1 = post("/query", {"plan": plan_json, "async": True})
        t0 = time.time()
        while time.time() - t0 < 20:
            with urllib.request.urlopen(url + f"/result?id={sub1['query_id']}") as r:
                if json.loads(r.read())["state"] == "RUNNING":
                    break
            time.sleep(0.05)
        # the second query queues behind the paused one and times out
        t0 = time.time()
        code, res = post("/query", {"plan": plan_json})
        assert time.time() - t0 < 10
        assert code == 499 and res["kind"] == "cancelled", (code, res)
        assert "service_queue_timeout_s" in res["error"] and res["code_name"] == "CANCELLED"
        post("/cancel", {"query_id": sub1["query_id"]})
    finally:
        FailPoint.disable_all()
        httpd.shutdown()


def test_config_template_loads_and_covers_every_setting():
    """etc/config-template.toml: every key is a Settings field, and
    loading it reproduces the defaults (the reference's template)."""
    import tomllib

    assert Settings.from_toml(TEMPLATE) == Settings()
    with open(TEMPLATE, "rb") as f:
        keys = set(tomllib.load(f)["engine"].keys())
    fields = {f.name for f in dataclasses.fields(Settings)}
    assert keys <= fields and len(keys) >= len(fields) - 2
