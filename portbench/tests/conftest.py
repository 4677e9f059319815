"""Shared fixtures: the tables of ``tpch_sf10``'s configuration, made by
its generator, the port's CPU service and the plain reference over them,
per seed, made once per test session."""

import functools
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

CONFIG = "tpch_sf10"
SF = 0.05
SEEDS = (0, 5, 16)


@functools.lru_cache(maxsize=None)
def world(seed: int, sf: float = SF):
    from portbench import dataset, system
    from portbench.reference._common import Tables
    from tiflash_tpu_torch.mpp.service import QueryService

    tables = dataset.generator(dataset.config(CONFIG)).generate(sf, seed, "cpu")
    service = QueryService(system.build_catalog(tables), device="cpu")
    return tables, service, Tables(tables, "cpu")


def served(service, plan):
    """What the HTTP route sends back, through a JSON round trip."""
    return json.loads(json.dumps(service.execute(plan)["columns"], default=str))


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
