"""Each plain reference against the port's CPU run of the frozen plan,
at SF 0.05 over three seeds, with Q1's and Q6's parameters at the ends
of the dashboard mix's ranges and beyond them, where they cut through
the data."""

import importlib

import pytest

from portbench import check, traffic
from portbench.tests.conftest import SEEDS, served, world

SHAPES = [f"q{n}" for n in range(1, 23)]
EXTRA = {"q1": [{"DELTA": 60}, {"DELTA": 120}, {"DELTA": 700}, {"DELTA": 2600}],
         "q6": [{"YEAR": 1993, "DISCOUNT": 0.02, "QUANTITY": 25},
                {"YEAR": 1997, "DISCOUNT": 0.09, "QUANTITY": 24},
                {"YEAR": 1998, "DISCOUNT": 0.0, "QUANTITY": 51},
                {"YEAR": 1999, "DISCOUNT": 0.05, "QUANTITY": 24}]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_port(shape, seed):
    _, service, t = world(seed)
    q = traffic.load_json("queries", shape)
    ref = importlib.import_module(f"portbench.reference.{shape}")
    for params in [q["params"]] + EXTRA.get(shape, []):
        got = served(service, traffic.bind(q, params))
        want = ref.answer(t, params)
        assert check.compare(got, want, ref.ORDER_BY, ref.LIMIT) is None, (params, got, want)


def test_answers_are_not_all_empty():
    """The scale and seeds give most shapes rows to compare."""
    _, _, t = world(SEEDS[0])
    empty = []
    for shape in SHAPES:
        q = traffic.load_json("queries", shape)
        ans = importlib.import_module(f"portbench.reference.{shape}").answer(t, q["params"])
        if all(v is None for col in ans.values() for v in col) or not any(ans.values()):
            empty.append(shape)
    assert len(empty) <= 2, empty
