"""The control: the reference with its DECIMAL arithmetic in float64 put
in the system's place is judged wrong in every cell (Q1's sums at scale
4 and 6 lose digits), while the exact reference is judged right."""

import pytest

from portbench.control import control_counts


@pytest.mark.parametrize("cell,requests", [("tpch_sf10.shapes22_1client", 22)])
def test_control_fails_the_comparison(cell, requests):
    for seed in (1, 2, 3):
        res = control_counts(cell, seed, requests, 0.05, "cpu")
        assert res["wrong_answers"] >= 1, res
        assert set(res["wrong_by_shape"]) <= {"q1", "q6"}
