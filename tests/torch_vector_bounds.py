"""The float32 bounds of the port's vector distances (``vec_*`` and
``ops/vector.py``) against the reference, shared by the parity tests.

A float32 sum of d terms adds in another order in XLA, torch on the CPU
and cuBLAS; each order is within (d - 1) unit roundoffs of the sum of the
magnitudes, so two orders differ by at most

    B = (d + ULP_SLACK) * 2**-23 * S

with S the magnitude the sum is made of, in float64 from the float32
inputs: sum|terms| for l1 and the inner product, (|q| + |x|)^2 for the
search's l2 score (its ``|q|^2 - 2 q.x + |x|^2`` identity), 3 for the
cosine distance.  A square root maps the bound through
``sqrt(s + B) - sqrt(s - B)``.

Not a test module: the parity test files import it.
"""

import numpy as np

EPS32 = 2.0 ** -23
ULP_SLACK = 4


def _sqrt_bound(s, b):
    s = np.maximum(s, 0.0)
    return np.sqrt(s + b) - np.sqrt(np.maximum(s - b, 0.0))


def _bound(scale, d):
    return (d + ULP_SLACK) * EPS32 * scale


def function_bound(name, x, y):
    """Per-row bound of ``name`` over float64 copies of float32 rows."""
    d = x.shape[1]
    if name == "vec_l2_distance":
        s = ((x - y) ** 2).sum(axis=1)
        return _sqrt_bound(s, _bound(s, d))
    if name == "vec_l2_norm":
        s = (x * x).sum(axis=1)
        return _sqrt_bound(s, _bound(s, d))
    if name == "vec_l1_distance":
        return _bound(np.abs(x - y).sum(axis=1), d)
    if name == "vec_negative_inner_product":
        return _bound(np.abs(x * y).sum(axis=1), d)
    if name == "vec_cosine_distance":
        return np.full(len(x), _bound(3.0, d))
    return np.zeros(len(x))  # vec_dims: exact


def search_truth(metric, x, q):
    """(q, n) float64 distances of float32 rows, and their bounds."""
    d = x.shape[1]
    nq, nx = np.linalg.norm(q, axis=1), np.linalg.norm(x, axis=1)
    if metric == "l1":
        s = np.abs(q[:, None, :] - x[None, :, :]).sum(axis=-1)
        return s, _bound(s, d)
    dot = q @ x.T
    if metric == "l2":
        s = (nq[:, None] ** 2) - 2 * dot + (nx[None, :] ** 2)
        b = _bound((nq[:, None] + nx[None, :]) ** 2, d)
        return np.sqrt(np.maximum(s, 0)), _sqrt_bound(s, b)
    if metric == "cosine":
        s = 1 - dot / np.maximum(nq[:, None] * nx[None, :], 1e-30)
        return s, np.full(s.shape, _bound(3.0, d))
    return -dot, _bound(np.abs(q) @ np.abs(x).T, d)


def assert_same_search(t_dist, t_idx, j_dist, j_idx, truth, bound):
    """Distances within the bound; indices equal but where the two rows'
    float64 distances lie within their bounds."""
    t_dist, t_idx = np.asarray(t_dist, dtype=np.float64), np.asarray(t_idx)
    j_dist, j_idx = np.asarray(j_dist, dtype=np.float64), np.asarray(j_idx)
    assert t_idx.shape == j_idx.shape and t_idx.dtype == np.int32
    for qi in range(t_idx.shape[0]):
        tb, jb = bound[qi][t_idx[qi]], bound[qi][j_idx[qi]]
        assert np.all(np.abs(t_dist[qi] - j_dist[qi]) <= np.maximum(tb, jb)), qi
        live = np.isfinite(t_dist[qi])
        assert np.all(np.abs(t_dist[qi][live] - truth[qi][t_idx[qi]][live]) <= tb[live])
        diff = t_idx[qi] != j_idx[qi]
        gap = np.abs(truth[qi][t_idx[qi]] - truth[qi][j_idx[qi]])
        assert np.all(gap[diff] <= (tb + jb)[diff]), (qi, t_idx[qi][diff], j_idx[qi][diff])
