"""``flechasdb_tpu_torch.ops.linalg`` against the JAX package's
``ops/linalg.py`` on the cases of ``tests/test_linalg.py``: a sweep of
sizes around the reference's 16-wide unroll and the semantic edges
(empty inputs, zero vectors, the ``norm2`` prescaling at 1e±30). Both
compute in f32 in their own order: rtol 1e-5 (atol 1e-6 for sums), the
JAX test's own bounds; the edges exactly.
"""

import numpy as np
import pytest
import torch

from flechasdb_tpu.ops import linalg as jlinalg
from flechasdb_tpu_torch.ops import linalg

SIZES = [1, 15, 16, 17, 33, 128, 1000]


def _np(t):
    assert isinstance(t, torch.Tensor)
    return t.numpy()


@pytest.mark.parametrize("n", SIZES)
def test_dot_and_norm2_match_jax_and_numpy(rng, n):
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(_np(linalg.dot(a, b)),
                               np.asarray(jlinalg.dot(a, b)), rtol=1e-5)
    np.testing.assert_allclose(_np(linalg.dot(a, b)), np.dot(a, b),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(linalg.norm2(a)),
                               np.asarray(jlinalg.norm2(a)), rtol=1e-5)
    np.testing.assert_allclose(_np(linalg.norm2(a)), np.linalg.norm(a),
                               rtol=1e-5)
    got = linalg.dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("n", SIZES)
def test_elementwise_and_reductions_match_jax(rng, n):
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    for mine, ref in ((linalg.add(a, b), jlinalg.add(a, b)),
                      (linalg.subtract(a, b), jlinalg.subtract(a, b)),
                      (linalg.scale(a, 2.5), jlinalg.scale(a, 2.5)),
                      (linalg.min_(a), jlinalg.min_(a)),
                      (linalg.max_abs(a), jlinalg.max_abs(a))):
        np.testing.assert_array_equal(_np(mine), np.asarray(ref))
    np.testing.assert_allclose(_np(linalg.sum_(a)),
                               np.asarray(jlinalg.sum_(a)), rtol=1e-5,
                               atol=1e-6)


def test_empty_and_zero_edges_match_jax():
    e = np.zeros(0, np.float32)
    for name, want in (("sum_", 0.0), ("min_", np.inf), ("max_abs", 0.0),
                       ("norm2", 0.0)):
        got = float(getattr(linalg, name)(e))
        assert got == want == float(getattr(jlinalg, name)(e)), name
    assert float(linalg.dot(e, e)) == float(jlinalg.dot(e, e)) == 0.0
    assert float(linalg.norm2(np.zeros(8, np.float32))) == 0.0
    rows = np.zeros((3, 0), np.float32)
    assert linalg.min_(rows).shape == (3,) == jlinalg.min_(rows).shape
    assert linalg.norm2(rows).dtype == torch.float32


@pytest.mark.parametrize("value,n", [(1e30, 16), (1e-30, 4), (1e36, 3)])
def test_norm2_prescaling_matches_jax(value, n):
    """Entries near the f32 range's ends survive the square (a naive sum
    of squares overflows to inf or flushes to 0)."""
    v = np.full(n, value, np.float32)
    got = float(linalg.norm2(v))
    assert got == pytest.approx(value * np.sqrt(n), rel=1e-5)
    assert got == pytest.approx(float(jlinalg.norm2(v)), rel=1e-6)
    naive = float(torch.sqrt((torch.from_numpy(v) ** 2).sum()))
    assert naive == 0.0 or np.isinf(naive)
