"""The port's small host utilities against the JAX package's: the
``WeightedIndex`` copy (the same draws, rejections and atomic failed
update, ``tests/test_utils.py``), ``trace`` / ``annotate`` on
``torch.profiler``, ``Partitions.reconstruct`` and ``partition(epsilon=)``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu import errors as jerrors
from flechasdb_tpu import partitions as jpartitions
from flechasdb_tpu.utils import WeightedIndex as JWeightedIndex
from flechasdb_tpu_torch import errors, partitions
from flechasdb_tpu_torch.utils import WeightedIndex, annotate, trace


def _stepper(values):
    """A 'uniform' yielding fixed fractions of the requested range."""
    it = iter(values)

    def uniform(lo, hi):
        return lo + (hi - lo) * next(it)
    return uniform


@pytest.mark.parametrize("weights, fracs, want", [
    ([1.0, 2.0, 3.0, 4.0], [0.0, 0.05, 0.25, 0.55, 0.95], [0, 0, 1, 2, 3]),
    ([0.0, 1.0, 0.0, 1.0, 0.0], [0.0, 0.99], [1, 3]),
    ([0.0, 0.0, 5.0], [0.0, 0.5, 1.0], [2, 2, 2]),
])
def test_weighted_sample_draws_as_the_jax_copy(weights, fracs, want):
    ours, theirs = WeightedIndex(weights), JWeightedIndex(weights)
    got = [ours.sample(_stepper(fracs)) for _ in fracs]
    ref = [theirs.sample(_stepper(fracs)) for _ in fracs]
    assert got == ref
    u, v = _stepper(fracs), _stepper(fracs)
    assert [ours.sample(u) for _ in fracs] == want
    assert [theirs.sample(v) for _ in fracs] == want


def test_weighted_sample_same_stream_of_draws():
    w = np.random.default_rng(5).random(50).tolist()
    w[3] = w[17] = 0.0
    ours, theirs = WeightedIndex(w), JWeightedIndex(w)
    a, b = random.Random(9), random.Random(9)
    got = [ours.sample(a.uniform) for _ in range(500)]
    assert got == [theirs.sample(b.uniform) for _ in range(500)]
    assert 3 not in got and 17 not in got
    random.seed(11)
    first = [ours.sample() for _ in range(20)]
    random.seed(11)
    assert first == [theirs.sample() for _ in range(20)]


@pytest.mark.parametrize("weights", [[], [1.0, -0.5], [0.0, 0.0]])
def test_weighted_new_rejections_match(weights):
    with pytest.raises(errors.InvalidArgs) as got:
        WeightedIndex(weights)
    with pytest.raises(jerrors.InvalidArgs) as want:
        JWeightedIndex(weights)
    assert str(got.value) == str(want.value)


def test_weighted_update_matches():
    ours, theirs = WeightedIndex([1.0, 1.0, 1.0]), \
        JWeightedIndex([1.0, 1.0, 1.0])
    for w in (ours, theirs):
        w.update([(0, 0.0), (2, 4.0)])
    assert [ours.get_weight(i) for i in range(3)] == \
        [theirs.get_weight(i) for i in range(3)] == [0.0, 1.0, 4.0]
    assert ours.total_weight == theirs.total_weight == pytest.approx(5.0)
    assert ours.sample(_stepper([0.1])) == theirs.sample(_stepper([0.1])) \
        == 1


@pytest.mark.parametrize("update", [
    [(0, 5.0), (7, 1.0)],       # out of range after a valid entry
    [(0, 0.0), (1, 0.0)],       # the total becomes zero
    [(1, -1.0)],                # a negative weight
    [(-1, 1.0)],
])
def test_weighted_failed_update_is_atomic_as_in_jax(update):
    ours, theirs = WeightedIndex([1.0, 2.0]), JWeightedIndex([1.0, 2.0])
    with pytest.raises(errors.InvalidArgs) as got:
        ours.update(update)
    with pytest.raises(jerrors.InvalidArgs) as want:
        theirs.update(update)
    assert str(got.value) == str(want.value)
    assert [ours.get_weight(0), ours.get_weight(1), ours.total_weight] == \
        [theirs.get_weight(0), theirs.get_weight(1), theirs.total_weight] \
        == [1.0, 2.0, 3.0]


def test_profiler_trace_writes_a_file_with_the_annotation(tmp_path):
    with trace(tmp_path):
        with annotate("unit-test-phase"):
            _ = torch.arange(8).sum().item()
    dumped = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert dumped, "no profiler output written"
    assert any("unit-test-phase" in p.read_text() for p in dumped)


def test_annotate_outside_a_trace_is_a_no_op():
    with annotate("alone"):
        assert torch.ones(2).sum().item() == 2.0


def _partitioned(seed=0, n=300, m=8, p=4):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((p, m)).astype(np.float32) * 100
    x = (centers[rng.integers(0, p, n)]
         + 0.01 * rng.standard_normal((n, m)).astype(np.float32))
    return x


def test_reconstruct_gives_back_x_as_the_jax_partitions():
    x = _partitioned()
    parts = partitions.partition(torch.from_numpy(x), 4,
                                 torch.Generator().manual_seed(1))
    jparts = jpartitions.Partitions(*(jnp.asarray(t.numpy()) for t in parts))
    for i in (0, 17, len(x) - 1):
        got = parts.reconstruct(i)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jparts.reconstruct(i)))
        np.testing.assert_allclose(got.numpy(), x[i], rtol=1e-6, atol=1e-4)
    rows = torch.tensor([3, 0, 299, 3])
    got = parts.reconstruct(rows)
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jparts.reconstruct(jnp.asarray(rows.numpy()))))
    np.testing.assert_allclose(got.numpy(), x[rows.numpy()], rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("epsilon, rounds", [(1e9, 1), (None, 2),
                                             (0.0, 100)])
def test_partition_epsilon_runs_the_jax_rounds(epsilon, rounds):
    """Four tight, far-apart clusters: any k-means++ seeding finds them, so
    both packages' fits run the same rounds: one under a huge epsilon, two
    by default (the second moves nothing), all 100 under epsilon 0 (a zero
    gradient is not below it)."""
    x = _partitioned(seed=2)
    kw = {} if epsilon is None else {"epsilon": epsilon}
    ours, theirs = [], []
    parts = partitions.partition(torch.from_numpy(x), 4,
                                 torch.Generator().manual_seed(3),
                                 events=ours.append, **kw)
    jparts = jpartitions.partition(jnp.asarray(x), 4, jax.random.key(3),
                                   events=theirs.append, **kw)

    def shape(evs):
        return [(type(e).__name__, getattr(e, "round", None))
                for e in evs]
    assert shape(ours) == shape(theirs)
    updates = [e for e in ours if type(e).__name__ == "FinishedCentroidUpdate"]
    assert len(updates) == rounds
    got = parts.centroids.numpy()
    want = np.asarray(jparts.centroids)
    order = np.lexsort(got.T[::-1]), np.lexsort(want.T[::-1])
    np.testing.assert_allclose(got[order[0]], want[order[1]], rtol=1e-5,
                               atol=1e-4)
