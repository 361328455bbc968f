"""Comparisons shared by the port's parity tests of filters, range search
and updates (``tests/test_torch_filters.py``, ``test_torch_range.py``,
``test_torch_update.py``).

The tolerance is the JAX package's own (``tests/test_stored.py:266``):
distances within rel 1e-4, abs 1e-5; rows equal, except where two rows'
distances tie (within rel 1e-6), where either order is right.
"""

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-4, 1e-5
TIE = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process (a file store under
    ``tmp_path``), as a CPU mesh; destroyed at teardown."""
    import datetime

    import torch.distributed as dist
    from flechasdb_tpu_torch.parallel import corpus_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield corpus_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def same_results(got, want):
    """Two lists of ``QueryResult``: the same vectors in the same order,
    distances within the tolerance."""
    assert [r.vector_id for r in got] == [r.vector_id for r in want]
    for g, w in zip(got, want):
        assert g.partition_index == w.partition_index
        assert g.vector_index == w.vector_index
        assert g.squared_distance == pytest.approx(w.squared_distance,
                                                   rel=RTOL, abs=ATOL)


def same_ranked(got_d, got_r, want_d, want_r):
    """Ranked ``(keys, rows)`` arrays, ``[B, k]`` or one query's ``[n]``:
    ``+inf`` in the same slots, finite keys within the tolerance, and
    rows equal except at distance ties."""
    got_d, want_d = np.atleast_2d(got_d), np.atleast_2d(want_d)
    got_r, want_r = np.atleast_2d(got_r), np.atleast_2d(want_r)
    assert got_d.shape == want_d.shape
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=RTOL, atol=ATOL)
    differ = (got_r != want_r) & fin
    np.testing.assert_allclose(got_d[differ], want_d[differ], rtol=TIE)


def same_range(got, want):
    """Two range results, one ``(rows, keys)`` pair a query: the same rows,
    in the same order up to distance ties, keys within the tolerance."""
    assert len(got) == len(want)
    for (gr, gk), (wr, wk) in zip(got, want):
        assert gr.dtype == wr.dtype == np.int64
        np.testing.assert_array_equal(np.sort(gr), np.sort(wr))
        same_ranked(gk, gr, wk, wr)


def midpoint_radius(keys, frac: float) -> float:
    """A radius halfway between two consecutive distinct finite ``keys``,
    near the ``frac`` quantile, with a gap far above the two packages'
    rounding differences: no key lies near it."""
    s = np.unique(np.asarray(keys)[np.isfinite(keys)])
    i = int(frac * (len(s) - 1))
    while s[i + 1] - s[i] <= 1e-3 * abs(s[i]) + 1e-4:
        i += 1
    return float((s[i] + s[i + 1]) / 2)


_ROUND_EVENTS = ("StartingCentroidUpdate", "FinishedCentroidUpdate",
                 "StartingCentroidReassignment",
                 "FinishedCentroidReassignment")


def event_pattern(events) -> list:
    """Event class names, a cluster event as ``cluster:`` and its inner
    event's name, each Lloyd round's four events collapsed into one
    ``round`` and runs of rounds into one: the order of a build's phases,
    whatever the number of rounds each of its fits took."""
    out = []
    for e in events:
        inner = getattr(e, "event", None)
        name = type(e if inner is None else inner).__name__
        if name in _ROUND_EVENTS:
            name = "round"
        if inner is not None:
            name = "cluster:" + name
        if not out or out[-1] != name or not name.endswith("round"):
            out.append(name)
    return out
