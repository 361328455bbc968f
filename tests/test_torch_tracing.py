"""The port's spans and counters (``flechasdb_tpu_torch/utils/profiling``)
on the paths the benchmark runs, on the CPU.

With no profiler, a span or a count is one check of the profiler's flag:
no ``record_function`` is entered and no counter moves. Under a CPU
``torch.profiler``, ``DeviceIndex(layout="bucketed").query_rerank`` and
``Database.query_batch`` on the masked layout emit their ``fdb.`` spans
nested as the layers nest, and each operator of a call lies in exactly
one leaf stage. The bucketed counters count the probed partitions' rows
and slots, ``tables.cells`` the (query, probed partition) tables (and
``tables.plain``, the formula's share of them on the CPU),
``rerank.rows`` the rerank's candidates that hold a row, the build emits
one seeding span a fit and one sync span a Lloyd round, and nothing the
program returns changes under a profiler, also at the GIST1M
configuration's widths (960 dimensions, 60 divisions, 256 codewords).
"""

import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flechasdb_tpu_torch as ft
from flechasdb_tpu_torch import serving, synth
from flechasdb_tpu_torch.parallel import build as pbuild
from flechasdb_tpu_torch.utils import profiling

#: The stages a query's operators fall in, one each.
LEAVES = {"fdb.to_device", "fdb.probe", "fdb.tables", "fdb.scan",
          "fdb.topk", "fdb.rerank", "fdb.to_host", "fdb.results"}
#: Each query span's enclosing span (``None``: none).
QUERY_PARENT = {"fdb.query_batch": None, "fdb.results": "fdb.query_batch",
                **{leaf: "fdb.index.query" for leaf in LEAVES
                   if leaf != "fdb.results"}}
P, D, C, K, NPROBE = 8, 4, 16, 5, 3


def _blobs(seed, n=640, m=16, skew=0):
    """Eight tight clusters; the first ``skew`` rows one repeated vector,
    which pads one bucket past the layout policy's limit."""
    rng = np.random.default_rng(seed)
    centers = 5.0 * rng.standard_normal((P, m)).astype(np.float32)
    x = (centers[rng.integers(0, P, n)]
         + 0.3 * rng.standard_normal((n, m))).astype(np.float32)
    x[:skew] = centers[0]
    q = (centers[rng.integers(0, P, 6)]
         + 0.3 * rng.standard_normal((6, m))).astype(np.float32)
    return x, q


def _build(x, seed=7, events=None):
    return pbuild.build_staged(x, P, D, C, seed, events, coarse_cap=400,
                               pq_cap=300, device="cpu")


def _index(b):
    return serving.DeviceIndex(
        *(t.numpy() for t in (b.partition_centroids, b.codebooks, b.codes,
                              b.partition_indices)),
        layout="bucketed", device="cpu")


def _bucketed():
    """``(index, originals, queries)``: the staged build's buckets."""
    x, q = _blobs(1)
    return _index(_build(x)), torch.from_numpy(x), q


@functools.cache
def _gist():
    """``(index, originals, queries)`` at the GIST1M widths: 4,096 rows of
    960 dimensions, D=60, C=256, on the staged build's buckets."""
    x, q = synth.gmm_pair(np.random.default_rng(6), 4096, 12, 960,
                          n_clusters=32, intrinsic=32)
    b = pbuild.build_staged(x, P, 60, 256, 5, device="cpu")
    return _index(b), torch.from_numpy(x), q


def _masked_db():
    x, q = _blobs(2, skew=400)
    db = (ft.DatabaseBuilder(x, device="cpu").with_partitions(P)
          .with_divisions(D).with_clusters(C).with_seed(3).build())
    return db, q


def _rerank_call():
    index, x, q = _bucketed()
    return lambda: index.query_rerank(q, x, k=K, nprobe=NPROBE, rerank=20)


def _gist_call():
    index, x, q = _gist()
    return lambda: index.query_rerank(q, x, k=10, nprobe=2, rerank=100)


def _batch_call():
    db, q = _masked_db()
    assert db._device_state().layout == "masked"
    return lambda: db.query_batch(q, K, NPROBE)


def _build_call():
    x, _ = _blobs(3)
    return lambda: _build(x)


CALLS = {"rerank": _rerank_call, "query_batch": _batch_call,
         "build": _build_call, "gist_rerank": _gist_call}


def _events(fn, tmp_path):
    """``(fn()'s result, the profiler's X events of the call)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    return out, [e for e in events if e.get("ph") == "X"]


def _spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("fdb.")]


def _inside(inner, outer) -> bool:
    mid = inner["ts"] + inner["dur"] / 2
    return outer["ts"] <= mid <= outer["ts"] + outer["dur"]


def _parent(span, spans):
    """The innermost other ``fdb.`` span around ``span``'s middle."""
    around = [s for s in spans if s is not span and _inside(span, s)
              and s["dur"] >= span["dur"]]
    return min(around, key=lambda s: s["dur"])["name"] if around else None


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("path", sorted(CALLS))
def test_with_no_profiler_no_span_is_entered_and_nothing_counts(
        path, monkeypatch):
    call = CALLS[path]()

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", entered)
    call()
    assert profiling.counters() == {}
    assert profiling.annotate("fdb.a") is profiling.annotate("fdb.b")


@pytest.mark.parametrize("path", ["rerank", "query_batch"])
def test_query_spans_nest_and_every_operator_lies_in_one_stage(
        path, tmp_path):
    call = CALLS[path]()
    call()                                # the index is built, off trace
    _, events = _events(call, tmp_path)
    spans = _spans(events)
    names = {s["name"] for s in spans}
    want = {"fdb.index.query", "fdb.to_device", "fdb.probe", "fdb.tables",
            "fdb.scan", "fdb.topk", "fdb.to_host"}
    want |= {"fdb.rerank"} if path == "rerank" else \
        {"fdb.query_batch", "fdb.results"}
    assert names == want
    for s in spans:
        parent = _parent(s, spans)
        if s["name"] == "fdb.index.query":
            assert parent == ("fdb.query_batch" if path == "query_batch"
                              else None)
        else:
            assert parent == QUERY_PARENT[s["name"]], s["name"]
    outer = [s for s in spans if _parent(s, spans) is None]
    assert len(outer) == 1
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and _inside(e, outer[0])]
    assert ops
    leaves = [s for s in spans if s["name"] in LEAVES]
    for op in ops:
        assert sum(_inside(op, s) for s in leaves) == 1, op["name"]


def _probed(index, q, nprobe):
    """The probe worked out again from the centroids, in float64."""
    cents = index.centroids.double()
    key = ((torch.from_numpy(q).double()[:, None] - cents[None]) ** 2) \
        .sum(-1)
    return torch.argsort(key, dim=1, stable=True)[:, :nprobe]


def test_bucketed_counters_count_the_probed_rows_and_slots(tmp_path):
    index, x, q = _bucketed()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            index.query_rerank(q, x, k=K, nprobe=NPROBE, rerank=20)
    rows = index.buckets.rows
    counts = (rows >= 0).sum(dim=1)
    probed = _probed(index, q, NPROBE)
    got = profiling.counters()
    assert got["bucketed.real_slots"] == 2 * int(counts[probed].sum())
    assert got["bucketed.slots"] == 2 * len(q) * NPROBE * rows.shape[1]
    assert 0 < got["bucketed.real_slots"] < got["bucketed.slots"]


@pytest.mark.parametrize("shape, nprobe, rerank", [
    ("blobs", NPROBE, 20), ("blobs", 1, 200), ("gist", 2, 100),
    ("gist", 1, 1000)])
def test_tables_and_rerank_counters_count_cells_and_live_candidates(
        shape, nprobe, rerank):
    """``tables.cells`` counts B·nprobe a call, and on the CPU all of them
    go to ``tables.plain`` (``tables.kernel`` counts the card's route);
    ``rerank.rows`` the candidates that hold a row: ``rerank`` a query, or
    fewer where its probed partitions hold fewer rows. None moves with no
    profiler."""
    index, x, q = _bucketed() if shape == "blobs" else _gist()
    index.query_rerank(q, x, k=K, nprobe=nprobe, rerank=rerank)
    for name in ("tables.cells", "tables.plain", "tables.kernel",
                 "rerank.rows"):
        assert profiling.counters().get(name, 0) == 0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            index.query_rerank(q, x, k=K, nprobe=nprobe, rerank=rerank)
    counts = (index.buckets.rows >= 0).sum(dim=1)
    held = counts[_probed(index, q, nprobe)].sum(dim=1)
    got = profiling.counters()
    assert got["tables.cells"] == 2 * len(q) * nprobe
    assert got["tables.plain"] == got["tables.cells"]
    assert got.get("tables.kernel", 0) == 0
    assert got["rerank.rows"] == 2 * int(held.clamp_max(rerank).sum())
    if rerank > int(counts.max()) * nprobe:
        assert got["rerank.rows"] < 2 * len(q) * rerank   # some ran dry


def test_a_build_emits_one_seeding_a_fit_and_one_sync_a_round(tmp_path):
    x, _ = _blobs(4)
    log = []
    _, events = _events(
        lambda: _build(x, events=lambda e: log.append(type(e).__name__)),
        tmp_path)
    spans = _spans(events)
    names = [s["name"] for s in spans]
    fits = log.count("StartingCentroidInitialization")
    rounds = log.count("StartingCentroidUpdate")
    assert fits == 2 and rounds >= 2
    assert names.count("fdb.kmeans.seeding") == fits
    assert names.count("fdb.kmeans.lloyd") == fits
    assert names.count("fdb.lloyd.sync") == rounds
    # The capped coarse fit nests its sub-fit, then assigns every row.
    assert names.count("fdb.kmeans.fit") == 3
    assert names.count("fdb.kmeans.assign") == 1
    assert names.count("fdb.build") == names.count("fdb.encode") == 1
    parent = {s["name"]: _parent(s, spans) for s in spans}
    assert parent["fdb.build"] is None
    assert parent["fdb.encode"] == "fdb.build"
    assert parent["fdb.kmeans.assign"] == "fdb.kmeans.fit"
    for s in spans:
        if s["name"] in ("fdb.kmeans.seeding", "fdb.kmeans.lloyd"):
            assert _parent(s, spans) == "fdb.kmeans.fit"
        if s["name"] == "fdb.lloyd.sync":
            assert _parent(s, spans) == "fdb.kmeans.lloyd"


def _flat(out):
    """A call's result as a list of arrays."""
    if isinstance(out, pbuild.ShardedBuild):
        return [t.numpy() for t in out]
    if isinstance(out[0], list):
        return [np.array([[r.vector_index, r.partition_index,
                           r.squared_distance] for r in rs]) for rs in out]
    return list(out)


@pytest.mark.parametrize("path", sorted(CALLS))
def test_results_are_bit_equal_under_a_profiler(path, tmp_path):
    call = CALLS[path]()
    plain = _flat(call())
    traced, _ = _events(call, tmp_path)
    for a, b in zip(plain, _flat(traced), strict=True):
        np.testing.assert_array_equal(a, b)
