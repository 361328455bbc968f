"""The exact SIFT1M configuration (``portbench/configs/sift1m-flat.json``)
through the port's flat tier on the CPU, at its width and a small scale:
20,000 rows of 128 dimensions and 64 queries from the configuration's
mixture (the configuration's 1M rows are what the card runs).

* ``FlatDatabase.query_batch`` answers as the benchmark's plain exact
  reference (``portbench/reference/exact.search``, float64) does: the same
  rows in the same order, except where two rows' reference keys lie
  within the tolerance below of each other, with or without a ``where=``
  filter.
* Its distances agree with the float64 keys within ``TOL_ULPS`` units of
  ``2⁻²⁴·(‖q‖² + ‖x‖²)``. The configuration states the f32 expanded form
  ``‖q‖² + ‖x‖² − 2q·x``: each of its three terms is a sum of 128 f32
  products, and the two adds round at the scale of ``‖q‖² + ‖x‖²``, so its
  error is a few such units whatever the distance (up to 12.7 on this
  mixture); 32 leaves that room. TF32's operands keep 10 bits of mantissa,
  and its error is hundreds of units (the reference in TF32 fails).
* Under a profiler the program counts ``exact.queries`` and
  ``exact.pairs`` and opens its flat spans; the benchmark's
  ``exact.roofline`` reads them (``portbench/roofline/exact.py``).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flechasdb_tpu_torch as ft
from flechasdb_tpu_torch.utils import profiling
from portbench import peaks, spans, synth, tracing
from portbench.core import Record
from portbench.reference import arith, exact
from portbench.roofline import exact as exact_roofline
from portbench.spec import REPO, load_module
from portbench.window import Call, Window

CFG = json.loads((REPO / "portbench/configs/sift1m-flat.json").read_text())
N, NQ, M = 20_000, 64, CFG["dim"]
TOL_ULPS = 32


@pytest.fixture(scope="module")
def sift():
    """``(x [N, M], q [NQ, M], db)`` from the configuration's mixture, the
    rows tagged ``i % 3``."""
    data = CFG["data"]
    x, q = synth.gmm_pair(torch.Generator().manual_seed(26), N, NQ, M,
                          n_clusters=data["components"],
                          intrinsic=data["intrinsic"],
                          cluster_std=data["cluster_std"],
                          noise=data["noise"])
    db = ft.FlatDatabase(x.numpy(), seed=26, device="cpu")
    for i in range(N):
        db.set_attribute_at(i, ("tag", i % 3))
    return x, q, db


def _answers(results, k):
    rows = torch.tensor([[r.vector_index for r in res] for res in results])
    dists = torch.tensor([[r.squared_distance for r in res]
                          for res in results], dtype=torch.float64)
    assert rows.shape == dists.shape == (len(results), k)
    return rows, dists


def _tol(x, q, rows):
    """``TOL_ULPS · 2⁻²⁴ · (‖q‖² + ‖x‖²)`` for each answered row."""
    qq = (q.double() ** 2).sum(1)[:, None]
    xx = (x.double()[rows] ** 2).sum(-1)
    return TOL_ULPS * 2.0 ** -24 * (qq + xx)


def _same_ranking(x, q, rows, ref_keys, ref_rows):
    """The rows equal the reference's, slot for slot, except where the
    two rows' float64 keys lie within the tolerance of each other."""
    got = exact.keys_of(x, q, rows)
    differ = rows != ref_rows
    slack = _tol(x, q, rows) + _tol(x, q, ref_rows.clamp_min(0))
    assert bool((ref_rows >= 0).all())
    assert bool(((got - ref_keys).abs() <= slack)[differ].all())
    assert int(differ.sum()) <= rows.numel() // 100
    assert all(len(set(r)) == len(r) for r in rows.tolist())


@pytest.mark.parametrize("k", [CFG["k"], 100])
def test_answers_as_the_exact_reference(sift, k):
    x, q, db = sift
    rows, dists = _answers(db.query_batch(q.numpy(), k), k)
    ref_keys, ref_rows = exact.search(x, q, k)
    _same_ranking(x, q, rows, ref_keys, ref_rows)
    err = (dists - exact.keys_of(x, q, rows)).abs()
    assert bool((err <= _tol(x, q, rows)).all()), float(err.max())


@pytest.mark.parametrize("k", [CFG["k"], 100])
def test_a_filter_answers_as_the_reference_with_its_row_mask(sift, k):
    x, q, db = sift
    rows, dists = _answers(db.query_batch(q.numpy(), k,
                                          where=ft.Eq("tag", 1)), k)
    mask = torch.arange(N) % 3 == 1
    assert bool(mask[rows].all())
    ref_keys, ref_rows = exact.search(x, q, k, row_mask=mask)
    _same_ranking(x, q, rows, ref_keys, ref_rows)
    err = (dists - exact.keys_of(x, q, rows)).abs()
    assert bool((err <= _tol(x, q, rows)).all()), float(err.max())


@pytest.mark.parametrize("k", [CFG["k"], 100])
def test_the_reference_in_tf32_fails_the_tolerance(sift, k):
    """So the tolerance would catch a scan that dropped below f32."""
    x, q, _ = sift
    keys, rows = exact.search(x, q, k, arith.TF32)
    err = (keys.double() - exact.keys_of(x, q, rows)).abs()
    over = err > _tol(x, q, rows)
    assert float(over.double().mean()) > 0.5


def test_the_scan_counts_and_spans(sift, tmp_path):
    x, q, db = sift
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        db.query_batch(q.numpy(), CFG["k"])
    got = profiling.counters()
    profiling.reset_counters()
    assert got["exact.queries"] == NQ
    assert got["exact.pairs"] == NQ * N
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    found = spans.parse(path)
    outer = [s for s in found.spans if s[0] == "fdb.query_batch"]
    assert len(outer) == 1
    _, a, z = outer[0]
    inner = {n: (s, e) for n, s, e in found.spans if n != "fdb.query_batch"}
    assert set(inner) == {"fdb.to_device", "fdb.exact", "fdb.to_host",
                          "fdb.results"}
    assert all(a <= s <= e <= z for s, e in inner.values())
    order = sorted(inner, key=lambda n: inner[n][0])
    assert order == ["fdb.to_device", "fdb.exact", "fdb.to_host",
                     "fdb.results"]


def test_the_scan_counts_nothing_without_a_profiler(sift):
    x, q, db = sift
    profiling.reset_counters()
    db.query_batch(q.numpy(), CFG["k"])
    assert "exact.pairs" not in profiling.counters()


def test_roofline_counts_the_corpus_once_and_the_product_at_tf32():
    b, n, m, k = 1000, CFG["rows"], CFG["dim"], CFG["k"]
    read, wrote, ops = exact_roofline.work(pairs=b * n, b=b, m=m, k=k)
    assert read == 4 * (n * m + b * m) == 512_512_000
    assert wrote == 8 * b * k
    assert ops == 2 * b * n * m
    t, by = exact_roofline.least_seconds(pairs=b * n, b=b, m=m, k=k)
    assert by == "ops, TF32"
    assert t == pytest.approx(ops / peaks.TF32_FLOPS)
    assert t == pytest.approx(0.5175e-3, rel=1e-3)
    # At the f32 units' rate the same batch takes 3.8 ms (PERF.md).
    assert ops / peaks.FP32_FLOPS == pytest.approx(3.827e-3, rel=1e-3)


def _ev(cat, name, ts, dur, corr=None, thread=(1, 11)):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _record(tmp_path, monkeypatch, b=1000, calls=2):
    """A traced window of ``calls`` batches of ``b`` queries: in each, an
    ``fdb.exact`` span that launches a 90-ms kernel, and a 1-ms kernel
    launched outside it."""
    events = [_ev("user_annotation", tracing.WINDOW, 0, 400_000)]
    for i in range(calls):
        t0 = 1000 + 150_000 * i
        events += [
            _ev("user_annotation", "fdb.exact", t0, 50),
            _ev("cuda_runtime", "cudaLaunchKernel", t0 + 10, 2, 10 * i + 1),
            _ev("kernel", "gemm", t0 + 100, 90_000, 10 * i + 1, (0, 7)),
            _ev("cuda_runtime", "cudaLaunchKernel", t0 + 100, 2,
                10 * i + 2),
            _ev("kernel", "copy", t0 + 91_000, 1000, 10 * i + 2, (0, 7)),
        ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "trace_path", lambda name: path)

    class Cell:
        name = "sift1m.flat-exact"
        config = CFG
    window = Window(0.0, [Call(i, 0.0, 1.0, b, True) for i in range(calls)])
    return Record(cell=Cell(), window=window, setup_s=0.0,
                  trace=tracing.parse(path))


@pytest.mark.parametrize("asked", [1, 3], ids=["one window", "three"])
def test_exact_roofline_reads_the_pairs_over_the_span_s_device_time(
        tmp_path, monkeypatch, asked):
    """Two batches of 1000 over 1M rows; the counters counted ``asked``
    such windows, so the kept window's share of them is read."""
    rec = _record(tmp_path, monkeypatch)
    monkeypatch.setattr(profiling, "counters", lambda: {
        "exact.queries": asked * 2000,
        "exact.pairs": asked * 2000 * CFG["rows"]})
    got = load_module("metrics", "exact.roofline").read(rec)
    least = exact_roofline.least_seconds(pairs=1000 * CFG["rows"], b=1000,
                                         m=CFG["dim"], k=CFG["k"])[0]
    assert got == pytest.approx(100 * 2 * least / 0.180)
    assert 0 < got < 100


def test_exact_roofline_is_silent_without_its_counter(tmp_path,
                                                      monkeypatch):
    """The parent's program counts no pairs: no share, and nothing
    raises; nor in an untraced run."""
    rec = _record(tmp_path, monkeypatch)
    read = load_module("metrics", "exact.roofline").read
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"bucketed.topk_kernel": 400})
    assert read(rec) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "exact.queries": 2000, "exact.pairs": 2000 * CFG["rows"]})
    assert read(rec) is not None
    rec.trace = None
    assert read(rec) is None
