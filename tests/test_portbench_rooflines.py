"""The benchmark's work of the ADC tables step and of the exact rerank
(``portbench/roofline/tables.py``, ``rerank.py``) against figures counted
by hand at the batches of the GIST1M and Deep10M serving cells, and the
two per-layer metrics that read them (``tables.roofline``,
``rerank.roofline``) over a hand-made trace: a share where the program
counted, nothing where its counter is absent.
"""

import json

import pytest

from flechasdb_tpu_torch.utils import profiling
from portbench import peaks, spans, tracing
from portbench.core import Record
from portbench.roofline import rerank, tables
from portbench.spec import REPO, load_module
from portbench.window import Call, Window

GIST = json.loads((REPO / "portbench/configs/gist1m-ivf1024-pq60.json")
                  .read_text())
DEEP = json.loads((REPO / "portbench/configs/deep10m-ivf4096-pq8.json")
                  .read_text())


def _batch(cfg, b):
    """A batch of ``b`` queries: its tables' and its rerank's shapes."""
    cells = b * cfg["nprobe"]
    return (dict(cells=cells, b=b, p=cfg["partitions"], m=cfg["dim"],
                 d=cfg["divisions"], c=cfg["clusters"]),
            dict(rows=b * cfg["rerank"], b=b, r=cfg["rerank"],
                 m=cfg["dim"], k=cfg["k"]))


@pytest.mark.parametrize("cfg, b, written, centroids", [
    (GIST, 1000, 614_400_000, 1024 * 960),      # every partition probed
    (DEEP, 200, 52_428_800, 4096 * 96),         # 6,400 cells, 4,096 parts
])
def test_tables_write_each_table_once(cfg, b, written, centroids):
    shape, _ = _batch(cfg, b)
    read, wrote, ops = tables.work(**shape)
    m = cfg["dim"]
    assert wrote == written
    assert read == 4 * (centroids + b * m + cfg["clusters"] * m)
    assert ops == 2 * shape["cells"] * 256 * m
    t, by = tables.least_seconds(**shape)
    assert by == "bytes"
    assert t == pytest.approx((read + wrote) / peaks.HBM_BYTES_PER_S)


def test_tables_read_a_centroid_once_a_cell_where_cells_are_fewer():
    read, _, _ = tables.work(cells=20, b=2, p=1024, m=960, d=60, c=256)
    assert read == 4 * (20 * 960 + 2 * 960 + 256 * 960)


@pytest.mark.parametrize("cfg, b, rows_bytes", [
    (GIST, 1000, 384_000_000),                  # 100,000 rows of 960
    (DEEP, 200, 7_680_000),                     # 20,000 rows of 96
])
def test_rerank_reads_each_counted_row_once(cfg, b, rows_bytes):
    _, shape = _batch(cfg, b)
    read, wrote, ops = rerank.work(**shape)
    m = cfg["dim"]
    assert read == rows_bytes + 4 * b * m + 8 * b * cfg["rerank"]
    assert wrote == 8 * b * cfg["k"]
    assert ops == 3 * shape["rows"] * m
    t, by = rerank.least_seconds(**shape)
    assert by == "bytes"
    assert t == pytest.approx((read + wrote) / peaks.HBM_BYTES_PER_S)


def _ev(cat, name, ts, dur, corr=None, thread=(1, 11)):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _record(tmp_path, monkeypatch, cfg, b, calls=2):
    """A traced window of ``calls`` batches of ``b`` queries: in each, an
    ``fdb.tables`` span that launches a 400-us kernel and an
    ``fdb.rerank`` span that launches a 250-us one."""
    events = [_ev("user_annotation", tracing.WINDOW, 0, 10_000)]
    for i in range(calls):
        t0 = 1000 + 4000 * i
        events += [
            _ev("user_annotation", "fdb.tables", t0, 50),
            _ev("cuda_runtime", "cudaLaunchKernel", t0 + 10, 2, 10 * i + 1),
            _ev("kernel", "tables", t0 + 100, 400, 10 * i + 1, (0, 7)),
            _ev("user_annotation", "fdb.rerank", t0 + 600, 50),
            _ev("cuda_runtime", "cudaLaunchKernel", t0 + 610, 2, 10 * i + 2),
            _ev("kernel", "rerank", t0 + 700, 250, 10 * i + 2, (0, 7)),
        ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "trace_path", lambda name: path)

    class Cell:
        name = "gist1m.serve-rerank"
        config = cfg
    window = Window(0.0, [Call(i, 0.0, 1.0, b, True) for i in range(calls)])
    return Record(cell=Cell(), window=window, setup_s=0.0,
                  trace=tracing.parse(path))


def _counted(monkeypatch, got):
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))


@pytest.mark.parametrize("asked", [1, 3], ids=["one window", "three"])
def test_each_metric_reads_its_counter_over_its_span_s_device_time(
        tmp_path, monkeypatch, asked):
    """Two batches of 1000 at GIST; the counters counted ``asked`` such
    windows (the profiler's records fell short and the window ran again),
    so the kept window's share of them is read."""
    rec = _record(tmp_path, monkeypatch, GIST, 1000)
    tab, rr = _batch(GIST, 1000)
    _counted(monkeypatch, {"tables.cells": asked * 2 * tab["cells"],
                           "rerank.rows": asked * 2 * rr["rows"],
                           "bucketed.topk_kernel": asked * 2000})
    got = load_module("metrics", "tables.roofline").read(rec)
    assert got == pytest.approx(
        100 * 2 * tables.least_seconds(**tab)[0] / 800e-6)
    got = load_module("metrics", "rerank.roofline").read(rec)
    assert got == pytest.approx(
        100 * 2 * rerank.least_seconds(**rr)[0] / 500e-6)


@pytest.mark.parametrize("name, counter", [
    ("tables.roofline", "tables.cells"), ("rerank.roofline", "rerank.rows")])
def test_each_metric_is_silent_without_its_counter(tmp_path, monkeypatch,
                                                   name, counter):
    """The parent's program counts neither: no share, and nothing
    raises; nor in an untraced run."""
    rec = _record(tmp_path, monkeypatch, DEEP, 200)
    read = load_module("metrics", name).read
    _counted(monkeypatch, {"bucketed.slots": 10, "bucketed.real_slots": 5,
                           "bucketed.topk_kernel": 400})
    assert read(rec) is None
    _counted(monkeypatch, {counter: 100, "bucketed.topk_kernel": 400})
    assert read(rec) is not None
    rec.trace = None
    assert read(rec) is None
