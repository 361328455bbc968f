"""The program's spans read back from a Chrome trace: each device op
credited to the innermost ``fdb.`` span open on the thread that launched
it, and the five readers of them."""

import json

import pytest

from portbench import spans, tracing
from portbench.core import Record
from portbench.spec import load_module
from portbench.window import Call, Window

NEW = ["serve.topk_device_ms_per_batch", "serve.scan_device_ms_per_batch",
       "serve.results_ms_per_batch", "bucketed.slot_fill", "lloyd.idle_pct"]
HOST, OTHER = (1, 11), (1, 12)


def _ev(cat, name, ts, dur, thread=HOST, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr, thread=HOST, cat="cuda_runtime"):
    return _ev(cat, "cudaLaunchKernel", ts, 2, thread, corr)


def _kernel(ts, dur, corr, cat="kernel"):
    return _ev(cat, f"k{corr}", ts, dur, (0, 7), corr)


def _serve_events():
    return [
        _ev("user_annotation", tracing.WINDOW, 0, 1000),
        _ev("user_annotation", "fdb.index.query", 10, 400),
        _ev("user_annotation", "fdb.scan", 20, 30),
        _launch(25, 1),
        _ev("user_annotation", "fdb.topk", 60, 20),
        _launch(65, 2),
        _launch(70, 3, cat="cuda_driver"),
        _ev("user_annotation", "fdb.to_host", 90, 300),
        _launch(95, 4),                         # the copy to the host
        _ev("user_annotation", "fdb.results", 400, 50),
        _launch(420, 5, thread=OTHER),          # in no span of its thread
        _launch(600, 6),                        # after every span
        _kernel(30, 40, 1),
        _kernel(100, 80, 2),                    # runs after fdb.topk ends
        _kernel(180, 20, 3),
        _kernel(200, 10, 4, cat="gpu_memcpy"),
        _kernel(430, 5, 5),
        _kernel(610, 7, 6),
        _kernel(2000, 9, 2),                    # outside the window
    ]


def _record(tmp_path, monkeypatch, events, cell="deep10m.serve-rerank",
            batches=2):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "trace_path", lambda name: path)

    class Cell:
        name = cell
    window = Window(0.0, [Call(i, 0.0, 1.0, 1, True)
                          for i in range(batches)])
    return Record(cell=Cell(), window=window, setup_s=0.0,
                  trace=tracing.parse(path))


def _credited(tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps(_serve_events()))
    return {dur: span for _, dur, span in spans.parse(path).ops}


def test_a_kernel_run_after_its_span_closed_is_still_the_span_s(tmp_path):
    got = _credited(tmp_path)
    assert got[80] == "fdb.topk"
    assert got[20] == "fdb.topk"
    assert got[40] == "fdb.scan"
    assert got[10] == "fdb.to_host"             # a copy


def test_a_launch_in_no_span_of_its_thread_is_credited_to_none(tmp_path):
    got = _credited(tmp_path)
    assert got[5] is None                       # another thread
    assert got[7] is None                       # after every span


def test_nested_spans_credit_the_innermost(tmp_path):
    events = [
        _ev("user_annotation", "fdb.build", 0, 100),
        _ev("user_annotation", "fdb.kmeans.fit", 10, 80),
        _ev("user_annotation", "fdb.kmeans.lloyd", 20, 60),
        _ev("user_annotation", "fdb.lloyd.sync", 40, 10),
        _launch(15, 1), _launch(30, 2), _launch(45, 3), _launch(60, 4),
        _launch(95, 5),
        _kernel(200, 1, 1), _kernel(201, 2, 2), _kernel(203, 3, 3),
        _kernel(206, 4, 4), _kernel(210, 5, 5),
    ]
    path = tmp_path / "n.json"
    path.write_text(json.dumps(events))
    got = {dur: span for _, dur, span in spans.parse(path).ops}
    assert got == {1: "fdb.kmeans.fit", 2: "fdb.kmeans.lloyd",
                   3: "fdb.lloyd.sync", 4: "fdb.kmeans.lloyd",
                   5: "fdb.build"}


def test_serving_readers_sum_each_stage_over_the_batches(tmp_path,
                                                         monkeypatch):
    rec = _record(tmp_path, monkeypatch, _serve_events(),
                  cell="sift1m.serve-policy")
    read = {n: load_module("metrics", n).read for n in NEW}
    # fdb.topk: 80 + 20 us (the kernel at 2000 lies outside the window)
    assert read["serve.topk_device_ms_per_batch"](rec) == \
        pytest.approx(100 / 1e3 / 2)
    assert read["serve.scan_device_ms_per_batch"](rec) == \
        pytest.approx(40 / 1e3 / 2)
    assert read["serve.results_ms_per_batch"](rec) == \
        pytest.approx(50 / 1e3 / 2)
    assert read["lloyd.idle_pct"](rec) is None


def test_lloyd_idle_pct_is_the_uncovered_share_of_the_loops(tmp_path,
                                                            monkeypatch):
    events = [
        _ev("user_annotation", tracing.WINDOW, 0, 1000),
        _ev("user_annotation", "fdb.kmeans.lloyd", 100, 200),   # [100, 300)
        _ev("user_annotation", "fdb.lloyd.sync", 250, 40),
        _ev("user_annotation", "fdb.kmeans.lloyd", 500, 100),   # [500, 600)
        _kernel(50, 100, 1),          # covers [100, 150) of the first
        _kernel(200, 30, 2),          # [200, 230)
        _kernel(580, 60, 3),          # [580, 600) of the second
    ]
    rec = _record(tmp_path, monkeypatch, events, cell="sift1m.build",
                  batches=1)
    # inside 300 us; busy 50 + 30 + 20 = 100 us; idle 200 / 300
    got = load_module("metrics", "lloyd.idle_pct").read(rec)
    assert got == pytest.approx(100 * 200 / 300)
    inside = spans.parse(spans.trace_path("x")).intervals(
        "fdb.kmeans.lloyd", rec.trace.window)
    assert spans.idle_seconds(inside, rec.trace.busy()) == \
        pytest.approx(200 / 1e6)


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_is_silent_where_the_spans_are_absent(
        tmp_path, monkeypatch, name):
    """A program without spans or counters (the parent of this
    benchmark's metrics) reports none of them, and none raises."""
    from flechasdb_tpu_torch.utils import profiling

    profiling.reset_counters()
    events = [e for e in _serve_events()
              if not e["name"].startswith("fdb.")]
    rec = _record(tmp_path, monkeypatch, events)
    assert load_module("metrics", name).read(rec) is None
    rec.trace = None
    assert load_module("metrics", name).read(rec) is None


def test_slot_fill_reads_the_program_s_counters(tmp_path, monkeypatch):
    import torch
    from torch.profiler import profile

    from flechasdb_tpu_torch.utils import profiling

    profiling.reset_counters()
    with profile():
        profiling.count("bucketed.slots", 400)
        profiling.count("bucketed.real_slots", torch.tensor([30, 70]))
    rec = _record(tmp_path, monkeypatch, _serve_events())
    try:
        assert load_module("metrics", "bucketed.slot_fill").read(rec) == \
            pytest.approx(25.0)
    finally:
        profiling.reset_counters()


@pytest.mark.parametrize("cell", ["deep10m.serve-rerank",
                                  "sift1m.serve-policy", "sift1m.build"])
def test_a_traced_run_on_the_cpu_reports_the_host_side_ones(small_bench,
                                                            cell):
    """A whole traced run at a CPU size: the spans and counters are read
    from the program; no device op exists, so the device readers are
    silent."""
    from flechasdb_tpu_torch.utils import profiling

    from portbench.core import run_cell

    profiling.reset_counters()
    res = run_cell(cell, 135792468024, 0.3, True, bench=small_bench,
                   device="cpu", require_chip=False)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    want = {"deep10m.serve-rerank": {"bucketed.slot_fill"},
            "sift1m.serve-policy": {"serve.results_ms_per_batch"},
            "sift1m.build": {"lloyd.idle_pct"}}[cell]
    assert want <= got
    assert not got & {"serve.topk_device_ms_per_batch",
                      "serve.scan_device_ms_per_batch"}
    fill = res["metrics"].get("bucketed.slot_fill", {}).get("value", 50.0)
    assert 0 < fill <= 100
