"""The traced window's reading: busy time, idle gaps named by the host,
kernel families and their cross-check against the launch counter."""

import json

import pytest

from portbench import tracing


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


K = {"adc": "void (anonymous namespace)::adc_scan_kernel<2, true>"
            "((anonymous namespace)::ScanArgs)",
     "kb": "void (anonymous namespace)::assign_kernel<true>(float const*)",
     "kbf": "void (anonymous namespace)::assign_fast_kernel(CUtensorMap)",
     "ts": "void (anonymous namespace)::tile_sums<false, 1, false, 4>"
           "(float const*)",
     "ct": "void (anonymous namespace)::combine_tiles(float const*)",
     "cb": "void (anonymous namespace)::combine(float const*, int)",
     "pl": "void (anonymous namespace)::place<true>(int const*)",
     "sort": "void at::native::radixSortKVInPlace<float>(float*)"}


def _trace(tmp_path):
    events = [
        _ev("user_annotation", tracing.WINDOW, 0, 1000),
        _ev("user_annotation", tracing.CALL, 0, 500),
        _ev("cpu_op", "aten::sort", 10, 80),
        _ev("cuda_runtime", "cudaStreamSynchronize", 300, 190),
        _ev("kernel", K["adc"], 100, 50),
        _ev("kernel", K["adc"], 140, 40),          # overlaps the first
        _ev("kernel", K["sort"], 200, 100),
        _ev("gpu_memcpy", "Memcpy DtoH", 480, 10),
        _ev("kernel", K["kb"], 600, 100),
        _ev("kernel", K["kbf"], 700, 50),
        _ev("kernel", K["ts"], 750, 20),
        _ev("kernel", K["ct"], 770, 10),
        _ev("kernel", K["pl"], 800, 5),
        _ev("kernel", K["cb"], 805, 5),
        _ev("kernel", K["adc"], 2000, 10),         # outside the window
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.parse(path)


def test_busy_is_the_union_inside_the_window(tmp_path):
    tr = _trace(tmp_path)
    # [100, 180) + [200, 300) + [480, 490) + [600, 780) + [800, 810)
    assert tr.busy_s == pytest.approx((80 + 100 + 10 + 180 + 10) / 1e6)
    assert tr.window_s == pytest.approx(1000 / 1e6)


def test_idle_gaps_are_named_by_the_innermost_host_event(tmp_path):
    gaps = dict(_trace(tmp_path).idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(100 / 1e6)        # [0, 100)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(180 / 1e6)
    assert gaps[tracing.CALL] == pytest.approx(20 / 1e6)        # [180, 200)
    # [490, 600), [780, 800), [810, 1000): nothing on the host profiled
    assert gaps["host (no profiled op)"] == pytest.approx(320 / 1e6)
    assert sum(gaps.values()) == pytest.approx((1000 - 380) / 1e6)


def test_families_do_not_take_each_others_kernels(tmp_path):
    tr = _trace(tmp_path)
    assert tr.launches("adc_scan") == 2           # the third is outside
    assert tr.launches("lloyd_round") == 1        # not assign_fast_kernel
    assert tr.launches("lloyd_grouped") == 0
    assert tr.launches("cluster_sums") == 2       # combine_tiles, combine
    assert len(tr.family("cluster_sums")) == 4    # and tile_sums, place
    ops = dict(tr.device_ops())
    assert ops["at::native::radixSortKVInPlace<float>"] == 100 / 1e6
    assert ops["(anonymous namespace)::adc_scan_kernel<2, true>"] == \
        pytest.approx(100 / 1e6)                   # 50 + 40 + 10


def test_a_window_that_loses_launches_is_profiled_again_then_fails(tmp_path):
    counter = {"adc_scan": 0}
    calls = []

    def lossy():
        calls.append(1)
        counter["adc_scan"] += 2        # counted, never seen by the trace
        return "record"

    with pytest.raises(RuntimeError, match="lost launches"):
        tracing.traced(lossy, counter, ["adc_scan"], tmp_path / "a.json",
                       log=lambda s: None)
    assert len(calls) == 3

    def clean():
        return "record"

    trace, rec = tracing.traced(clean, counter, ["adc_scan"],
                                tmp_path / "b.json", log=lambda s: None)
    assert rec == "record" and trace.window_s > 0
