"""``serve.bucketed_pct``: the share of a traced window's batches on the
card that the program answered from the bucketed layout, read from its
``graph.replays``, ``graph.eager`` and ``serve.masked`` counters."""

import json

import pytest

from portbench import tracing
from portbench.core import Record
from portbench.spec import load_module
from portbench.window import Call, Window


def _record(tmp_path, batches=2):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
         "ts": 0, "dur": 1000, "pid": 1, "tid": 11}]}))

    class Cell:
        name = "sift1m.serve-policy"
    window = Window(0.0, [Call(i, 0.0, 1.0, 1, True)
                          for i in range(batches)])
    return Record(cell=Cell(), window=window, setup_s=0.0,
                  trace=tracing.parse(path))


def _read(rec):
    return load_module("metrics", "serve.bucketed_pct").read(rec)


def _counted(**counts):
    """The counters as a traced window of a program counts them."""
    from torch.profiler import profile

    from flechasdb_tpu_torch.utils import profiling

    profiling.reset_counters()
    with profile():
        for name, n in counts.items():
            profiling.count(name.replace("_", "."), n)


@pytest.mark.parametrize("counts, want", [
    ({"graph_replays": 6}, 100.0),
    ({"graph_replays": 5, "graph_eager": 1}, 100.0),
    ({"graph_eager": 3}, 100.0),
    ({"graph_replays": 2, "graph_eager": 1, "serve_masked": 1}, 75.0),
    ({"serve_masked": 4}, 0.0)])
def test_bucketed_pct_reads_the_program_s_counters(tmp_path, counts, want):
    from flechasdb_tpu_torch.utils import profiling

    _counted(**counts)
    try:
        assert _read(_record(tmp_path)) == pytest.approx(want)
    finally:
        profiling.reset_counters()


def test_bucketed_pct_is_silent_where_no_batch_was_counted(tmp_path):
    """A program without the counters (the parent of this metric) reports
    no share, traced or not, and the reader never raises."""
    from flechasdb_tpu_torch.utils import profiling

    _counted()
    rec = _record(tmp_path)
    try:
        assert _read(rec) is None
        rec.trace = None
        assert _read(rec) is None
    finally:
        profiling.reset_counters()
