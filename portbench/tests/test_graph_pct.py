"""``serve.graph_pct``: the share of a traced window's bucketed batches
that the program answered by replaying CUDA graphs, read from its
``graph.replays`` and ``graph.eager`` counters."""

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
        name = "deep10m.serve-rerank"
    window = Window(0.0, [Call(i, 0.0, 1.0, 1, True)
                          for i in range(batches)])
    return Record(cell=Cell(), window=window, setup_s=0.0,
                  trace=tracing.parse(path))


def _read(rec):
    return load_module("metrics", "serve.graph_pct").read(rec)


@pytest.mark.parametrize("eager, want", [(0, 100.0), (2, 75.0)])
def test_graph_pct_reads_the_program_s_counters(tmp_path, eager, want):
    from torch.profiler import profile

    from flechasdb_tpu_torch.utils import profiling

    profiling.reset_counters()
    with profile():
        profiling.count("graph.replays", 6)
        if eager:
            profiling.count("graph.eager", eager)
    try:
        assert _read(_record(tmp_path)) == pytest.approx(want)
    finally:
        profiling.reset_counters()


@pytest.mark.parametrize("eager", [0, 3])
def test_graph_pct_is_silent_where_no_batch_was_replayed(tmp_path, eager):
    """A program without the counters (the parent of this metric), or one
    that replayed nothing, reports no share, and the reader never
    raises."""
    from torch.profiler import profile

    from flechasdb_tpu_torch.utils import profiling

    profiling.reset_counters()
    with profile():
        if eager:
            profiling.count("graph.eager", eager)
    rec = _record(tmp_path)
    try:
        assert _read(rec) is None
        rec.trace = None
        assert _read(rec) is None
    finally:
        profiling.reset_counters()
