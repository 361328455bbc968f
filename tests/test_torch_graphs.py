"""The graph route of ``serving.DeviceIndex``: the bucketed query and the
reranked query replayed as CUDA graphs, one a stage span.

On the CPU: which calls take the route, when a key is captured, the
least recently used key out at ``GRAPH_KEYS``, the counters a replay
makes, the kernel launches counted on the thread that makes them, and
the aten ops the op-by-op path dispatches. A stand-in for the
graphs (:class:`_CpuGraph`: the capture runs the stage, a replay runs it
again into the same tensors) carries the route's bookkeeping on the CPU.
On the card (``-m cuda``): the replays bit-equal to the op-by-op path,
batch after batch, for a second key and after it, with the same counters
and kernel launches, another thread's launches during a capture counted
once, and each kernel seen by the profiler inside its stage's span.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flechasdb_tpu_torch import _kernels, serving
from flechasdb_tpu_torch.build import DatabaseBuilder
from flechasdb_tpu_torch.serving import GRAPH_KEYS, DeviceIndex, ShardedIndex
from flechasdb_tpu_torch.utils import profiling

from _torch_helpers import cuda, world_of_one  # noqa: F401

STAGES = {"knn": ["fdb.probe", "fdb.tables", "fdb.scan", "fdb.topk"],
          "rerank": ["fdb.probe", "fdb.tables", "fdb.scan", "fdb.topk",
                     "fdb.rerank"]}


def _arrays(seed, n, m, p, d, c):
    """An index's arrays drawn from ``seed``: skewed partition sizes, so
    bucket lengths vary, and the corpus ``x [N, M]``."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((p, m)).astype(np.float32)
    books = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = np.minimum(rng.geometric(4.0 / p, n) - 1, p - 1).astype(np.int32)
    x = rng.standard_normal((n, m)).astype(np.float32)
    return (cents, books, codes, pidx), x, rng


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


class _CpuGraph:
    """A CUDA graph's stand-in on the CPU: the capture runs the stage once;
    each replay runs it again into the same tensors, both its outputs and
    the tensors it counted, as a replay rewrites the graph's memory (the
    counts go to the capture's record, not to the counters)."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args
        record = profiling._RECORDING.counts
        first = len(record)
        self.out = fn(*args)
        self.counted = record[first:]
        self.replays = 0

    def replay(self):
        with profiling.recording() as counted:
            new = self.fn(*self.args)
        pairs = list(zip(_flat(self.out), _flat(new)))
        pairs += [(o, n) for (_, o), (_, n) in zip(self.counted, counted)
                  if isinstance(o, torch.Tensor)]
        for o, n in pairs:
            o.copy_(n)
        self.replays += 1

    def pool(self):
        return None


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Captures on the CPU with :class:`_CpuGraph`; the list of them. The
    results cross to the host as copies, as ``.cpu()`` copies them off the
    card (on the CPU it would hand out the static buffers themselves)."""
    made = []

    def graphed(fn, args, device, pool):
        made.append(_CpuGraph(fn, args))
        return made[-1], made[-1].out

    host = serving._host
    monkeypatch.setattr(serving, "_graphed", graphed)
    monkeypatch.setattr(serving, "_host",
                        lambda *ts: tuple(a.copy() for a in host(*ts)))
    return made


def _cpu_index(layout="bucketed", graphed=True, seed=5):
    arrays, x, rng = _arrays(seed, 3000, 16, 16, 4, 16)
    idx = DeviceIndex(*arrays, layout=layout, device="cpu")
    if graphed:
        idx._graphs = serving._Graphs(idx.device)
    return idx, torch.as_tensor(x), rng


def _ask(idx, kind, q, x):
    if kind == "knn":
        return idx.query(q, 5, 4)
    return idx.query_rerank(q, x, k=5, nprobe=4, rerank=20)


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32))
        else:
            np.testing.assert_array_equal(g, w)


# -- the route on the CPU -----------------------------------------------------

@pytest.mark.parametrize("layout", ["bucketed", "masked"])
def test_the_cpu_takes_no_graph_route(layout):
    idx, _, rng = _cpu_index(layout, graphed=False)
    assert idx._graphs is None
    q = rng.standard_normal((6, 16)).astype(np.float32)
    for _ in range(3):
        assert len(idx.query(q, 5, 4)[0]) == 6


def test_a_mesh_takes_no_graph_route(world_of_one):  # noqa: F811
    arrays, _, rng = _arrays(6, 3000, 16, 16, 4, 16)
    idx = ShardedIndex(*arrays, layout="bucketed", mesh=world_of_one)
    assert idx._graphs is None
    q = rng.standard_normal((6, 16)).astype(np.float32)
    want = DeviceIndex(*arrays, layout="bucketed", device="cpu").query(
        q, 5, 4)
    for _ in range(3):
        _same_bits(idx.query(q, 5, 4), want)


@pytest.mark.parametrize("kind", ["knn", "rerank"])
def test_a_key_is_captured_at_its_second_call(cpu_graphs, kind):
    idx, x, rng = _cpu_index()
    plain, _, _ = _cpu_index(graphed=False)
    batches = [rng.standard_normal((6, 16)).astype(np.float32)
               for _ in range(5)]
    for i, q in enumerate(batches):
        got = _ask(idx, kind, q, x)
        assert len(cpu_graphs) == (0 if i == 0 else len(STAGES[kind]))
        _same_bits(got, _ask(plain, kind, q, x))
    stages = next(iter(idx._graphs._graphs.values()))[1]
    assert [s.span for s in stages] == STAGES[kind]
    assert idx._graphs.captures == 1
    assert [g.replays for g in cpu_graphs] == [4] * len(STAGES[kind])


def test_row_masks_and_range_search_run_op_by_op(cpu_graphs):
    idx, x, rng = _cpu_index()
    q = rng.standard_normal((6, 16)).astype(np.float32)
    mask = rng.random(3000) < 0.5
    for _ in range(3):
        idx.query(q, 5, 4, row_mask=mask)
        idx.query_rerank(q, x, k=5, nprobe=4, rerank=20, row_mask=mask)
        idx.query_range(q, 10.0, 4)
    assert not cpu_graphs
    assert not idx._graphs._graphs and not idx._graphs._seen


def test_the_least_recently_used_key_goes_at_the_limit(cpu_graphs):
    idx, x, rng = _cpu_index()
    qs = [rng.standard_normal((b, 16)).astype(np.float32)
          for b in range(1, GRAPH_KEYS + 2)]
    for q in qs:
        idx.query(q, 5, 4)
        idx.query(q, 5, 4)
    held = idx._graphs._graphs
    assert len(cpu_graphs) == 4 * (GRAPH_KEYS + 1)
    assert len(held) == GRAPH_KEYS
    assert (qs[0].shape, 5, 4, None) not in held
    assert (qs[1].shape, 5, 4, None) in held
    idx.query(qs[0], 5, 4)                  # seen afresh: op by op
    assert len(cpu_graphs) == 4 * (GRAPH_KEYS + 1)
    idx.query(qs[0], 5, 4)                  # captured again
    assert len(cpu_graphs) == 4 * (GRAPH_KEYS + 2)
    assert idx._graphs.captures == GRAPH_KEYS + 2
    assert (qs[1].shape, 5, 4, None) not in held
    for b in range(10, 10 + GRAPH_KEYS + 1):    # one-off shapes
        idx.query(rng.standard_normal((b, 16)).astype(np.float32), 5, 4)
    assert len(idx._graphs._seen) == GRAPH_KEYS
    assert len(held) == GRAPH_KEYS


def test_threads_never_share_a_key_s_buffers(cpu_graphs):
    """Threads on one index and one key, switching often: each call gets
    its own batch's answer."""
    idx, x, rng = _cpu_index()
    plain, _, _ = _cpu_index(graphed=False)
    batches = [rng.standard_normal((6, 16)).astype(np.float32)
               for _ in range(16)]
    want = [plain.query(q, 5, 4) for q in batches]
    idx.query(batches[0], 5, 4)
    idx.query(batches[0], 5, 4)             # captured
    wrong = []

    def ask(i):
        for j in range(4):
            k = (i + j) % len(batches)
            got = idx.query(batches[k], 5, 4)
            if any(not np.array_equal(g, w) for g, w in zip(got, want[k])):
                wrong.append((i, j))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    assert len(cpu_graphs) == 4


def test_no_key_is_captured_while_a_profiler_collects(cpu_graphs):
    idx, x, rng = _cpu_index()
    q = rng.standard_normal((6, 16)).astype(np.float32)
    idx.query(q, 5, 4)
    with profile():
        idx.query(q, 5, 4)
        idx.query(q, 5, 4)
    assert not cpu_graphs
    idx.query(q, 5, 4)
    assert len(cpu_graphs) == 4


@pytest.mark.parametrize("kind", ["knn", "rerank"])
def test_a_replay_counts_what_the_op_by_op_path_counts(cpu_graphs, kind):
    idx, x, rng = _cpu_index()
    plain, _, _ = _cpu_index(graphed=False)
    warm = rng.standard_normal((6, 16)).astype(np.float32)
    _ask(idx, kind, warm, x)
    _ask(idx, kind, warm, x)                # captured
    batches = [rng.standard_normal((6, 16)).astype(np.float32)
               for _ in range(3)]
    got = {}
    for name, index in (("graphs", idx), ("plain", plain)):
        profiling.reset_counters()
        try:
            with profile():
                for q in batches:
                    _ask(index, kind, q, x)
            got[name] = profiling.counters()
        finally:
            profiling.reset_counters()
    assert got["graphs"].pop("graph.replays") == 3
    assert got["graphs"] == got["plain"]
    assert got["plain"]["bucketed.real_slots"] > 0
    assert ("rerank.rows" in got["plain"]) == (kind == "rerank")


def test_a_recording_takes_its_own_thread_s_launches_alone():
    """Inside ``_kernels.recording`` a thread's launches go to its record;
    another thread's, made meanwhile, go to ``LAUNCHES``."""
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        for _ in range(3):
            _kernels.launched("adc_scan")
        done.set()

    _kernels.reset_launches()
    try:
        thread = threading.Thread(target=other)
        thread.start()
        with _kernels.recording() as record:
            _kernels.launched("adc_scan")
            inside.set()
            assert done.wait(10)
            _kernels.launched("probed_tables", 2)
        thread.join()
        assert record == {"adc_scan": 1, "probed_tables": 2}
        assert _kernels.LAUNCHES["adc_scan"] == 3
        assert _kernels.LAUNCHES["probed_tables"] == 0
        _kernels.launched("adc_scan")
        assert _kernels.LAUNCHES["adc_scan"] == 4
    finally:
        _kernels.reset_launches()


def test_launches_made_during_a_capture_count_once(cpu_graphs, monkeypatch):
    """Another thread's launches during a capture count once, as it makes
    them; each replay adds the launches its stages' capture made (one a
    stage here, as a kernel wrapper counts it)."""
    graphed, other = serving._graphed, []

    def launching(fn, args, device, pool):
        _kernels.launched("adc_scan")
        if not other:
            other.append(threading.Thread(target=lambda: [
                _kernels.launched("adc_scan") for _ in range(3)]))
            other[0].start()
            other[0].join()
        return graphed(fn, args, device, pool)

    monkeypatch.setattr(serving, "_graphed", launching)
    idx, _, rng = _cpu_index()
    q = rng.standard_normal((6, 16)).astype(np.float32)
    _kernels.reset_launches()
    try:
        for _ in range(5):                  # op by op, captured, 3 replays
            idx.query(q, 5, 4)
        assert _kernels.LAUNCHES["adc_scan"] == 3 + 4 * len(STAGES["knn"])
    finally:
        _kernels.reset_launches()


def _aten_ops(fn):
    fn()
    profiling.reset_counters()
    try:
        with profile() as prof:
            fn()
    finally:
        profiling.reset_counters()
    return sum(e.name.startswith("aten::") for e in prof.events())


@pytest.mark.parametrize("call, ops", [("query_rerank", 315), ("query", 260),
                                       ("query_batch", 225)])
def test_the_op_by_op_path_dispatches_the_ops_it_did(call, ops):
    """One batch op by op dispatches as many aten ops as before the graph
    route: a bucketed ``query_rerank`` and ``query``, and
    ``Database.query_batch`` on the masked layout."""
    arrays, x, rng = _arrays(0, 2000, 16, 16, 4, 16)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    if call == "query_batch":
        db = (DatabaseBuilder(x, device="cpu").with_partitions(16)
              .with_divisions(4).with_clusters(16).build())
        db._dev = DeviceIndex(*arrays, layout="masked", device="cpu")
        assert _aten_ops(lambda: db.query_batch(q, 5, 4)) == ops
        return
    idx = DeviceIndex(*arrays, layout="bucketed", device="cpu")
    xt = torch.as_tensor(x)
    fn = (lambda: idx.query(q, 5, 4)) if call == "query" else \
        (lambda: idx.query_rerank(q, xt, k=5, nprobe=4, rerank=20))
    assert _aten_ops(fn) == ops


# -- the card ------------------------------------------------------------------

#: Deep10M's shapes (B=200, nprobe 32, D=8, rerank 100) and GIST1M's (B=1000,
#: D=60, nprobe 10), on corpora cut to a test's size.
SHAPES = {"deep": dict(n=200_000, m=96, p=512, d=8, c=256, b=200,
                       nprobe=32, rerank=100),
          "gist": dict(n=50_000, m=960, p=128, d=60, c=256, b=1000,
                       nprobe=10, rerank=100)}


def _card_pair(shape, seed=11):
    """A graphed index and an op-by-op twin over the same arrays on the
    card, the corpus there, the batches' rng."""
    s = SHAPES[shape]
    arrays, x, rng = _arrays(seed, s["n"], s["m"], s["p"], s["d"], s["c"])
    idx = DeviceIndex(*arrays, layout="bucketed", device="cuda")
    plain = DeviceIndex(*arrays, layout="bucketed", device="cuda")
    plain._graphs = None
    return idx, plain, torch.as_tensor(x, device="cuda"), rng


def _card_ask(idx, kind, q, x, shape):
    s = SHAPES[shape]
    if kind == "knn":
        return idx.query(q, 10, s["nprobe"])
    return idx.query_rerank(q, x, k=10, nprobe=s["nprobe"],
                            rerank=s["rerank"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "rerank"])
@pytest.mark.parametrize("shape", ["deep", "gist"])
def test_replays_are_bit_equal_to_the_op_by_op_path(cuda, shape, kind):
    idx, plain, x, rng = _card_pair(shape)
    b, m = SHAPES[shape]["b"], SHAPES[shape]["m"]

    def batch(n=b):
        return rng.standard_normal((n, m)).astype(np.float32)

    for _ in range(5):                      # op by op, captured, 3 replays
        q = batch()
        _same_bits(_card_ask(idx, kind, q, x, shape),
                   _card_ask(plain, kind, q, x, shape))
    assert len(idx._graphs._graphs) == 1
    for _ in range(3):                      # a second key, captured
        q = batch(b // 2)
        _same_bits(_card_ask(idx, kind, q, x, shape),
                   _card_ask(plain, kind, q, x, shape))
    assert len(idx._graphs._graphs) == 2
    for _ in range(2):                      # the first key, still served
        q = batch()
        _same_bits(_card_ask(idx, kind, q, x, shape),
                   _card_ask(plain, kind, q, x, shape))


@pytest.mark.cuda
def test_a_row_mask_call_runs_op_by_op_on_the_card(cuda):
    idx, plain, x, rng = _card_pair("deep")
    q = rng.standard_normal((200, 96)).astype(np.float32)
    mask = rng.random(SHAPES["deep"]["n"]) < 0.7
    for _ in range(3):
        _same_bits(idx.query(q, 10, 32, row_mask=mask),
                   plain.query(q, 10, 32, row_mask=mask))
        _same_bits(
            idx.query_rerank(q, x, 10, 32, 100, row_mask=mask),
            plain.query_rerank(q, x, 10, 32, 100, row_mask=mask))
    assert not idx._graphs._graphs and not idx._graphs._seen


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "rerank"])
def test_replays_count_and_launch_as_the_op_by_op_path(cuda, kind):
    idx, plain, x, rng = _card_pair("deep")
    warm = rng.standard_normal((200, 96)).astype(np.float32)
    _card_ask(idx, kind, warm, x, "deep")
    _card_ask(idx, kind, warm, x, "deep")   # captured
    batches = [rng.standard_normal((200, 96)).astype(np.float32)
               for _ in range(3)]
    counted, launched = {}, {}
    for name, index in (("graphs", idx), ("plain", plain)):
        profiling.reset_counters()
        _kernels.reset_launches()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                for q in batches:
                    _card_ask(index, kind, q, x, "deep")
            counted[name] = profiling.counters()
            launched[name] = dict(_kernels.LAUNCHES)
        finally:
            profiling.reset_counters()
    assert counted["graphs"].pop("graph.replays") == 3
    assert counted["plain"].pop("graph.eager") == 3
    assert counted["graphs"] == counted["plain"]
    assert launched["graphs"] == launched["plain"]
    assert launched["plain"]["adc_scan"] == 3
    assert launched["plain"]["probed_tables"] == 3
    assert launched["plain"]["bucketed_topk"] == 3


@pytest.mark.cuda
def test_another_thread_s_launches_during_a_capture_count_once(cuda):
    """A second thread makes op-by-op calls (a ``row_mask``) on the index
    while a key is captured: every call's launches count once, and both
    threads' answers equal the op-by-op path's."""
    idx, plain, x, rng = _card_pair("deep")
    q = rng.standard_normal((200, 96)).astype(np.float32)
    mask = rng.random(SHAPES["deep"]["n"]) < 0.7
    want, want_masked = plain.query(q, 10, 32), plain.query(
        q, 10, 32, row_mask=mask)
    idx.query(q, 10, 32)                    # seen: the next call captures
    started, captured, calls, wrong = (threading.Event(), threading.Event(),
                                       [], [])

    def masked():
        while not captured.is_set():
            got = idx.query(q, 10, 32, row_mask=mask)
            calls.append(1)
            started.set()
            if any(not np.array_equal(g, w)
                   for g, w in zip(got, want_masked)):
                wrong.append(len(calls))

    _kernels.reset_launches()
    try:
        thread = threading.Thread(target=masked)
        thread.start()
        assert started.wait(60)
        before = len(calls)
        _same_bits(idx.query(q, 10, 32), want)     # captured, replayed
        captured.set()
        thread.join(60)
        assert not thread.is_alive() and not wrong
        assert len(calls) > before and idx._graphs.captures == 1
        for _ in range(3):
            _same_bits(idx.query(q, 10, 32), want)
        for name in ("adc_scan", "probed_tables", "bucketed_topk"):
            assert _kernels.LAUNCHES[name] == len(calls) + 4, name
    finally:
        _kernels.reset_launches()


@pytest.mark.cuda
def test_the_profiler_sees_each_replayed_kernel_in_its_span(cuda, tmp_path):
    """Each kernel of a replay is in the trace, paired by its correlation
    id with the graph launch made inside its stage's span."""
    idx, _, x, rng = _card_pair("deep")
    warm = rng.standard_normal((200, 96)).astype(np.float32)
    for _ in range(2):
        _card_ask(idx, "rerank", warm, x, "deep")
    _kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _card_ask(idx, "rerank", warm, x, "deep")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events.get("traceEvents", events)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("fdb."))
    launch = {}             # correlation → (the call, its innermost span)
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr:
            inside = [n for s, t, n in spans if s <= e["ts"] <= t]
            launch[corr] = (e["name"], inside[-1] if inside else None)
    assert sum("GraphLaunch" in c for c, _ in launch.values()) == 3 * 5
    kernels = [(e["name"], launch.get((e.get("args") or {})
                                      .get("correlation")))
               for e in events if e.get("cat") == "kernel"]
    replayed = {}
    for name, (call, span) in ((n, l or ("", None)) for n, l in kernels):
        if "GraphLaunch" in call:
            replayed.setdefault(span, []).append(name)
    scans = [n for n in replayed["fdb.scan"] if "adc_scan_kernel" in n]
    assert len(scans) == _kernels.LAUNCHES["adc_scan"] == 3
    assert sum("adc_scan_kernel" in n for n, _ in kernels) == 3
    assert any("probed_tables_kernel" in n for n in replayed["fdb.tables"])
    assert any("topk_cells_kernel" in n for n in replayed["fdb.topk"])
    assert replayed["fdb.probe"] and replayed["fdb.rerank"]
