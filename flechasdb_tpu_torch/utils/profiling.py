"""Profiling helpers (the JAX package's ``utils/profiling.py`` on
``torch.profiler``): the program's spans and counters, and a trace of a
region.

The reference's observability is event callbacks timed by callers
(SURVEY.md §5); on a GPU the device timeline matters too, so these
wrappers pair the event API with ``torch.profiler``: wrap a build or
query-serving region in :func:`trace` and open the Chrome trace it writes
under ``logdir`` (``chrome://tracing``, Perfetto or TensorBoard's
profiler plugin).

The program marks its stages with :func:`annotate` (``fdb.*`` spans:
``fdb.query_batch``, ``fdb.index.query``, ``fdb.probe``, ``fdb.tables``,
``fdb.scan``, ``fdb.topk``, the flat tier's ``fdb.exact`` ...
``fdb.build``, ``fdb.kmeans.lloyd``) and counts work with :func:`count`
(``bucketed.slots``, ``bucketed.real_slots``, ``tables.cells``,
``tables.kernel``, ``tables.plain``, ``rerank.rows``; the exact scan's
``exact.queries`` and ``exact.pairs``; the graph route of
:class:`..serving.DeviceIndex`: ``graph.replays``, the batches answered
by replaying CUDA graphs, and ``graph.eager``, the bucketed batches on
a CUDA device that ran op by op; ``serve.masked``, the batches on a CUDA
device that the masked layout answered). Both
record only while a profiler collects: with none, a span or a count
costs one check of the profiler's flag. A graph's capture takes the
counts its stage makes with :func:`recording`, and its replays make
them again. A span is then a ``record_function``, a
``user_annotation`` on the same timeline as the card's kernels and the
runtime calls that launched them, so it keeps no clock of its own. A
count of a device tensor is summed on the device, so counting never
waits for the card; :func:`counters` reads the sums (one
synchronization).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()
#: Host counts and device accumulators (``(name, device)`` → 0-d int64)
#: since the last :func:`reset_counters`.
_HOST_COUNTS: dict = {}
_DEVICE_COUNTS: dict = {}
_LOCK = threading.Lock()
#: The list :func:`recording` collects this thread's counts into.
_RECORDING = threading.local()


@contextmanager
def trace(logdir: str):
    """Captures a ``torch.profiler`` trace of the enclosed region (host
    activity, and the card's when CUDA is available) and writes it under
    ``logdir`` as a Chrome trace, as ``jax.profiler`` writes its dump
    there. The program's spans and counters record inside it."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        str(logdir), f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """A context manager naming the enclosed region on the profiler's
    timeline while a profiler collects; otherwise a shared no-op."""
    return record_function(name) if _profiler_enabled() else _OFF


def annotated(name: str):
    """Decorates a function so that each call is an :func:`annotate`
    span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def count(name: str, n) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler collects: a
    host int, or an integer tensor whose sum is added on its device, with
    no synchronization. Inside :func:`recording` it is recorded instead."""
    recorded = getattr(_RECORDING, "counts", None)
    if recorded is not None:
        recorded.append((name, n))
        return
    if not _profiler_enabled():
        return
    with _LOCK:
        if isinstance(n, torch.Tensor):
            key = (name, n.device)
            acc = _DEVICE_COUNTS.get(key)
            if acc is None:
                acc = _DEVICE_COUNTS[key] = torch.zeros(
                    (), dtype=torch.int64, device=n.device)
            acc.add_(n.sum() if n.dim() else n)
        else:
            _HOST_COUNTS[name] = _HOST_COUNTS.get(name, 0) + int(n)


@contextmanager
def recording():
    """Collects the ``(name, n)`` of every :func:`count` this thread makes
    inside, into the list it yields, and counts none of them: what a CUDA
    graph's capture counted, for its replays to count again (a count of a
    device tensor sums it on the device, which no graph may hold)."""
    counts = []
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = None


def counters() -> dict:
    """Every counter's sum since the last :func:`reset_counters`, as ints
    (reading a device accumulator waits for the card)."""
    with _LOCK:
        out = dict(_HOST_COUNTS)
        device = list(_DEVICE_COUNTS.items())
    for (name, _), acc in device:
        out[name] = out.get(name, 0) + int(acc)
    return out


def reset_counters() -> None:
    with _LOCK:
        _HOST_COUNTS.clear()
        _DEVICE_COUNTS.clear()
