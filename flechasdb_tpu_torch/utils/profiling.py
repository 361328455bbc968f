"""Profiling helpers (the JAX package's ``utils/profiling.py`` on
``torch.profiler``).

The reference's observability is event callbacks timed by callers
(SURVEY.md §5); on a GPU the device timeline matters too, so these
wrappers pair the event API with ``torch.profiler``: wrap a build or
query-serving region in :func:`trace` and open the Chrome trace it writes
under ``logdir`` (``chrome://tracing``, Perfetto or TensorBoard's
profiler plugin), or scope individual phases with :func:`annotate` so they
show up as named ranges on the timeline.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextmanager
def trace(logdir: str):
    """Captures a ``torch.profiler`` trace of the enclosed region (host
    activity, and the card's when CUDA is available) and writes it under
    ``logdir`` as a Chrome trace, as ``jax.profiler`` writes its dump
    there."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        str(logdir), f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextmanager
def annotate(name: str):
    """Names the enclosed region on the profiler timeline."""
    with record_function(name):
        yield
