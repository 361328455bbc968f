"""Host contention and the card's state, printed on an earlier line of
each run.

:func:`host_canary_ms` is a frozen copy of
``flechasdb_tpu/utils/quiet.py``'s ``host_canary_ms`` (never imported:
the benchmark loads nothing of the JAX package): the min-of-5 wall time
of a fixed 1500² f32 numpy matmul, which reads several times its quiet
value when the host's cores are shared with other work.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np


def host_canary_ms() -> float:
    """Min-of-5 wall time of a fixed host matmul, in ms."""
    a = np.random.default_rng(0).standard_normal((1500, 1500))
    a = a.astype(np.float32)
    best = float("inf")
    for _ in range(5):
        t0 = time.time()
        _ = a @ a
        best = min(best, time.time() - t0)
    return best * 1e3


def card_state() -> str:
    """``nvidia-smi``'s name, SM clock, power draw and power limit, or why
    it could not be read."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return (res.stdout.strip() or res.stderr.strip()).replace("\n", " | ")
