"""One run of one cell: set-up, the measured (or traced) window, the
check against the plain reference, the metrics, and the result line.

The result is the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` in a traced run), and last ``checks``: each number the
check compared, with its limit. The same numbers are the last lines of
standard error.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from . import canary, peaks
from .common import Context, sync
from .spec import HERE, REPO, load_cell, load_driver, load_module
from .tracing import CALL, trace_path, traced
from .window import Window, closed_loop, percentile

#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "flechasdb_tpu")


@dataclass
class Record:
    """What the metric readers read."""
    cell: object
    window: Window
    setup_s: float
    trace: object = None
    work: dict = field(default_factory=dict)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _number(v: float):
    """``v``, or its name where it is not finite (strict JSON has no
    infinities)."""
    return v if math.isfinite(v) else str(v)


def _checks(numbers: dict, limits: dict) -> tuple[dict, bool]:
    out, ok = {}, bool(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = float(numbers.get(name, math.nan))
        limit = float(limits.get(name, {}).get("limit", math.nan))
        out[name] = {"value": _number(value), "limit": _number(limit)}
        ok = ok and value <= limit
    return out, ok


def _read(entries: list, rec: Record, root: Path) -> dict:
    metrics = {}
    for m in entries:
        value = load_module("metrics", m["name"], root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             bench: Path = REPO / "BENCHMARK.json", root: Path = HERE,
             device: str = "cuda", require_chip: bool = True,
             control: bool = False, t_process: Optional[float] = None,
             parts: Optional[dict] = None) -> Optional[dict]:
    """Runs ``workload`` once and prints its result line; returns the
    result, or ``None`` where the run may print none."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    cell = load_cell(workload, bench, root)
    if require_chip:
        if not torch.cuda.is_available():
            log("torch.cuda.is_available() is False: no result")
            return None
        if torch.cuda.device_count() < cell.chips:
            log(f"the cell needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} visible: no result")
            return None
    ctx = Context(cell=cell, seed=seed, device=device, trace=trace,
                  parts=dict(parts or {}))
    on_card = torch.device(device).type == "cuda"
    log(f"cell {workload} seed {seed} seconds {seconds} trace {int(trace)}"
        f"{' CONTROL' if control else ''}")
    log(f"host canary {canary.host_canary_ms():.1f} ms")
    if on_card:
        with ctx.part("cuda context"):
            torch.cuda.init()
            torch.zeros(1, device=device)
        log(f"card {canary.card_state()}; peaks {peaks.NAME}: HBM "
            f"{peaks.HBM_BYTES_PER_S:.3g} B/s, TF32 "
            f"{peaks.TF32_FLOPS:.4g} FLOP/s")
    with ctx.part("program import"):
        from flechasdb_tpu_torch import _kernels
    if on_card:
        with ctx.part("kernel load"):
            _kernels.load()
    driver = load_driver(cell, root).Driver(ctx)
    if control and hasattr(driver, "control_setup"):
        driver.control_setup()
    sync(device)
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ctx.parts.items()) + f"; "
        f"{driver.describe()}")

    call = driver.control_call if control else driver.call
    rec = Record(cell=cell, window=Window(0.0), setup_s=setup_s)
    if trace:
        from torch.profiler import record_function

        def window() -> Window:
            return closed_loop(driver.prepare, call, driver.keep,
                               cell.mix["trace_seconds"],
                               wrap=lambda i: record_function(CALL))
        rec.trace, rec.window = traced(
            window, _kernels.LAUNCHES, ["adc_scan", "lloyd_round",
                                        "lloyd_grouped", "cluster_sums"],
            trace_path(workload), log)
        rec.work = driver.work(rec.window)
    else:
        rec.window = closed_loop(driver.prepare, call, driver.keep, seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    win = rec.window
    log(f"window {win.seconds:.3f} s, {len(win.calls)} calls, "
        f"{win.items} items, {win.failed} failed")
    lat = [(c.end - c.start) * 1e3 for c in win.calls]
    if lat:
        q = [percentile(lat, p) for p in (0, 25, 50, 75, 100)]
        log("call ms: min {:.3f} p25 {:.3f} median {:.3f} p75 {:.3f} "
            "max {:.3f}; first {:.3f}, last {:.3f}".format(*q, lat[0],
                                                          lat[-1]))

    driver.free_program()
    t0 = time.perf_counter()
    numbers = driver.judge(win)
    log(f"check {time.perf_counter() - t0:.3f} s")
    metrics = _read(cell.per_layer if trace else cell.end_to_end, rec, root)
    checks, ok = _checks(numbers, cell.limits)
    correct = ok and win.failed == 0 and bool(win.calls)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        log(f"the run holds modules it may not load: {bad[:10]}; no result")
        return None
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return result
