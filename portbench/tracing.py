"""The traced window: ``torch.profiler`` over a stretch of calls, read
back from its Chrome trace.

* The card's busy time is the union of its kernels, copies and sets
  inside the window (the ``portbench.window`` span); the idle gaps
  between them are named by what the host was doing at their middle
  (the innermost operator, runtime call or span).
* Each kernel family the per-layer metrics read is cross-checked against
  the program's launch counter (``_kernels.LAUNCHES``) over the same
  window. The profiler has dropped kernel records on the H100 while the
  counter counted every launch (``chip_smoke.device_ms``), so a window
  whose records fall short is profiled again, up to three windows in all;
  after that the run fails rather than report a share from a window that
  lost launches.
"""

from __future__ import annotations

import bisect
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

#: Kernel names a family's launches carry (demangled, as the trace has
#: them) and, for the cluster-sum pass, the kernel that ends each pass.
FAMILIES = {
    "adc_scan": (r"\badc_scan_kernel\b", None),
    "lloyd_round": (r"\bassign_kernel\b", None),
    "lloyd_grouped": (r"\bgrouped_round_kernel\b", None),
    "cluster_sums": (r"\b(tile_sums|combine_tiles|tile_count|tile_scan|"
                     r"cluster_scan|chunk_sum)\b|\b(place|combine)\s*[<(]",
                     r"\bcombine_tiles\b|\bcombine\s*[<(]"),
}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"
CALL = "portbench.call"


@dataclass
class Trace:
    window: tuple
    kernels: list                 # (name, start_us, dur_us), by start
    device: list                  # (start_us, end_us) of all device work
    host: list                    # (start_us, dur_us, name), by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> list:
        """The union of device intervals inside the window, merged."""
        a0, a1 = self.window
        out = []
        for s, e in sorted(self.device):
            s, e = max(s, a0), min(e, a1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def family(self, name: str, *, ends: bool = False) -> list:
        """``(name, start_us, dur_us)`` of the window's kernels of a family
        (only the kernels that end a pass where ``ends``)."""
        pat = FAMILIES[name][1 if ends and FAMILIES[name][1] else 0]
        rx = re.compile(pat)
        a0, a1 = self.window
        return [k for k in self.kernels
                if rx.search(k[0]) and a0 <= k[1] <= a1]

    def launches(self, name: str) -> int:
        return len(self.family(name, ends=True))

    def device_ops(self, top: int = 10) -> list:
        """The kernels (and copies) that took the most device time, summed
        by name: ``[[name, seconds], ...]``."""
        by = {}
        for name, _, dur in self.kernels:
            short = _short(name)
            by[short] = by.get(short, 0.0) + dur / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time inside the window summed by what the host was
        doing: ``[[name, seconds], ...]``."""
        busy = self.busy()
        a0, a1 = self.window
        edges = [a0] + [x for s, e in busy for x in (s, e)] + [a1]
        starts = [h[0] for h in self.host]
        by = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            name = self._doing((s + e) / 2, starts)
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _doing(self, t: float, starts: list) -> str:
        """The innermost host event covering ``t``: on one thread events
        nest, so the covering event that started last."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 500), -1):
            s, d, name = self.host[j]
            if s + d >= t:
                return name
        return "host (no profiled op)"


def _short(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list (the last
    balanced parenthesized group), at most 120 characters."""
    name = re.sub(r"^void ", "", name.strip())
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:120]


def parse(path: Path) -> Trace:
    """The Chrome trace at ``path`` as a :class:`Trace` over its
    ``portbench.window`` span."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    window = None
    kernels, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name == WINDOW:
            window = (ts, ts + dur)
        elif cat in _DEVICE_CATS:
            device.append((ts, ts + dur))
            kernels.append((name if cat == "kernel" else f"[{cat}] {name}",
                            ts, dur))
        elif cat in _HOST_CATS:
            host.append((ts, dur, name))
    if window is None:
        raise RuntimeError(f"{path}: no {WINDOW} span in the trace")
    kernels.sort(key=lambda k: k[1])
    host.sort()
    return Trace(window, kernels, device, host)


def traced(fn: Callable[[], object], counter: Optional[dict],
           families: list, path: Path, log=None) -> tuple:
    """Runs ``fn`` (the calls of a traced window; it returns their record)
    under the profiler, up to three windows, until the trace holds as
    many launches of each family as ``counter`` (the program's launch
    counter) gained. Returns ``(trace, record)``; raises where every
    window lost launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    log = log or (lambda s: print(s, file=sys.stderr))
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    short = []
    for attempt in range(3):
        before = dict(counter or {})
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                record = fn()
        prof.export_chrome_trace(str(path))
        trace = parse(path)
        gained = {k: (counter or {}).get(k, 0) - before.get(k, 0)
                  for k in families}
        seen = {k: trace.launches(k) for k in families}
        short = [k for k in families if seen[k] != gained[k]]
        if not short:
            return trace, record
        log(f"trace window {attempt + 1}: kernel records {seen} against "
            f"launches counted {gained}; profiling again")
    raise RuntimeError(f"the profiler lost launches of {short} in three "
                       "windows: no share is reported from such a window")


def trace_path(workload: str) -> Path:
    """Where a traced run keeps its Chrome trace (one file a cell,
    overwritten): inside the checkout, under the ignored ``.portbench``."""
    return (Path(__file__).resolve().parent.parent / ".portbench"
            / f"trace-{workload}.json")
