#!/usr/bin/env python3
"""Where the time of the PyTorch port's paths goes, on one NVIDIA GPU.

    python3 profile_slice.py [--config headline|sift] [--seed N] [--out F]

The data and configurations are ``chip_smoke.py``'s. ``headline``:
100,000 x 1536 unit rows made with numpy from the seed, P=100, D=12,
C=256, a batch of 64 queries, k=10, nprobe=5 (writes
``chiprun_out/profile_slice.json`` by default). ``sift``: 1,000,000 x 128
GMM rows and 1,000 queries (``flechasdb_tpu_torch.synth``), P=1024, D=8,
C=256, served from a bucketed ``DeviceIndex``, a batch of all 1,000
queries at k=10, nprobe=10, with and without rerank of the top 100, and
the same batch through ``Database.query_batch``, which takes the layout
policy's pick (writes ``chiprun_out/profile_sift.json``). After a warm-up
build, which also builds the kernels:

1. Build phases. One build whose event handler synchronizes the device
   and reads the host clock at every event, so each phase holds its own
   device work: ids, upload (up to the coarse seeding), coarse seeding,
   coarse Lloyd rounds, residues, subvector division, PQ seeding, PQ
   Lloyd rounds, and the copy-out after the last event.
2. Device time of one build (no synchronizing handler) under
   ``torch.profiler``: the kernels and copies by name, their total, and
   the busy share (device time / wall time).
3. The same for a warm query batch and for one query (and, for
   ``sift``, a batch with rerank and one through ``query_batch``).

Prints a summary and writes all of it to ``--out`` as JSON. The device
numbers read "not measured" where the profiler saw no device activity.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np

K_TOP = 10
TOP_KERNELS = 12
#: Per configuration: partitions, divisions, clusters, query batch,
#: nprobe, serving layout (None: the database's own, the layout policy's
#: pick) and rerank depth (profiled with the layout).
CONFIGS = {
    "headline": dict(p=100, d=12, c=256, batch=64, nprobe=5, layout=None,
                     rerank=None),
    "sift": dict(p=1024, d=8, c=256, batch=1000, nprobe=10,
                 layout="bucketed", rerank=100),
}


def make_data(config: str, seed: int):
    """``chip_smoke.py``'s corpus and queries."""
    rng = np.random.default_rng(seed)
    if config == "sift":
        from flechasdb_tpu_torch import synth
        return synth.gmm_pair(rng, 1_000_000, 1000, 128, n_clusters=256,
                              intrinsic=12)
    n, m, batch = 100_000, 1536, CONFIGS[config]["batch"]
    x = rng.standard_normal((n, m), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, batch + 8, replace=False)]
    return x, q + 0.02 * rng.standard_normal(q.shape, dtype=np.float32)


def builder(ft, x, cfg: dict, seed: int):
    return (ft.DatabaseBuilder(x, device="cuda").with_partitions(cfg["p"])
            .with_divisions(cfg["d"]).with_clusters(cfg["c"])
            .with_seed(seed))


def build_phases(torch, ft, x, cfg: dict, seed: int) -> dict:
    """Milliseconds a phase, from a synchronizing event handler."""
    from flechasdb_tpu_torch.events import ClusterEvent
    stamps = []                      # (stage, event name, seconds)
    stage = ["top"]

    def handler(e):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if isinstance(e, ClusterEvent):
            stamps.append((stage[0], type(e.event).__name__, t))
            return
        if type(e).__name__ == "StartingPartitioning":
            stage[0] = "coarse"
        elif type(e).__name__ == "StartingSubvectorDivision":
            stage[0] = "pq"
        stamps.append(("top", type(e).__name__, t))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    builder(ft, x, cfg, seed).build_with_events(handler)
    torch.cuda.synchronize()
    t_end = time.perf_counter()

    def at(stage_, name, last=False):
        hits = [t for s, n, t in stamps if s == stage_ and n == name]
        return hits[-1] if last else hits[0]

    marks = [
        ("before ids", t0, at("top", "StartingIdAssignment")),
        ("ids (UUIDs, host)", at("top", "StartingIdAssignment"),
         at("top", "FinishedIdAssignment")),
        ("upload of x", at("top", "StartingPartitioning"),
         at("coarse", "StartingCentroidInitialization")),
    ]
    for stage_, end in (("coarse", "FinishedPartitioning"),
                        ("pq", "FinishedQuantization")):
        last_update = at(stage_, "FinishedCentroidUpdate", last=True)
        marks += [
            (f"{stage_} seeding",
             at(stage_, "StartingCentroidInitialization"),
             at(stage_, "FinishedCentroidInitialization")),
            (f"{stage_} Lloyd rounds",
             at(stage_, "FinishedCentroidInitialization"), last_update),
            (f"{stage_} after the rounds", last_update,
             at("top", end, last=True)),
        ]
    marks += [("subvector division", at("top", "StartingSubvectorDivision"),
               at("top", "FinishedSubvectorDivision")),
              ("copy-out to host", stamps[-1][2], t_end)]
    rounds = {s: sum(1 for st, n, _ in stamps
                     if st == s and n == "FinishedCentroidUpdate")
              for s in ("coarse", "pq")}
    phases = {name: (b - a) * 1e3 for name, a, b in marks}
    phases["other"] = (t_end - t0) * 1e3 - sum(phases.values())
    return {"wall_ms": (t_end - t0) * 1e3, "lloyd_rounds": rounds,
            "phases_ms": phases}


def device_profile(torch, fn) -> dict:
    """Wall time of ``fn`` and its device activity under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}                     # kernels and copies, not the ops
    for e in prof.key_averages():    # that launched them
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (e.self_device_time_total / 1e3, e.count)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {
        "wall_ms_under_profiler": wall_ms,
        "device_ms": device_ms if by_name else "not measured",
        "busy_share": device_ms / wall_ms if by_name else "not measured",
        "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="headline")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cfg = CONFIGS[args.config]
    out = Path(args.out or ("chiprun_out/profile_slice.json"
                            if args.config == "headline"
                            else f"chiprun_out/profile_{args.config}.json"))

    import torch
    import flechasdb_tpu_torch as ft
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    x, q = make_data(args.config, args.seed)
    batch, one = q[:cfg["batch"]], q[-1]
    kw = dict(k=K_TOP, nprobe=cfg["nprobe"])

    def build():
        return builder(ft, x, cfg, args.seed).build()

    db = build()                       # warm-up; builds the kernels
    queries = {"query_batch_device": lambda: db.query_batch(batch, **kw),
               "query_one_device": lambda: db.query(one, **kw)}
    if cfg["layout"]:
        # Served from a DeviceIndex of this layout, as the JAX package's
        # sweep serves the SIFT shape; query_batch keeps the policy's pick.
        from flechasdb_tpu_torch.serving import DeviceIndex
        index = DeviceIndex(db.partition_centroids, db.codebooks,
                            db.codes.astype(np.int32), db.partition_indices,
                            layout=cfg["layout"], metric=db.metric,
                            device="cuda")
        orig = db._device_originals()
        queries = {
            "query_batch_device": lambda: index.query(batch, **kw),
            "query_one_device": lambda: index.query(one[None], **kw),
            "query_batch_rerank_device": lambda: index.query_rerank(
                batch, orig, rerank=cfg["rerank"], **kw),
            f"query_batch_{db._device_state().layout}_policy_device":
                lambda: db.query_batch(batch, **kw)}
    for fn in queries.values():        # warm-up
        fn()
    report = {"card": card, "torch": torch.__version__,
              "config": args.config,
              "build": build_phases(torch, ft, x, cfg, args.seed),
              "build_device": device_profile(torch, build)}
    for key, fn in queries.items():
        report[key] = device_profile(torch, fn)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    b = report["build"]
    print(f"build {b['wall_ms']:.1f} ms with a synchronize at every event; "
          f"Lloyd rounds {b['lloyd_rounds']}", flush=True)
    for name, ms in sorted(b["phases_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {ms:9.1f} ms", flush=True)
    for key in ["build_device", *queries]:
        r = report[key]
        print(f"{key}: wall {r['wall_ms_under_profiler']:.3f} ms, device "
              f"{r['device_ms']}, busy share {r['busy_share']}", flush=True)
        for t in r["top"][:6]:
            print(f"  {t['ms']:10.3f} ms x{t['count']:<5d} {t['name'][:70]}",
                  flush=True)
    print(f"written to {out}", flush=True)


if __name__ == "__main__":
    main()
