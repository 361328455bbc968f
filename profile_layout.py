#!/usr/bin/env python3
"""The card's break-even between the two serving layouts, from which
``serving.CARD_PAD_LIMIT`` is set, on one NVIDIA GPU.

    python3 profile_layout.py [--config FILE] [--batch 256] [--wide 16 64 256]
                              [--repeats 10] [--out FILE]

Builds the index a configuration of the benchmark states
(``portbench/configs/sift1m-ivf1024-pq8.json`` by default: its corpus
drawn on the card from its ``data_seed``, ``DatabaseBuilder`` with its
partitions, divisions, clusters and build seed, as its serving cell
builds it), then serves the database's arrays from a masked and from a
bucketed ``DeviceIndex`` and times, with CUDA events around ``--repeats``
back-to-back calls of the index's device pipeline after a warm-up, for
each batch size of ``--wide``:

1. the masked scan (its work does not depend on nprobe): device time a
   query-row, over ``B·N`` query-rows;
2. the bucketed pipeline with every partition probed (nprobe = P, its
   worst case): device time a query-slot, over ``B·P·L`` query-slots;

and both at the configuration's nprobe and a batch of ``--batch``, the
serving cell's. Prints the bucket length ``L``, the pad ratio ``P·L/N``,
each time, the ratio (1) / (2) at each batch size and the break-even
``R``, the least of them: the pad ratio up to which buckets cost no more
than the masked scan at any nprobe. Writes all of it, with the card's
name and power limit, to ``--out`` (``chiprun_out/profile_layout.json``
by default). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def device_ms(torch, fn, repeats: int) -> float:
    """Device milliseconds a call of ``fn``: CUDA events around
    ``repeats`` calls after one warm-up call, the card synchronized."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(
        ROOT / "portbench/configs/sift1m-ivf1024-pq8.json"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--wide", type=int, nargs="+", default=[16, 64, 256])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=str(
        ROOT / "chiprun_out/profile_layout.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_layout.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import serving
    from flechasdb_tpu_torch.host import bucket_len
    from flechasdb_tpu_torch.ops.bucketed import packs
    from portbench.common import derive, make_data

    cfg = json.loads(Path(args.config).read_text())
    x, pool = make_data(cfg, "cuda")
    db = (ft.DatabaseBuilder(x.cpu().numpy(), device="cuda")
          .with_partitions(cfg["partitions"])
          .with_divisions(cfg["divisions"]).with_clusters(cfg["clusters"])
          .with_seed(derive(cfg["data_seed"], 0xB17D)).build())
    del x
    arrays = (db.partition_centroids, db.codebooks,
              db.codes.astype(np.int32), db.partition_indices)
    n, p, d = len(arrays[2]), cfg["partitions"], cfg["divisions"]
    counts = np.bincount(arrays[3], minlength=p)
    l = bucket_len(counts)
    memory = torch.cuda.get_device_properties(0).total_memory
    out = {"card": card(), "torch": torch.__version__,
           "config": cfg["name"], "n": n, "p": p, "d": d, "L": l,
           "largest_partition": int(counts.max()),
           "pad_ratio": p * l / n, "memory": memory,
           "policy": serving.card_layout(counts, n, d, memory,
                                         packs(arrays[2])),
           "card_pad_limit": serving.CARD_PAD_LIMIT}
    k, nprobe = cfg["k"], cfg["nprobe"]
    pool = pool[torch.randperm(len(pool), device=pool.device)]

    masked = serving.DeviceIndex(*arrays, layout="masked", device="cuda")
    bucketed = serving.DeviceIndex(*arrays, layout="bucketed",
                                   device="cuda")

    def ms(index, b: int, probes: int) -> float:
        qd = pool[:b].contiguous()
        t = device_ms(torch, lambda: index._query(qd, k, probes, None),
                      args.repeats)
        torch.cuda.empty_cache()
        return t

    out["batches"] = []
    for b in args.wide:
        m_ms, b_ms = ms(masked, b, nprobe), ms(bucketed, b, p)
        row_ns, slot_ps = m_ms * 1e6 / (b * n), b_ms * 1e9 / (b * p * l)
        out["batches"].append({
            "batch": b, "masked_ms": m_ms, "ns_per_row": row_ns,
            "bucketed_ms_all_probed": b_ms, "ps_per_slot": slot_ps,
            "ratio": row_ns * 1e3 / slot_ps})
    out["cell"] = {"batch": args.batch, "nprobe": nprobe,
                   "masked_chunk": masked._masked_batch_limit(),
                   "masked_ms": ms(masked, args.batch, nprobe),
                   "bucketed_ms": ms(bucketed, args.batch, nprobe)}
    out["break_even"] = min(r["ratio"] for r in out["batches"])

    print(json.dumps(out, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
