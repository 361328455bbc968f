#!/usr/bin/env python3
"""Times K-A, the ADC bucket scan, on one NVIDIA GPU at its five shapes,
for this tree's kernel and, with ``--other``, another tree's, in turns on
the same tensors. ``chip_smoke.py`` times only its own tree's kernel; this
script holds a kernel against an earlier tree's, whose own
``chip_smoke.py`` may not time it the same way.

    python3 profile_scan.py [--other DIR] [--seed N] [--reps N] [--out F]

The shapes, built once with this tree's package:

* the headline slice's buckets and the tables of its 64 queries at
  nprobe 5 (100,000 x 1536, P=100, D=12, C=256; ``chip_smoke.py`` phase
  2's data and build);
* the SIFT path's buckets and the tables of its 1,000 queries at nprobe
  10 (1M x 128 GMM, P=1024, D=8, C=256, ``DeviceIndex(layout=
  "bucketed")``; phase 3's data and build);
* ``adc_lookup`` at G=640, D=8, C=256, L=1280, unpacked;
* two tables of 256 KB a cell (D=256, C=256 packed; D=64, C=1024
  unpacked) at G=320, L=1152, P=100.

``--other DIR`` imports ``DIR/flechasdb_tpu_torch`` (say, a ``git
archive`` of the parent commit) under another name; its kernels build
into its own ``build/``. At each shape the two kernels run other, this,
this, other. Each run is checked against this tree's plain version and
timed by ``chip_smoke.device_ms``: the device time of one launch from
``torch.profiler`` with the L2 flushed before each call and back to
back, and the host time per call. A tree whose K-A refuses a shape is
recorded as refused. One line per run is printed and all are written to
``--out`` (default ``chiprun_out/profile_scan.json``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs


def load_other(root: str):
    """``ops.scan`` of the package under ``root``, imported as
    ``other_fdb``."""
    pkg = Path(root).resolve() / "flechasdb_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_fdb", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_fdb"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_fdb.ops.scan")


def shapes(torch, seed: int):
    """``(name, adc_lookup or not, args, d)`` for each of the five
    shapes."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import synth
    from flechasdb_tpu_torch.serving import DeviceIndex

    out = []
    t0 = time.perf_counter()
    x, q = cs.headline_data(seed)
    db, _, _ = cs.build_db(torch, ft, x, cs.P, cs.D, cs.C, seed)
    args, d = cs.main_path_scan_args(torch, db._device_state(),
                                     q[:cs.N_BATCH], cs.NPROBE)
    out.append(("headline buckets", False, args, d))
    del db, x
    x, q = synth.gmm_pair(np.random.default_rng(seed), cs.SIFT_N,
                          cs.SIFT_NQ, cs.SIFT_M, n_clusters=256,
                          intrinsic=12)
    db, _, _ = cs.build_db(torch, ft, x, cs.SIFT_P, cs.SIFT_D, cs.C, seed)
    index = DeviceIndex(db.partition_centroids, db.codebooks,
                        db.codes.astype(np.int32), db.partition_indices,
                        layout="bucketed", metric=db.metric, device="cuda")
    args, d = cs.main_path_scan_args(torch, index, q, cs.SIFT_NPROBE)
    out.append(("SIFT buckets", False, args, d))
    del db, x, index
    gen = torch.Generator("cuda").manual_seed(seed)
    codes = torch.randint(0, 256, (640, 8, 1280), generator=gen,
                          device="cuda", dtype=torch.int32)
    ftab = torch.rand((640, 8 * 256), generator=gen, device="cuda")
    out.append(("adc_lookup G=640 D=8 L=1280", True, (codes, ftab), 8))
    out.append(("D=256 C=256 packed", False,
                cs.scan_inputs(torch, gen, 256, 256, True, l=1152), 256))
    out.append(("D=64 C=1024 unpacked", False,
                cs.scan_inputs(torch, gen, 64, 1024, False, l=1152), 64))
    cs.log(f"inputs built: {time.perf_counter() - t0:.3f} s")
    return out


def run(torch, scan, lookup: bool, args, d: int, want, reps: int) -> dict:
    if lookup:
        def call():
            return scan.adc_lookup(*args, d=d)
    else:
        def call():
            return scan.adc_lookup_indexed(*args, d=d)
    try:
        got = call()
    except ValueError as e:
        return {"refused": str(e)}
    torch.cuda.synchronize()
    err = cs.scan_error(torch, got, want)
    del got
    t = cs.device_ms(torch, call, reps, "adc_scan_kernel")
    t["max_abs_err"] = err
    return t


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a tree whose K-A runs beside this one")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out/profile_scan.json")
    args = ap.parse_args()

    import torch
    cs.setup(torch)
    from flechasdb_tpu_torch.ops import scan
    trees = [("this", scan)]
    if args.other:
        other = load_other(args.other)
        other_fdb = sys.modules["other_fdb"]
        other_fdb._kernels.load()
        trees = [("other", other), ("this", scan), ("this", scan),
                 ("other", other)]
    records = []
    inputs = shapes(torch, args.seed)
    for name, lookup, a, d in inputs:
        plain = scan.adc_lookup_plain if lookup else \
            scan.adc_lookup_indexed_plain
        want = plain(*a, d=d)
        bms, by = (cs.scan_bound(a[0], a[1], torch.arange(a[1].shape[0]),
                                 None, d) if lookup
                   else cs.scan_bound(*a, d))
        for turn, (tree, mod) in enumerate(trees):
            r = run(torch, mod, lookup, a, d, want, args.reps)
            r.update(shape=name, tree=tree, turn=turn, bound_ms=bms,
                     bound_by=by)
            records.append(r)
            if "refused" in r:
                cs.log(f"{name} [{tree}]: refused: {r['refused']}")
            else:
                cs.log(f"{name} [{tree}]: device {r['ms']:.5f} ms with a "
                       f"cold L2, {r['warm_ms']:.5f} ms back to back, host "
                       f"{r['host_ms'] * 1e3:.2f} us a call, bound "
                       f"{bms:.5f} ms ({by}), max_abs_err "
                       f"{r['max_abs_err']:.3g}")
        del want
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(json.dumps({"ok": True, "records": len(records),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
