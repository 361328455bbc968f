#!/usr/bin/env python3
"""Times the Lloyd rounds, K-B, K-C and their fast variants, on one NVIDIA
GPU at ``chip_smoke.py``'s phase-1 shapes, for this tree and, with
``--other``, another tree's, in turns on the same tensors.

    python3 profile_lloyd.py [--other DIR] [--seed N] [--out F]

A round is what ``ops.lloyd.lloyd_round`` / ``lloyd_round_grouped``
returns: the assignment, the cluster sums and the counts (in this tree,
the assignment kernel and the cluster-sum pass; in a tree from before the
pass, whatever that tree launches). ``--other DIR`` imports
``DIR/flechasdb_tpu_torch`` (say, a ``git archive`` of the parent commit
unpacked under the gitignored ``build/``) under another name; its kernels
build into its own ``build/``. At each shape the two trees run other,
this, this, other. Each run is checked against this tree's plain version
of its own assignment: the counts must equal ``bincount``'s and this
tree's sums must lie within ``chip_smoke.SUM_RTOL`` / ``SUM_ATOL`` of the
f64 sums (for the other tree that is recorded, as is whether a second
call returns the same bits: a tree that adds with float atomics may
not). Times are ``chip_smoke.cuda_ms``: CUDA-event
means over back-to-back warm calls, median of five. Beside each round,
its assignment kernel alone by device time (``chip_smoke.
kernel_device_ms``: ``torch.profiler`` over back-to-back rounds, the
launches of the kernel whose name holds ``assign_fast_kernel`` or
``assign_kernel`` (K-B, either tree), ``grouped_round_kernel`` (K-C,
and K-C fast before it had a kernel of its own) or
``grouped_fast_assign`` (this tree's K-C fast); this tree's fast kernels
also their staging, ``stage_kernel`` or ``grouped_fast_staging``, apart),
against its bound (x and the centroids read once, idx written; 2 B N K M
operations at the units' rate). In every turn the
cluster-sum pass is also timed alone on this tree's assignment, as the
rounds launch it (each tree's ``_launch_sums``: no host sync), by its
device time (``chip_smoke.pass_device_ms``: ``torch.profiler`` over
back-to-back calls, split over the pass's kernels: the dense route's
``tile_sums`` and ``combine_tiles``, or the sort route's six), with the
route this tree's ``sum_tiling`` picks. A line a run is printed and all are
written to ``--out`` (default ``chiprun_out/profile_lloyd.json``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import chip_smoke as cs
import profile_scan

# (label, B, N, K, M, grouped, fast, skew): phase 1's timed shapes, K-B
# fast at the skewed SIFT coarse shape, and K-C fast at phase 1's other
# shapes.
SHAPES = [
    ("K-B PQ", cs.D, cs.N, cs.C, cs.M // cs.D, False, False, False),
    ("K-B coarse", 1, cs.N, cs.P, cs.M, False, False, False),
    ("K-B K=1024", 1, 65_536, 1024, 128, False, False, False),
    ("K-B SIFT coarse", 1, cs.SIFT_N, cs.SIFT_P, cs.SIFT_M, False, False,
     False),
    ("K-B SIFT coarse skewed", 1, cs.SIFT_N, cs.SIFT_P, cs.SIFT_M, False,
     False, True),
    ("K-B fast PQ", cs.D, cs.N, cs.C, cs.M // cs.D, False, True, False),
    ("K-B fast coarse", 1, cs.N, cs.P, cs.M, False, True, False),
    ("K-B fast K=1024", 1, 65_536, 1024, 128, False, True, False),
    ("K-B fast SIFT coarse", 1, cs.SIFT_N, cs.SIFT_P, cs.SIFT_M, False,
     True, False),
    ("K-B fast SIFT coarse skewed", 1, cs.SIFT_N, cs.SIFT_P, cs.SIFT_M,
     False, True, True),
    ("K-C SIFT PQ", 8, cs.SIFT_N, cs.C, 16, True, False, False),
    ("K-C fast SIFT PQ", 8, cs.SIFT_N, cs.C, 16, True, True, False),
    ("K-C fast B=60", 60, cs.N, cs.C, 16, True, True, False),
    ("K-C fast m=8", 16, cs.N, cs.C, 8, True, True, False),
    ("K-C fast m=32", 4, cs.N, cs.C, 32, True, True, False),
    ("K-C fast m=64 K=300", 2, cs.N, 300, 64, True, True, False),
]


def inputs(torch, gen, b, n, k, m, skew):
    """``chip_smoke.parity_lloyd``'s data: unit rows across B·m, centroids
    drawn from the rows; ``skew`` puts 5/8 of the rows next to centroid
    0."""
    x = torch.randn((b, n, m), generator=gen, device="cuda")
    x /= x.norm(dim=(0, 2), keepdim=True)
    c = x[:, torch.randint(0, n, (k,), generator=gen, device="cuda")] \
        .contiguous()
    if skew:
        crowd = n // 2 + n // 8
        x[:, :crowd] = c[:, :1] + 1e-3 * torch.randn(
            (b, crowd, m), generator=gen, device="cuda")
    return x, c


def run(torch, lloyd, this, x, xg, c, grouped, fast, mine: bool) -> dict:
    def call():
        if grouped:
            return lloyd.lloyd_round_grouped(xg, c, fast_math=fast)
        return lloyd.lloyd_round(x, c, fast_math=fast)
    idx, sums, counts = call()
    again = call()
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip((idx, sums, counts), again))
    del again
    b, _, m = x.shape
    k = c.shape[1]
    xs = this._bf16(x) if fast else x
    flat = (idx.long() + k * torch.arange(b, device="cuda")[:, None]
            ).reshape(-1)
    want = torch.zeros((b * k, m), dtype=torch.float64, device="cuda") \
        .index_add_(0, flat, xs.reshape(-1, m).double()).reshape(b, k, m)
    cs.require(torch.equal(counts, torch.bincount(flat, minlength=b * k)
                           .reshape(b, k).float()), "counts differ")
    err = float((sums.double() - want).abs().max())
    within = bool(((sums.double() - want).abs()
                   <= cs.SUM_ATOL + cs.SUM_RTOL * want.abs()).all())
    cs.require(within or not mine, f"sums disagree with the f64 sums: {err}")
    cs.require(same or not mine, "two calls differ")
    del idx, sums, counts, want, flat
    # The assignment kernel: K-C's (either tree's K-C fast before this
    # one), this tree's K-C fast and its staging, K-B's, or this tree's
    # K-B fast and its staging. "assign_kernel" is no part of
    # "assign_fast_kernel".
    keys = (("grouped_round_kernel", "grouped_fast_assign",
             "grouped_fast_staging") if grouped else
            ("assign_kernel", "assign_fast_kernel", "stage_kernel"))
    stage = keys[2]
    by, calls = cs.profile_kernels(torch, call, keys)
    first = next(k for k in keys if calls[k] and k != stage)
    out = {"ms": cs.cuda_ms(torch, call, 5),
           "assign_ms": by[first] / calls[first] / 1e3,
           "reproducible": same, "max_abs_err_f64": err,
           "within_tolerance": within}
    if calls.get(stage):  # a fast kernel's staging, a launch
        out["stage_ms"] = by[stage] / calls[stage] / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a tree whose Lloyd rounds run beside "
                    "this one's")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="chiprun_out/profile_lloyd.json")
    args = ap.parse_args()

    import torch
    cs.setup(torch)
    from flechasdb_tpu_torch.ops import lloyd
    trees = [("this", lloyd)]
    if args.other:
        profile_scan.load_other(args.other)
        sys.modules["other_fdb"]._kernels.load()
        other = importlib.import_module("other_fdb.ops.lloyd")
        trees = [("other", other), ("this", lloyd), ("this", lloyd),
                 ("other", other)]
    gen = torch.Generator("cuda").manual_seed(args.seed)
    records = []
    for label, b, n, k, m, grouped, fast, skew in SHAPES:
        x, c = inputs(torch, gen, b, n, k, m, skew)
        xg = lloyd.regroup_divisions(x) if grouped else None
        rate, ops = ((cs.BF16_FLOPS, "operations (bf16 tensor cores)")
                     if fast else
                     (cs.TF32_FLOPS, "operations (TF32 tensor cores)"))
        x_bytes = (xg if grouped else x).numel() * 4
        bms, by = cs.lloyd_bound(x_bytes, b, n, k, m, rate, ops)
        abms, aby = cs.bound(x_bytes + 4 * (b * k * m + b * n),
                             2.0 * b * n * k * m, rate, ops)
        for turn, (tree, mod) in enumerate(trees):
            r = run(torch, mod, lloyd, x, xg, c, grouped, fast,
                    tree == "this")
            r.update(shape=label, b=b, n=n, k=k, m=m, tree=tree, turn=turn,
                     bound_ms=bms, bound_by=by, assign_bound_ms=abms,
                     assign_bound_by=aby)
            records.append(r)
            cs.log(f"{label} B={b} N={n} K={k} M={m} [{tree}]: "
                   f"{r['ms']:.3f} ms, bound {bms:.3f} ms ({by}); the "
                   f"assignment alone {r['assign_ms']:.4f} ms device"
                   + (f" (its staging {r['stage_ms']:.4f} more)"
                      if "stage_ms" in r else "")
                   + f", bound {abms:.4f} ms ({aby}); two "
                   f"calls {'bit-equal' if r['reproducible'] else 'DIFFER'};"
                   f" sums max_abs_err vs f64 {r['max_abs_err_f64']:.3g}"
                   f"{'' if r['within_tolerance'] else ' (over the tolerance)'}")
        idx = (lloyd.lloyd_round_grouped(xg, c, fast)[0] if grouped
               else lloyd.lloyd_round(x, c, fast)[0])
        g = lloyd.GROUP_WIDTH // m if grouped else 1
        tiling = lloyd.sum_tiling(b, n, k, m, g)
        sbound = cs.bound(x_bytes + 4 * (b * n + b * k * m + b * k),
                          float(b * n * m))
        for turn, (tree, mod) in enumerate(trees):
            r = cs.pass_device_ms(torch, cs.sum_pass(
                mod, xg if grouped else x, idx, k, m, g, fast))
            r.update(shape=label, tree=tree, turn=turn,
                     part="cluster_sums", bound_ms=sbound[0],
                     bound_by=sbound[1],
                     route=tiling.route if tree == "this" else "other")
            records.append(r)
            cs.log(f"{label} [{tree}] cluster-sum pass alone: "
                   f"{r['ms']:.4f} ms device ({r['route']} route"
                   + (f", S={tiling.cols} R={tiling.rows}"
                      if tree == "this" else "")
                   + f"), bound {sbound[0]:.4f} ms ({sbound[1]}); by kernel "
                   + ", ".join(f"{kn} {v:.4f}"
                               for kn, v in r["by_kernel"].items()))
        del x, xg, c, idx
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(json.dumps({"ok": True, "records": len(records),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
