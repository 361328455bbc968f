"""The readings the limits of ``limits/<cell>.json`` are set from: the
program's numbers on many seeds and the control's on a few, in one
process (set-up is the dearer part).

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 ... --control-seeds 7 8 9

``--fault unchanged`` runs the program with its Lloyd update returning
the centroids it was given (the state left unchanged), the reading that
bounds ``lloyd_gain``, which a change of precision does not move.
``--fault tables-tf32`` (the rerank cell) serves with the reference's
ADC keys in TF32 and its rerank in float64: only the candidates the
rerank is given move.

The control is the plain reference put in the program's place, in set-up
(a serving cell's build) and in the window, computed in TF32
(``reference/arith.py``), the nearest precision below the f32 the
configurations state; its answers and its build must fail the check.
Each seed prints one JSON line (mode, seed, numbers, calls); the last
line sums them up: per number the program's largest reading (the lower
reading) and the control's smallest (the upper one). The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--sample-every", type=int,
                   help="sample one call in this many (a shorter window "
                   "then checks as many answers as a run does)")
    p.add_argument("--fault", choices=("unchanged", "tables-tf32"),
                   help="plant a fault in the program for --seeds: "
                   "'unchanged', a Lloyd update that returns its centroids "
                   "as they were; 'tables-tf32', the reference's search "
                   "with its ADC keys in TF32 and its rerank in float64 "
                   "(drivers with a control_tables_call)")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import torch

    from portbench.common import Context
    from portbench.core import forbidden_modules, log
    from portbench.spec import load_cell, load_driver
    from portbench.window import closed_loop

    if args.fault == "unchanged":
        from flechasdb_tpu_torch.ops import kmeans
        kmeans._means_grad = lambda sums, counts, old: (
            old, torch.zeros(old.shape[0], device=old.device))
    cell = load_cell(args.workload)
    if args.sample_every:
        cell.mix["sample_every"] = args.sample_every
    mod = load_driver(cell)
    lower, upper = {}, {}
    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds]
    for mode, seed in runs:
        t0 = time.perf_counter()
        ctx = Context(cell=cell, seed=seed, device="cuda")
        driver = mod.Driver(ctx)
        if mode == "control":
            if hasattr(driver, "control_setup"):
                driver.control_setup()
            call = driver.control_call
        elif args.fault == "tables-tf32":
            call = driver.control_tables_call
        else:
            call = driver.call
        win = closed_loop(driver.prepare, call, driver.keep, args.seconds)
        driver.free_program()
        numbers = driver.judge(win)
        if mode == "program" and args.fault:
            mode = f"fault {args.fault}"
        line = {"mode": mode, "seed": seed, "numbers": numbers,
                "calls": len(win.calls), "items": win.items,
                "failed": win.failed, "window_s": win.seconds,
                "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        for k, v in numbers.items():
            if mode == "program":
                lower[k] = max(lower.get(k, v), v)
            elif mode.startswith("fault"):
                upper[k] = min(upper.get(k, v), v)
            else:
                upper[k] = min(upper.get(k, v), v)
        del driver, win
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "limits": limits}), flush=True)
    if forbidden_modules():
        log(f"loaded {forbidden_modules()[:10]}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
