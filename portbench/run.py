"""Runs one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints the set-up's parts, the card and the check on standard error
and one JSON result line last on standard output. Exits non-zero, with no
result, where there is no card, where the program is absent, or where the
process loaded JAX or the JAX package.
"""

import os
import sys
import time

_T_START = time.perf_counter()


def _process_start() -> float:
    """The interpreter's start on the ``perf_counter`` clock, from
    ``/proc`` where it is readable, else this module's first line."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 600:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return _T_START


def main(argv=None) -> int:
    import argparse

    t_process = _process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    t0 = time.perf_counter()
    import torch  # noqa: F401
    parts = {"interpreter": t0 - t_process,
             "torch import": time.perf_counter() - t0}

    from portbench.core import run_cell
    result = run_cell(args.workload, args.seed % (1 << 63), args.seconds,
                      bool(args.trace), t_process=t_process, parts=parts)
    return 0 if result is not None else 1


if __name__ == "__main__":
    sys.exit(main())
