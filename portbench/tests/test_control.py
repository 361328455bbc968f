"""The control, the plain reference put in the program's place in the
window and computed in TF32, must come out not ``correct``: on the card
at each cell's own size (``control.py``, readings in PERF.md), and here
at a size the CPU holds, against each cell's own limits."""

import pytest

from portbench.core import run_cell


@pytest.mark.parametrize("cell", ["deep10m.serve-rerank",
                                  "sift1m.serve-policy", "deep10m.build",
                                  "sift1m.build"])
def test_the_tf32_control_is_not_correct(small_bench, control_bench,
                                         cell):
    bench = control_bench if cell.endswith(".build") else small_bench
    res = run_cell(cell, 246813579, 0.3, False, bench=bench, device="cpu",
                   require_chip=False, control=True)
    assert not res["correct"], res["checks"]
