"""The exact cell, ``sift1m.flat-exact``, whole on the CPU: a sound run is
``correct``; a run with the flat scan broken underneath, and the TF32
control, are not. The configuration is cut as the other cells' are
(``conftest.SMALL``, ``CONTROL``), and its batch of 1000 to 64, since the
cut pool holds 600 queries."""

import pytest
import torch

from portbench import core
from portbench.core import run_cell

CELL = "sift1m.flat-exact"
BATCH = 64


@pytest.fixture
def small_batch(monkeypatch):
    load = core.load_cell

    def cut(*a, **k):
        cell = load(*a, **k)
        cell.mix = dict(cell.mix, batch=BATCH)
        return cell
    monkeypatch.setattr(core, "load_cell", cut)


def _run(bench, control=False, seed=987654321012):
    return run_cell(CELL, seed, 0.3, False, bench=bench, device="cpu",
                    require_chip=False, control=control)


def test_a_sound_run_is_correct(small_bench, small_batch):
    res = _run(small_bench)
    assert res["correct"], res["checks"]
    assert res["attempted"] % BATCH == 0


def _altered(out, half: bool):
    """The first row of every answer moved to the next corpus row, or the
    first half of the batch's answers standing for the whole batch."""
    dist, rows = out
    if half:
        h = (len(rows) + 1) // 2
        rows = torch.cat([rows[:h], rows[:len(rows) - h]])
        dist = torch.cat([dist[:h], dist[:len(dist) - h]])
    else:
        rows = rows.clone()
        rows[:, 0] = rows[:, 0] + 1
    return dist, rows


@pytest.mark.parametrize("half", [False, True], ids=["answer", "half"])
def test_a_broken_scan_is_not_correct(small_bench, small_batch, half,
                                      monkeypatch):
    from flechasdb_tpu_torch import flat

    orig = flat.exact_topk
    monkeypatch.setattr(flat, "exact_topk",
                        lambda *a, **k: _altered(orig(*a, **k), half))
    res = _run(small_bench)
    assert not res["correct"], res["checks"]


def test_the_tf32_control_is_not_correct(control_bench, small_batch):
    res = _run(control_bench, control=True, seed=246813579)
    assert not res["correct"], res["checks"]
