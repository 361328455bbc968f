"""A whole run with the timed path broken underneath must come out not
``correct``: the harness's look for a card skipped, everything else as a
run on the card, at a size the CPU holds, against each cell's own
limits. One sound run of each cell comes out ``correct``."""

import pytest
import torch

from portbench.core import run_cell

SERVE = ["deep10m.serve-rerank", "sift1m.serve-policy"]
BUILD = ["deep10m.build", "sift1m.build"]


def _run(bench, cell, seed=987654321012):
    return run_cell(cell, seed, 0.3, False, bench=bench, device="cpu",
                    require_chip=False)


@pytest.mark.parametrize("cell", SERVE + BUILD)
def test_a_sound_run_is_correct(small_bench, cell):
    res = _run(small_bench, cell)
    assert res["correct"], res["checks"]


def _altered(out, half: bool):
    """The first row of every answer moved to the next corpus row, or the
    first half of the batch's answers standing for the whole batch."""
    dist, rows = out[0], out[1]
    if half:
        h = (len(rows) + 1) // 2
        rows = torch.cat([rows[:h], rows[:len(rows) - h]])
        dist = torch.cat([dist[:h], dist[:len(dist) - h]])
    else:
        rows = rows.clone()
        rows[:, 0] = rows[:, 0] + 1
    return (dist, rows, *out[2:])


@pytest.mark.parametrize("half", [False, True], ids=["answer", "half"])
@pytest.mark.parametrize("cell", SERVE)
def test_a_broken_search_is_not_correct(small_bench, cell, half,
                                        monkeypatch):
    from flechasdb_tpu_torch import serving

    for name in ("_rerank_exact", "query_bucketed", "query_masked_scan"):
        orig = getattr(serving, name)
        monkeypatch.setattr(
            serving, name,
            lambda *a, _o=orig, **k: _altered(_o(*a, **k), half))
    res = _run(small_bench, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["answer", "half", "unchanged"])
@pytest.mark.parametrize("cell", SERVE + BUILD)
def test_a_broken_build_is_not_correct(small_bench, cell, fault,
                                       monkeypatch):
    """In a build cell the timed builds break; in a serving cell the
    build its index is made from."""
    from flechasdb_tpu_torch.ops import kmeans

    if fault == "unchanged":
        # A Lloyd step that returns its state (the centroids) unchanged.
        monkeypatch.setattr(kmeans, "_means_grad",
                            lambda sums, counts, old:
                            (old, torch.zeros(old.shape[0])))
    else:
        fit = kmeans.fit

        def broken(*a, **k):
            res = fit(*a, **k)
            idx = res.indices.clone()
            n = idx.shape[1]
            if fault == "half":
                idx[:, n // 2:] = 0
            else:
                idx[:, :n // 100 + 1] = (idx[:, :n // 100 + 1] + 1) % a[1]
            return res._replace(indices=idx)
        monkeypatch.setattr(kmeans, "fit", broken)
    res = _run(small_bench, cell)
    assert not res["correct"], res["checks"]
