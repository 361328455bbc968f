"""The comparison itself: the reference's own answers read 0, a changed
row or distance reads above the limits, a build whose Lloyd rounds never
moved reads a large ``lloyd_gain``."""

import json

import pytest
import torch

from portbench.reference import arith, ivfpq, judge
from portbench.spec import HERE
from portbench import synth


@pytest.fixture(scope="module")
def index():
    g = torch.Generator().manual_seed(5)
    x, q = synth.gmm_pair(g, 6000, 64, 32, n_clusters=64)
    cents, idx, books, codes = ivfpq.build(x, 16, 4, 64, 3, arith.F64)
    return x, q, cents, books, codes, idx


def _limits(cell):
    return {k: v["limit"] for k, v in json.loads(
        (HERE / "limits" / f"{cell}.json").read_text()).items()}


@pytest.mark.parametrize("rerank", [None, 20])
def test_serving_numbers(index, rerank):
    x, q, cents, books, codes, idx = index
    keys, rows = ivfpq.search(x, q, cents, books, codes, idx, k=5,
                              nprobe=4, rerank=rerank)
    kw = dict(k=5, nprobe=4, rerank=rerank)
    ok = judge.serve_numbers(x, q, cents, books, codes, idx, rows, keys,
                             **kw)
    assert ok["miss_pct"] == 0 and ok["dist_err"] < 1e-12
    lim = _limits("deep10m.serve-rerank" if rerank else
                  "sift1m.serve-policy")
    moved = rows.clone()
    moved[:, 0] = (moved[:, 0] + 1) % x.shape[0]
    bad = judge.serve_numbers(x, q, cents, books, codes, idx, moved, keys,
                              **kw)
    assert bad["dist_err"] > lim["dist_err"]
    assert bad["miss_pct"] > lim["miss_pct"]


def test_build_numbers(index):
    x, _, cents, books, codes, idx = index
    rows = torch.arange(x.shape[0])
    ok = judge.build_numbers(x, cents, idx, books, codes, rows, p=16, d=4,
                             c=64)
    assert ok["assign_gap"] == 0 and ok["code_gap"] == 0
    assert ok["lloyd_gain"] < 1e-3
    # Centroids left at rows of the corpus (seeds), everything assigned to
    # them as it should be: only the Lloyd reading sees it.
    seeds = x[torch.randperm(x.shape[0])[:16]].double()
    sidx = ivfpq._argmin(x[None].double(), seeds[None], arith.F64)[0]
    res = (x.double() - seeds[sidx]).reshape(-1, 4, 8).transpose(0, 1)
    scodes = ivfpq._argmin(res, books.double(), arith.F64).T
    bad = judge.build_numbers(x, seeds.float(), sidx, books, scodes, rows,
                              p=16, d=4, c=64)
    assert bad["assign_gap"] == 0
    assert bad["lloyd_gain"] > 0.1
    wrong = idx.clone()
    wrong[:50] = (wrong[:50] + 1) % 16
    assert judge.build_numbers(x, cents, wrong, books, codes, rows, p=16,
                               d=4, c=64)["assign_gap"] > 0.1


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0000001])
    r = arith.tf32_round(t)
    assert r[0] == 1.0
    assert r[1] == 1.0 + 2 ** -10                 # a tie goes away from 0
    assert r[2] == 1.0 + 2 ** -10
    assert r[3] == -3.0
