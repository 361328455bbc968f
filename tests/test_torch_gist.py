"""The GIST1M configuration (``portbench/configs/gist1m-ivf1024-pq60.json``)
through the port on the CPU, at its widths and a small scale: 4,096 rows of
960 dimensions from the configuration's mixture, D=60 divisions of 16,
C=256 codewords, P=8 partitions (the configuration's 1M rows and 1024
partitions are what the card runs).

* ``parallel.build_staged`` builds the index; ``DeviceIndex(layout=
  "bucketed")`` packs its codes four a word, 15 words a slot, and every
  slot unpacks to its row's codes.
* ``query_rerank`` answers as the benchmark's plain reference
  (``portbench/reference/ivfpq.search``, float64) does over the program's
  own arrays: the same rows, ties to the lower row, and the same exact
  distances within a relative 1e-5. The port sums 960 squared f32
  differences (a rounding of at most 2^-24 each, summed in blocks), so its
  error stays near 1e-6 of the distance; 1e-5 leaves that ten times and is
  still far below TF32's 2^-11.
* The build is judged as the GIST cells judge theirs (``reference/judge.
  build_numbers`` over every row): each number under the cells' limits.
"""

import json

import numpy as np
import pytest
import torch

from flechasdb_tpu_torch import serving
from flechasdb_tpu_torch.parallel import build_staged
from portbench import synth
from portbench.reference import ivfpq, judge
from portbench.spec import HERE, REPO

CFG = json.loads((REPO / "portbench/configs/gist1m-ivf1024-pq60.json")
                 .read_text())
N, NQ, P = 4096, 48, 8
M, D, C = CFG["dim"], CFG["divisions"], CFG["clusters"]
K, RERANK = CFG["k"], CFG["rerank"]


@pytest.fixture(scope="module")
def gist():
    """``(x [N, M], q [NQ, M], build)`` from the configuration's mixture."""
    data = CFG["data"]
    x, q = synth.gmm_pair(torch.Generator().manual_seed(22), N, NQ, M,
                          n_clusters=data["components"],
                          intrinsic=data["intrinsic"],
                          cluster_std=data["cluster_std"],
                          noise=data["noise"])
    b = build_staged(x, P, D, C, 2011, coarse_cap=CFG["coarse_train_cap"],
                     pq_cap=CFG["pq_train_cap"], device="cpu")
    return x, q, b


@pytest.fixture(scope="module")
def index(gist):
    _, _, b = gist
    return serving.DeviceIndex(
        *(t.numpy() for t in (b.partition_centroids, b.codebooks, b.codes,
                              b.partition_indices)),
        layout="bucketed", device="cpu")


def test_buckets_hold_15_packed_words_a_slot(gist, index):
    _, _, b = gist
    words, rows = index.buckets.codes, index.buckets.rows
    assert words.shape[:2] == (P, 15) and words.dtype == torch.int32
    live = rows >= 0
    assert int(live.sum()) == N
    codes = torch.stack([(words[:, d // 4] >> (8 * (d % 4))) & 0xFF
                         for d in range(D)], dim=1)        # [P, D, L]
    got = codes.permute(0, 2, 1)[live]                     # [N, D]
    want = b.codes.long()[rows[live].long()]
    assert torch.equal(got.long(), want)


@pytest.mark.parametrize("k, nprobe, rerank", [
    (K, 2, RERANK),          # the configuration's k and rerank
    (K, P, RERANK),          # every partition probed
    (1, 1, 10),
    (K, 2, K),               # rerank equal to k
])
def test_query_rerank_answers_as_the_reference(gist, index, k, nprobe,
                                               rerank):
    x, q, b = gist
    dists, rows = index.query_rerank(q.numpy(), x, k=k, nprobe=nprobe,
                                     rerank=rerank)
    keys, want = ivfpq.search(x, q, b.partition_centroids, b.codebooks,
                              b.codes, b.partition_indices, k=k,
                              nprobe=nprobe, rerank=rerank)
    np.testing.assert_array_equal(rows, want.numpy())
    np.testing.assert_allclose(dists, keys.numpy(), rtol=1e-5, atol=0)
    numbers = judge.serve_numbers(
        x, q, b.partition_centroids, b.codebooks, b.codes,
        b.partition_indices, torch.from_numpy(rows),
        torch.from_numpy(dists), k=k, nprobe=nprobe, rerank=rerank)
    assert numbers["miss_pct"] == 0.0
    assert numbers["dist_err"] < 1e-5


@pytest.fixture(scope="module")
def build_numbers(gist):
    x, _, b = gist
    return judge.build_numbers(x, b.partition_centroids,
                               b.partition_indices, b.codebooks, b.codes,
                               torch.arange(N), p=P, d=D, c=C)


@pytest.mark.parametrize("cell", ["gist1m.build", "gist1m.serve-rerank"])
@pytest.mark.parametrize("number", ["assign_gap", "code_gap", "lloyd_gain"])
def test_the_build_is_within_the_gist_cells_limits(build_numbers, cell,
                                                   number):
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert 0 <= build_numbers[number] < limits[number]["limit"]
