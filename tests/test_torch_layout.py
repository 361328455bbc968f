"""The layout policy of the PyTorch port: on a CUDA device the card's own
rule (``serving.card_layout``: buckets while their pad ratio is at most
``CARD_PAD_LIMIT`` and their bytes fit ``CARD_BUCKET_SHARE`` of the card's
memory), elsewhere the JAX package's (``host.choose_layout``).

The rule's cases run on the CPU as a pure function of partition sizes,
rows, code width and a memory figure. The card test holds a skewed
database, which the card serves from buckets, to a masked index over
the same arrays on the card and to the CPU path (masked there), with and
without a filter: equal up to distance ties, distances within rel 1e-4,
abs 1e-5 (``_torch_helpers``). It carries the ``cuda`` marker and skips
here.
"""

import uuid as _uuid

import numpy as np
import pytest

import flechasdb_tpu_torch as ft
from _torch_helpers import cuda, same_ranked  # noqa: F401
from flechasdb_tpu_torch import host, serving
from flechasdb_tpu_torch.serving import DeviceIndex

#: SIFT1M's shape: 1M rows, P=1024 partitions of 8 codes a row.
N, P, D = 1_000_000, 1024, 8
GIB = 1 << 30


def _counts(p: int, n: int, largest: int) -> np.ndarray:
    """Partition sizes: one of ``largest`` rows, the rest of ``n`` spread
    evenly over the other ``p - 1``."""
    counts = np.full(p, (n - largest) // (p - 1))
    counts[0] = largest
    return counts


def _pad(counts) -> float:
    return len(counts) * host.bucket_len(counts) / counts.sum()


def _bucket_bytes(counts, d: int, words: int) -> int:
    """The bytes the rule counts: codes and rows on the card, the host's
    unpacked codes."""
    return 4 * len(counts) * host.bucket_len(counts) * (words + 1 + d)


def _sift_like():
    """SIFT's skew: the largest partition 8,000 rows, so L = 8192 and the
    buckets pad 8.4× the corpus, past the JAX package's 4× and within
    the card's limit."""
    counts = _counts(P, N, 8000)
    assert host.PAD_LIMIT < _pad(counts) <= serving.CARD_PAD_LIMIT
    return serving.card_layout(counts, N, D, 80 * GIB), "bucketed"


def _past_the_limit():
    """A skew 1.5× past the card's limit."""
    largest = int(1.5 * serving.CARD_PAD_LIMIT * N / P)
    counts = _counts(P, N, largest)
    assert _pad(counts) > serving.CARD_PAD_LIMIT
    return serving.card_layout(counts, N, D, 80 * GIB), "masked"


def _memory(share: float, packed: bool):
    """SIFT's skew on a card whose memory puts the buckets at ``share`` of
    ``CARD_BUCKET_SHARE`` (packed: 2 words of codes a slot; unpacked:
    8)."""
    counts = _counts(P, N, 8000)
    nbytes = _bucket_bytes(counts, D, 2 if packed else D)
    memory = int(nbytes / (serving.CARD_BUCKET_SHARE * share))
    want = "bucketed" if share <= 1 else "masked"
    return serving.card_layout(counts, N, D, memory, packed), want


def _cpu_index(skewed: bool):
    """A CPU ``DeviceIndex`` with ``layout=None`` takes the JAX package's
    rule: masked for a skew (L = 896 over 16 partitions of 2,000 rows,
    7.2×) that the card's rule would serve from buckets."""
    rng = np.random.default_rng(27)
    n, m, p, d = 2000, 16, 16, 4
    pidx = rng.integers(0, p, n).astype(np.int32)
    if skewed:
        pidx[:700] = 0
    codes = rng.integers(0, 16, (n, d)).astype(np.int32)
    counts = np.bincount(pidx, minlength=p)
    card = serving.card_layout(counts, n, d, 80 * GIB)
    index = DeviceIndex(rng.standard_normal((p, m)).astype(np.float32),
                        rng.standard_normal((d, 16, m // d))
                        .astype(np.float32), codes, pidx, device="cpu")
    want = host.choose_layout(p, pidx, n)
    assert want == ("masked" if skewed else "bucketed")
    assert card == "bucketed"
    return index.layout, want


CASES = {
    "sift-like skew takes buckets": _sift_like,
    "skew past the card's limit takes masked": _past_the_limit,
    "buckets within the memory share take buckets":
        lambda: _memory(0.99, True),
    "buckets past the memory share take masked":
        lambda: _memory(1.01, True),
    "unpacked codes past the memory share take masked":
        lambda: _memory(1.01, False),
    "cpu index keeps the jax rule on a skew": lambda: _cpu_index(True),
    "cpu index keeps the jax rule on even partitions":
        lambda: _cpu_index(False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_layout_policy(case):
    got, want = CASES[case]()
    assert got == want


# --- on the card -------------------------------------------------------------

K, NPROBE = 10, 6


def _skewed_db(device: str):
    """A database of 6,000 rows over 48 partitions, 800 of them in
    partition 0: L = 1024, the buckets pad 8.2× the corpus (masked by
    the JAX package's rule, buckets by the card's); every row's
    ``tenant`` is its row modulo 3."""
    rng = np.random.default_rng(5)
    n, m, p, d, c = 6000, 32, 48, 8, 64
    pidx = rng.integers(0, p, n).astype(np.int32)
    pidx[:800] = 0
    assert host.PAD_LIMIT < _pad(np.bincount(pidx, minlength=p)) \
        <= serving.CARD_PAD_LIMIT
    db = ft.Database(
        vector_size=m, num_partitions=p, num_divisions=d, num_clusters=c,
        vector_ids=[_uuid.UUID(int=i + 1) for i in range(n)],
        partition_centroids=rng.standard_normal((p, m)).astype(np.float32),
        partition_indices=pidx,
        codebooks=rng.standard_normal((d, c, m // d)).astype(np.float32),
        codes=rng.integers(0, c, (n, d)).astype(np.uint32), device=device)
    for i in range(n):
        db.set_attribute_at(i, ("tenant", i % 3))
    return db


def _arrays(results, db):
    """``(dists, rows)`` ``[B, K]`` of ``QueryResult`` lists."""
    row = {vid: i for i, vid in enumerate(db.vector_ids)}
    dists = np.full((len(results), K), np.inf, np.float32)
    rows = np.full((len(results), K), -1, np.int64)
    for b, got in enumerate(results):
        dists[b, :len(got)] = [r.squared_distance for r in got]
        rows[b, :len(got)] = [row[r.vector_id] for r in got]
    return dists, rows


@pytest.mark.cuda
def test_skewed_database_serves_from_buckets_on_card(cuda):
    from torch.profiler import profile

    from flechasdb_tpu_torch.utils import profiling

    card, cpu = _skewed_db("cuda"), _skewed_db("cpu")
    index = card._device_state()
    assert index.layout == "bucketed"
    assert cpu._device_state().layout == "masked"
    masked = DeviceIndex(card.partition_centroids, card.codebooks,
                         card.codes.astype(np.int32), card.partition_indices,
                         layout="masked", device="cuda")
    q = np.random.default_rng(6).standard_normal((64, 32)) \
        .astype(np.float32)
    tenant = ft.Eq("tenant", 1)
    mask = np.arange(card.num_vectors) % 3 == 1
    for where, row_mask in ((None, None), (tenant, mask)):
        for _ in range(3):      # op by op, captured, replayed
            got = card.query_batch(q, K, NPROBE, where=where)
        want = cpu.query_batch(q, K, NPROBE, where=where)
        same_ranked(*_arrays(got, card), *_arrays(want, cpu))
        gd, gr, gp = index.query(q, K, NPROBE, row_mask=row_mask)
        wd, wr, wp = masked.query(q, K, NPROBE, row_mask=row_mask)
        np.testing.assert_array_equal(gp, wp)
        same_ranked(gd, gr, wd, wr)
    assert index._graphs.captures == 1
    profiling.reset_counters()
    try:
        with profile():
            masked.query(q, K, NPROBE)
            index.query(q, K, NPROBE, row_mask=mask)
        got = profiling.counters()
        assert got.get("serve.masked") == 1 and got.get("graph.eager") == 1
    finally:
        profiling.reset_counters()
