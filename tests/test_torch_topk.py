"""The bucketed top-k (``flechasdb_tpu_torch.ops.topk``): the kernel of
``csrc/bucketed_topk.cu`` against the stable sort it replaces on the card.

The contract is bit equality: the kernel's values, flat indices and rows
must equal the first ``kk`` of ``torch.sort(vdist.reshape(B, nprobe·L),
dim=1, stable=True)`` and the rows the index arithmetic gives from them
(:func:`topk.bucketed_topk_plain`, the route the CPU and a ``kk`` above
the limit take). The cases cover exact ties inside and across probes, a
row mask that leaves fewer than ``kk`` finite keys, empty buckets, ``k``
over ``nprobe·L``, ``kk`` at the limit and above it, negative keys with
−0 and +0, buckets longer than the kernel's 4096-slot tile, and the
Deep10M serving shape.

On the CPU the plain version is held to a numpy reference on the same
cases and the wrapper's checks and route are held; the kernel runs only
on the card, in the tests that carry the ``cuda`` marker. This file
imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch.ops import bucketed, topk
from flechasdb_tpu_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _case(seed, b, nprobe, l, k, fill=0.5, p=64, ties=False, mask=0.0,
          empty=0.0, signed=False, zeros=False):
    """``(vdist [G, L], lengths, bidx, brows, nprobe, kk)`` as numpy, the
    pad slots ``+inf`` as K-A writes them. ``fill``: the mean share of a
    bucket's slots that hold a row; ``ties``: keys on a coarse grid, so
    many are equal inside and across probes; ``mask``: the share of live
    slots a row mask sets to ``+inf``; ``empty``: the share of empty cells;
    ``signed``: dot-metric keys of both signs; ``zeros``: −0 and +0 keys
    in every cell."""
    rng = np.random.default_rng(seed)
    g = b * nprobe
    lens = rng.integers(0, min(l, int(2 * fill * l)) + 1, g)
    lens[rng.random(g) < empty] = 0
    if signed:
        v = rng.standard_normal((g, l)) * 50.0
    else:
        v = rng.random((g, l)) * 1e3
    if ties:
        v = np.round(v / 8.0) * 8.0
    v = v.astype(np.float32)
    if zeros:
        v[:, 0::7] = 0.0
        v[:, 3::7] = -0.0
    v[rng.random((g, l)) < mask] = np.inf
    v[np.arange(l)[None, :] >= lens[:, None]] = np.inf
    bidx = rng.integers(0, p, g).astype(np.int32)
    brows = rng.integers(0, 1 << 30, (p, l)).astype(np.int32)
    return v, lens.astype(np.int32), bidx, brows, nprobe, min(k, nprobe * l)


CASES = {
    "ties": (1, 6, 4, 512, 50, dict(ties=True)),
    "mask_leaves_few": (2, 5, 3, 300, 40, dict(fill=0.3, mask=0.97)),
    "empty_buckets": (3, 6, 5, 256, 30, dict(fill=0.2, empty=0.6)),
    "all_empty": (4, 3, 4, 128, 20, dict(empty=1.0)),
    "k_over_slots": (5, 4, 3, 16, 100, dict(fill=0.7)),
    "kk_at_limit": (6, 3, 4, 2048, topk.KERNEL_MAX_K, dict(ties=True)),
    "signed_and_zeros": (7, 4, 4, 700, 120, dict(signed=True, zeros=True)),
    "long_buckets": (8, 3, 3, 20_000, 64, dict(fill=0.6, ties=True)),
    "one_probe": (9, 5, 1, 5000, 1, dict()),
}
#: The Deep10M serving shape: B=200, nprobe=32, L=12,288, rerank 100,
#: about 23% of the slots live.
DEEP10M = (10, 200, 32, 12_288, 100, dict(fill=0.23))


def _reference(v, lens, bidx, brows, nprobe, kk):
    """numpy's stable argsort over each query's slots (−0 compares equal
    to +0) and the rows at the winners."""
    g, l = v.shape
    order = np.argsort(v.reshape(g // nprobe, nprobe * l), axis=1,
                       kind="stable")[:, :kk]
    dist = np.take_along_axis(v.reshape(g // nprobe, -1), order, axis=1)
    cell = np.arange(g // nprobe)[:, None] * nprobe + order // l
    return dist, order, brows[bidx[cell], order % l]


def _torch(case, device="cpu"):
    v, lens, bidx, brows, nprobe, kk = case
    return ([torch.from_numpy(a).to(device) for a in (v, lens, bidx, brows)],
            dict(nprobe=nprobe, kk=kk))


def _bits_equal(got, want):
    """Values bit for bit (−0 is not +0), indices and rows exactly."""
    got = [np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
           for t in got]
    want = [np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
            for t in want]
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_numpy_stable_order(name):
    seed, b, nprobe, l, k, kw = CASES[name]
    case = _case(seed, b, nprobe, l, k, **kw)
    args, kw2 = _torch(case)
    got = topk.bucketed_topk(*args, **kw2)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert got[2].dtype == torch.int32
    _bits_equal(got, _reference(*case))


def test_cpu_tensors_take_the_sort_and_count_no_launch():
    args, kw = _torch(_case(11, 4, 3, 256, 20))
    before = dict(_kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]):
        got = topk.bucketed_topk(*args, **kw)
    assert _kernels.LAUNCHES == before
    _bits_equal(got, topk.bucketed_topk_plain(*args, **kw))
    assert profiling.counters() == {"bucketed.topk_sort": 4}


@pytest.mark.parametrize("kk,slots,takes", [
    (0, 100, False), (1, 1, True), (100, 393_216, True),
    (topk.KERNEL_MAX_K, 4096, True), (topk.KERNEL_MAX_K + 1, 4096, False),
    (10, 1 << 32, True), (10, (1 << 32) + 1, False)])
def test_the_kernel_takes_kk_up_to_its_limit(kk, slots, takes):
    assert topk.kernel_takes(kk, slots) is takes


@pytest.mark.parametrize("bad,err", [
    ("vdist_dtype", TypeError), ("lengths_dtype", TypeError),
    ("bidx_dtype", TypeError), ("brows_dtype", TypeError),
    ("vdist_rank", ValueError), ("nprobe", ValueError), ("kk", ValueError),
    ("lengths_shape", ValueError), ("bidx_shape", ValueError),
    ("brows_shape", ValueError), ("noncontiguous", ValueError),
    ("device", ValueError)])
def test_wrapper_rejects_bad_arguments(bad, err):
    (v, lens, bidx, brows), kw = _torch(_case(12, 4, 3, 64, 10))
    if bad == "vdist_dtype":
        v = v.double()
    elif bad == "lengths_dtype":
        lens = lens.long()
    elif bad == "bidx_dtype":
        bidx = bidx.long()
    elif bad == "brows_dtype":
        brows = brows.long()
    elif bad == "vdist_rank":
        v = v.reshape(4, 3, 64)
    elif bad == "nprobe":
        kw["nprobe"] = 5
    elif bad == "kk":
        kw["kk"] = 3 * 64 + 1
    elif bad == "lengths_shape":
        lens = lens[:-1]
    elif bad == "bidx_shape":
        bidx = bidx[:-1]
    elif bad == "brows_shape":
        brows = brows[:, :-1]
    elif bad == "noncontiguous":
        v = v.t().contiguous().t()
    else:
        brows = torch.empty(brows.shape, dtype=torch.int32, device="meta")
    with pytest.raises(err):
        topk.bucketed_topk(v, lens, bidx, brows, **kw)


def _query_index(seed, n=3000, m=32, p=12, d=4, c=16):
    """A small IVF-PQ index with duplicated rows (exact ties inside and
    across buckets) and its queries, as numpy."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((p, m)).astype(np.float32)
    books = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    codes[n // 2:] = codes[:n - n // 2]
    pidx = rng.integers(0, p, n).astype(np.int32)
    q = rng.standard_normal((20, m)).astype(np.float32)
    return cents, books, codes, pidx, q


def test_query_counts_the_route_under_a_profiler():
    cents, books, codes, pidx, q = _query_index(13)
    bk = bucketed.bucketize(codes, pidx, 12)
    with profile(activities=[ProfilerActivity.CPU]):
        bucketed.query_bucketed(*map(torch.from_numpy, (q, cents, books)),
                                bk, k=10, nprobe=3)
    got = profiling.counters()
    assert got["bucketed.topk_sort"] == len(q)
    assert "bucketed.topk_kernel" not in got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES) + ["deep10m"])
def test_kernel_equals_the_stable_sort_bit_for_bit(cuda, name):
    seed, b, nprobe, l, k, kw = DEEP10M if name == "deep10m" else \
        CASES[name]
    case = _case(seed, b, nprobe, l, k, **kw)
    args, kw2 = _torch(case, cuda)
    before = _kernels.LAUNCHES["bucketed_topk"]
    got = topk.bucketed_topk(*args, **kw2)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["bucketed_topk"] == before + 1
    # The sort's route on the card, and on the host.
    _bits_equal(got, topk.bucketed_topk_plain(*args, **kw2))
    _bits_equal(got, topk.bucketed_topk_plain(*_torch(case)[0], **kw2))


@pytest.mark.cuda
def test_two_calls_give_the_same_bits(cuda):
    args, kw = _torch(_case(*DEEP10M[:5], **DEEP10M[5]), cuda)
    first = topk.bucketed_topk(*args, **kw)
    _bits_equal(topk.bucketed_topk(*args, **kw), first)


@pytest.mark.cuda
def test_kk_above_the_limit_takes_the_sort_on_card(cuda):
    case = _case(14, 3, 4, 2048, topk.KERNEL_MAX_K + 1, ties=True)
    args, kw = _torch(case, cuda)
    before = _kernels.LAUNCHES["bucketed_topk"]
    with profile(activities=[ProfilerActivity.CPU]):
        got = topk.bucketed_topk(*args, **kw)
    assert _kernels.LAUNCHES["bucketed_topk"] == before
    assert profiling.counters() == {"bucketed.topk_sort": 3}
    _bits_equal(got, _reference(*case))


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """An NCCL group of one rank in this process, as a mesh on the card."""
    import datetime

    import torch.distributed as dist
    from flechasdb_tpu_torch.parallel import corpus_mesh

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield corpus_mesh(device="cuda:0")
    finally:
        dist.destroy_process_group()


def _queries(cuda, masked, metric, sharded=None):
    """``query_bucketed`` (or, on ``sharded``, the sharded query) on the
    card over :func:`_query_index`, at k=40 over nprobe=5, with a row mask
    that leaves about one row in eight when ``masked``."""
    from flechasdb_tpu_torch.parallel.bucketed import (
        query_bucketed_sharded, shard_buckets)

    cents, books, codes, pidx, q = _query_index(15)
    bk = bucketed.bucketize(codes, pidx, 12, device=cuda)
    row_mask = None
    if masked:
        keep = np.random.default_rng(16).random(len(codes)) < 0.125
        row_mask = torch.from_numpy(keep).to(cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (q, cents, books)]
    kw = dict(k=40, nprobe=5, metric=metric)
    if sharded is None:
        return bucketed.query_bucketed(*args, bk, row_mask, **kw)
    return query_bucketed_sharded(*args, shard_buckets(sharded, bk),
                                  row_mask, mesh=sharded, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("masked", [False, True])
def test_query_bucketed_equals_the_sort_route(cuda, monkeypatch, metric,
                                              masked):
    before = _kernels.LAUNCHES["bucketed_topk"]
    got = _queries(cuda, masked, metric)
    assert _kernels.LAUNCHES["bucketed_topk"] == before + 1
    monkeypatch.setattr(topk, "KERNEL_MAX_K", 0)
    want = _queries(cuda, masked, metric)
    assert _kernels.LAUNCHES["bucketed_topk"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                      w.cpu().numpy().view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_world_of_one_equals_the_sort_route(nccl_world,
                                                    monkeypatch, masked):
    cuda = torch.device("cuda:0")
    before = _kernels.LAUNCHES["bucketed_topk"]
    got = _queries(cuda, masked, "l2", sharded=nccl_world)
    assert _kernels.LAUNCHES["bucketed_topk"] == before + 1
    unsharded = _queries(cuda, masked, "l2")
    monkeypatch.setattr(topk, "KERNEL_MAX_K", 0)
    want = _queries(cuda, masked, "l2", sharded=nccl_world)
    assert _kernels.LAUNCHES["bucketed_topk"] == before + 2
    for g, u, w in zip(got, unsharded, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        np.testing.assert_array_equal(g.cpu().numpy(), u.cpu().numpy())
