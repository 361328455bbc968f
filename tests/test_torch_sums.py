"""The cluster-sum pass that follows every Lloyd round of K-B and K-C
(``ops.lloyd.cluster_sums``, ``cluster_sums_grouped``;
``csrc/cluster_sums.cu``), and the reproducibility it gives the card's
builds.

On the CPU the wrappers take the plain version: sums and counts of an
assignment against numpy's (``np.add.at``, the JAX oracle's ``_update``
step, in f64; sums within rtol 1e-4, atol 1e-3, the JAX test's bound,
counts equal), the grouped wrapper equal to the ungrouped one, the
``fast_math`` sums of the bf16-rounded rows, and the checks.

The ``cuda``-marked tests skip here. On the card, each of K-B, K-B fast,
K-C and K-C fast, called twice on the same inputs, must return the same
``idx``, ``sums`` and ``counts`` bit for bit (many rows a cluster, a
cluster holding over half the rows, and K=4096 at m=16, where the pass's
counters live in its scratch instead of shared memory); the pass's sums
lie within the tolerance of the f64 sums and its counts equal them; and
two same-seed card builds at a SIFT-coarse-like shape (200,000 x 128,
P=1024, D=8, C=256), at full precision and with ``with_fast_math()``, are
equal array for array.
"""

import numpy as np
import pytest
import torch

from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch.ops import lloyd

SUM_RTOL, SUM_ATOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assignment(b, n, m, k, seed, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    idx = rng.integers(0, k, (b, n)).astype(np.int32)
    if skew:
        idx[:, : n // 2 + 1] = k - 1
    return x, idx


def _numpy_sums(x, idx, k):
    b, _, m = x.shape
    sums = np.zeros((b, k, m))
    for bb in range(b):
        np.add.at(sums[bb], idx[bb], x[bb].astype(np.float64))
    counts = np.stack([np.bincount(i, minlength=k) for i in idx])
    return sums, counts


@pytest.mark.parametrize("b,n,m,k,skew", [(1, 3000, 24, 7, False),
                                          (3, 517, 128, 40, True),
                                          (2, 100, 1536, 3, False),
                                          (4, 64, 8, 100, False)])
def test_plain_sums_match_numpy(b, n, m, k, skew):
    x, idx = _assignment(b, n, m, k, n + k, skew)
    sums, counts = lloyd.cluster_sums(torch.from_numpy(x),
                                      torch.from_numpy(idx), k)
    want, want_counts = _numpy_sums(x, idx, k)
    np.testing.assert_allclose(sums.numpy(), want, rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert counts.dtype == sums.dtype == torch.float32


def test_plain_fast_sums_add_the_bf16_rows():
    x, idx = _assignment(2, 700, 32, 9, 5)
    sums = lloyd.cluster_sums(torch.from_numpy(x), torch.from_numpy(idx), 9,
                              fast_math=True)[0].numpy()
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(sums, _numpy_sums(rounded, idx, 9)[0],
                               rtol=SUM_RTOL, atol=SUM_ATOL)
    assert not np.allclose(sums, _numpy_sums(x, idx, 9)[0], rtol=SUM_RTOL,
                           atol=SUM_ATOL)


@pytest.mark.parametrize("b,m", [(6, 16), (3, 32), (5, 8), (10, 16),
                                 (1, 64)])
def test_grouped_sums_equal_the_ungrouped(b, m):
    x, idx = _assignment(b, 301, m, 12, b * m)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    xg = lloyd.regroup_divisions(xt)
    for fast in (False, True):
        got = lloyd.cluster_sums_grouped(xg, it, 12, m, fast)
        want = lloyd.cluster_sums(xt, it, 12, fast)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_round_sums_are_the_pass_on_its_assignment():
    x, _ = _assignment(3, 400, 16, 1, 8)
    c = x[:, :10].copy()
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    idx, sums, counts = lloyd.lloyd_round(xt, ct)
    want = lloyd.cluster_sums(xt, idx, 10)
    assert torch.equal(sums, want[0]) and torch.equal(counts, want[1])
    g_idx, g_sums, g_counts = lloyd.lloyd_round_grouped(
        lloyd.regroup_divisions(xt), ct)
    assert torch.equal(g_idx, idx)
    assert torch.equal(g_sums, sums) and torch.equal(g_counts, counts)


def test_cpu_sums_launch_nothing():
    _kernels.reset_launches()
    x, idx = _assignment(2, 50, 16, 4, 1)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    lloyd.cluster_sums(xt, it, 4)
    lloyd.cluster_sums_grouped(lloyd.regroup_divisions(xt), it, 4, 16)
    assert not any(_kernels.LAUNCHES.values())


@pytest.mark.parametrize("case", ["x_rank", "x_dtype", "idx_dtype",
                                  "idx_shape", "k", "idx_high", "idx_low",
                                  "group_width", "groups", "m"])
def test_sums_check_their_arguments(case):
    x, idx = _assignment(2, 30, 16, 4, 2)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    xg = lloyd.regroup_divisions(xt)
    call = {
        "x_rank": lambda: lloyd.cluster_sums(xt[0], it, 4),
        "x_dtype": lambda: lloyd.cluster_sums(xt.double(), it, 4),
        "idx_dtype": lambda: lloyd.cluster_sums(xt, it.long(), 4),
        "idx_shape": lambda: lloyd.cluster_sums(xt, it[:, :5], 4),
        "k": lambda: lloyd.cluster_sums(xt, it, 0),
        "idx_high": lambda: lloyd.cluster_sums(xt, it, 3),
        "idx_low": lambda: lloyd.cluster_sums_grouped(xg, it - 1, 4, 16),
        "group_width": lambda: lloyd.cluster_sums_grouped(xt, it, 4, 16),
        "groups": lambda: lloyd.cluster_sums_grouped(
            torch.cat([xg, xg]), it, 4, 16),
        "m": lambda: lloyd.cluster_sums_grouped(xg, it, 4, 24),
    }[case]
    with pytest.raises(ValueError):
        call()


def _equal_twice(fn):
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    return first


def _held_to_f64(x, idx, sums, counts, k, fast):
    xr = lloyd._bf16(x) if fast else x
    b, _, m = x.shape
    flat = (idx.long() + k * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    want = torch.zeros((b * k, m), dtype=torch.float64, device=x.device) \
        .index_add_(0, flat, xr.double().reshape(-1, m)).reshape(b, k, m)
    assert torch.equal(counts, torch.bincount(flat, minlength=b * k)
                       .reshape(b, k).float())
    assert bool(((sums.double() - want).abs()
                 <= SUM_ATOL + SUM_RTOL * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("grouped,b,n,k,m,skew", [
    (False, 1, 300_000, 1024, 128, False),
    (False, 1, 300_000, 1024, 128, True),
    (False, 8, 200_000, 256, 16, False),
    (True, 8, 200_000, 256, 16, False),
    (True, 8, 200_000, 256, 16, True),
    (True, 4, 50_000, 4096, 16, False)])
def test_rounds_on_card_are_bit_reproducible(cuda, fast, grouped, b, n, k,
                                             m, skew):
    gen = torch.Generator("cuda").manual_seed(n + k)
    x = torch.randn((b, n, m), generator=gen, device=cuda)
    c = x[:, torch.randint(0, n, (k,), generator=gen, device=cuda)] \
        .contiguous()
    if skew:
        x[:, : n // 2 + 1] = c[:, :1] + 1e-3 * torch.randn(
            (b, n // 2 + 1, m), generator=gen, device=cuda)
    if grouped:
        xg = lloyd.regroup_divisions(x)
        name = "lloyd_grouped"

        def fn():
            return lloyd.lloyd_round_grouped(xg, c, fast)
    else:
        name = "lloyd_round"

        def fn():
            return lloyd.lloyd_round(x, c, fast)
    name += "_fast" if fast else ""
    _kernels.reset_launches()
    idx, sums, counts = _equal_twice(fn)
    assert _kernels.LAUNCHES[name] == _kernels.LAUNCHES["cluster_sums"] == 2
    if skew:
        assert int(counts.max()) > n // 2
    _held_to_f64(x, idx, sums, counts, k, fast)


@pytest.mark.cuda
def test_sums_pass_on_card_agrees_with_plain(cuda):
    gen = torch.Generator("cuda").manual_seed(3)
    for b, n, m, k in [(2, 70_001, 1536, 37), (3, 999, 100, 5000),
                       (1, 37, 7, 3)]:
        x = torch.randn((b, n, m), generator=gen, device=cuda)
        idx = torch.randint(0, k, (b, n), generator=gen, device=cuda,
                            dtype=torch.int32)
        sums, counts = _equal_twice(lambda: lloyd.cluster_sums(x, idx, k))
        _held_to_f64(x, idx, sums, counts, k, False)


def _card_build(x, seed, fast):
    import flechasdb_tpu_torch as ft
    builder = (ft.DatabaseBuilder(x, device="cuda").with_partitions(1024)
               .with_divisions(8).with_clusters(256).with_seed(seed))
    return (builder.with_fast_math() if fast else builder).build()


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_same_seed_card_builds_are_equal(cuda, fast):
    from flechasdb_tpu_torch import synth
    x, _ = synth.gmm_pair(np.random.default_rng(42), 200_000, 1, 128,
                          n_clusters=256, intrinsic=12)
    _kernels.reset_launches()
    one = _card_build(x, 7, fast)
    assert _kernels.LAUNCHES["cluster_sums"] > 0
    two = _card_build(x, 7, fast)
    assert one.vector_ids == two.vector_ids
    for name in ("partition_centroids", "partition_indices", "codebooks",
                 "codes", "residues"):
        np.testing.assert_array_equal(getattr(one, name), getattr(two, name),
                                      err_msg=name)
