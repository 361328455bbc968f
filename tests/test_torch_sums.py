"""The cluster-sum pass that follows every Lloyd round of K-B and K-C
(``ops.lloyd.cluster_sums``, ``cluster_sums_grouped``;
``csrc/cluster_sums.cu``), and the reproducibility it gives the card's
builds.

On the CPU the wrappers take the plain version: sums and counts of an
assignment against numpy's (``np.add.at``, the JAX oracle's ``_update``
step, in f64; sums within rtol 1e-4, atol 1e-3, the JAX test's bound,
counts equal), the grouped wrapper equal to the ungrouped one, the
``fast_math`` sums of the bf16-rounded rows, and the checks.

The dense route's order model, ``cluster_sums_ordered`` (each tile's rows
in ascending order into their clusters, then the tiles in order), equals
a float32 serial loop in numpy in that order bit for bit, for the K-B
layout and K-C's grouped layout at m = 8, 16, 32 and 64, ``fast_math``, a
skewed cluster, N not a multiple of R and empty clusters, and lies within
the tolerance of the f64 sums. The tiling picker (``sum_tiling``) keeps
every shape within a block's 227 KB and the partials' budget, gives the
same answer whatever the process's CUDA state, and takes the sort route
above the dense route's K limit.

The ``cuda``-marked tests skip here. On the card, the dense route equals
``cluster_sums_ordered`` bit for bit over every copy path (full and fast,
both layouts), the sort route runs above the limit within the f64
tolerance, a Lloyd round (K-B, K-C, full and fast) makes no host sync
(``torch.cuda.set_sync_debug_mode("error")``), and each of K-B, K-B fast,
K-C and K-C fast, called twice on the same inputs, must return the same
``idx``, ``sums`` and ``counts`` bit for bit (many rows a cluster, a
cluster holding over half the rows, and K=4096 at m=16, on the sort route,
whose counters live in its scratch); the pass's sums
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


# --- the dense route's order and tiling --------------------------------------

def _numpy_ordered(x, idx, k, rows):
    """The dense route's order as a float32 serial loop: each tile's rows
    in ascending order into their clusters from 0, then the tiles in
    order from 0."""
    b, n, m = x.shape
    sums = np.zeros((b, k, m), np.float32)
    for bb in range(b):
        for t0 in range(0, n, rows):
            part = np.zeros((k, m), np.float32)
            for i in range(t0, min(n, t0 + rows)):
                part[idx[bb, i]] = part[idx[bb, i]] + x[bb, i]
            sums[bb] = sums[bb] + part
    return sums


def _ordered_case(case):
    """(x, idx, k, g, fast) for a named case; g = 128 // m for K-C's
    division-grouped layout (x ungrouped from the grouped rows)."""
    b, n, m, k, g, fast, skew, empty = {
        "kb": (3, 700, 24, 9, 1, False, False, False),
        "kb_fast": (2, 600, 40, 7, 1, True, False, False),
        "kb_skew": (2, 900, 16, 12, 1, False, True, False),
        "kb_ragged": (1, 1283, 8, 5, 1, False, False, False),
        "kb_empty": (2, 520, 12, 30, 1, False, False, True),
        "kc_m8": (16, 530, 8, 11, 16, False, False, False),
        "kc_m16": (10, 530, 16, 11, 8, False, False, False),
        "kc_m32": (4, 530, 32, 11, 4, True, False, False),
        "kc_m64": (3, 530, 64, 11, 2, False, True, True),
    }[case]
    x, idx = _assignment(b, n, m, k, n * m + k, skew)
    if empty:
        idx[idx % 3 == 1] = 0            # a third of the clusters empty
    if g > 1:
        xg = lloyd.regroup_divisions(torch.from_numpy(x))
        x = lloyd._ungroup(xg, b, m).numpy()
    return x, idx, k, g, fast


ORDERED_CASES = ["kb", "kb_fast", "kb_skew", "kb_ragged", "kb_empty",
                 "kc_m8", "kc_m16", "kc_m32", "kc_m64"]


@pytest.mark.parametrize("case", ORDERED_CASES)
def test_ordered_sums_equal_a_serial_f32_loop(case):
    x, idx, k, g, fast = _ordered_case(case)
    b, n, m = x.shape
    tiling = lloyd.sum_tiling(b, n, k, m, g)
    assert tiling.route == "dense" and n > tiling.rows
    sums, counts = lloyd.cluster_sums_ordered(
        torch.from_numpy(x), torch.from_numpy(idx), k, fast, tiling)
    xr = torch.from_numpy(x).to(torch.bfloat16).float().numpy() if fast \
        else x
    want = _numpy_ordered(xr, idx, k, tiling.rows)
    np.testing.assert_array_equal(sums.numpy(), want)
    assert sums.dtype == counts.dtype == torch.float32
    # Within the tolerance of the f64 sums; counts equal bincount's.
    want64, want_counts = _numpy_sums(xr, idx, k)
    np.testing.assert_allclose(sums.numpy(), want64, rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    if case.endswith("empty"):
        assert (counts.numpy() == 0).any()
        assert (sums.numpy()[counts.numpy() == 0] == 0).all()


def test_ordered_sums_model_the_dense_route_only():
    x, idx = _assignment(1, 50, 8, 8192, 1)
    tiling = lloyd.sum_tiling(1, 50, 8192, 8, 1)
    assert tiling.route == "sort"
    with pytest.raises(ValueError):
        lloyd.cluster_sums_ordered(torch.from_numpy(x),
                                   torch.from_numpy(idx), 8192, False,
                                   tiling)


# (B, N, K, m, g): the chip's shapes, the card tests' and the limits.
TILING_SHAPES = {
    "kb_pq": (12, 100_000, 256, 128, 1),
    "headline_coarse": (1, 100_000, 100, 1536, 1),
    "sift_coarse": (1, 1_000_000, 1024, 128, 1),
    "kc_sift_pq": (8, 1_000_000, 256, 16, 8),
    "k1024": (1, 65_536, 1024, 128, 1),
    "kc_m8": (16, 100_000, 256, 8, 16),
    "kc_m64_k300": (2, 100_000, 300, 64, 2),
    "kb_k5000": (3, 999, 5000, 100, 1),
    "cli_coarse": (1, 5000, 10, 1024, 1),
    "tiny": (1, 37, 3, 7, 1),
}


@pytest.mark.parametrize("shape", sorted(TILING_SHAPES))
def test_dense_tiling_fits_the_block_and_the_partials_budget(shape):
    b, n, k, m, g = TILING_SHAPES[shape]
    t = lloyd.sum_tiling(b, n, k, m, g)
    assert t.route == "dense"
    assert t.smem == lloyd._dense_smem(k, t.cols, g, t.stage_rows) \
        <= 232_448
    assert k * t.cols * 4 <= lloyd._ACC_MAX
    assert t.cols == (128 if g > 1 else min(m, t.cols)) and t.cols >= 1
    assert t.rows & (t.rows - 1) == 0 and t.rows % t.stage_rows == 0
    tiles = -(-n // t.rows)
    part = tiles * b * k * m * 4
    assert part <= max(b * n * m * 4 // 10, 16 << 20) or tiles == 1
    if t.rows > 256:                      # R is the smallest that fits
        assert -(-n // (t.rows // 2)) * b * k * m * 4 \
            > max(b * n * m * 4 // 10, 16 << 20)


def test_tiling_at_the_chip_shapes():
    want = {"kb_pq": (128, 4096), "headline_coarse": (128, 1024),
            "sift_coarse": (32, 16384), "kc_sift_pq": (128, 4096),
            "k1024": (32, 2048)}
    for shape, (s, r) in want.items():
        t = lloyd.sum_tiling(*TILING_SHAPES[shape])
        assert (t.cols, t.rows) == (s, r), shape


@pytest.mark.parametrize("b,n,k,m,g", [(1, 50_000, 8192, 8, 1),
                                       (1, 1000, 5121, 128, 1),
                                       (4, 50_000, 4096, 16, 8),
                                       (8, 1000, 321, 16, 8)])
def test_tiling_takes_the_sort_route_above_the_limit(b, n, k, m, g):
    assert lloyd.sum_tiling(b, n, k, m, g).route == "sort"
    below = lloyd.sum_tiling(b, n, 5120 if g == 1 else 320, m, g)
    assert below.route == "dense"


def test_tiling_reads_no_device_state(monkeypatch):
    before = {s: lloyd.sum_tiling(*v) for s, v in TILING_SHAPES.items()}

    def refuse(*args, **kwargs):
        raise AssertionError("the tiling asked the CUDA runtime")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_capability"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    after = {s: lloyd.sum_tiling(*v) for s, v in TILING_SHAPES.items()}
    assert after == before


@pytest.mark.parametrize("case", ["grouped_high", "plain_low"])
def test_public_sums_raise_on_idx_out_of_range(case):
    x, idx = _assignment(2, 30, 16, 4, 3)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    with pytest.raises(ValueError, match=r"idx must lie in \[0, "):
        if case == "grouped_high":
            lloyd.cluster_sums_grouped(lloyd.regroup_divisions(xt), it, 3,
                                       16)
        else:
            lloyd.cluster_sums(xt, it - 1, 4)


# --- the dense route on the card ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ORDERED_CASES + ["kb_k1024", "kb_wide",
                                                  "kb_unaligned",
                                                  "kb_odd_width",
                                                  "kc_unaligned"])
def test_dense_route_equals_the_order_model_bit_for_bit(cuda, case):
    """Every copy path: a whole-row stage (one bulk copy), a slice of the
    rows (a 2-D tensor copy; ``kb_wide``, ``kb_k1024``, at a ragged N) and
    x off 16 bytes (4-byte copies, both layouts)."""
    if case.startswith("kb_") and case not in ORDERED_CASES:
        b, n, m, k = {"kb_k1024": (1, 5000, 128, 1024),
                      "kb_wide": (2, 3001, 1536, 37),
                      "kb_unaligned": (3, 900, 64, 20),
                      "kb_odd_width": (2, 1100, 7, 6)}[case]
        x, idx = _assignment(b, n, m, k, b + n + m + k, skew=True)
        g, fast = 1, False
    else:
        x, idx, k, g, fast = _ordered_case(
            "kc_m16" if case == "kc_unaligned" else case)
    b, n, m = x.shape
    xt = torch.from_numpy(x).to(cuda)
    if case == "kb_unaligned":           # x 4 bytes off 16: 4-byte copies
        xt = torch.empty(xt.numel() + 1, device=cuda)[1:].view(b, n, m) \
            .copy_(xt)
        assert xt.data_ptr() % 16
    it = torch.from_numpy(idx).to(cuda)
    tiling = lloyd.sum_tiling(b, n, k, m, g)
    assert tiling.route == "dense"
    for full in (not fast, fast) if case == "kb" else (fast,):
        _kernels.reset_launches()
        if g > 1:
            xg = lloyd.regroup_divisions(xt)
            if case == "kc_unaligned":
                xg = torch.empty(xg.numel() + 1, device=cuda)[1:] \
                    .view(xg.shape).copy_(xg)
                assert xg.data_ptr() % 16
            got = _equal_twice(
                lambda: lloyd.cluster_sums_grouped(xg, it, k, m, full))
        else:
            got = _equal_twice(lambda: lloyd.cluster_sums(xt, it, k, full))
        assert _kernels.LAUNCHES["cluster_sums"] == 2
        want = lloyd.cluster_sums_ordered(xt, it, k, full, tiling)
        assert torch.equal(got[0], want[0]), case
        assert torch.equal(got[1], want[1]), case


@pytest.mark.cuda
def test_sort_route_above_the_limit_on_card(cuda):
    b, n, k, m = 1, 50_000, 8192, 8
    assert lloyd.sum_tiling(b, n, k, m, 1).route == "sort"
    gen = torch.Generator("cuda").manual_seed(8)
    x = torch.randn((b, n, m), generator=gen, device=cuda)
    idx = torch.randint(0, k, (b, n), generator=gen, device=cuda,
                        dtype=torch.int32)
    for fast in (False, True):
        sums, counts = _equal_twice(
            lambda: lloyd.cluster_sums(x, idx, k, fast))
        _held_to_f64(x, idx, sums, counts, k, fast)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_lloyd_round_makes_no_host_sync(cuda, fast, grouped):
    gen = torch.Generator("cuda").manual_seed(5)
    x = torch.randn((8, 20_000, 16), generator=gen, device=cuda)
    c = x[:, :256].contiguous()
    xg = lloyd.regroup_divisions(x)
    lloyd.lloyd_round(x, c, fast)             # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = (lloyd.lloyd_round_grouped(xg, c, fast) if grouped
               else lloyd.lloyd_round(x, c, fast))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out[0].shape == (8, 20_000) and out[1].shape == (8, 256, 16)
