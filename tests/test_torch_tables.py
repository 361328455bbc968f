"""The probed partitions' L2 ADC tables (``ops.bucketed.probed_tables``):
the kernel of ``csrc/probed_tables.cu`` against the plain formula it
replaces on the card.

The kernel sums ``(r_s − cb[d, c, s])²`` in f32 where the plain version
(:func:`bucketed.l2_tables_plain`, the CPU's route) expands ``rr + cc −
2·rc`` and clamps; the two agree within ``RTOL`` (``test_torch_query``'s)
and an ``atol`` of ``RTOL`` times the largest table entry, the rule
``test_ranking_products_ignore_tf32_on_card`` uses: the expansion's
rounding scales with the largest entry, not with each one. Where the
inputs sit 3 away from the origin the expansion cancels digits; there the
kernel must be at least as close to a float64 reference as the formula.

The shapes: both serving cells' (GIST1M B=1000, nprobe=10, D=60, C=256,
16 dimensions a division; Deep10M B=200, nprobe=32, D=8, 12 a division),
ragged ones (1, 2, 3 and 12 dimensions a division, C=17, 300 and 1100,
D=1 with wide divisions that the kernel takes in tiles, zero cells),
repeated partitions in ``probed`` and an OPQ rotation; and the bucketed
serving path, which must launch the kernel once a batch for every cell.
On the CPU the route, its counters and the kernel's argument checks are
held, and the plain version against a float64 difference form; the kernel
runs only on the card, in the tests that carry the ``cuda`` marker. This
file imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flechasdb_tpu_torch import _kernels, serving
from flechasdb_tpu_torch.ops import bucketed
from flechasdb_tpu_torch.utils import profiling

RTOL = 1e-4

#: ``name: (B, nprobe, D, C, sub, P)``.
SHAPES = {
    "gist": (1000, 10, 60, 256, 16, 1024),
    "deep": (200, 32, 8, 256, 12, 4096),
    "sub1": (7, 3, 16, 256, 1, 20),
    "sub2": (7, 3, 8, 256, 2, 20),
    "sub3": (5, 4, 5, 64, 3, 20),
    "sub12": (9, 5, 4, 256, 12, 20),
    "c17": (6, 3, 6, 17, 4, 10),
    "c300": (6, 3, 4, 300, 8, 10),
    "c1100": (4, 2, 3, 1100, 4, 8),
    "d1": (5, 3, 1, 256, 96, 10),
    "d1_wide": (3, 2, 1, 256, 960, 6),
    "no_queries": (0, 3, 4, 256, 4, 10),
    "no_probes": (4, 0, 4, 256, 4, 10),
}
SMALL = [k for k in SHAPES if k not in ("gist", "deep")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    _kernels.reset_launches()
    yield
    profiling.reset_counters()


def _case(name, seed=0, offset=0.0, repeats=False, device="cpu"):
    """``(q, centroids, codebooks, probed)`` on ``device``; ``probed`` the
    first ``nprobe`` of a stable sort of random scores, a slice whose rows
    lie ``P`` apart as the main path's probe gives it (``repeats``: drawn
    from three partitions, so cells repeat). ``offset`` moves the queries
    and codewords away from the centroids."""
    b, nprobe, d, c, sub, p = SHAPES[name]
    rng = np.random.default_rng(seed)
    m = d * sub
    q = rng.standard_normal((b, m)).astype(np.float32) + offset
    cent = rng.standard_normal((p, m)).astype(np.float32)
    cb = rng.standard_normal((d, c, sub)).astype(np.float32) + offset
    if repeats:
        probed = torch.from_numpy(rng.integers(0, 3, (b, nprobe)))
    else:
        scores = torch.from_numpy(rng.random((b, p))).to(device)
        probed = torch.sort(scores, dim=1, stable=True).indices[:, :nprobe]
    return (torch.from_numpy(q).to(device), torch.from_numpy(cent).to(device),
            torch.from_numpy(cb).to(device), probed.to(device))


def _reference(q, cent, cb, probed):
    """The difference form in float64: ``[B, nprobe, D, C]``."""
    d, c, sub = cb.shape
    b, nprobe = probed.shape
    resid = (q.double()[:, None, :] - cent.double()[probed]) \
        .reshape(b, nprobe, d, 1, sub)
    return ((resid - cb.double()[None, None]) ** 2).sum(dim=-1)


def _close(got, want, scale=None):
    want = want.cpu().double().numpy()
    scale = np.abs(want).max(initial=0.0) if scale is None else scale
    np.testing.assert_allclose(got.cpu().double().numpy(), want, rtol=RTOL,
                               atol=RTOL * scale)


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("name", SMALL)
def test_plain_tables_equal_the_difference_form(name):
    args = _case(name)
    got = bucketed.l2_tables_plain(*args)
    assert got.shape == SHAPES[name][:2] + SHAPES[name][2:4]
    _close(got, _reference(*args))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_the_cpu_and_dot_take_the_formula_and_count_plain(metric):
    q, cent, cb, probed = _case("sub12")
    with profile(activities=[ProfilerActivity.CPU]):
        got = bucketed.probed_tables(q, cent, cb, probed, metric)
    counts = profiling.counters()
    assert counts["tables.plain"] == probed.numel()
    assert "tables.kernel" not in counts
    assert not any(_kernels.LAUNCHES.values())
    if metric == "l2":
        assert torch.equal(got, bucketed.l2_tables_plain(q, cent, cb,
                                                         probed))


def _refused():
    q, cent, cb, probed = _case("sub12")
    m = q.shape[1]
    rot = torch.eye(m)
    return {
        "q_f64": ((q.double(), cent, cb, probed, None), TypeError),
        "centroids_f16": ((q, cent.half(), cb, probed, None), TypeError),
        "codebooks_f64": ((q, cent, cb.double(), probed, None), TypeError),
        "rotation_f64": ((q, cent, cb, probed, rot.double()), TypeError),
        "probed_int32": ((q, cent, cb, probed.to(torch.int32), None),
                         TypeError),
        "q_strided": ((q.t().contiguous().t(), cent, cb, probed, None),
                      ValueError),
        "centroids_strided": ((q, cent.t().contiguous().t(), cb, probed,
                               None), ValueError),
        "codebooks_strided": ((q, cent, cb.transpose(1, 2).contiguous()
                               .transpose(1, 2), probed, None), ValueError),
        "probed_columns_apart": ((q, cent, cb, torch.cat(
            [probed, probed], dim=1)[:, ::2], None), ValueError),
        "q_width": ((q[:, :-1].contiguous(), cent, cb, probed, None),
                    ValueError),
        "divisions": ((q, cent, cb[:-1].contiguous(), probed, None),
                      ValueError),
        "probed_rows": ((q, cent, cb, probed[:-1], None), ValueError),
        "rotation_shape": ((q, cent, cb, probed, torch.eye(m + 1)),
                           ValueError),
        "q_rank": ((q[None], cent, cb, probed, None), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_the_kernel_refuses_what_it_does_not_take(case):
    args, err = _refused()[case]
    with pytest.raises(err):
        bucketed._check_tables(*args)


def test_the_kernel_takes_the_probes_slice_and_a_rotation():
    q, cent, cb, probed = _case("sub12")
    assert not probed.is_contiguous()
    bucketed._check_tables(q, cent, cb, probed, None)
    bucketed._check_tables(q, cent, cb, probed, torch.eye(q.shape[1]))


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_the_formula(cuda, name):
    q, cent, cb, probed = _case(name, seed=1, device=cuda)
    got = bucketed.l2_tables_kernel(q, cent, cb, probed)
    torch.cuda.synchronize()
    assert got.shape == SHAPES[name][:2] + SHAPES[name][2:4]
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got, bucketed.l2_tables_plain(q, cent, cb, probed))
    if name in SMALL:
        _close(got, _reference(q, cent, cb, probed))
    assert _kernels.LAUNCHES["probed_tables"] == (1 if got.numel() else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gist", "sub3", "c17"])
def test_kernel_matches_the_formula_on_repeated_partitions(cuda, name):
    q, cent, cb, probed = _case(name, seed=2, repeats=True, device=cuda)
    assert probed.unique().numel() <= 3
    got = bucketed.l2_tables_kernel(q, cent, cb, probed)
    _close(got, bucketed.l2_tables_plain(q, cent, cb, probed))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deep", "sub3", "c300"])
def test_kernel_matches_the_formula_under_a_rotation(cuda, name):
    q, cent, cb, probed = _case(name, seed=3, device=cuda)
    m = q.shape[1]
    rot = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(4).standard_normal((m, m))))[0] \
        .float().to(cuda).contiguous()
    got = bucketed.probed_tables(q, cent, cb, probed, rotation=rot)
    _close(got, bucketed.l2_tables_plain(q, cent, cb, probed, rot))
    assert _kernels.LAUNCHES["probed_tables"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deep", "sub12", "c300", "d1"])
def test_kernel_is_at_least_as_exact_where_the_expansion_cancels(cuda,
                                                                  name):
    q, cent, cb, probed = _case(name, seed=5, offset=3.0, device=cuda)
    got = bucketed.l2_tables_kernel(q, cent, cb, probed)
    plain = bucketed.l2_tables_plain(q, cent, cb, probed)
    _close(got, plain)
    want = _reference(q, cent, cb, probed)
    _close(got, want)
    err_kernel = (got.double() - want).abs().max()
    err_plain = (plain.double() - want).abs().max()
    assert err_kernel <= err_plain, (float(err_kernel), float(err_plain))


@pytest.mark.cuda
def test_kernel_route_counts_and_repeats_its_bits(cuda):
    q, cent, cb, probed = _case("deep", seed=6, device=cuda)
    with profile(activities=[ProfilerActivity.CPU]):
        first = bucketed.probed_tables(q, cent, cb, probed)
        again = bucketed.probed_tables(q, cent, cb, probed)
        bucketed.probed_tables(q, cent, cb, probed, "dot")
    counts = profiling.counters()
    assert counts["tables.kernel"] == 2 * probed.numel()
    assert counts["tables.plain"] == probed.numel()
    assert _kernels.LAUNCHES["probed_tables"] == 2
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q_f64", "probed_int32", "q_strided",
                                  "codebooks_strided"])
def test_kernel_route_raises_on_what_it_does_not_take(cuda, case):
    args, err = _refused()[case]
    q, cent, cb, probed = (t.to(cuda) for t in args[:4])  # strides kept
    with pytest.raises(err):
        bucketed.probed_tables(q, cent, cb, probed)
    assert _kernels.LAUNCHES["probed_tables"] == 0


@pytest.mark.cuda
def test_bucketed_serving_takes_the_kernel_once_a_batch(cuda):
    """``DeviceIndex(layout="bucketed").query_rerank`` on the card: every
    cell's tables go to the kernel, one launch a batch; with every probed
    row reranked, the answer is the CPU index's."""
    rng = np.random.default_rng(7)
    n, m, p, d, c, b, nprobe = 3000, 64, 16, 8, 32, 40, 4
    x = rng.standard_normal((n, m)).astype(np.float32)
    arrays = (rng.standard_normal((p, m)).astype(np.float32),
              rng.standard_normal((d, c, m // d)).astype(np.float32),
              rng.integers(0, c, (n, d)).astype(np.int32),
              rng.integers(0, p, n).astype(np.int32))
    q = rng.standard_normal((b, m)).astype(np.float32)
    kw = dict(k=10, nprobe=nprobe, rerank=n)
    on_card = serving.DeviceIndex(*arrays, layout="bucketed", device=cuda)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            got = on_card.query_rerank(q, torch.from_numpy(x).to(cuda), **kw)
    counts = profiling.counters()
    assert counts["tables.kernel"] == counts["tables.cells"] == 2 * b * nprobe
    assert "tables.plain" not in counts
    assert _kernels.LAUNCHES["probed_tables"] == 2
    want = serving.DeviceIndex(*arrays, layout="bucketed", device="cpu") \
        .query_rerank(q, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=RTOL)
