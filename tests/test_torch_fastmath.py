"""Fast-math training of the PyTorch port (the ``fast_math`` variants of
K-B and K-C in ``flechasdb_tpu_torch.ops.lloyd``, the ``_fast`` impl
suffix of ``ops.kmeans`` and ``DatabaseBuilder.with_fast_math``) against
the JAX package.

The same numpy inputs go through the port's plain fast versions and
through the JAX package's ``pallas_kmeans.lloyd_round`` /
``lloyd_round_grouped`` with ``fast_math=True`` in interpret mode, as
``tests/test_kmeans.py`` runs them on the CPU. Both round x and the
centroids to bf16 (to nearest even), multiply exactly and sum in f32 in
another order, and keep ``‖c‖²`` in f32. Tolerances:

* indices equal, except at rows whose two candidates' distances, from the
  bf16-rounded operands in float64, lie within 1e-5 of the row's distance
  scale;
* sums within rtol 1e-4, atol 1e-3 of a float64 one-hot sum of the
  bf16-rounded x (a sum of the f32 x misses that bound, which the tests
  check too); counts exact;
* whole fits (different random draws in the two packages) within 5% of
  the JAX fast fit's inertia, the JAX package's own bound
  (``tests/test_kmeans.py:453``).

The CUDA kernels run only on the card: those tests carry the ``cuda``
marker and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu import DatabaseBuilder as JaxBuilder
from flechasdb_tpu.ops import kmeans as jkmeans
from flechasdb_tpu.ops.pallas_kmeans import lloyd_round as jax_lloyd
from flechasdb_tpu.ops.pallas_kmeans import \
    lloyd_round_grouped as jax_grouped
from flechasdb_tpu.ops.pallas_kmeans import \
    regroup_divisions as jax_regroup
import flechasdb_tpu_torch as ft
from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch.ops import kmeans, lloyd

TIE_REL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(a):
    """``a`` rounded to bf16 (to nearest even), back in f32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) \
        .float().numpy()


def _near_tie_rows(x, c, a, b):
    """Rows where picks ``a`` and ``b`` are within TIE_REL of a tie, by
    the fast distance ``‖c‖² − 2·bf16(x)·bf16(c)`` in float64."""
    xr, cr = _bf16(x).astype(np.float64), _bf16(c).astype(np.float64)
    cc = (c.astype(np.float64) ** 2).sum(-1)
    bb = np.arange(x.shape[0])[:, None]

    def dist(pick):
        return cc[bb, pick] - 2 * np.einsum("bnm,bnm->bn", xr, cr[bb, pick])

    scale = (xr * xr).sum(-1) + cc.max(-1, keepdims=True)
    return np.abs(dist(a) - dist(b)) <= TIE_REL * scale


def _onehot_sums(x, idx, k):
    out = np.zeros((x.shape[0], k, x.shape[2]))
    for bb in range(x.shape[0]):
        oh = (np.arange(k)[:, None] == idx[bb][None, :]).astype(np.float64)
        out[bb] = oh @ x[bb].astype(np.float64)
    return out


def _check_fast_round(x, c, idx, sums, counts, ref_idx):
    """Picks up to near-ties against ``ref_idx``; sums of the rounded x,
    which a sum of the f32 x misses; counts exact."""
    assert not ((idx != ref_idx) & ~_near_tie_rows(x, c, idx, ref_idx)).any()
    k = c.shape[1]
    np.testing.assert_allclose(sums, _onehot_sums(_bf16(x), idx, k),
                               rtol=SUM_RTOL, atol=SUM_ATOL)
    assert not np.allclose(sums, _onehot_sums(x, idx, k), rtol=SUM_RTOL,
                           atol=SUM_ATOL)
    for bb in range(x.shape[0]):
        np.testing.assert_array_equal(counts[bb],
                                      np.bincount(idx[bb], minlength=k))


ROUND_SHAPES = [(1, 1000, 24, 16, 256), (3, 517, 12, 7, 128),
                (1, 300, 8, 1280, 128), (2, 1200, 100, 40, 512)]


@pytest.mark.parametrize("b,n,m,k,tile", ROUND_SHAPES)
def test_plain_fast_round_matches_jax_kernel(b, n, m, k, tile):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    idx, sums, counts = (a.numpy() for a in lloyd.lloyd_round(
        torch.from_numpy(x), torch.from_numpy(c), fast_math=True))
    ref_idx, ref_sums, ref_counts = (np.asarray(a) for a in jax_lloyd(
        jnp.asarray(x), jnp.asarray(c), tile=tile, fast_math=True,
        interpret=True))
    _check_fast_round(x, c, idx, sums, counts, ref_idx)
    if (idx == ref_idx).all():
        np.testing.assert_allclose(sums, ref_sums, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
        np.testing.assert_array_equal(counts, ref_counts)


GROUPED_SHAPES = [(16, 400, 8, 12), (10, 300, 16, 20), (5, 257, 32, 9),
                  (3, 333, 64, 17)]


@pytest.mark.parametrize("b,n,m,k", GROUPED_SHAPES)
def test_plain_fast_grouped_matches_jax_kernel(b, n, m, k):
    rng = np.random.default_rng(n + k + m)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    xg = lloyd.regroup_divisions(torch.from_numpy(x))
    idx, sums, counts = (a.numpy() for a in lloyd.lloyd_round_grouped(
        xg, torch.from_numpy(c), fast_math=True))
    ref_idx, ref_sums, ref_counts = (np.asarray(a) for a in jax_grouped(
        jax_regroup(jnp.asarray(x)), jnp.asarray(c), fast_math=True,
        interpret=True))
    assert idx.shape == (b, n) and sums.shape == (b, k, m)
    _check_fast_round(x, c, idx, sums, counts, ref_idx)
    if (idx == ref_idx).all():
        np.testing.assert_allclose(sums, ref_sums, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
        np.testing.assert_array_equal(counts, ref_counts)


def test_plain_fast_versions_agree_and_round_to_nearest_even():
    """The grouped plain version is the round's on the ungrouped data; the
    bf16 rounding is to nearest, ties to even (1 + 2⁻⁸ lies halfway
    between 1 and 1 + 2⁻⁷ and rounds to 1), as XLA's astype."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 200, 16)).astype(np.float32)
    c = rng.standard_normal((8, 6, 16)).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = lloyd.lloyd_round_grouped(lloyd.regroup_divisions(xt), ct,
                                    fast_math=True)
    want = lloyd.lloyd_round(xt, ct, fast_math=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    halfway = np.float32(1 + 2 ** -8)
    assert lloyd._bf16(torch.tensor([halfway])).item() == 1.0
    assert np.asarray(jnp.asarray([halfway]).astype(jnp.bfloat16)
                      .astype(jnp.float32))[0] == 1.0


@pytest.mark.parametrize("impl,parts", [
    (None, (None, False)), ("_fast", (None, True)),
    ("round_fast", ("round", True)), ("grouped_fast", ("grouped", True)),
    ("round", ("round", False)), ("grouped", ("grouped", False))])
def test_impl_parts_parse_as_the_jax_package(impl, parts):
    assert kmeans._impl_parts(impl) == parts
    jimpl = None if impl is None else impl.replace(
        "grouped", "pallas_grouped").replace("round", "pallas")
    jparts = jkmeans._impl_parts(jimpl)
    assert (jparts[1], jparts[0] is None) == (parts[1], parts[0] is None)


def _blobs(rng, n_per, k, m, spread=0.05):
    centers = rng.standard_normal((k, m)).astype(np.float32) * 3
    pts = np.concatenate([
        ctr + spread * rng.standard_normal((n_per, m)).astype(np.float32)
        for ctr in centers])
    return pts[rng.permutation(len(pts))]


def _inertia(x, centroids, indices):
    return float(np.sum((x - np.asarray(centroids)[np.asarray(indices)])
                        ** 2))


@pytest.mark.parametrize("impl,jimpl,shape", [
    ("_fast", "pallas_fast", (50, 8, 6)),
    ("round_fast", "pallas_fast", (50, 8, 6)),
    ("grouped_fast", "pallas_grouped_fast", (200, 4, 16))])
def test_fit_fast_inertia_within_5_percent_of_jax(impl, jimpl, shape):
    rng = np.random.default_rng(42)
    n_per, k, m = shape
    x = _blobs(rng, n_per, k, m)
    ref = jkmeans.fit(jnp.asarray(x)[None], k, jax.random.key(3),
                      impl=jimpl)
    got = kmeans.fit(torch.from_numpy(x)[None], k,
                     torch.Generator().manual_seed(3), impl=impl)
    i_ref = _inertia(x, ref.centroids[0], ref.indices[0])
    i_got = _inertia(x, got.centroids[0].numpy(), got.indices[0].numpy())
    assert abs(i_ref - i_got) <= 0.05 * max(i_ref, 1e-9), (i_ref, i_got)
    with pytest.raises(ValueError, match="unknown impl"):
        kmeans.fit(torch.from_numpy(x)[None], k, torch.Generator(),
                   impl="bogus_fast")


def test_fit_fast_takes_the_fast_round_to_the_end(monkeypatch):
    """Every round and the final reassignment of an exhausted fit go
    through the fast round."""
    calls = []
    real = kmeans.lloyd_round

    def spy(x, c, fast_math=False):
        calls.append(fast_math)
        return real(x, c, fast_math=fast_math)

    monkeypatch.setattr(kmeans, "lloyd_round", spy)
    x = np.random.default_rng(5).standard_normal((2, 300, 6)) \
        .astype(np.float32)
    res = kmeans.fit(torch.from_numpy(x), 7, torch.Generator().manual_seed(1),
                     max_rounds=3, impl="_fast")
    assert int(res.rounds.max()) == 3
    assert calls == [True] * 4


def test_with_fast_math_finds_the_self_neighbour():
    """``tests/test_build.py``'s fast-math case: a serveable database
    whose queries find their own row for at least 9 of 10 rows, as the
    JAX package's does on the same data."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    hits = {}
    for name, pkg_builder, kw in (("port", ft.DatabaseBuilder,
                                   {"device": "cpu"}),
                                  ("jax", JaxBuilder, {})):
        db = (pkg_builder(x, **kw).with_partitions(8).with_divisions(4)
              .with_clusters(8).with_seed(5).with_fast_math().build())
        hits[name] = sum(db.query(x[i], k=1, nprobe=8)[0].vector_id
                         == db.vector_ids[i] for i in range(10))
    assert hits["port"] >= 9 and hits["jax"] >= 9, hits


def test_fast_build_routes_both_fits_through_the_fast_impl(monkeypatch):
    seen = []
    real = kmeans.fit

    def spy(x, k, gen, **kw):
        seen.append(kw.get("impl"))
        return real(x, k, gen, **kw)

    monkeypatch.setattr(kmeans, "fit", spy)
    x = np.random.default_rng(2).standard_normal((300, 8)).astype(np.float32)
    ft.DatabaseBuilder(x, device="cpu").with_partitions(4).with_divisions(2) \
        .with_clusters(4).with_seed(1).with_fast_math().build()
    ft.DatabaseBuilder(x, device="cpu").with_partitions(4).with_divisions(2) \
        .with_clusters(4).with_seed(1).with_fast_math().with_opq(2).build()
    assert seen == ["_fast"] * 2 + ["_fast"] * 4
    seen.clear()
    ft.DatabaseBuilder(x, device="cpu").with_partitions(4).with_divisions(2) \
        .with_clusters(4).with_seed(1).with_fast_math(False).build()
    assert seen == [None, None]


def test_fast_wrappers_count_nothing_on_cpu():
    before = dict(_kernels.LAUNCHES)
    lloyd.lloyd_round(torch.zeros((1, 10, 8)), torch.zeros((1, 3, 8)),
                      fast_math=True)
    lloyd.lloyd_round_grouped(torch.zeros((1, 10, 128)),
                              torch.zeros((8, 3, 16)), fast_math=True)
    assert _kernels.LAUNCHES == before
    assert {"lloyd_round_fast", "lloyd_grouped_fast"} <= set(before)


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,m,dup", [(1, 5000, 100, 1536, False),
                                         (12, 3000, 256, 128, False),
                                         (1, 2000, 1024, 128, False),
                                         (3, 517, 7, 12, False),
                                         (12, 3000, 256, 128, True),
                                         (2, 129, 1, 5, False),
                                         (1, 1000, 16, 24, False),
                                         (2, 4133, 300, 100, False),
                                         (12, 3000, 256, 128, 200),
                                         (1, 3000, 1024, 128, 1000),
                                         (2, 3000, 256, 256, False),
                                         (1, 3000, 257, 264, False),
                                         (2, 3000, 257, 128, False),
                                         (3, 1, 100, 128, False),
                                         (1, 3000, 100, 136, False)])
def test_fast_kernel_matches_plain_on_card(cuda, b, n, k, m, dup):
    """K-B fast against the plain fast round, two calls bit-equal, the
    full-precision round launching only K-B. ``dup``: centroid 7 (True)
    or that centroid, in another tile than centroid 3, is a copy of
    centroid 3 and must never be picked. The shapes take K-B fast's
    regimes and their edges (M=128 the widest resident band; M=136, 256
    and 264 chunked), a tile pair past K=256 and one row."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = x[:, rng.integers(0, n, k)].copy()
    twin = 7 if dup is True else dup
    if dup:
        c[:, twin] = c[:, 3]
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    before = dict(_kernels.LAUNCHES)
    first = lloyd.lloyd_round(xt, ct, fast_math=True)
    again = lloyd.lloyd_round(xt, ct, fast_math=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))
    idx, sums, counts = (a.cpu().numpy() for a in first)
    assert _kernels.LAUNCHES["lloyd_round_fast"] == \
        before["lloyd_round_fast"] + 2
    assert _kernels.LAUNCHES["lloyd_round"] == before["lloyd_round"]
    ref_idx = lloyd.lloyd_round_plain(xt, ct, fast_math=True)[0] \
        .cpu().numpy()
    _check_fast_round(x, c, idx, sums, counts, ref_idx)
    if dup:
        assert not (idx == twin).any()
    lloyd.lloyd_round(xt, ct)
    assert _kernels.LAUNCHES["lloyd_round"] == before["lloyd_round"] + 1
    assert _kernels.LAUNCHES["lloyd_round_fast"] == \
        before["lloyd_round_fast"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,m,dup", [(8, 5000, 256, 16, False),
                                         (60, 1000, 256, 16, False),
                                         (16, 3000, 256, 8, False),
                                         (4, 3000, 256, 32, False),
                                         (3, 2000, 300, 64, False),
                                         (10, 777, 9, 16, False),
                                         (8, 3000, 256, 16, True),
                                         (4, 300, 1, 8, False),
                                         (2, 1000, 4096, 16, False),
                                         (8, 3000, 1024, 16, (200, 1023)),
                                         (8, 1, 256, 16, False),
                                         (4, 1001, 256, 32, False),
                                         (5, 2000, 256, 8, False)])
def test_fast_grouped_kernel_matches_plain_on_card(cuda, b, n, k, m, dup):
    """K-C fast against the plain fast round, two calls bit-equal. ``dup``:
    centroids 7 and K-1 (True), or those given (in other 64-centroid
    tiles than centroid 3), are copies of centroid 3 and must never be
    picked. The shapes take N=1, N and B off the kernel's row blocks and
    groups (B=5 at m=8, 16 divisions a group), and every width."""
    rng = np.random.default_rng(n + k + m)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = x[:, rng.integers(0, n, k)].copy()
    twins = [7, k - 1] if dup is True else list(dup or ())
    for j in twins:
        c[:, j] = c[:, 3]
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    xg = lloyd.regroup_divisions(xt)
    before = dict(_kernels.LAUNCHES)
    first = lloyd.lloyd_round_grouped(xg, ct, fast_math=True)
    again = lloyd.lloyd_round_grouped(xg, ct, fast_math=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))
    idx, sums, counts = (a.cpu().numpy() for a in first)
    assert _kernels.LAUNCHES["lloyd_grouped_fast"] == \
        before["lloyd_grouped_fast"] + 2
    assert _kernels.LAUNCHES["lloyd_grouped"] == before["lloyd_grouped"]
    ref_idx = lloyd.lloyd_round_grouped_plain(xg, ct, fast_math=True)[0] \
        .cpu().numpy()
    _check_fast_round(x, c, idx, sums, counts, ref_idx)
    np.testing.assert_array_equal(counts.sum(-1), np.full(b, n))
    if twins:
        assert not np.isin(idx, twins).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,m", [(8, 5000, 256, 16), (4, 3000, 300, 32),
                                     (8, 2000, 1024, 16)])
def test_fast_grouped_picks_equal_kb_fast_on_card(cuda, b, n, k, m):
    """Where a division starts a k16 step (m >= 16), K-C fast issues its
    steps as K-B fast does on the ungrouped data and stages its norms in
    K-B fast's order: the same distances, so the same picks, row for
    row."""
    rng = np.random.default_rng(b * n + m)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = x[:, rng.integers(0, n, k)].copy()
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    got = lloyd.lloyd_round_grouped(lloyd.regroup_divisions(xt), ct,
                                    fast_math=True)[0]
    want = lloyd.lloyd_round(xt, ct, fast_math=True)[0]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fast_fit_on_card_launches_the_fast_kernels(cuda):
    """Fits through each fast kernel, against the full-precision fit of
    the same kernel from the same seeding (the same draws): inertia
    within 5%."""
    rng = np.random.default_rng(9)
    x = np.stack([_blobs(rng, 500, 16, 16) for _ in range(8)])
    xt = torch.from_numpy(x).to(cuda)

    def inertia(r):
        cents = r.centroids.cpu().numpy()
        idx = r.indices.cpu().numpy()
        return sum(float(((x[b] - cents[b][idx[b]]) ** 2).sum())
                   for b in range(8))

    for impl, name in (("_fast", "lloyd_grouped"),
                       ("round_fast", "lloyd_round")):
        _kernels.reset_launches()
        res = kmeans.fit(xt, 16, torch.Generator("cuda").manual_seed(4),
                         impl=impl)
        assert _kernels.LAUNCHES[name + "_fast"] >= int(res.rounds.max())
        assert _kernels.LAUNCHES[name] == 0
        ref = kmeans.fit(xt, 16, torch.Generator("cuda").manual_seed(4),
                         impl=impl[:-len("_fast")] or None)
        assert _kernels.LAUNCHES[name] > 0
        assert abs(inertia(res) - inertia(ref)) <= 0.05 * inertia(ref), \
            (impl, inertia(res), inertia(ref))
