"""K-B, the fused Lloyd round of the PyTorch port
(``flechasdb_tpu_torch.ops.lloyd``), and the k-means around it
(``ops.kmeans``, ``ops.distance``), against the JAX package.

The same numpy inputs go through the port's plain version and through the
JAX package's ``pallas_kmeans.lloyd_round(..., interpret=True)`` on the
shapes of ``tests/test_kmeans.py:297``. Tolerances:

* indices equal, except at rows whose two candidate distances lie within
  1e-5 of the row's distance scale (the JAX kernel's bf16x3 product, the
  card kernel's 3xTF32 product and an f32 product may rank such near-ties
  either way);
* sums within rtol 1e-4, atol 1e-3 of a float64 one-hot sum (the JAX
  test's own bound); counts exact;
* distances within rel 1e-4, abs 1e-5.

Whole fits use different random draws in the two packages, so they agree
in quality (``test_torch_slice.py``), while the convergence rules are
checked here exactly. The CUDA kernel runs only on the card: those tests
carry the ``cuda`` marker and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu.ops import kmeans as jkmeans
from flechasdb_tpu.ops.distance import assign_chunked as jax_assign
from flechasdb_tpu.ops.distance import sqdist as jax_sqdist
from flechasdb_tpu.ops.pallas_kmeans import lloyd_round as jax_lloyd
from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch import events as ev
from flechasdb_tpu_torch.ops import kmeans, lloyd
from flechasdb_tpu_torch.ops.distance import assign_chunked, sqdist

TIE_REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(seed=0, device="cpu"):
    return torch.Generator(device).manual_seed(seed)


def _near_tie_rows(x, c, a, b):
    """Rows where picks ``a`` and ``b`` are within TIE_REL of a tie
    (float64 distances)."""
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    bb = np.arange(x.shape[0])[:, None]
    cc = (c64 * c64).sum(-1)

    def dist(pick):
        return (cc[bb, pick]
                - 2 * np.einsum("bnm,bnm->bn", x64, c64[bb, pick]))

    scale = (x64 * x64).sum(-1) + cc.max(-1, keepdims=True)
    return np.abs(dist(a) - dist(b)) <= TIE_REL * scale


def _check_round(x, c, idx, sums, counts, ref_idx):
    differ = idx != ref_idx
    assert not (differ & ~_near_tie_rows(x, c, idx, ref_idx)).any()
    k = c.shape[1]
    for bb in range(x.shape[0]):
        oh = (np.arange(k)[:, None] == idx[bb][None, :]).astype(np.float64)
        np.testing.assert_allclose(sums[bb], oh @ x[bb].astype(np.float64),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(counts[bb], oh.sum(1))


ROUND_SHAPES = [(1, 1000, 24, 16), (3, 517, 12, 7), (1, 300, 8, 1280),
                (2, 129, 5, 1)]


@pytest.mark.parametrize("b,n,m,k,tile", [s + (t,) for s, t in zip(
    ROUND_SHAPES, (256, 128, 128, 128))])
def test_plain_round_matches_jax_kernel(b, n, m, k, tile):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    idx, sums, counts = (a.numpy() for a in lloyd.lloyd_round(
        torch.from_numpy(x), torch.from_numpy(c)))
    ref_idx, ref_sums, ref_counts = (np.asarray(a) for a in jax_lloyd(
        jnp.asarray(x), jnp.asarray(c), tile=tile, interpret=True))
    _check_round(x, c, idx, sums, counts, ref_idx)
    if (idx == ref_idx).all():
        np.testing.assert_allclose(sums, ref_sums, rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(counts, ref_counts)


def _tf32(v, nearest=True):
    """f32 cut to tf32 (10 mantissa bits) by bit masking: to nearest, ties
    away from zero (half of the dropped 13 bits' range added to the
    magnitude bits, as ``cvt.rna.tf32.f32`` rounds), or truncated."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_distances(x, c, passes=3):
    """K-B's and K-C's distances on the card, emulated: each operand split
    into hi, its tf32 to nearest, and lo = v - hi, which the tensor cores
    read truncated to tf32; x·c as lo·hi + hi·lo + hi·hi in f32 (or hi·hi
    alone, ``passes=1``), then ‖c‖² − 2 x·c in f32."""
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh, nearest=False), _tf32(c - ch, nearest=False)
    ch, cl = ch.transpose(0, 2, 1), cl.transpose(0, 2, 1)
    dot = xh @ ch
    if passes == 3:
        dot = (xl @ ch + xh @ cl) + dot
    cc = (c * c).sum(-1, dtype=np.float32)
    return cc[:, None, :] - np.float32(2) * dot


def test_tf32_rounding_and_split():
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)                  # tf32's spacing at 1
    v = np.array([one + ulp * 0.49, one + ulp * 0.5, one + ulp * 0.51,
                  -(one + ulp * 0.5), one + ulp * 1.5], np.float32)
    np.testing.assert_array_equal(
        _tf32(v), np.array([one, one + ulp, one + ulp, -(one + ulp),
                            one + 2 * ulp], np.float32))
    np.testing.assert_array_equal(
        _tf32(v, nearest=False), np.array([one, one, one, -one, one + ulp],
                                          np.float32))
    r = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = _tf32(r)
    assert ((hi.view(np.uint32) & 0x1FFF) == 0).all()
    assert (np.abs(r - hi) <= np.abs(r) * 2.0 ** -11).all()
    lo = _tf32(r - hi, nearest=False)                # the split's residue
    assert (np.abs(r - hi - lo) <= np.abs(r) * 2.0 ** -21).all()


# K-C's shapes (b, n, m, k): the SIFT PQ fit's m=16 and K=256, m=8, m=32,
# and m=64 with K=300.
GROUPED_SHAPES = [(8, 3000, 16, 256), (16, 2000, 8, 256), (4, 2000, 32, 256),
                  (3, 1000, 64, 300)]


@pytest.mark.parametrize("b,n,m,k", ROUND_SHAPES + [(1, 5000, 1536, 100),
                                                    (12, 3000, 128, 256),
                                                    (1, 2000, 96, 1024)]
                         + GROUPED_SHAPES)
def test_three_tf32_product_ranks_as_float64(b, n, m, k):
    """The card kernels' 3xTF32 product (K-B's, and K-C's on grouped
    data), emulated on the CPU, picks the float64 argmin up to TIE_REL
    near-ties, and its distances err less than a tenth of TIE_REL of the
    row's scale, where a single tf32 pass does not."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = (x[:, rng.integers(0, n, k)] if k <= n else
         rng.standard_normal((b, k, m)).astype(np.float32)).copy()
    d = _tf32_distances(x, c)
    idx = d.argmin(-1)
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    d64 = (c64 * c64).sum(-1)[:, None, :] - 2 * x64 @ c64.transpose(0, 2, 1)
    ref = d64.argmin(-1)
    assert not ((idx != ref) & ~_near_tie_rows(x, c, idx, ref)).any()
    scale = (x64 * x64).sum(-1) + (c64 * c64).sum(-1).max(-1, keepdims=True)
    assert (np.abs(d - d64).max(-1) <= 0.1 * TIE_REL * scale).all()
    one_pass = _tf32_distances(x, c, passes=1)
    assert (np.abs(one_pass - d64).max(-1) > 0.1 * TIE_REL * scale).any()


def test_plain_round_duplicated_centroids_take_the_first():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 400, 16)).astype(np.float32)
    c = rng.standard_normal((2, 9, 16)).astype(np.float32)
    c[:, 6] = c[:, 2]
    c[:, 8] = c[:, 2]
    idx = lloyd.lloyd_round(torch.from_numpy(x), torch.from_numpy(c))[0]
    ref = np.asarray(jax_lloyd(jnp.asarray(x), jnp.asarray(c),
                               interpret=True)[0])
    idx = idx.numpy()
    assert (idx == 2).any()
    assert not np.isin(idx, [6, 8]).any()
    assert not np.isin(ref, [6, 8]).any()
    np.testing.assert_array_equal(idx, ref)


def test_round_wrapper_checks_and_counts_nothing_on_cpu():
    x = torch.zeros((1, 10, 4))
    before = dict(_kernels.LAUNCHES)
    lloyd.lloyd_round(x, torch.zeros((1, 3, 4)))
    assert _kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        lloyd.lloyd_round(x, torch.zeros((1, 3, 5)))
    with pytest.raises(TypeError):
        lloyd.lloyd_round(x.double(), torch.zeros((1, 3, 4)).double())
    with pytest.raises(ValueError):
        lloyd.lloyd_round(torch.zeros((1, 4, 10)).transpose(1, 2),
                          torch.zeros((1, 3, 4)))


def test_sqdist_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 50, 7)).astype(np.float32)
    c = rng.standard_normal((2, 6, 7)).astype(np.float32)
    np.testing.assert_allclose(
        sqdist(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(jax_sqdist(jnp.asarray(x), jnp.asarray(c))),
        rtol=1e-4, atol=1e-5)


def test_assign_chunked_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 300, 5)).astype(np.float32)
    c = rng.standard_normal((2, 7, 5)).astype(np.float32)
    c[:, 4] = c[:, 1]                           # ties go to the first
    idx, dmin = assign_chunked(torch.from_numpy(x), torch.from_numpy(c),
                               chunk=64)
    ref_idx, ref_min = jax_assign(jnp.asarray(x), jnp.asarray(c), k=7,
                                  chunk=64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(dmin.numpy(), np.asarray(ref_min),
                               rtol=1e-4, atol=1e-5)


def test_means_grad_matches_jax():
    rng = np.random.default_rng(3)
    sums = rng.standard_normal((3, 5, 4)).astype(np.float32)
    counts = rng.integers(0, 4, (3, 5)).astype(np.float32)
    counts[0, 1] = 0                            # an empty cluster
    old = rng.standard_normal((3, 5, 4)).astype(np.float32)
    old[2] = 0.0
    sums[2] = 0.0                               # max norm 0: gradient 0
    new, grad = kmeans._means_grad(torch.from_numpy(sums),
                                   torch.from_numpy(counts),
                                   torch.from_numpy(old))
    ref_new, ref_grad = jkmeans._means_grad(
        jnp.asarray(sums), jnp.asarray(counts), jnp.asarray(old),
        jnp.float32)
    np.testing.assert_allclose(new.numpy(), np.asarray(ref_new),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-7)


def test_seed_cap_matches_jax():
    for k in (1, 100, 128, 256, 4096):
        assert kmeans._seed_cap(k) == jkmeans._seed_cap(k)


def test_plusplus_init_all_zero_weights_picks_row_zero():
    x = torch.ones((2, 10, 4))
    c, idx = kmeans.plusplus_init(x, 3, _gen())
    assert torch.equal(c, torch.ones((2, 3, 4)))
    assert idx.dtype == torch.int32


def test_plusplus_init_picks_distinct_rows():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(np.float32))
    c, idx = kmeans.plusplus_init(x, 8, _gen(1))
    for b in range(2):
        rows = [int((x[b] == c[b, i]).all(1).nonzero()[0]) for i in range(8)]
        assert len(set(rows)) == 8               # chosen rows weigh 0
        # indices track the nearest chosen-so-far centroid
        want = sqdist(x[b], c[b]).argmin(1)
        assert (idx[b].long() == want).float().mean() > 0.95


def test_fit_shortcuts_and_errors():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 6, 4)).astype(np.float32))
    res = kmeans.fit(x, 6, _gen())
    assert torch.equal(res.centroids, x)
    assert res.indices[0].tolist() == list(range(6))
    assert int(res.rounds[0]) == 0
    with pytest.raises(ValueError):
        kmeans.fit(x, 7, _gen())
    one = kmeans.fit(x, 1, _gen())
    np.testing.assert_allclose(one.centroids[0, 0].numpy(),
                               x[0].mean(0).numpy(), rtol=1e-4, atol=1e-5)
    same = kmeans.fit(torch.ones((1, 10, 4)), 3, _gen())
    assert torch.equal(same.centroids, torch.ones((1, 3, 4)))


def test_fit_exhaustion_reassigns():
    """kmeans.py:376-431: an entry that exhausts max_rounds is reassigned
    against its final centroids; an entry that converged keeps the
    assignment against its pre-update centroids."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((4, 5)).astype(np.float32) * 3
    tight = centers[rng.integers(0, 4, 200)] + 0.01 * rng.standard_normal(
        (200, 5)).astype(np.float32)
    loose = rng.standard_normal((200, 5)).astype(np.float32)
    x = torch.from_numpy(np.stack([tight, loose]))
    res = kmeans.fit(x, 4, _gen(2), max_rounds=3)
    assert int(res.rounds[1]) == 3 and float(res.gradient[1]) > 1e-6
    assert torch.equal(res.indices[1],
                       lloyd.lloyd_round(x[1:], res.centroids[1:])[0][0])
    if float(res.gradient[0]) < 1e-6:
        assert int(res.rounds[0]) < 3
    r0 = kmeans.fit(x, 4, _gen(2), max_rounds=0)
    assert (r0.rounds == 0).all() and torch.isinf(r0.gradient).all()
    assert torch.equal(r0.indices, assign_chunked(x, r0.centroids)[0])


def test_fit_events_follow_the_jax_grammar():
    """The clustering events of the JAX package's fit_with_events
    (kmeans.py:505-555): initialization, then per round an update pair,
    then a reassignment pair unless that round converged everything."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 150, 6)).astype(np.float32)
    seen = []
    res = kmeans.fit(torch.from_numpy(x), 5, _gen(3), handler=seen.append)
    jseen = []
    jkmeans.fit_with_events(jnp.asarray(x), 5, jax.random.key(3),
                            jseen.append)

    def grammar(events):
        names = [type(e).__name__ for e in events]
        assert names[:2] == ["StartingCentroidInitialization",
                             "FinishedCentroidInitialization"]
        rounds, i = 0, 2
        while i < len(names):
            assert names[i:i + 2] == ["StartingCentroidUpdate",
                                      "FinishedCentroidUpdate"]
            assert events[i].round == rounds
            i += 2
            if i < len(names):
                assert names[i:i + 2] == ["StartingCentroidReassignment",
                                          "FinishedCentroidReassignment"]
                i += 2
            rounds += 1
        return rounds

    assert grammar(seen) == int(res.rounds.max())
    grammar(jseen)
    last = seen[-1]
    assert isinstance(last, ev.FinishedCentroidUpdate)
    assert np.shape(last.gradient) == (2,)
    assert (np.asarray(last.gradient) < kmeans.DEFAULT_EPSILON).all()
    assert {type(e).__name__ for e in seen} == \
        {type(e).__name__ for e in jseen}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,m,dup", [(1, 5000, 100, 1536, False),
                                         (12, 3000, 256, 128, False),
                                         (1, 2000, 1024, 96, False),
                                         (3, 517, 7, 12, False),
                                         (12, 3000, 256, 128, True),
                                         (2, 129, 1, 5, False),
                                         (1, 1000, 16, 24, False),
                                         (2, 4133, 300, 128, False),
                                         (1, 3000, 1024, 960, False)])
def test_kernel_matches_plain_on_card(cuda, b, n, k, m, dup):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = x[:, rng.integers(0, n, k)].copy()
    if dup:
        c[:, 7] = c[:, 3]
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    before = _kernels.LAUNCHES["lloyd_round"]
    idx, sums, counts = (a.cpu().numpy() for a in lloyd.lloyd_round(xt, ct))
    assert _kernels.LAUNCHES["lloyd_round"] == before + 1
    ref_idx = lloyd.lloyd_round_plain(xt, ct)[0].cpu().numpy()
    _check_round(x, c, idx, sums, counts, ref_idx)
    if dup:
        assert not (idx == 7).any()


@pytest.mark.cuda
def test_fit_on_card_matches_cpu_quality(cuda):
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((8, 6)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 8, 800)]
         + 0.05 * rng.standard_normal((800, 6)).astype(np.float32))[None]

    def inertia(res):
        cents = res.centroids[0].cpu().numpy()
        return float(((x[0] - cents[res.indices[0].cpu().numpy()]) ** 2)
                     .sum())

    on_card = kmeans.fit(torch.from_numpy(x).to(cuda), 8, _gen(1, "cuda"))
    on_cpu = kmeans.fit(torch.from_numpy(x), 8, _gen(1))
    assert inertia(on_card) <= 1.02 * inertia(on_cpu) + 1e-3
