"""The port's training caps and single-device staged build
(``flechasdb_tpu_torch/ops/kmeans.fit(train_cap=)``,
``flechasdb_tpu_torch/parallel/build.py``) and its device GMM sampler
(``flechasdb_tpu_torch/synth.gmm_*_device``), held against the JAX
package's ``ops/kmeans``, ``parallel/build`` and ``utils/synth`` on the
CPU.

The draws differ (``torch.Generator`` against JAX keys), so fits and
builds are held to the JAX package's in quality (inertia, recall) and in
their events, and bit for bit to themselves; the chunked encode is held
to the JAX package's on the same arrays, up to near-ties. The ``cuda``
cases hold K-B and K-B fast at the Deep10M shapes (reduced N) against
their plain versions and skip here.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flechasdb_tpu.ops import kmeans as jkmeans
from flechasdb_tpu.parallel import build as jbuild
from flechasdb_tpu.utils import synth as jsynth
from flechasdb_tpu_torch import _kernels, synth
from flechasdb_tpu_torch.ops import kmeans, lloyd
from flechasdb_tpu_torch.ops.bucketed import bucketize, query_bucketed
from flechasdb_tpu_torch.parallel import build as pbuild

from _torch_helpers import cuda, event_pattern  # noqa: F401

TIE_REL = 1e-5


def _gen(seed, device="cpu"):
    return torch.Generator(device).manual_seed(seed)


def _blobs(rng, n, k, m, spread=0.3):
    centers = 4.0 * rng.standard_normal((k, m)).astype(np.float32)
    pick = rng.integers(0, k, n)
    return (centers[pick] + spread * rng.standard_normal((n, m))
            ).astype(np.float32)


def _inertia(x, centroids, indices):
    x, centroids = np.asarray(x, np.float64), np.asarray(centroids)
    indices = np.asarray(indices)
    return float(sum(((x[b] - centroids[b][indices[b]]) ** 2).sum()
                     for b in range(x.shape[0])))


# --- fit(train_cap=) ---------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 0, -1, 3000, 4500])
def test_cap_at_or_above_n_is_the_uncapped_fit(cap):
    """A cap of ``n`` or more (or none, or not positive) leaves the
    generator alone: the fit is the uncapped one, bit for bit."""
    x = torch.from_numpy(_blobs(np.random.default_rng(1), 3000, 12, 16)
                         )[None]
    want = kmeans.fit(x, 12, _gen(4))
    got = kmeans.fit(x, 12, _gen(4), train_cap=cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,impl", [(1, None), (3, None), (1, "_fast")])
def test_engaged_cap_assigns_the_full_x_to_the_trained_centroids(b, impl):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(np.stack([_blobs(rng, 5000, 16, 12)
                                   for _ in range(b)]))
    res = kmeans.fit(x, 16, _gen(5), train_cap=1200, impl=impl)
    assert res.indices.shape == (b, 5000) and res.indices.dtype == torch.int32
    fast = impl is not None
    want = lloyd.lloyd_round_plain(x, res.centroids, fast)[0]
    assert torch.equal(res.indices, want)
    assert bool((res.rounds > 0).all())
    again = kmeans.fit(x, 16, _gen(5), train_cap=1200, impl=impl)
    for g, w in zip(again, res):
        assert torch.equal(g, w)


def test_cap_below_k_raises_the_jax_text():
    x = np.random.default_rng(3).standard_normal((1, 400, 8)) \
        .astype(np.float32)
    with pytest.raises(ValueError) as mine:
        kmeans.fit(torch.from_numpy(x), 32, _gen(0), train_cap=20)
    with pytest.raises(ValueError) as theirs:
        jkmeans.fit(jax.numpy.asarray(x), 32, jax.random.key(0),
                    train_cap=20)
    assert str(mine.value) == str(theirs.value) \
        == "train_cap is smaller than k: 20 < 32"


@pytest.mark.parametrize("b,n,k,m,cap", [(1, 20000, 64, 16, 4096),
                                         (4, 8000, 32, 8, 2048)])
def test_capped_inertia_within_5_percent_of_jax(b, n, k, m, cap):
    rng = np.random.default_rng(n + k)
    x = np.stack([_blobs(rng, n, k, m) for _ in range(b)])
    mine = kmeans.fit(torch.from_numpy(x), k, _gen(7), train_cap=cap)
    theirs = jkmeans.fit(jax.numpy.asarray(x), k, jax.random.key(7),
                         train_cap=cap)
    i_mine = _inertia(x, mine.centroids.numpy(), mine.indices.numpy())
    i_theirs = _inertia(x, np.asarray(theirs.centroids),
                        np.asarray(theirs.indices))
    assert i_mine <= 1.05 * i_theirs, (i_mine, i_theirs)


def test_capped_events_are_the_jax_pattern():
    """Three rounds that do not converge, under an engaged cap: the same
    events, in the same order and with the same rounds, as the JAX
    package's ``fit_with_events(train_cap=)``; none for the final
    assignment."""
    x = np.random.default_rng(4).standard_normal((1, 3000, 8)) \
        .astype(np.float32)
    mine, theirs = [], []
    kmeans.fit(torch.from_numpy(x), 16, _gen(1), max_rounds=3,
               handler=mine.append, train_cap=1000)
    jkmeans.fit_with_events(jax.numpy.asarray(x), 16, jax.random.key(1),
                            theirs.append, max_rounds=3, train_cap=1000)

    def plain(events):
        return [(type(e).__name__, getattr(e, "round", None))
                for e in events]

    assert plain(mine) == plain(theirs)
    assert len(mine) == 2 + 3 * 4


# --- parallel/build ----------------------------------------------------------

def _near_tie(r, books, a, b):
    """Whether codes ``a`` and ``b`` of residual rows ``r [n, D, m]`` lie
    within TIE_REL of a tie, by the encode's key in float64."""
    r64, b64 = r.astype(np.float64), books.astype(np.float64)
    dd = np.arange(books.shape[0])[None, :]

    def key(code):
        c = b64[dd, code]                              # [n, D, m]
        return (c * c).sum(-1) - 2 * (r64 * c).sum(-1)

    scale = (r64 * r64).sum(-1) + (b64 * b64).sum(-1).max()
    return np.abs(key(a) - key(b)) <= TIE_REL * scale


@pytest.mark.parametrize("n,chunk", [(1000, 256), (700, 700), (300, 1024)])
def test_encode_chunked_matches_jax(n, chunk):
    rng = np.random.default_rng(n)
    m, p, d, c = 32, 16, 4, 16
    x = rng.standard_normal((n, m)).astype(np.float32)
    cents = rng.standard_normal((p, m)).astype(np.float32)
    idx = rng.integers(0, p, n).astype(np.int32)
    books = rng.standard_normal((d, c, m // d)).astype(np.float32)
    got = pbuild._encode_chunked(*map(torch.from_numpy, (x, cents, idx,
                                                         books)),
                                 chunk=chunk)
    want = np.asarray(jbuild._encode_chunked(
        *map(jax.numpy.asarray, (x, cents, idx, books)), chunk=chunk))
    assert got.dtype == torch.uint8 and got.shape == (n, d)
    got = got.numpy()
    r = (x - cents[idx]).reshape(n, d, m // d)
    differ = got != want
    assert not (differ & ~_near_tie(r, books, got.astype(np.int64),
                                    want.astype(np.int64))).any()


#: The port's kernel names against the JAX package's.
_JAX_NAME = {None: None, "round": "pallas", "grouped": "pallas_grouped"}


@pytest.mark.parametrize("impl", [None, "round", "grouped", "_fast",
                                  "round_fast", "grouped_fast"])
@pytest.mark.parametrize("sub", [8, 12, 16, 127, 128, 192])
def test_pq_impl_re_resolves_as_the_jax_package(impl, sub):
    base, fast = kmeans._impl_parts(impl)
    jimpl = _JAX_NAME[base]
    if fast:
        jimpl = (jimpl or "") + "_fast"
    want = jbuild._pq_impl(jimpl, sub)
    got = pbuild._pq_impl(impl, sub)
    to_jax = {v: k for k, v in _JAX_NAME.items()}
    wb, wf = jkmeans._impl_parts(want)
    assert kmeans._impl_parts(got) == (to_jax[wb], wf)


def _recall(arrays, x, q, gt, nprobe=8):
    cents, pidx, books, codes = (np.array(a) for a in arrays)
    bk = bucketize(codes.astype(np.int32), pidx.astype(np.int32),
                   cents.shape[0])
    _, rows, _ = query_bucketed(torch.from_numpy(q), torch.from_numpy(cents),
                                torch.from_numpy(books), bk, k=10,
                                nprobe=nprobe)
    rows = rows.numpy()
    return float(np.mean([len(set(rows[b]) & set(gt[b])) / 10
                          for b in range(len(q))]))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(15)
    x, q = synth.gmm_pair(rng, 30_000, 50, 32, n_clusters=64, intrinsic=6)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d, axis=1, kind="stable")[:, :10]


STAGED = dict(coarse_cap=8192, pq_cap=4096)


def test_build_staged_matches_jax(corpus):
    """At caps that engage both branches: the JAX package's dtypes and
    shapes, recall within 0.05 of its ``build_staged`` on the same
    queries, and its events in the same pattern."""
    x, q, gt = corpus
    mine_ev, theirs_ev = [], []
    mine = pbuild.build_staged(x, 64, 4, 32, 5, mine_ev.append,
                               device="cpu", **STAGED)
    theirs = jbuild.build_staged(jax.numpy.asarray(x), 64, 4, 32,
                                 jax.random.key(5), theirs_ev.append,
                                 **STAGED)
    for g, w in zip(mine, theirs):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert event_pattern(mine_ev) == event_pattern(theirs_ev) == [
        "StartingCentroidInitialization", "FinishedCentroidInitialization",
        "round", "StartingSubvectorDivision", "FinishedSubvectorDivision",
        "StartingCentroidInitialization", "FinishedCentroidInitialization",
        "round"]
    r_mine, r_theirs = _recall(mine, x, q, gt), _recall(theirs, x, q, gt)
    assert r_mine > r_theirs - 0.05, (r_mine, r_theirs)
    assert r_mine > 0.3


def test_build_staged_is_reproducible_and_the_one_call_build(corpus):
    x = corpus[0][:12_000]
    a = pbuild.build_staged(x, 32, 4, 16, 9, device="cpu", **STAGED)
    b = pbuild._build_fn(x, 9, p=32, d=4, c=16, device="cpu", **STAGED)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = pbuild._build_fn(x, 10, p=32, d=4, c=16, device="cpu", **STAGED)
    assert not torch.equal(a.partition_centroids, c.partition_centroids)


def test_build_staged_codes_under_and_over_the_pq_cap(corpus):
    """Over the PQ cap the codes are ``_encode_chunked``'s; at or under
    it they are the PQ fit's own assignment (no second pass)."""
    x = corpus[0][:6000]
    for pq_cap in (2000, 6000):
        got = pbuild.build_staged(x, 16, 4, 16, 3, device="cpu",
                                  coarse_cap=4000, pq_cap=pq_cap)
        xt = torch.from_numpy(x)
        want = pbuild._encode_chunked(xt, got.partition_centroids,
                                      got.partition_indices.int(),
                                      got.codebooks)
        assert got.codes.dtype == torch.uint8
        assert got.partition_indices.dtype == torch.uint16
        if pq_cap < len(x):
            assert torch.equal(got.codes, want)
        else:
            # The fit's last assignment predates its final update; the
            # encode against the final codebooks agrees on most rows.
            assert float((got.codes == want).float().mean()) > 0.9


def test_dtypes_follow_the_index_ranges():
    assert pbuild._code_dtype(256) == torch.uint8
    assert pbuild._code_dtype(257) == torch.int32
    assert pbuild._pidx_dtype(1 << 16) == torch.uint16
    assert pbuild._pidx_dtype((1 << 16) + 1) == torch.int32
    assert pbuild.PQ_TRAIN_CAP == jbuild.PQ_TRAIN_CAP == 1 << 20
    assert pbuild.COARSE_TRAIN_CAP == jbuild.COARSE_TRAIN_CAP == 2 << 20


# --- synth -------------------------------------------------------------------

def test_device_gmm_matches_the_host_statistics():
    """The torch sampler looks like the numpy generator and the JAX
    sampler: shape, spread, a tail chunk drawn from the same mixture, and
    queries from the same mixture as the corpus."""
    x = synth.gmm_corpus_device(_gen(0), 4000, 24, n_clusters=32,
                                intrinsic=6, chunk=1700).numpy()
    h = synth.gmm_corpus(np.random.default_rng(0), 4000, 24, n_clusters=32,
                         intrinsic=6)
    j = np.asarray(jsynth.gmm_corpus_device(jax.random.key(0), 4000, 24,
                                            n_clusters=32, intrinsic=6,
                                            chunk=1700))
    assert x.shape == (4000, 24) and x.dtype == np.float32
    assert np.isfinite(x).all()
    assert 0.5 < x.std() / h.std() < 2.0 and 0.5 < x.std() / j.std() < 2.0
    assert 0.5 < x[3400:].std() / x[:3400].std() < 2.0
    again = synth.gmm_corpus_device(_gen(0), 4000, 24, n_clusters=32,
                                    intrinsic=6, chunk=1700).numpy()
    np.testing.assert_array_equal(x, again)

    c, q = synth.gmm_pair_device(_gen(1), 3000, 64, 24, n_clusters=32,
                                 intrinsic=6, chunk=999)
    c, q = c.numpy(), q.numpy()
    assert c.shape == (3000, 24) and q.shape == (64, 24)
    dq = ((q[:, None, :] - c[None, :1000, :]) ** 2).sum(-1).min(1)
    dc = ((c[:64, None, :] - c[None, :1000, :]) ** 2).sum(-1)
    dc = np.partition(dc, 1, axis=1)[:, 1]
    assert 0.2 < np.median(dq) / np.median(dc) < 5.0


def test_device_gmm_component_weights_follow_the_zipf_law():
    """Drawn components follow ``1/i^0.7``: the share of rows nearest each
    component mean, for the four heaviest, within 0.02 of its weight."""
    g = _gen(2)
    w, means, cdf, scales = synth._gmm_params_device(g, 16, 8, 4, 0.01)
    x = synth._gmm_sample_device(g, (w, means, cdf, scales), 40_000, 16,
                                 0.0, 7000)
    near = torch.cdist(x, means).argmin(1).numpy()
    share = np.bincount(near, minlength=8) / len(near)
    weights = 1.0 / np.arange(1, 9) ** 0.7
    np.testing.assert_allclose(share[:4], (weights / weights.sum())[:4],
                               atol=0.02)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys; import flechasdb_tpu_torch.streaming, "
            "flechasdb_tpu_torch.parallel.build, flechasdb_tpu_torch.synth;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flechasdb_tpu' or "
            "m.startswith('flechasdb_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# --- on the card -------------------------------------------------------------

#: The Deep10M path's K-B shapes at reduced N: the coarse fit (K=4096,
#: M=96), the PQ fit (B=8, K=256, m=12), and K=4096 with copies of
#: centroid 3 in other tiles.
DEEP_SHAPES = [(1, 65_536, 4096, 96, False), (8, 65_536, 256, 12, False),
               (1, 20_000, 4096, 96, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,n,k,m,dup", DEEP_SHAPES)
def test_round_at_the_deep10m_shapes_matches_plain_on_card(cuda, b, n, k, m,
                                                           dup, fast):
    """K-B (or K-B fast) against its plain version up to near-ties, two
    calls bit-equal, one cluster-sum pass a round, no twin picked."""
    rng = np.random.default_rng(k + m)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = x[:, rng.integers(0, n, k)].copy()
    twins = (7, 200, k - 1)
    if dup:
        for t in twins:
            c[:, t] = c[:, 3]
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    name = "lloyd_round_fast" if fast else "lloyd_round"
    before = dict(_kernels.LAUNCHES)
    first = lloyd.lloyd_round(xt, ct, fast_math=fast)
    again = lloyd.lloyd_round(xt, ct, fast_math=fast)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))
    assert _kernels.LAUNCHES[name] == before[name] + 2
    assert _kernels.LAUNCHES["cluster_sums"] == before["cluster_sums"] + 2
    idx = first[0].cpu().numpy()
    want = lloyd.lloyd_round_plain(xt, ct, fast)[0].cpu().numpy()
    xr = lloyd._bf16(xt).cpu().numpy() if fast else x
    cr = lloyd._bf16(ct).cpu().numpy() if fast else c
    cc = (c.astype(np.float64) ** 2).sum(-1)
    bb = np.arange(b)[:, None]

    def dist(pick):
        return cc[bb, pick] - 2 * np.einsum(
            "bnm,bnm->bn", xr.astype(np.float64),
            cr.astype(np.float64)[bb, pick])

    scale = (xr.astype(np.float64) ** 2).sum(-1) + cc.max(-1, keepdims=True)
    tie = np.abs(dist(idx) - dist(want)) <= TIE_REL * scale
    assert not ((idx != want) & ~tie).any()
    if dup:
        assert not np.isin(idx, twins).any()
    counts = first[2].cpu().numpy()
    for j in range(b):
        np.testing.assert_array_equal(counts[j],
                                      np.bincount(idx[j], minlength=k))


@pytest.mark.cuda
def test_capped_fit_on_card_launches_one_pass_a_round(cuda):
    x = torch.from_numpy(_blobs(np.random.default_rng(6), 40_000, 64, 96)
                         ).to(cuda)[None]
    _kernels.reset_launches()
    res = kmeans.fit(x, 64, _gen(3, "cuda"), train_cap=8192)
    torch.cuda.synchronize()
    rounds = int(res.rounds[0])
    # The sub-fit's rounds (one more where max_rounds ran out), then the
    # final assignment: each a K-B launch and one pass.
    assert _kernels.LAUNCHES["lloyd_round"] in (rounds + 1, rounds + 2)
    assert _kernels.LAUNCHES["cluster_sums"] == \
        _kernels.LAUNCHES["lloyd_round"]
    want = lloyd.lloyd_round_plain(x, res.centroids)[0]
    assert float((res.indices == want).float().mean()) > 0.999
