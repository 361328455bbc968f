"""The query side of the PyTorch port (``ops.bucketed``, ``ops.adc``,
``serving``) against the JAX package on identical arrays.

Layouts (``bucketize``) and tie order must be equal exactly; tables and
distances within rel 1e-4, abs 1e-5 (f32 products and sums in another
order); rows equal up to exact-distance ties, and equal outright where
the ties are exact in both (duplicated vectors), because both break ties
to the lower slot.

The ranking products (distances, coarse scores, tables) run in full f32
even where the process allows TF32: on the card they match the CPU's
within rel 1e-4, abs 1e-4 of the largest value, which TF32 misses. Those
tests, and the one that the kernels leave the caller's current device
alone, carry the ``cuda`` marker and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu.ops import adc as jadc
from flechasdb_tpu.ops import bucketed as jb
from flechasdb_tpu.serving import DeviceIndex as JaxIndex
from flechasdb_tpu_torch.ops import adc, bucketed, distance, lloyd, \
    scan
from flechasdb_tpu_torch.serving import DeviceIndex

RTOL, ATOL = 1e-4, 1e-5


def _index(rng, n=700, m=64, p=9, d=4, c=16, dup=False):
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    if dup:                        # exact ties: repeated (partition, codes)
        codes[n // 2:] = codes[:n - n // 2]
        pidx[n // 2:] = pidx[:n - n // 2]
    return centroids, codebooks, codes, pidx


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows_match_up_to_ties(got_d, got_r, want_d, want_r):
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)
    for b in range(len(got_r)):
        differ = got_r[b] != want_r[b]
        if differ.any():
            np.testing.assert_allclose(got_d[b][differ], want_d[b][differ],
                                       rtol=1e-6)


# Packed (D > 1, codes < 256), and unpacked by a code >= 256 or by D = 1.
@pytest.mark.parametrize("c,d", [(200, 5), (300, 5), (200, 1)])
@pytest.mark.parametrize("n,p,big", [(700, 9, False), (40, 8, False),
                                     (2300, 2, True)])
def test_bucketize_matches_jax(c, d, n, p, big):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    codes[0, 0] = c - 1
    pidx = rng.integers(0, p, n).astype(np.int32)
    if big:
        pidx[:2100] = 0            # L > 2048 rounds up to 3072
    got = bucketed.bucketize(codes, pidx, p)
    want = jb.bucketize(codes, pidx, p, pack="auto")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.codes.shape[1] == (2 if c < 256 and d > 1 else d)
    if big:
        assert got.codes.shape[2] == 3072


def test_bucketize_pack_validation():
    """Packing is automatic: four byte codes a word only when they fit."""
    pidx = np.zeros(10, np.int32)
    assert bucketed.bucketize(np.full((10, 4), 300, np.int32), pidx,
                              2).codes.shape[1] == 4
    assert bucketed.bucketize(np.full((10, 4), 255, np.int32), pidx,
                              2).codes.shape[1] == 1
    assert bucketed.bucketize(np.zeros((0, 4), np.int32),
                              np.zeros(0, np.int32), 2).codes.shape == (2, 1, 128)


@pytest.mark.parametrize("d", [1, 4, 5, 12])
def test_unpack_codes_matches_jax(d):
    rng = np.random.default_rng(d)
    raw = rng.integers(0, 256, (3, d, 128)).astype(np.int32)
    words = np.asarray(jb.bucketize(
        raw.transpose(0, 2, 1).reshape(-1, d),
        np.repeat(np.arange(3), 128).astype(np.int32), 3,
        pack=d > 1).codes)
    np.testing.assert_array_equal(
        scan.unpack_codes(_t(words), d).numpy(),
        np.asarray(jb.unpack_codes(jnp.asarray(words), d))
        if d > 1 else words)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_coarse_scores_match_jax(metric):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    c = rng.standard_normal((7, 32)).astype(np.float32)
    np.testing.assert_allclose(
        adc.coarse_scores(_t(q), _t(c), metric).numpy(),
        np.asarray(jadc.coarse_scores(jnp.asarray(q), jnp.asarray(c),
                                      metric)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric,with_coarse", [("l2", False),
                                                ("dot", False),
                                                ("dot", True)])
def test_probed_tables_match_jax(metric, with_coarse):
    rng = np.random.default_rng(12)
    centroids, codebooks, _, _ = _index(rng)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    probed = rng.integers(0, 9, (4, 3)).astype(np.int64)
    coarse = -q @ centroids.T if with_coarse else None
    got = bucketed.probed_tables(
        _t(q), _t(centroids), _t(codebooks), _t(probed), metric,
        None if coarse is None else _t(coarse))
    want = jb.probed_tables(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jnp.asarray(probed), None, metric,
        None if coarse is None else jnp.asarray(coarse))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 10), (9, 10), (1, 300),
                                      (9, 2000)])
def test_query_bucketed_matches_jax(metric, nprobe, k):
    rng = np.random.default_rng(nprobe * k)
    centroids, codebooks, codes, pidx = _index(rng)
    q = rng.standard_normal((6, 64)).astype(np.float32)
    args = (centroids, codebooks)
    got = bucketed.query_bucketed(
        _t(q), *map(_t, args), bucketed.bucketize(codes, pidx, 9),
        k=k, nprobe=nprobe, metric=metric)
    want = jb.query_bucketed(
        jnp.asarray(q), *map(jnp.asarray, args),
        jb.bucketize(codes, pidx, 9, pack="auto"), k=k, nprobe=nprobe,
        impl="gather", metric=metric)
    got = [a.numpy() for a in got]
    want = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(got[2], want[2])      # probed
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(want[0]))
    fin = np.isfinite(want[0])
    _rows_match_up_to_ties(np.where(fin, got[0], 0), np.where(fin, got[1], 0),
                           np.where(fin, want[0], 0),
                           np.where(fin, want[1], 0))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_query_bucketed_tie_order_matches_jax(metric):
    """Duplicated vectors tie exactly in both packages; both must list
    them in the same (lower slot first) order."""
    rng = np.random.default_rng(13)
    centroids, codebooks, codes, pidx = _index(rng, n=400, p=5, dup=True)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    got = bucketed.query_bucketed(
        _t(q), _t(centroids), _t(codebooks),
        bucketed.bucketize(codes, pidx, 5), k=40, nprobe=3,
        metric=metric)
    want = jb.query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jb.bucketize(codes, pidx, 5, pack="auto"), k=40, nprobe=3,
        impl="gather", metric=metric)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


def test_query_bucketed_approx_is_answered_exactly():
    rng = np.random.default_rng(14)
    centroids, codebooks, codes, pidx = _index(rng, n=600, p=5)
    q = _t(rng.standard_normal((4, 64)).astype(np.float32))
    bk = bucketed.bucketize(codes, pidx, 5)
    a = bucketed.query_bucketed(q, _t(centroids), _t(codebooks), bk, k=8,
                                nprobe=3)
    b = bucketed.query_bucketed(q, _t(centroids), _t(codebooks), bk, k=8,
                                nprobe=3, approx=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="item 10"):
        bucketed.query_bucketed(q, _t(centroids), _t(codebooks), bk,
                                torch.ones(600, dtype=torch.bool), k=8,
                                nprobe=3)


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_device_index_matches_jax(metric):
    rng = np.random.default_rng(15)
    centroids, codebooks, codes, pidx = _index(rng, n=900, p=12, c=64)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    mine = DeviceIndex(centroids, codebooks, codes, pidx, metric=metric,
                       device="cpu")
    ref = JaxIndex(centroids, codebooks, codes, pidx, metric=metric)
    assert mine.layout == ref.layout == "bucketed"
    got = mine.query(q, 10, 4)
    want = ref.query(q, 10, 4)
    np.testing.assert_array_equal(got[2], want[2])
    _rows_match_up_to_ties(got[0], got[1], want[0], want[1])


def test_device_index_masked_layout_is_not_ported():
    """The masked layout is ported now (ROADMAP item 8): a corpus with one
    huge bucket takes it, as in the JAX package, and answers the same.
    An OPQ rotation is still not ported."""
    rng = np.random.default_rng(16)
    centroids, codebooks, codes, _ = _index(rng, n=700, p=64)
    pidx = np.zeros(700, np.int32)                      # one huge bucket
    mine = DeviceIndex(centroids, codebooks, codes, pidx, device="cpu")
    ref = JaxIndex(centroids, codebooks, codes, pidx)
    assert mine.layout == ref.layout == "masked"
    q = rng.standard_normal((3, 64)).astype(np.float32)
    got, want = mine.query(q, 10, 2), ref.query(q, 10, 2)
    np.testing.assert_array_equal(got[2], want[2])
    _rows_match_up_to_ties(got[0], got[1], want[0], want[1])
    with pytest.raises(NotImplementedError, match="item 13"):
        DeviceIndex(centroids, codebooks, codes, pidx, device="cpu",
                    rotation=np.eye(64, dtype=np.float32))


# --- full-f32 ranking products, whatever TF32 setting the process chose ----

_MM = torch.backends.cuda.matmul
_NEW_API = hasattr(_MM, "fp32_precision")          # PyTorch >= 2.9


def _tf32_allowed() -> bool:
    return _MM.fp32_precision == "tf32" if _NEW_API else _MM.allow_tf32


@pytest.fixture(params=["global", "per_backend"])
def tf32_on(request):
    """TF32 matmuls allowed process-wide, as many applications set it:
    through the global setting or PyTorch's per-backend one."""
    if request.param == "global":
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        yield
        torch.set_float32_matmul_precision(prev)
    else:
        if not _NEW_API:
            pytest.skip("PyTorch < 2.9 has no per-backend fp32_precision")
        prev = _MM.fp32_precision
        _MM.fp32_precision = "tf32"
        yield
        _MM.fp32_precision = prev


def _ranking_calls(dev):
    rng = np.random.default_rng(17)
    centroids, codebooks, _, _ = _index(rng)
    # An offset makes the cross term dominate, where TF32's 10-bit
    # mantissa shows: about 1e-3 of it against f32's 1e-7.
    q = rng.standard_normal((5, 64)).astype(np.float32) + 3.0
    x = rng.standard_normal((2, 300, 64)).astype(np.float32) + 3.0
    probed = torch.from_numpy(rng.integers(0, 9, (5, 3))).to(dev)
    t = {k: torch.from_numpy(v).to(dev) for k, v in
         dict(q=q, c=centroids + 3.0, cb=codebooks, x=x).items()}
    return {
        "sqdist": lambda: distance.sqdist(t["x"], t["x"][:, :40]),
        "coarse_l2": lambda: adc.coarse_scores(t["q"], t["c"]),
        "coarse_dot": lambda: adc.coarse_scores(t["q"], t["c"], "dot"),
        "tables_l2": lambda: bucketed.probed_tables(
            t["q"], t["c"], t["cb"], probed),
        "tables_dot": lambda: bucketed.probed_tables(
            t["q"], t["c"], t["cb"], probed, "dot"),
        "lloyd_plain": lambda: lloyd.lloyd_round_plain(
            t["x"], t["x"][:, :40].contiguous())[1],
    }


@pytest.mark.parametrize("name", ["sqdist", "coarse_l2", "coarse_dot",
                                  "tables_l2", "tables_dot", "lloyd_plain"])
def test_ranking_products_run_in_full_f32(tf32_on, monkeypatch, name):
    """Every matrix product on the ranking path sees full f32 selected,
    and the process's own TF32 setting is back afterwards."""
    seen = []
    for fn in ("matmul", "einsum", "bmm"):
        orig = getattr(torch, fn)

        def spy(*a, _orig=orig, **kw):
            seen.append(_tf32_allowed())
            return _orig(*a, **kw)
        monkeypatch.setattr(torch, fn, spy)
    assert _tf32_allowed()
    _ranking_calls("cpu")[name]()
    assert seen and not any(seen), seen
    assert _tf32_allowed()


@pytest.mark.cuda
def test_ranking_products_ignore_tf32_on_card(tf32_on):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    on_card, on_cpu = _ranking_calls("cuda"), _ranking_calls("cpu")
    for name, fn in on_card.items():
        want = on_cpu[name]().numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(fn().cpu().numpy(), want, rtol=RTOL,
                                   atol=RTOL * scale, err_msg=name)
    assert _tf32_allowed()


@pytest.mark.cuda
def test_kernels_leave_the_current_device_alone():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(18)
    centroids, codebooks, codes, pidx = _index(rng)
    before = torch.cuda.current_device()
    buckets = bucketed.bucketize(codes, pidx, 9, device=last)
    q = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    bucketed.query_bucketed(q.to(last), torch.from_numpy(centroids).to(last),
                            torch.from_numpy(codebooks).to(last), buckets,
                            k=5, nprobe=2)
    x = torch.randn((1, 500, 64), device=last)
    lloyd.lloyd_round(x, x[:, :7].contiguous())
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == before
