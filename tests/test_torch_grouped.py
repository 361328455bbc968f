"""K-C, the grouped Lloyd round of the PyTorch port
(``flechasdb_tpu_torch.ops.lloyd.lloyd_round_grouped``), and the routing
of ``ops.kmeans.fit`` between K-B and K-C, against the JAX package.

The same numpy inputs go through the port's plain version and through the
JAX package's ``pallas_kmeans.lloyd_round_grouped(..., interpret=True)``
(which runs ``_grouped_round_kernel``) at the shapes of
``tests/test_kmeans.py:394``, plus m=8 and a group count that does not
divide B. Tolerances: indices equal, counts equal, sums within rtol 1e-4,
atol 1e-3 (the JAX test's own bound). ``regroup_divisions`` is equal to
the JAX one.

The CUDA kernel runs only on the card: those tests carry the ``cuda``
marker and skip here. On the card, K-C's indices must agree with K-B's
on the ungrouped data exactly (K-C forms K-B's 3xTF32 tensor-core
product in K-B's order) and with the cuBLAS plain version up to near-ties
(the f32 plain version rounds differently). The card cases also cover
N below one row tile of the kernel, K=1, centroid tiles walked over K
(m=64, K=300) and sums added to global memory where the block-private
ones do not fit (K=4096), and hold the counts to N, so rows past N add
nothing.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu.ops.pallas_kmeans import lloyd_round_grouped as jax_grouped
from flechasdb_tpu.ops.pallas_kmeans import regroup_divisions as jax_regroup
from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch.ops import kmeans, lloyd

TIE_REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(b, n, m, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    return x, c


def _onehot_check(x, idx, sums, counts, k):
    for bb in range(x.shape[0]):
        oh = (np.arange(k)[:, None] == idx[bb][None, :]).astype(np.float64)
        np.testing.assert_allclose(sums[bb], oh @ x[bb].astype(np.float64),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(counts[bb], oh.sum(1))


@pytest.mark.parametrize("b,n,m", [(6, 500, 16), (3, 301, 32), (1, 257, 64),
                                   (5, 100, 8), (20, 33, 16), (3, 7, 4)])
def test_regroup_divisions_equals_jax(b, n, m):
    x, _ = _data(b, n, m, 1, b * n)
    got = lloyd.regroup_divisions(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_regroup(
        jnp.asarray(x))))


# (b, n, m, k): tests/test_kmeans.py:394, then m=8, and 128/m = 8 groups
# that do not divide B=10 (6 pad divisions in the second group).
_SHAPES = [(6, 500, 16, 32), (3, 301, 32, 7), (1, 257, 64, 5),
           (5, 300, 8, 12), (10, 200, 16, 9)]


@pytest.mark.parametrize("b,n,m,k", _SHAPES)
def test_plain_grouped_matches_jax_kernel(b, n, m, k):
    x, c = _data(b, n, m, k, n + k)
    xg = lloyd.regroup_divisions(torch.from_numpy(x))
    idx, sums, counts = (a.numpy() for a in lloyd.lloyd_round_grouped(
        xg, torch.from_numpy(c)))
    ref = [np.asarray(a) for a in jax_grouped(
        jax_regroup(jnp.asarray(x)), jnp.asarray(c), interpret=True)]
    assert idx.shape == (b, n) and sums.shape == (b, k, m)
    np.testing.assert_array_equal(idx, ref[0])
    np.testing.assert_allclose(sums, ref[1], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(counts, ref[2])
    _onehot_check(x, idx, sums, counts, k)


def test_plain_grouped_equals_the_plain_round():
    x, c = _data(10, 150, 16, 6, 3)
    c[:, 4] = c[:, 1]                           # ties go to the first
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = lloyd.lloyd_round_grouped(lloyd.regroup_divisions(xt), ct)
    want = lloyd.lloyd_round(xt, ct)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not (got[0] == 4).any()


def test_grouped_wrapper_checks_and_counts_nothing_on_cpu():
    xg = torch.zeros((1, 10, 128))
    before = dict(_kernels.LAUNCHES)
    lloyd.lloyd_round_grouped(xg, torch.zeros((8, 3, 16)))
    assert _kernels.LAUNCHES == before
    with pytest.raises(ValueError):            # m does not divide 128
        lloyd.lloyd_round_grouped(xg, torch.zeros((1, 3, 24)))
    with pytest.raises(ValueError):            # 9 divisions need 2 groups
        lloyd.lloyd_round_grouped(xg, torch.zeros((9, 3, 16)))
    with pytest.raises(ValueError):            # rows are not 128 wide
        lloyd.lloyd_round_grouped(torch.zeros((1, 10, 64)),
                                  torch.zeros((4, 3, 16)))
    with pytest.raises(TypeError):
        lloyd.lloyd_round_grouped(xg.double(), torch.zeros((8, 3, 16)))
    with pytest.raises(ValueError):
        lloyd.regroup_divisions(torch.zeros((2, 5, 24)))


def _fake(shape, device):
    return types.SimpleNamespace(shape=shape, device=torch.device(device))


@pytest.mark.parametrize("m,want", [(16, "grouped"), (8, "grouped"),
                                    (32, "grouped"), (64, "grouped"),
                                    (4, "round"), (24, "round"),
                                    (128, "round"), (1536, "round")])
def test_auto_impl_is_the_jax_shape_rule_on_cuda(m, want):
    assert kmeans._auto_impl(_fake((8, 1000, m), "cuda")) == want
    assert kmeans._auto_impl(_fake((8, 1000, m), "cpu")) == "round"


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = {"regroup": 0, "grouped": 0, "round": 0}
        for name, attr in (("regroup", "regroup_divisions"),
                           ("grouped", "lloyd_round_grouped"),
                           ("round", "lloyd_round")):
            monkeypatch.setattr(kmeans, attr, self._wrap(
                name, getattr(kmeans, attr)))

    def _wrap(self, name, fn):
        def spy(*args):
            self.calls[name] += 1
            return fn(*args)
        return spy


@pytest.mark.parametrize("max_rounds", [3, 100])
def test_fit_on_cuda_routes_to_the_grouped_kernel(monkeypatch, max_rounds):
    """fit takes K-C where _auto_impl says so (on a CUDA tensor; here its
    decision is forced, since this machine has no card): the data is
    regrouped once, every round and the final reassignment go through
    the grouped wrapper, and the fit equals the K-B route's."""
    x, _ = _data(10, 300, 16, 1, 5)
    xt = torch.from_numpy(x)
    want = kmeans.fit(xt, 6, torch.Generator().manual_seed(1),
                      max_rounds=max_rounds)
    spy = _Spy(monkeypatch)
    monkeypatch.setattr(kmeans, "_auto_impl", lambda t: "grouped")
    got = kmeans.fit(xt, 6, torch.Generator().manual_seed(1),
                     max_rounds=max_rounds)
    rounds = int(got.rounds.max())
    exhausted = bool((got.gradient >= kmeans.DEFAULT_EPSILON).any())
    assert spy.calls == {"regroup": 1, "grouped": rounds + exhausted,
                         "round": 0}
    assert exhausted == (max_rounds == 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fit_on_cpu_stays_on_the_plain_round(monkeypatch):
    x, _ = _data(8, 200, 16, 1, 6)
    spy = _Spy(monkeypatch)
    res = kmeans.fit(torch.from_numpy(x), 4, torch.Generator().manual_seed(2))
    assert spy.calls["grouped"] == spy.calls["regroup"] == 0
    assert spy.calls["round"] == int(res.rounds.max()) + bool(
        (res.gradient >= kmeans.DEFAULT_EPSILON).any())


def test_fit_impl_names_and_errors():
    x = torch.from_numpy(_data(4, 100, 16, 1, 7)[0])
    gen = torch.Generator().manual_seed(3)
    a = kmeans.fit(x, 5, gen.manual_seed(3), impl="round")
    b = kmeans.fit(x, 5, gen.manual_seed(3), impl="grouped")
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.indices, b.indices)
    for impl in ("grouped_fast", "_fast", "round_fast"):
        with pytest.raises(NotImplementedError, match=r"item 12\b"):
            kmeans.fit(x, 5, gen, impl=impl)
    for impl in ("pallas", "xla", "bogus"):
        with pytest.raises(ValueError, match="unknown impl"):
            kmeans.fit(x, 5, gen, impl=impl)


# --- on the card -------------------------------------------------------------

def _near_tie_rows(x, c, a, b):
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    bb = np.arange(x.shape[0])[:, None]
    cc = (c64 * c64).sum(-1)

    def dist(pick):
        return (cc[bb, pick]
                - 2 * np.einsum("bnm,bnm->bn", x64, c64[bb, pick]))

    scale = (x64 * x64).sum(-1) + cc.max(-1, keepdims=True)
    return np.abs(dist(a) - dist(b)) <= TIE_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,m,dup", [(8, 5000, 256, 16, False),
                                         (60, 1000, 256, 16, False),
                                         (16, 3000, 256, 8, False),
                                         (4, 3000, 256, 32, False),
                                         (3, 2000, 300, 64, False),
                                         (10, 777, 9, 16, False),
                                         (8, 3000, 256, 16, True),
                                         (3, 50, 16, 16, False),
                                         (4, 300, 1, 8, False),
                                         (2, 1000, 4096, 16, False)])
def test_kernel_matches_plain_and_k_b_on_card(cuda, b, n, k, m, dup):
    rng = np.random.default_rng(n + k + m)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = x[:, rng.integers(0, n, k)].copy()
    if dup:
        c[:, 7] = c[:, 3]
        c[:, k - 1] = c[:, 3]
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    xg = lloyd.regroup_divisions(xt)
    before = _kernels.LAUNCHES["lloyd_grouped"]
    idx, sums, counts = (a.cpu().numpy()
                         for a in lloyd.lloyd_round_grouped(xg, ct))
    assert _kernels.LAUNCHES["lloyd_grouped"] == before + 1
    ref_idx = lloyd.lloyd_round_grouped_plain(xg, ct)[0].cpu().numpy()
    assert not ((idx != ref_idx) & ~_near_tie_rows(x, c, idx, ref_idx)).any()
    # K-C splits, multiplies and accumulates as K-B does: equal picks.
    kb_idx = lloyd.lloyd_round(xt, ct)[0].cpu().numpy()
    np.testing.assert_array_equal(idx, kb_idx)
    _onehot_check(x, idx, sums, counts, k)
    np.testing.assert_array_equal(counts.sum(-1), np.full(b, n))
    if dup:
        assert not np.isin(idx, [7, k - 1]).any()


@pytest.mark.cuda
def test_fit_on_card_launches_the_grouped_kernel(cuda):
    x, _ = _data(8, 4000, 16, 1, 8)
    xt = torch.from_numpy(x).to(cuda)
    _kernels.reset_launches()
    res = kmeans.fit(xt, 16, torch.Generator("cuda").manual_seed(4))
    assert _kernels.LAUNCHES["lloyd_grouped"] >= int(res.rounds.max())
    assert _kernels.LAUNCHES["lloyd_round"] == 0
    ref = kmeans.fit(xt, 16, torch.Generator("cuda").manual_seed(4),
                     impl="round")

    def inertia(r):
        cents = r.centroids.cpu().numpy()
        idx = r.indices.cpu().numpy()
        return sum(float(((x[b] - cents[b][idx[b]]) ** 2).sum())
                   for b in range(8))

    assert inertia(res) <= 1.02 * inertia(ref) + 1e-3
