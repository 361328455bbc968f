"""K-C fast's host side in the PyTorch port (``flechasdb_tpu_torch.ops.
lloyd``: ``stage_grouped_centroids`` and ``grouped_fast_tiling``), against
the JAX package where it has a counterpart.

The kernel (``csrc/lloyd_grouped_fast.cu``) multiplies bf16 centroids that
the wrapper stages once a round as ``cs [G, Kp, 128]``: row k of group j
holds the k-th centroid of each of the group's divisions side by side.
That is the TPU kernel's block-diagonal operand ``bdhi [G, g·Kp', 128]``
(``flechasdb_tpu/ops/pallas_kmeans.py:266-277``, made outside its grid)
with its zeros compacted away, so the staging must be bit-equal to
``bdhi``'s diagonal blocks, taken from the JAX function itself on the same
numpy inputs, with zeros in the pad divisions and past K and ``‖c‖² =
+inf`` there, so that a padded centroid never wins. ``grouped_fast_tiling``
decides the kernel's row blocks, passes, ring and shared memory from the
shape alone; its block must fit the H100's 232,448 bytes at every shape
the build's paths, ``chip_smoke.py`` and the card tests give it. The
kernel itself runs only on the card: ``tests/test_torch_fastmath.py``'s
``cuda`` tests hold it against the plain fast round and K-B fast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu.ops import pallas_kmeans
from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch.ops import lloyd

SMEM_MAX = 232_448

# (B, N, K, m): the SIFT PQ fit, chip_smoke.py's phase-1 shapes, the card
# tests' shapes and a few off the paths.
GROUPED_SHAPES = {
    "sift_pq": (8, 1_000_000, 256, 16),
    "gist_pq": (60, 100_000, 256, 16),
    "gist_pq_1m": (60, 1_000_000, 256, 16),
    "m8": (16, 100_000, 256, 8),
    "m32": (4, 100_000, 256, 32),
    "m64_k300": (2, 100_000, 300, 64),
    "dup_k1024": (8, 100_000, 1024, 16),
    "sift_opq": (8, 1_000_000, 256, 16),
    "card_5000": (8, 5000, 256, 16),
    "card_b60": (60, 1000, 256, 16),
    "card_m8": (16, 3000, 256, 8),
    "card_m64": (3, 2000, 300, 64),
    "card_k9": (10, 777, 9, 16),
    "card_k1": (4, 300, 1, 8),
    "card_k4096": (2, 1000, 4096, 16),
    "card_n1": (8, 1, 256, 16),
    "card_n1001": (4, 1001, 256, 32),
    "card_b5_m8": (5, 2000, 256, 8),
    "fit_m16": (8, 500, 16, 16),
    "fast_fit": (200, 4, 16, 16),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _centroids(b, k, m, seed):
    """Normal draws, with every 5th value moved halfway between two bf16
    neighbours, so that round-to-nearest-even decides it."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    bits = c.view(np.uint32)
    bits[..., ::5] = (bits[..., ::5] & np.uint32(0xFFFF0000)) \
        | np.uint32(0x8000)
    return c


def _jax_bdhi(c: np.ndarray, n: int = 16):
    """The block-diagonal bf16 centroids and the norms that the JAX
    package's ``lloyd_round_grouped(fast_math=True)`` hands its Pallas
    kernel for ``c``: the kernel call is replaced by one that records its
    operands (eagerly, under ``jax.disable_jit``)."""
    b, k, m = c.shape
    g = 128 // m
    seen = []

    def record(kernel, *, out_shape, **kwargs):
        def call(*args):
            seen.append([np.asarray(a) for a in args])
            return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
        return call

    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    xg = pallas_kmeans.regroup_divisions(jnp.asarray(x))
    orig = pallas_kmeans.pl.pallas_call
    pallas_kmeans.pl.pallas_call = record
    try:
        with jax.disable_jit():
            pallas_kmeans.lloyd_round_grouped(xg, jnp.asarray(c),
                                              fast_math=True)
    finally:
        pallas_kmeans.pl.pallas_call = orig
    _, bdhi, _, cc = seen[0]
    gg = -(-b // g)
    kpj = bdhi.shape[1] // g
    return bdhi.reshape(gg, g, kpj, 128), cc.reshape(gg, g, kpj), kpj


@pytest.mark.parametrize("b,k,m", [(8, 256, 16), (60, 256, 16),
                                   (16, 256, 8), (4, 256, 32), (2, 300, 64),
                                   (8, 1, 16), (2, 4096, 16), (5, 7, 8)])
def test_staging_is_bit_equal_to_jax_block_diagonal(b, k, m):
    c = _centroids(b, k, m, seed=b * k + m)
    tiling = lloyd.grouped_fast_tiling(b, 1000, k, m)
    cs, _ = lloyd.stage_grouped_centroids(torch.from_numpy(c), tiling)
    bdhi, _, kpj = _jax_bdhi(c)
    g = 128 // m
    bits = bdhi.view(np.uint16)
    for i in range(g):
        cols = slice(i * m, (i + 1) * m)
        # Division i of each group: its diagonal block; elsewhere zeros
        # (signed: the JAX package multiplies by an identity), which the
        # compacted rows leave out.
        np.testing.assert_array_equal(_bits(cs[:, :k, cols]),
                                      bits[:, i, :k, cols])
        off = np.ones(128, bool)
        off[cols] = False
        assert not (bits[:, i][..., off] & 0x7FFF).any()
    assert kpj >= k and not (bits[:, :, k:] & 0x7FFF).any()


@pytest.mark.parametrize("b,k,m", [(8, 256, 16), (16, 100, 8), (3, 300, 64)])
def test_staged_norms_match_jax_within_f32_order(b, k, m):
    """The norms of the f32 centroids: the JAX package's ``cc`` up to the
    order of an f32 sum of m squares; +inf past K in both."""
    c = _centroids(b, k, m, seed=k)
    tiling = lloyd.grouped_fast_tiling(b, 1000, k, m)
    _, ccp = lloyd.stage_grouped_centroids(torch.from_numpy(c), tiling)
    _, cc, _ = _jax_bdhi(c)
    want = cc.reshape(-1, cc.shape[-1])[:b, :k]
    np.testing.assert_allclose(ccp[:b, :k].numpy(), want,
                               rtol=m * 2.0 ** -23)
    np.testing.assert_array_equal(
        ccp[:b, :k].numpy(), (torch.from_numpy(c) ** 2).sum(-1).numpy())


@pytest.mark.parametrize("b,k,m", [(5, 129, 8), (60, 3, 16), (3, 256, 32),
                                   (1, 65, 64), (9, 64, 16)])
def test_staging_pads_zeros_and_infinite_norms(b, k, m):
    c = _centroids(b, k, m, seed=7)
    t = lloyd.grouped_fast_tiling(b, 1000, k, m)
    cs, ccp = lloyd.stage_grouped_centroids(torch.from_numpy(c), t)
    g = 128 // m
    assert cs.dtype == torch.bfloat16 and ccp.dtype == torch.float32
    assert cs.shape == (t.groups, t.kp, 128)
    assert ccp.shape == (t.groups * g, t.kp)
    assert not _bits(cs[:, k:]).any()
    # The pad divisions of the last group.
    pad = t.groups * g - b
    if pad:
        assert not _bits(cs[-1, :, (g - pad) * m:]).any()
    assert torch.isinf(ccp[:, k:]).all() and (ccp[:, k:] > 0).all()
    assert torch.isinf(ccp[b:]).all() and (ccp[b:] > 0).all()
    assert torch.isfinite(ccp[:b, :k]).all()
    # Division d sits in group d // g, columns (d % g)·m …
    for d in range(b):
        got = cs[d // g, :k, (d % g) * m:(d % g + 1) * m]
        assert torch.equal(got, torch.from_numpy(c[d]).to(torch.bfloat16))


@pytest.mark.parametrize("shape", sorted(GROUPED_SHAPES))
def test_grouped_fast_tiling_fits_the_block_and_the_kernel(shape):
    b, n, k, m = GROUPED_SHAPES[shape]
    t = lloyd.grouped_fast_tiling(b, n, k, m)
    assert t == lloyd.grouped_fast_tiling(b, n, k, m)
    assert t.smem <= SMEM_MAX
    # The kernel's layout: 1 KB of alignment slack, the x slot of three
    # bands of 64 rows of 128 floats, `stages` ring slots of a 64-centroid
    # tile of 128 bf16 columns, two barriers each and the x slot's.
    assert t.rows == 192 and t.stages == 8
    assert t.smem == 1024 + 3 * 64 * 128 * 4 + t.stages * 64 * 128 * 2 \
        + (2 + 2 * t.stages) * 8
    g = 128 // m
    assert t.g == g and t.groups == -(-b // g)
    # Four divisions a pass at m <= 16, two above (the running minima a
    # thread holds beside its fragments and two accumulator sets).
    assert t.per_pass == (4 if m <= 16 else 2)
    assert t.per_pass * t.passes == g
    assert t.kp % 64 == 0 and k <= t.kp < k + 64
    assert t.row_blocks == t.groups * -(-n // t.rows)


def test_grouped_fast_tiling_at_the_chip_shapes():
    want = {"sift_pq": (1, 4, 2, 256, 5209), "gist_pq": (8, 4, 2, 256, 4168),
            "gist_pq_1m": (8, 4, 2, 256, 41672),
            "m8": (1, 4, 4, 256, 521), "m32": (1, 2, 2, 256, 521),
            "m64_k300": (1, 2, 1, 320, 521),
            "dup_k1024": (1, 4, 2, 1024, 521)}
    for shape, fields in want.items():
        t = lloyd.grouped_fast_tiling(*GROUPED_SHAPES[shape])
        assert (t.groups, t.per_pass, t.passes, t.kp, t.row_blocks) \
            == fields, shape


@pytest.mark.parametrize("m", [0, 4, 12, 128])
def test_grouped_fast_tiling_refuses_other_widths(m):
    with pytest.raises(ValueError, match="K-C fast takes m"):
        lloyd.grouped_fast_tiling(8, 100, 16, m)


def test_grouped_fast_tiling_reads_no_device_state(monkeypatch):
    before = {s: lloyd.grouped_fast_tiling(*v)
              for s, v in GROUPED_SHAPES.items()}

    def refuse(*args, **kwargs):
        raise AssertionError("the tiling asked the CUDA runtime")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_capability"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    after = {s: lloyd.grouped_fast_tiling(*v)
             for s, v in GROUPED_SHAPES.items()}
    assert after == before


@pytest.mark.parametrize("b,m", [(8, 16), (5, 8), (3, 32)])
def test_cpu_fast_grouped_round_stays_plain_and_counts_nothing(b, m):
    rng = np.random.default_rng(b + m)
    x = torch.from_numpy(rng.standard_normal((b, 300, m)).astype(
        np.float32))
    c = x[:, :10].clone()
    xg = lloyd.regroup_divisions(x)
    before = dict(_kernels.LAUNCHES)
    got = lloyd.lloyd_round_grouped(xg, c, fast_math=True)
    want = lloyd.lloyd_round_grouped_plain(xg, c, fast_math=True)
    assert _kernels.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
