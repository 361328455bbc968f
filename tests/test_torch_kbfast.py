"""K-B fast's host side in the PyTorch port (``flechasdb_tpu_torch.ops.
lloyd``: ``stage_centroids`` and ``fast_tiling``), against the JAX
package where it has a counterpart.

The kernel (``csrc/lloyd_round_fast.cu``) multiplies bf16 centroids that
the wrapper rounds once a round into a zero-padded ``[B, Kp, Mp]`` buffer,
as the TPU kernel rounds its ``chi`` outside its grid
(``flechasdb_tpu/ops/pallas_kmeans.py:422``): the staging must be bit-equal
to ``centroids.astype(jnp.bfloat16)`` on the same numpy inputs, with zeros
in the padding and ``‖c‖² = +inf`` past K so that a padded centroid never
wins. ``fast_tiling`` decides the kernel's regime, tile pairs, widths,
ring and shared memory from the shape alone; its block must fit the H100's
232,448 bytes at every shape the build's paths, ``chip_smoke.py`` and the
card tests give it. The kernel itself runs only on the card:
``tests/test_torch_fastmath.py``'s ``cuda`` tests hold it against the
plain fast round.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu_torch.ops import lloyd

SMEM_MAX = 232_448

# (B, N, K, M): the fast builds' fits (headline coarse and PQ, SIFT
# coarse), chip_smoke.py's phase-1 shapes and edges, the CLI's fits, the
# card tests' shapes and a few off the paths.
FAST_SHAPES = {
    "headline_coarse": (1, 100_000, 100, 1536),
    "headline_pq": (12, 100_000, 256, 128),
    "sift_coarse": (1, 1_000_000, 1024, 128),
    "gist_coarse": (1, 1_000_000, 1024, 960),
    "k1024": (1, 65_536, 1024, 128),
    "cli_coarse": (1, 5000, 10, 1024),
    "cli_pq": (8, 5000, 25, 128),
    "edge_m256": (2, 20_000, 256, 256),
    "edge_m264": (1, 20_000, 257, 264),
    "edge_k257": (2, 30_000, 257, 128),
    "edge_n1": (3, 1, 100, 128),
    "m192": (3, 3000, 257, 192),
    "m100_k300": (2, 4133, 300, 100),
    "m5_k1": (2, 129, 1, 5),
    "m12_k7": (3, 517, 7, 12),
    "m24_k16": (1, 1000, 16, 24),
    "fit_m16": (8, 500, 16, 16),
    "k4096_m16": (2, 1000, 4096, 16),
    "m2048": (1, 3000, 1000, 2048),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _centroids(b, k, m, seed):
    """Normal draws, with every 5th value moved halfway between two bf16
    neighbours, so that round-to-nearest-even decides it."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    bits = c.view(np.uint32)
    bits[..., ::5] = (bits[..., ::5] & np.uint32(0xFFFF0000)) \
        | np.uint32(0x8000)
    return c


@pytest.mark.parametrize("b,k,m", [(1, 100, 1536), (12, 256, 128),
                                   (3, 7, 12), (2, 257, 264), (1, 1, 5)])
def test_staging_is_bit_equal_to_jax_astype_bfloat16(b, k, m):
    c = _centroids(b, k, m, seed=b * k + m)
    tiling = lloyd.fast_tiling(b, 1000, k, m)
    cs, _ = lloyd.stage_centroids(torch.from_numpy(c), tiling)
    want = np.asarray(jnp.asarray(c).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(_bits(cs[:, :k, :m]), want)


@pytest.mark.parametrize("b,k,m", [(2, 129, 70), (1, 3, 5), (3, 256, 128)])
def test_staging_pads_zeros_and_infinite_norms(b, k, m):
    c = _centroids(b, k, m, seed=7)
    tiling = lloyd.fast_tiling(b, 1000, k, m)
    cs, ccp = lloyd.stage_centroids(torch.from_numpy(c), tiling)
    assert cs.dtype == torch.bfloat16 and ccp.dtype == torch.float32
    assert cs.shape == (b, tiling.kp, tiling.mp)
    assert ccp.shape == (b, tiling.kp)
    assert not _bits(cs[:, k:]).any() and not _bits(cs[:, :, m:]).any()
    assert torch.isinf(ccp[:, k:]).all() and (ccp[:, k:] > 0).all()
    # ‖c‖² of the f32 centroids, as the plain round and the TPU kernel.
    np.testing.assert_array_equal(
        ccp[:, :k].numpy(), (torch.from_numpy(c) ** 2).sum(-1).numpy())


@pytest.mark.parametrize("shape", sorted(FAST_SHAPES))
def test_fast_tiling_fits_the_block_and_the_kernel(shape):
    b, n, k, m = FAST_SHAPES[shape]
    t = lloyd.fast_tiling(b, n, k, m)
    assert t == lloyd.fast_tiling(b, n, k, m)
    assert t.smem <= SMEM_MAX
    # The kernel's layout: 1 KB of alignment slack, the x slot of three
    # bands of `chunk` f32 columns, `stages` ring slots of a 64-centroid
    # tile's chunk in bf16, two barriers each and the x slot's.
    assert t.rows == 192
    assert t.smem == (1024 + 3 * 64 * t.chunk * 4
                      + t.stages * 64 * t.chunk * 2 + (2 + 2 * t.stages) * 8)
    assert t.stages == 8
    assert t.kp % 128 == 0 and k <= t.kp < k + 128
    assert t.mp % 64 == 0 and m <= t.mp < m + 64
    assert t.row_blocks == b * -(-n // t.rows)
    # What fdb_lloyd_round_fast accepts.
    if t.regime == "resident":
        assert t.mp <= 128 and t.chunk == t.mp
    else:
        assert t.regime == "chunked" and t.mp > 128 and t.chunk == 128


def test_fast_tiling_at_the_chip_shapes():
    want = {"headline_coarse": ("chunked", 128, 1536, 128),
            "headline_pq": ("resident", 256, 128, 128),
            "sift_coarse": ("resident", 1024, 128, 128),
            "gist_coarse": ("chunked", 1024, 960, 128),
            "k1024": ("resident", 1024, 128, 128),
            "edge_m256": ("chunked", 256, 256, 128),
            "edge_m264": ("chunked", 384, 320, 128),
            "m24_k16": ("resident", 128, 64, 64)}
    for shape, (regime, kp, mp, chunk) in want.items():
        t = lloyd.fast_tiling(*FAST_SHAPES[shape])
        assert (t.regime, t.kp, t.mp, t.chunk) == (regime, kp, mp, chunk), \
            shape
    assert lloyd.fast_tiling(*FAST_SHAPES["sift_coarse"]).row_blocks == 5209


def test_fast_tiling_reads_no_device_state(monkeypatch):
    before = {s: lloyd.fast_tiling(*v) for s, v in FAST_SHAPES.items()}

    def refuse(*args, **kwargs):
        raise AssertionError("the tiling asked the CUDA runtime")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_capability"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    after = {s: lloyd.fast_tiling(*v) for s, v in FAST_SHAPES.items()}
    assert after == before


def test_cpu_fast_round_stays_plain_and_counts_nothing():
    from flechasdb_tpu_torch import _kernels
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 300, 24)).astype(
        np.float32))
    c = x[:, :10].clone()
    before = dict(_kernels.LAUNCHES)
    got = lloyd.lloyd_round(x, c, fast_math=True)
    want = lloyd.lloyd_round_plain(x, c, fast_math=True)
    assert _kernels.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
