"""K-A, the ADC bucket scan of the PyTorch port
(``flechasdb_tpu_torch.ops.scan``), against the JAX package, and
``adc_lookup``, the same sum over pre-gathered codes, against the JAX
package's ``pallas_scan.adc_lookup(..., interpret=True)`` (which runs
``_lookup_kernel``) at the shapes of ``tests/test_bucketed.py:77-187``.

The same numpy inputs go through the port's plain version and through
the JAX package's ``bucket_scan(impl="gather")`` (the XLA route its own
tests hold the Pallas kernels against) and, where the code rows allow the
DMA pipeline (1, 2, 4 or 8), through ``adc_lookup_indexed(pipeline="dma",
interpret=True)``. The shapes follow ``tests/test_bucketed.py``.

Tolerance: rel 1e-4, abs 1e-5 — sums of D f32 table entries taken in
another order — and ``+inf`` at exactly the same slots.

The CUDA kernel itself runs only on the card: those tests carry the
``cuda`` marker and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flechasdb_tpu.ops.bucketed import bucket_scan
from flechasdb_tpu.ops.pallas_scan import adc_lookup as jax_lookup
from flechasdb_tpu.ops.pallas_scan import adc_lookup_indexed as jax_indexed
from flechasdb_tpu_torch import _kernels
from flechasdb_tpu_torch.ops import scan

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pack(raw, d):
    p, _, l = raw.shape
    packed = np.zeros((p, -(-d // 4), l), np.int32)
    for di in range(d):
        w, b = divmod(di, 4)
        packed[:, w] |= raw[:, di] << (8 * b)
    return packed


def _case(rng, p, d, c, l, g, pack, lengths):
    raw = rng.integers(0, c, (p, d, l)).astype(np.int32)
    resident = _pack(raw, d) if pack else raw
    ftab = rng.standard_normal((g, d * c)).astype(np.float32)
    bidx = rng.integers(0, p, (g,)).astype(np.int32)
    lens = None
    if lengths:
        lens = rng.integers(0, l + 1, (g,)).astype(np.int32)
        lens[0] = 0                  # a fully masked cell
        if g > 1:
            lens[1] = l              # a fully live cell
    return resident, ftab, bidx, lens


def _port(resident, ftab, bidx, lens, d):
    def t(a):
        return None if a is None else torch.from_numpy(a)
    return scan.adc_lookup_indexed(t(resident), t(ftab), t(bidx), t(lens),
                                   d=d).numpy()


def _jax_gather(resident, ftab, bidx, lens, d):
    return np.asarray(bucket_scan(
        jnp.asarray(resident), jnp.asarray(ftab), jnp.asarray(bidx),
        None if lens is None else jnp.asarray(lens), d=d, impl="gather"))


def _assert_close(got, want, msg=""):
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want),
                                  err_msg=msg)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL,
                               err_msg=msg)


# (p, d, c, l, g): test_bucketed.py:196 and :238 (ragged G), :258 (L over
# several tiles), :110 (C=200, D not a multiple of 4), :99 (C below and
# above one 128-lane vreg), and the headline's D=12, C=256.
_SHAPES = [(6, 8, 256, 384, 10), (6, 8, 256, 384, 11), (3, 4, 64, 4608, 5),
           (7, 5, 200, 256, 9), (7, 2, 200, 256, 9), (5, 4, 25, 256, 6),
           (5, 4, 300, 256, 6), (20, 12, 256, 2048, 24)]
_CASES = [(s, pack, lengths) for s in _SHAPES for pack in (False, True)
          for lengths in (False, True) if not (pack and s[2] > 256)]


@pytest.mark.parametrize("shape,pack,lengths", _CASES)
def test_plain_matches_jax_gather(shape, pack, lengths):
    p, d, c, l, g = shape
    args = _case(np.random.default_rng(sum(shape)), p, d, c, l, g, pack,
                 lengths)
    _assert_close(_port(*args, d), _jax_gather(*args, d))


# Code rows the JAX package's interpreted DMA pipeline accepts: unpacked
# D in {1, 2, 4, 8}, packed D in {4, 8, 16, 32} (rows = ceil(D/4)).
@pytest.mark.parametrize("d,pack", [(1, False), (2, False), (4, False),
                                    (8, False), (4, True), (8, True),
                                    (16, True), (32, True)])
def test_plain_matches_jax_dma_pipeline(d, pack):
    args = _case(np.random.default_rng(d), 4, d, 256, 384, 7, pack, True)
    want = np.asarray(jax_indexed(
        *[jnp.asarray(a) for a in args], d=d, pipeline="dma",
        interpret=True))
    _assert_close(_port(*args, d), want)


def test_plain_matches_jax_randomized_shapes():
    """The randomized-shape fuzz of ``test_bucketed.py:361``, held against
    the JAX gather route."""
    rng = np.random.default_rng(88)
    for _ in range(10):
        d = int(rng.choice([2, 4, 5, 8, 9, 12, 16]))
        c = int(rng.choice([16, 64, 200, 256]))
        l = 128 * int(rng.choice([1, 2, 3, 4, 6, 8]))
        p = int(rng.integers(2, 9))
        g = int(rng.integers(1, 20))
        pack = bool(rng.integers(0, 2))
        args = _case(rng, p, d, c, l, g, pack, bool(rng.integers(0, 2)))
        _assert_close(_port(*args, d), _jax_gather(*args, d),
                      msg=str((d, c, l, p, g, pack)))


def test_packed_sign_byte_reads_unsigned():
    """Codes >= 128 in byte 3 set the int32 sign bit; they must still read
    as their byte value."""
    raw = np.full((1, 4, 128), 255, np.int32)
    raw[0, :, 1::2] = 128
    ftab = np.tile(np.arange(256, dtype=np.float32), 4)[None]
    got = _port(_pack(raw, 4), ftab, np.zeros(1, np.int32), None, 4)
    assert (_pack(raw, 4) < 0).all()
    np.testing.assert_array_equal(got[0, ::2], 4 * 255.0)
    np.testing.assert_array_equal(got[0, 1::2], 4 * 128.0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args = _case(np.random.default_rng(1), 3, 4, 16, 128, 4, True, True)
    before = dict(_kernels.LAUNCHES)
    _port(*args, 4)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("bad,err", [
    ("codes_dtype", TypeError), ("ftab_dtype", TypeError),
    ("rows", ValueError), ("bidx_shape", ValueError),
    ("lengths_shape", ValueError), ("noncontiguous", ValueError)])
def test_wrapper_rejects_bad_arguments(bad, err):
    resident, ftab, bidx, lens = _case(np.random.default_rng(2), 3, 8, 16,
                                       128, 4, False, True)
    t = {"bcodes": torch.from_numpy(resident), "ftab": torch.from_numpy(ftab),
         "bidx": torch.from_numpy(bidx), "lengths": torch.from_numpy(lens)}
    d = 8
    if bad == "codes_dtype":
        t["bcodes"] = t["bcodes"].long()
    elif bad == "ftab_dtype":
        t["ftab"] = t["ftab"].double()
    elif bad == "rows":
        d = 5
        t["ftab"] = torch.zeros((4, 5 * 16))
    elif bad == "bidx_shape":
        t["bidx"] = t["bidx"][:3]
    elif bad == "lengths_shape":
        t["lengths"] = t["lengths"][:2]
    else:
        t["bcodes"] = t["bcodes"].transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises(err):
        scan.adc_lookup_indexed(t["bcodes"], t["ftab"], t["bidx"],
                                t["lengths"], d=d)


# (g, d, c, l): test_bucketed.py:99 (C below and above one vreg), :196
# (L over several tiles), :213 and :228 (ragged cell groups), :239 (D=8,
# C=256), C=200 with D not a multiple of 4, and the roofline's SIFT shape.
_LOOKUP = [(6, 4, 25, 256), (6, 4, 300, 256), (2, 4, 64, 4352),
           (13, 4, 64, 256), (21, 4, 64, 256), (10, 8, 256, 384),
           (9, 5, 200, 256), (64, 8, 256, 1280)]


def _lookup_case(g, d, c, l, pack):
    rng = np.random.default_rng(g * d + c + l)
    raw = rng.integers(0, c, (g, d, l)).astype(np.int32)
    ftab = rng.standard_normal((g, d * c)).astype(np.float32)
    return (_pack(raw, d) if pack else raw), ftab, raw


@pytest.mark.parametrize("shape,pack", [(s, p) for s in _LOOKUP
                                        for p in (False, True)
                                        if not (p and s[2] > 256)])
def test_adc_lookup_plain_matches_jax_lookup_kernel(shape, pack):
    g, d, c, l = shape
    codes, ftab, raw = _lookup_case(g, d, c, l, pack)
    got = scan.adc_lookup(torch.from_numpy(codes), torch.from_numpy(ftab),
                          d=d).numpy()
    want = np.asarray(jax_lookup(jnp.asarray(codes), jnp.asarray(ftab),
                                 d=d, interpret=True))
    _assert_close(got, want)
    ref = ftab.reshape(g, d, c)[np.arange(g)[:, None, None],
                                np.arange(d)[None, :, None], raw].sum(1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got, scan.adc_lookup_plain(torch.from_numpy(codes),
                                   torch.from_numpy(ftab), d=d).numpy())


def test_adc_lookup_checks_and_counts_nothing_on_cpu():
    codes, ftab, _ = _lookup_case(3, 8, 16, 256, False)
    before = dict(_kernels.LAUNCHES)
    out = scan.adc_lookup(torch.from_numpy(codes), torch.from_numpy(ftab))
    assert out.shape == (3, 256) and _kernels.LAUNCHES == before
    # L not a multiple of 128 and code rows that fit no D: the JAX
    # package's two checks, with its error type.
    for bad, kw in [(codes[:, :, :200], {}), (codes[:, :3], {"d": 8})]:
        a = np.ascontiguousarray(bad)
        with pytest.raises(ValueError) as got:
            scan.adc_lookup(torch.from_numpy(a), torch.from_numpy(ftab), **kw)
        with pytest.raises(ValueError) as want:
            jax_lookup(jnp.asarray(a), jnp.asarray(ftab), interpret=True,
                       **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):            # a table for every cell
        scan.adc_lookup(torch.from_numpy(codes[:2].copy()),
                        torch.from_numpy(ftab))


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,c,l,pack", [(640, 8, 256, 1280, False),
                                          (640, 8, 256, 1280, True),
                                          (9, 5, 200, 256, False),
                                          (37, 12, 256, 2048, True)])
def test_adc_lookup_matches_plain_on_card(cuda, g, d, c, l, pack):
    codes, ftab, _ = _lookup_case(g, d, c, l, pack)
    ct, ft = torch.from_numpy(codes).to(cuda), torch.from_numpy(ftab).to(cuda)
    before = dict(_kernels.LAUNCHES)
    got = scan.adc_lookup(ct, ft, d=d)
    assert _kernels.LAUNCHES["adc_lookup"] == before["adc_lookup"] + 1
    assert _kernels.LAUNCHES["adc_scan"] == before["adc_scan"]
    want = scan.adc_lookup_plain(ct, ft, d=d)
    torch.cuda.synchronize()
    _assert_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,pack,l", [(12, 256, True, 2048),
                                        (8, 256, True, 3072),
                                        (12, 200, False, 2048),
                                        (5, 64, True, 384),
                                        (4, 300, False, 4608)])
def test_kernel_matches_plain_on_card(cuda, d, c, pack, l):
    args = _case(np.random.default_rng(d * c), 9, d, c, l, 37, pack, True)
    t = [None if a is None else torch.from_numpy(a).to(cuda) for a in args]
    before = _kernels.LAUNCHES["adc_scan"]
    got = scan.adc_lookup_indexed(*t, d=d)
    assert _kernels.LAUNCHES["adc_scan"] == before + 1
    want = scan.adc_lookup_indexed_plain(*t, d=d)
    torch.cuda.synchronize()
    _assert_close(got.cpu().numpy(), want.cpu().numpy())
