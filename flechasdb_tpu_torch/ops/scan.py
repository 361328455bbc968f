"""K-A: the ADC bucket scan, ``csrc/adc_scan.cu``, and its plain version.

:func:`adc_lookup_indexed` keeps the signature of the JAX package's
``ops/pallas_scan.adc_lookup_indexed``: ``bcodes [P, D or ceil(D/4), L]``
int32 resident buckets (packed when the row count is not ``D``), ``ftab
[G, D*C]`` f32 one table per gather cell, ``bidx [G]`` int32 bucket per
cell, optional ``lengths [G]`` int32 fill counts → ``[G, L]`` f32 with
``out[g, l] = Σ_d ftab[g, d*C + code(bcodes[bidx[g]], d, l)]`` and ``+inf``
at ``l >= lengths[g]``.

On a CUDA tensor it launches the kernel; on a CPU tensor it runs
:func:`adc_lookup_indexed_plain`, the gather-and-sum of the JAX package's
``bucket_scan(impl="gather")``. The source note on what bounds the kernel
and how its design answers is at the top of ``csrc/adc_scan.cu``.

:func:`adc_lookup` keeps the contract of the JAX package's
``pallas_scan.adc_lookup``, the same sum over PRE-gathered codes ``[G,
D or ceil(D/4), L]``. On a CUDA tensor it runs K-A with the identity
bucket index and no lengths, as the JAX package runs it on the TPU
(``_pipe_call`` with ``bidx = arange(G)``); it counts its launches apart.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels

#: Largest table the kernel stages in shared memory (227 KB).
MAX_TABLE_BYTES = 232448

#: ``adc_lookup`` takes code rows whose length L is a multiple of this.
LANE = 128


def unpack_codes(words: torch.Tensor, d: int) -> torch.Tensor:
    """``[..., ceil(D/4), L]`` int32 packed words → ``[..., D, L]`` codes
    (division ``d`` in byte ``d % 4``; the mask drops the sign bits an
    arithmetic shift of byte 3 brings in)."""
    ar = torch.arange(d, device=words.device)
    w = words.index_select(-2, ar // 4)
    return (w >> (8 * (ar % 4))[:, None].to(w.dtype)) & 0xFF


def mask_lengths(vdist: torch.Tensor,
                 lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """``vdist[g, l] = +inf`` for ``l >= lengths[g]``."""
    if lengths is None:
        return vdist
    lane = torch.arange(vdist.shape[1], device=vdist.device)
    return vdist.masked_fill(lane[None, :] >= lengths[:, None], float("inf"))


def adc_lookup_indexed_plain(bcodes: torch.Tensor, ftab: torch.Tensor,
                             bidx: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None, *,
                             d: int) -> torch.Tensor:
    """Gather the selected buckets, look the codes up, sum over D."""
    g = ftab.shape[0]
    l = bcodes.shape[2]
    c = ftab.shape[1] // d
    codes = bcodes.index_select(0, bidx.long())           # [G, rows, L]
    if codes.shape[1] != d:
        codes = unpack_codes(codes, d)
    ar = torch.arange(d, device=codes.device, dtype=codes.dtype)
    gidx = codes + ar[None, :, None] * c
    vals = ftab.gather(1, gidx.reshape(g, d * l).long())
    return mask_lengths(vals.reshape(g, d, l).sum(dim=1), lengths)


def _check(bcodes, ftab, bidx, lengths, d: int) -> None:
    p, rows, l = bcodes.shape
    g, dc = ftab.shape
    if rows not in (d, -(-d // 4)):
        raise ValueError(f"codes rows {rows} match neither D={d} nor "
                         f"ceil(D/4)={-(-d // 4)}")
    if dc % d:
        raise ValueError(f"ftab width {dc} is not a multiple of D={d}")
    if bidx.shape != (g,):
        raise ValueError(f"bidx shape {tuple(bidx.shape)} != (G,) = ({g},)")
    if lengths is not None and lengths.shape != (g,):
        raise ValueError(
            f"lengths shape {tuple(lengths.shape)} != (G,) = ({g},)")
    want = {"bcodes": (bcodes, torch.int32), "ftab": (ftab, torch.float32),
            "bidx": (bidx, torch.int32)}
    if lengths is not None:
        want["lengths"] = (lengths, torch.int32)
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != bcodes.device:
            raise ValueError(f"{name} is on {t.device}, bcodes on "
                             f"{bcodes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(bcodes: torch.Tensor, ftab: torch.Tensor, bidx: torch.Tensor,
            lengths: Optional[torch.Tensor], d: int, name: str,
            ) -> torch.Tensor:
    """Runs K-A on checked arguments and counts the launch under
    ``name``."""
    if bcodes.device.type != "cuda":
        raise ValueError(f"unsupported device: {bcodes.device}")
    g, dc = ftab.shape
    rows, l = bcodes.shape[1], bcodes.shape[2]
    if dc * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"table of {dc * 4} bytes exceeds the kernel's "
                         f"{MAX_TABLE_BYTES}-byte shared memory")
    out = torch.empty((g, l), dtype=torch.float32, device=bcodes.device)
    if g == 0 or l == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(bcodes.device):
        rc = lib.fdb_adc_scan(
            bcodes.data_ptr(), ftab.data_ptr(), bidx.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            g, rows, l, d, dc // d, int(rows != d),
            _kernels.stream_of(bcodes))
    _kernels.check(rc, name)
    _kernels.LAUNCHES[name] += 1
    return out


def adc_lookup_indexed(bcodes: torch.Tensor, ftab: torch.Tensor,
                       bidx: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None, *,
                       d: int) -> torch.Tensor:
    """ADC lookup-sum reading buckets in place; see the module docstring."""
    _check(bcodes, ftab, bidx, lengths, d)
    if bcodes.device.type == "cpu":
        return adc_lookup_indexed_plain(bcodes, ftab, bidx, lengths, d=d)
    return _launch(bcodes, ftab, bidx, lengths, d, "adc_scan")


def _identity(codes: torch.Tensor) -> torch.Tensor:
    return torch.arange(codes.shape[0], dtype=torch.int32,
                        device=codes.device)


def adc_lookup_plain(codes: torch.Tensor, ftab: torch.Tensor, *,
                     d: Optional[int] = None) -> torch.Tensor:
    """:func:`adc_lookup_indexed_plain` with bucket ``g`` for cell ``g``."""
    return adc_lookup_indexed_plain(codes, ftab, _identity(codes),
                                    d=codes.shape[1] if d is None else d)


def adc_lookup(codes: torch.Tensor, ftab: torch.Tensor, *,
               d: Optional[int] = None) -> torch.Tensor:
    """ADC lookup-sum over pre-gathered codes ``[G, D or ceil(D/4), L]``
    int32 and ``ftab [G, D*C]`` f32 → ``[G, L]`` f32. ``d`` defaults to
    the code rows (unpacked); ``L`` must be a multiple of 128."""
    g, rows, l = codes.shape
    if d is None:
        d = rows
    if l % LANE:
        raise ValueError(f"L ({l}) must be a multiple of {LANE}")
    if ftab.ndim != 2 or ftab.shape[0] != g:
        raise ValueError(f"ftab shape {tuple(ftab.shape)} != (G, D*C) with "
                         f"G={g}")
    bidx = _identity(codes)
    _check(codes, ftab, bidx, None, d)
    if codes.device.type == "cpu":
        return adc_lookup_plain(codes, ftab, d=d)
    return _launch(codes, ftab, bidx, None, d, "adc_lookup")
