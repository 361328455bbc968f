"""The bucketed top-k, ``csrc/bucketed_topk.cu``, and its plain version.

:func:`bucketed_topk` takes ``vdist [G, L]`` f32, the ADC keys of ``G =
B·nprobe`` gather cells as K-A writes them (cell ``b·nprobe + j`` is query
``b``'s ``j``-th probe), ``lengths [G]`` int32 the cells' fill counts,
``bidx [G]`` int32 the cells' buckets and ``brows [P, L]`` int32 the
buckets' corpus rows, and returns ``(dist [B, kk] f32, flat_idx [B, kk]
int64, rows [B, kk] int32)``: the first ``kk`` of ``torch.sort(vdist
.reshape(B, nprobe·L), dim=1, stable=True)`` (keys ascending, equal keys
by the lower flat index ``j·L + slot``, ``lax.top_k``'s rule) and each
entry's row ``brows[bidx[b·nprobe + j], slot]``. Slots at or past
``lengths[g]`` must hold ``+inf``, as K-A writes them.

On a CPU tensor it runs :func:`bucketed_topk_plain`, that stable sort. On
a CUDA tensor it launches the kernel, which reads only the slots below
``lengths[g]`` and gives the same bits (−0 ties +0 and keeps its sign),
for ``kk`` up to :data:`KERNEL_MAX_K` and ``nprobe·L`` up to 2³²; above
either it runs the stable sort on the card. NaN keys are outside the
contract. The counters ``bucketed.topk_kernel`` and ``bucketed.topk_sort``
count the queries each route took. The source note on what bounds the
kernel and how its design answers is at the top of the ``.cu`` file.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..utils.profiling import count

#: The largest ``kk`` the kernel takes (its second stage sorts the winners
#: in one block); a larger one takes the stable sort.
KERNEL_MAX_K = 1024
#: The most slots a query the kernel takes (its flat indices are 32-bit).
KERNEL_MAX_SLOTS = 1 << 32


def kernel_takes(kk: int, slots: int) -> bool:
    """Whether the kernel takes ``kk`` of ``slots = nprobe·L`` a query on
    the card (the route by shape; the stable sort takes the rest)."""
    return 0 < kk <= KERNEL_MAX_K and slots <= KERNEL_MAX_SLOTS


def bucketed_topk_plain(vdist: torch.Tensor, lengths: torch.Tensor,
                        bidx: torch.Tensor, brows: torch.Tensor, *,
                        nprobe: int, kk: int,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stable sort of every slot and the index arithmetic on its first
    ``kk`` (``lengths`` is not read: the pad slots' keys are ``+inf``)."""
    g, l = vdist.shape
    b = g // nprobe
    best = torch.sort(vdist.reshape(b, nprobe * l), dim=1, stable=True)
    dist, flat_idx = best.values[:, :kk], best.indices[:, :kk]
    bucket = bidx.reshape(b, nprobe).gather(1, flat_idx // l).long()
    rows = brows.reshape(-1)[bucket * l + flat_idx % l]
    return dist, flat_idx, rows


def _check(vdist, lengths, bidx, brows, nprobe: int, kk: int) -> None:
    if vdist.ndim != 2:
        raise ValueError(f"vdist must be [G, L], got {tuple(vdist.shape)}")
    g, l = vdist.shape
    if nprobe < 1 or g % nprobe:
        raise ValueError(f"G={g} is not a multiple of nprobe={nprobe}")
    if not 0 <= kk <= nprobe * l:
        raise ValueError(f"kk={kk} is outside [0, nprobe·L={nprobe * l}]")
    for name, t in (("lengths", lengths), ("bidx", bidx)):
        if t.shape != (g,):
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != (G,) = ({g},)")
    if brows.ndim != 2 or brows.shape[1] != l:
        raise ValueError(
            f"brows shape {tuple(brows.shape)} != (P, L) with L={l}")
    want = {"vdist": (vdist, torch.float32), "lengths": (lengths, torch.int32),
            "bidx": (bidx, torch.int32), "brows": (brows, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != vdist.device:
            raise ValueError(f"{name} is on {t.device}, vdist on "
                             f"{vdist.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(vdist, lengths, bidx, brows, nprobe: int, kk: int,
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Runs the kernel's two stages on checked arguments; one count."""
    g, l = vdist.shape
    b = g // nprobe
    dev = vdist.device
    dist = torch.empty((b, kk), dtype=torch.float32, device=dev)
    flat_idx = torch.empty((b, kk), dtype=torch.int64, device=dev)
    rows = torch.empty((b, kk), dtype=torch.int32, device=dev)
    if b == 0:
        return dist, flat_idx, rows
    lib = _kernels.load()
    entries = lib.fdb_bucketed_topk_scratch(g, l, kk)
    cand = torch.empty((entries,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fdb_bucketed_topk(
            vdist.data_ptr(), lengths.data_ptr(), bidx.data_ptr(),
            brows.data_ptr(), cand.data_ptr(), dist.data_ptr(),
            flat_idx.data_ptr(), rows.data_ptr(), b, nprobe, l, kk,
            _kernels.stream_of(vdist))
    _kernels.check(rc, "bucketed_topk")
    _kernels.launched("bucketed_topk")
    return dist, flat_idx, rows


def bucketed_topk(vdist: torch.Tensor, lengths: torch.Tensor,
                  bidx: torch.Tensor, brows: torch.Tensor, *, nprobe: int,
                  kk: int,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query's ``kk`` best slots; see the module docstring."""
    _check(vdist, lengths, bidx, brows, nprobe, kk)
    b = vdist.shape[0] // nprobe
    if vdist.device.type == "cuda" and kernel_takes(kk,
                                                    nprobe * vdist.shape[1]):
        count("bucketed.topk_kernel", b)
        return _launch(vdist, lengths, bidx, brows, nprobe, kk)
    count("bucketed.topk_sort", b)
    return bucketed_topk_plain(vdist, lengths, bidx, brows, nprobe=nprobe,
                               kk=kk)
