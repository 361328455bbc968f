"""The corpus mesh over ``torch.distributed`` and its collective helpers
(the JAX package's ``parallel/mesh.py``).

The JAX package drives an ``n``-device mesh from one program; its
multi-host form has every process run the same program on the same full
host arrays (``mesh.put_global``). The port follows that form, which is
PyTorch's own idiom: one process a rank (``torchrun``, one rank a GPU),
every sharded entry point a collective call. Every rank calls it with the
same arguments and gets the same full result, as the JAX package's
replicated outputs give; every decision taken on the host is taken from
replicated values, so that no rank waits alone in a collective.

Rank ``r`` owns one contiguous block of rows (:func:`row_block`); a block
holds only real rows, so a kernel never sees a pad row, and pads exist
only in the transport buffers of :func:`gather_blocks` and
:func:`gather_rows` (the JAX package's ``pad_rows`` has no use here).

The backend is a property of the mesh. NCCL carries device tensors; gloo
carries CPU tensors, so on a gloo mesh the helpers here move a CUDA
tensor through host memory and back. They choose by backend and never act
on a failed call: the kernels run on the rank's device either way.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.adc import smallest_k


class CorpusMesh(NamedTuple):
    """A process group seen from one rank: ``group`` (``None`` is the
    default group), this process's ``rank`` in it, the world ``size``,
    the ``device`` its kernels run on and the group's ``backend``."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str

    def block(self, n: int, align: int = 1) -> tuple[int, int]:
        """This rank's ``[start, stop)`` of ``n`` rows (:func:`row_block`)."""
        return row_block(n, self.size, self.rank, align)


def corpus_mesh(group: Optional[dist.ProcessGroup] = None,
                device: str | torch.device | None = None) -> CorpusMesh:
    """The mesh of an initialised process group (the default group unless
    ``group`` is given). ``device`` defaults to ``cuda:LOCAL_RANK``, the
    GPU ``torchrun`` gives this rank (``cuda:0`` without the variable)."""
    if not dist.is_initialized():
        raise ValueError("corpus_mesh needs an initialised process group "
                         "(torch.distributed.init_process_group)")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return CorpusMesh(group, dist.get_rank(group), dist.get_world_size(group),
                      torch.device(device), dist.get_backend(group))


def row_block(n: int, size: int, rank: int, align: int = 1,
              ) -> tuple[int, int]:
    """Rank ``rank``'s ``[start, stop)`` of ``n`` rows split over ``size``
    ranks: whole units of ``align`` rows (the last one short) shared as
    evenly as they go, the lower ranks first. With ``align=1`` every rank
    holds ``n // size`` or one more rows."""
    units = -(-n // align)
    return (min(n, rank * units // size * align),
            min(n, (rank + 1) * units // size * align))


def block_sizes(mesh: CorpusMesh, n: int, align: int = 1) -> list:
    """Every rank's row count under :func:`row_block`."""
    return [b - a for a, b in (row_block(n, mesh.size, r, align)
                               for r in range(mesh.size))]


def shard_corpus(mesh: CorpusMesh, codes: np.ndarray, pidx: np.ndarray,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of PQ ``codes [N, D]`` and partition indices
    ``pidx [N]``, int32 on the mesh's device (narrow build dtypes widen
    here for the scans' gathers)."""
    a, b = mesh.block(len(codes))
    return (torch.as_tensor(np.asarray(codes[a:b], np.int32),
                            device=mesh.device),
            torch.as_tensor(np.asarray(pidx[a:b], np.int32),
                            device=mesh.device))


def shard_mask(mesh: CorpusMesh, mask) -> torch.Tensor:
    """This rank's block of a row mask ``[N] bool``, as
    :func:`shard_corpus` blocks the rows."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    a, b = mesh.block(len(mask))
    return mask[a:b].to(mesh.device)


# -- collectives ----------------------------------------------------------------

def _wire(mesh: CorpusMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend carries it: a contiguous tensor, on the host
    for gloo and on the mesh's device otherwise; bool as uint8, which
    every backend moves."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.to("cpu" if mesh.backend == "gloo" else mesh.device) \
        .contiguous()


def all_gather(mesh: CorpusMesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (equal shapes and dtypes), in rank order, on
    ``t``'s device."""
    src = _wire(mesh, t)
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(t.device, t.dtype) for o in out]


def sum_ranks(mesh: CorpusMesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order on every rank
    (an ``all_reduce`` adds in the library's order): every rank gets the
    same bits, and a world of one gets ``t``'s."""
    parts = all_gather(mesh, t)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def broadcast(mesh: CorpusMesh, t: torch.Tensor, src: int = 0,
              ) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank; the others pass a tensor of the
    same shape and dtype, whose values are ignored."""
    wire = _wire(mesh, t)
    dist.broadcast(wire, src=dist.get_global_rank(mesh.group, src)
                   if mesh.group is not None else src, group=mesh.group)
    return wire.to(t.device, t.dtype)


def gather_blocks(mesh: CorpusMesh, t: torch.Tensor, sizes: list,
                  dim: int = 0) -> torch.Tensor:
    """Every rank's block along ``dim`` (rank ``r``'s of ``sizes[r]``
    entries) concatenated in rank order: the whole of a row-blocked
    array, bit for bit."""
    most = max(sizes)
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, most - t.shape[dim]]
    wire = _wire(mesh, t)
    if most > t.shape[dim]:
        wire = torch.nn.functional.pad(wire, pad)
    parts = all_gather(mesh, wire)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim).to(t.device, t.dtype)


def gather_rows(mesh: CorpusMesh, x: torch.Tensor, rows: torch.Tensor,
                n: int) -> torch.Tensor:
    """``whole[:, rows]`` on every rank, where ``x [B, nloc, ...]`` is this
    rank's block of the rows of ``whole [B, n, ...]`` and ``rows`` (the
    same on every rank) are global row numbers: each owner sends the rows
    it holds, and each row is copied from its owner, never summed."""
    sizes = block_sizes(mesh, n)
    stops = torch.tensor(np.cumsum(sizes)[:-1], dtype=rows.dtype,
                         device=rows.device)
    owner = torch.searchsorted(stops, rows, right=True)
    counts = torch.bincount(owner, minlength=mesh.size).tolist()
    start = mesh.block(n)[0]
    mine = rows[owner == mesh.rank] - start
    parts = all_gather(mesh, torch.nn.functional.pad(
        x[:, mine.to(x.device)],
        [0, 0] * (x.ndim - 2) + [0, max(counts) - counts[mesh.rank]]))
    out = torch.empty((x.shape[0], len(rows), *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    for r, part in enumerate(parts):
        if counts[r]:
            at = torch.nonzero(owner == r)[:, 0].to(x.device)
            out[:, at] = part[:, :counts[r]]
    return out


def merge_topk(mesh: CorpusMesh, dists: torch.Tensor, rows: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-best merge every sharded query ends with: each rank's ``k``
    candidates (``dists [B, k]`` ascending, global ``rows [B, k]``) are
    gathered, and the ``k`` smallest of their rank-major concatenation
    kept, the lower position first among equal keys (``lax.top_k``'s rule
    in the JAX package's ``merge_topk``; :func:`..ops.adc.smallest_k`).
    Only ``k`` candidates a rank move. Returns ``(dists [B, k], rows
    [B, k] int32)``."""
    all_d = torch.cat(all_gather(mesh, dists), dim=1)
    all_r = torch.cat(all_gather(mesh, rows.to(torch.int32)), dim=1)
    best, sel = smallest_k(all_d, k)
    return best, all_r.gather(1, sel)
