"""The builds of Deep10M-class corpora, on one device and over a mesh
(the JAX package's ``parallel/build.py``).

Both k-means phases train on capped samples: the coarse fit on at most
:data:`COARSE_TRAIN_CAP` rows, through ``ops.kmeans.fit(train_cap=)``,
which then assigns the full corpus once; the PQ fit on the residuals of
at most :data:`PQ_TRAIN_CAP` rows, after which every row's code comes
from :func:`_encode_chunked`, a chunked pass with residuals made a chunk
at a time. The corpus stays the only full-size array on the device.

PyTorch runs eagerly, so the JAX package's two forms, one jitted program
(``_build_fn``) and the host-stepped :func:`build_staged`, are one body
here; :func:`build_staged` also emits the build events. Randomness comes
from three ``torch.Generator`` on the data's device seeded from ``seed``
(the coarse fit, the PQ fit, the PQ sample), in the place of the JAX
package's three-way key split: builds agree with the JAX package's in
quality, not in bits, and two builds with the same seed on the same card
are equal.

Not carried over: ``build_step_donating`` (XLA buffer donation, which
eager PyTorch has no use for) and ``build_staged``'s ``rounds_per_step``
and ``rounds_per_step_max`` (the number of Lloyd rounds fused into one
XLA program; the port's Lloyd loop steps on the host).

:func:`build_sharded` is the same build over a :class:`.mesh.CorpusMesh`,
one rank a process: each rank holds its block of the rows, both fits run
sharded (:func:`.kmeans.fit_sharded`), and the partition indices and codes
are gathered to every rank once, at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import events as ev
from ..events import EventHandler, _noop
from ..ops import kmeans
from ..ops.distance import full_f32
from ..utils.profiling import annotated
from .kmeans import fit_sharded
from .mesh import CorpusMesh, block_sizes, gather_blocks, gather_rows

#: Most rows that train the PQ codebooks (``parallel/build.py:34-41``):
#: codebook quality saturates at a few thousand rows a code, while the
#: ``[D, N, M/D]`` division copy grows with N. Above the cap the
#: codebooks train on a uniform sample and every code comes from
#: :func:`_encode_chunked`.
PQ_TRAIN_CAP = 1 << 20

#: Most rows that train the coarse centroids (``parallel/build.py:43-51``):
#: 512 rows a centroid at P=4096. Above the cap the Lloyd rounds run on a
#: uniform sample and the full corpus gets one final assignment.
COARSE_TRAIN_CAP = 2 << 20


class ShardedBuild(NamedTuple):
    """The build's device tensors: ``partition_centroids [P, M]`` f32,
    ``partition_indices [N]`` (``uint16`` when P <= 65536, else
    ``int32``), ``codebooks [D, C, M/D]`` f32, ``codes [N, D]`` (``uint8``
    when C <= 256, else ``int32``), the JAX package's dtypes."""
    partition_centroids: torch.Tensor
    partition_indices: torch.Tensor
    codebooks: torch.Tensor
    codes: torch.Tensor


def _code_dtype(c: int) -> torch.dtype:
    """Narrowest dtype that holds PQ code values ``0..c-1``."""
    return torch.uint8 if c <= 256 else torch.int32


def _pidx_dtype(p: int) -> torch.dtype:
    """Narrowest dtype that holds partition indices ``0..p-1``."""
    return torch.uint16 if p <= (1 << 16) else torch.int32


@annotated("fdb.encode")
@full_f32()
def _encode_chunked(x: torch.Tensor, cents: torch.Tensor, idx: torch.Tensor,
                    codebooks: torch.Tensor, *,
                    chunk: int = 1 << 16) -> torch.Tensor:
    """PQ codes of the corpus residuals against ``codebooks [D, C, M/D]``:
    ``codes[n, d] = argmin_c ‖c_dc‖² − 2 (x[n] − cents[idx[n]])_d·c_dc``
    (the first minimum), over chunks of ``chunk`` rows whose residuals are
    made a chunk at a time; the last chunk shifts back over rows already
    done, which come out the same. The products run in full f32."""
    n, m = x.shape
    d, c, sub = codebooks.shape
    chunk = min(chunk, n)
    cc = (codebooks * codebooks).sum(dim=-1)                   # [D, C]
    codes = torch.zeros((n, d), dtype=_code_dtype(c), device=x.device)
    for i in range(-(-n // chunk)):
        start = min(i * chunk, n - chunk)
        rows = slice(start, start + chunk)
        r = (x[rows] - cents[idx[rows].long()]).reshape(chunk, d, sub)
        rc = torch.einsum("nds,dcs->ndc", r, codebooks)
        codes[rows] = torch.argmin(cc[None] - 2.0 * rc, dim=-1) \
            .to(codes.dtype)
    return codes


def _pq_impl(impl: Optional[str], sub: int) -> Optional[str]:
    """The PQ fit's ``impl`` from the build's: a forced ``"round"`` (K-B)
    re-resolves to the auto kernel at subvector widths below 128, as the
    JAX package's forced ``"pallas"`` does; other names pass through, and
    a ``_fast`` suffix survives (``ops.kmeans._impl_parts``)."""
    base, fast = kmeans._impl_parts(impl)
    base = None if (base == "round" and sub < 128) else base
    return (base or "") + "_fast" if fast else base


def _sample_residuals(x: torch.Tensor, cents: torch.Tensor,
                      idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return x[rows] - cents[idx[rows].long()]


def _all_residuals(x: torch.Tensor, cents: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    return x - cents[idx.long()]


@annotated("fdb.build")
def build_staged(x, p: int, d: int, c: int, seed: int,
                 events: Optional[EventHandler] = None, *,
                 pq_cap: int = PQ_TRAIN_CAP,
                 coarse_cap: int = COARSE_TRAIN_CAP,
                 impl: Optional[str] = None,
                 device: str | torch.device = "cuda") -> ShardedBuild:
    """Builds the IVF-PQ arrays of ``x [N, M]`` (a tensor or an array; as
    f32 on ``device``): the coarse fit under ``coarse_cap``, the PQ fit on
    at most ``pq_cap`` residuals, then the codes. ``events`` receives the
    clustering events of both fits and the subvector-division pair
    between them, as the JAX package's ``build_staged`` emits them.
    ``impl`` as in ``ops.kmeans.fit``, re-resolved for the PQ fit by
    :func:`_pq_impl`."""
    handler = events if events is not None else _noop
    x = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    n, m = x.shape
    dev = x.device
    g_coarse, g_pq, g_sub = (torch.Generator(dev).manual_seed(seed + i * 2**32)
                             for i in range(3))

    coarse = kmeans.fit(x[None], p, g_coarse, handler=handler, impl=impl,
                        train_cap=coarse_cap)
    cents, idx = coarse.centroids[0], coarse.indices[0]

    handler(ev.StartingSubvectorDivision())
    if n > pq_cap:
        # A uniform sample drawn with replacement: duplicates reweight the
        # objective negligibly at this cap.
        rows = torch.randint(0, n, (pq_cap,), generator=g_sub, device=dev)
        sample = _sample_residuals(x, cents, idx, rows)
    else:
        sample = _all_residuals(x, cents, idx)
    divided = sample.reshape(-1, d, m // d).transpose(0, 1).contiguous()
    del sample
    handler(ev.FinishedSubvectorDivision())

    pq = kmeans.fit(divided, c, g_pq, handler=handler,
                    impl=_pq_impl(impl, m // d))
    del divided
    if n > pq_cap:
        codes = _encode_chunked(x, cents, idx, pq.centroids)
    else:
        # The fit saw every residual: its assignment is the codes, as
        # the JAX package keeps it (a second pass could flip ties).
        codes = pq.indices.T.to(_code_dtype(c))
    return ShardedBuild(cents, idx.to(_pidx_dtype(p)), pq.centroids, codes)


def _build_fn(x, seed: int, *, p: int, d: int, c: int,
              pq_cap: int = PQ_TRAIN_CAP,
              coarse_cap: int = COARSE_TRAIN_CAP,
              impl: Optional[str] = None,
              device: str | torch.device = "cuda") -> ShardedBuild:
    """The one-call build (the JAX package's ``_build_fn``): the arrays of
    :func:`build_staged` for the same arguments, without events."""
    return build_staged(x, p, d, c, seed, pq_cap=pq_cap,
                        coarse_cap=coarse_cap, impl=impl, device=device)


def _encode_sharded(x: torch.Tensor, cents: torch.Tensor, idx: torch.Tensor,
                    codebooks: torch.Tensor, mesh: CorpusMesh,
                    ) -> torch.Tensor:
    """This rank's codes: :func:`_encode_chunked` of its block ``x [nloc,
    M]`` (no collective; an empty block gives no codes)."""
    if x.shape[0] == 0:
        return torch.zeros((0, codebooks.shape[0]),
                           dtype=_code_dtype(codebooks.shape[1]),
                           device=x.device)
    return _encode_chunked(x, cents, idx, codebooks)


@annotated("fdb.build")
def build_sharded(x, p: int, d: int, c: int, seed: int, *,
                  mesh: CorpusMesh, pq_cap: int = PQ_TRAIN_CAP,
                  coarse_cap: int = COARSE_TRAIN_CAP,
                  impl: Optional[str] = None) -> ShardedBuild:
    """The arrays of :func:`_build_fn` for ``x [N, M]``, built over
    ``mesh``. A collective call: every rank passes the same full ``x`` (an
    array or a tensor) and arguments, uploads only its block of the rows
    to ``mesh.device``, and gets the same :class:`ShardedBuild`.

    The generator stream is :func:`_build_fn`'s (three generators on the
    mesh's device seeded from ``seed``), drawn alike on every rank. Each
    rank runs the Lloyd kernels on its own rows; the capped PQ sample's
    rows and partitions come from their owners bit for bit; the codes
    are this rank's (:func:`_encode_sharded`, or the PQ fit's own
    assignment when it saw every residual). The partition indices and
    codes are then gathered to every rank once: N·(4 + D) bytes with
    byte codes. A world of one is bit-equal to :func:`_build_fn` on the
    same device; a wider world's centroids differ from it in the last
    bits (the sums' tiling follows the block's shape)."""
    dev = mesh.device
    n, m = x.shape
    a, z = mesh.block(n)
    xl = torch.as_tensor(x[a:z], dtype=torch.float32, device=dev) \
        .contiguous()
    g_coarse, g_pq, g_sub = (torch.Generator(dev).manual_seed(seed + i * 2**32)
                             for i in range(3))

    coarse = fit_sharded(xl[None], p, g_coarse, mesh=mesh, n=n, impl=impl,
                         train_cap=coarse_cap)
    cents, idx = coarse.centroids[0], coarse.indices[0]
    if n > pq_cap:
        rows = torch.randint(0, n, (pq_cap,), generator=g_sub, device=dev)
        sample = (gather_rows(mesh, xl[None], rows, n)[0]
                  - cents[gather_rows(mesh, idx[None], rows, n)[0].long()])
        s0, s1 = mesh.block(pq_cap)
        sample, n_pq = sample[s0:s1], pq_cap
    else:
        sample, n_pq = _all_residuals(xl, cents, idx), n
    divided = sample.reshape(-1, d, m // d).transpose(0, 1).contiguous()
    del sample
    pq = fit_sharded(divided, c, g_pq, mesh=mesh, n=n_pq,
                     impl=_pq_impl(impl, m // d))
    del divided
    if n > pq_cap:
        codes = _encode_sharded(xl, cents, idx, pq.centroids, mesh)
    else:
        codes = pq.indices.T.to(_code_dtype(c))
    sizes = block_sizes(mesh, n)
    return ShardedBuild(cents, gather_blocks(mesh, idx, sizes)
                        .to(_pidx_dtype(p)), pq.centroids,
                        gather_blocks(mesh, codes.contiguous(), sizes))
