"""Sharded k-means: each rank's Lloyd kernels on its own rows, the sums
added across the mesh (the JAX package's ``parallel/kmeans.py``).

Each rank runs :func:`..ops.kmeans._round_fn` (K-B, or K-C at subvector
widths below 128 that divide it, or their fast variants; then the
cluster-sum pass) on its block of rows. The ``[B, K, M]`` sums and
``[B, K]`` counts are gathered and added in rank order on every rank
(:func:`.mesh.sum_ranks`), so every rank holds bit-equal centroids by
construction: a fit is reproducible for a fixed world size, and a world
of one is bit-equal to :func:`..ops.kmeans.fit` (the same tiling, a rank
sum of one term). Seeding, the means and the convergence rule run
replicated, on the same values on every rank.

Pad rows: none. A rank's block holds only real rows (:func:`.mesh.
row_block`) and each kernel launches on those, so the JAX package's
zero pad rows and its count correction after the ``psum`` have no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import kmeans
from ..ops.kmeans import DEFAULT_EPSILON, MAX_ROUNDS, KMeansResult
from ..utils.profiling import annotate, annotated
from .mesh import CorpusMesh, block_sizes, gather_blocks, gather_rows, \
    sum_ranks


def _local_round_fn(x: torch.Tensor, impl: str, fast: bool):
    """This rank's Lloyd round over its block ``x [B, nloc, M]`` (a block
    may be empty when the world outnumbers the rows)."""
    b, nloc, m = x.shape
    if nloc == 0:
        def empty(c):
            k = c.shape[1]
            return (torch.empty((b, 0), dtype=torch.int32, device=x.device),
                    torch.zeros((b, k, m), device=x.device),
                    torch.zeros((b, k), device=x.device))
        return empty
    return kmeans._round_fn(x, impl, fast)


def _check_block(x: torch.Tensor, n: int, mesh: CorpusMesh) -> None:
    a, b = mesh.block(n)
    if x.shape[1] != b - a:
        raise ValueError(f"rank {mesh.rank} holds {x.shape[1]} rows; its "
                         f"block of {n} is {b - a}")


def fused_round_sharded(round_fn, centroids: torch.Tensor, *,
                        mesh: CorpusMesh,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd round over the mesh: ``round_fn`` this rank's round over
    its block (:func:`_local_round_fn`, the kernel resolved once),
    ``centroids [B, K, M]`` the same on every rank → ``(indices [B,
    nloc], sums [B, K, M], counts [B, K])``, the sums and counts over
    every rank's rows. The assignment alone is ``round_fn(c)[0]``: it
    needs no collective."""
    idx, sums, counts = round_fn(centroids)
    return idx, sum_ranks(mesh, sums), sum_ranks(mesh, counts)


@annotated("fdb.kmeans.fit")
def fit_sharded(x: torch.Tensor, k: int, generator: torch.Generator, *,
                mesh: CorpusMesh, n: int,
                epsilon: float = DEFAULT_EPSILON,
                max_rounds: int = MAX_ROUNDS,
                impl: Optional[str] = None,
                train_cap: Optional[int] = None) -> KMeansResult:
    """:func:`..ops.kmeans.fit` of ``n`` rows over the mesh, ``x [B, nloc,
    M]`` this rank's block of them (:meth:`.mesh.CorpusMesh.block`).

    The same generator stream, convergence rule and ``train_cap`` path as
    the single-device fit: every rank draws the same seeding and cap rows
    from its own identically seeded ``generator`` (on the mesh's device
    type), the owners send those rows bit for bit
    (:func:`.mesh.gather_rows`), and k-means++ runs replicated. An engaged
    ``train_cap`` fits the sample sharded in its own blocks, then assigns
    this rank's rows once. ``indices`` come back as this rank's block;
    ``centroids``, ``rounds`` and ``gradient`` are the same on every rank.
    The kernel is resolved once, against the local block."""
    b, nloc, m = x.shape
    _check_block(x, n, mesh)
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if max_rounds < 1:
        raise ValueError(f"fit_sharded needs max_rounds >= 1: {max_rounds}")
    resolved = kmeans._resolve_impl(impl, x)
    base, fast = kmeans._impl_parts(resolved)
    dev = x.device
    sizes = block_sizes(mesh, n)
    if n == k:
        start = mesh.block(n)[0]
        idx = torch.arange(start, start + nloc, dtype=torch.int32,
                           device=dev).expand(b, nloc)
        return KMeansResult(gather_blocks(mesh, x, sizes, dim=1),
                            idx.contiguous(),
                            torch.zeros(b, dtype=torch.int32, device=dev),
                            torch.zeros(b, dtype=torch.float32, device=dev))
    if train_cap is not None and train_cap > 0 and n > train_cap:
        if train_cap < k:
            raise ValueError(
                f"train_cap is smaller than k: {train_cap} < {k}")
        rows = torch.randint(0, n, (train_cap,),
                             generator=kmeans._split(generator), device=dev)
        a, z = mesh.block(train_cap)
        sample = gather_rows(mesh, x, rows, n)[:, a:z].contiguous()
        sub = fit_sharded(sample, k, generator, mesh=mesh, n=train_cap,
                          epsilon=epsilon, max_rounds=max_rounds,
                          impl=resolved)
        del sample
        with annotate("fdb.kmeans.assign"):
            idx = _local_round_fn(x, base, fast)(sub.centroids)[0]
        return KMeansResult(sub.centroids, idx, sub.rounds, sub.gradient)

    # Seeding: ops.kmeans._subsampled_init's draws on the gathered rows.
    cap = kmeans._seed_cap(k)
    with annotate("fdb.kmeans.seeding"):
        if n <= cap:
            sample = gather_blocks(mesh, x, sizes, dim=1)
        else:
            rows = torch.randint(0, n, (cap,), generator=generator,
                                 device=dev)
            sample = gather_rows(mesh, x, rows, n)
        centroids, _ = kmeans.plusplus_init(sample, k, generator)
        del sample

    round_fn = _local_round_fn(x, base, fast)
    return kmeans.lloyd_loop(
        centroids, torch.zeros((b, nloc), dtype=torch.int32, device=dev),
        lambda c: fused_round_sharded(round_fn, c, mesh=mesh),
        lambda c: round_fn(c)[0], epsilon=epsilon, max_rounds=max_rounds)
