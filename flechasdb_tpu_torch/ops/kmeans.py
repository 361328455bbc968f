"""Batched k-means++ / Lloyd clustering (the JAX package's
``ops/kmeans.py``).

The same semantics, carried over:

* k-means++ seeding on a subsample of at most :func:`_seed_cap` rows,
  each new centroid drawn with probability proportional to the running
  minimum squared distance (clamped :func:`.distance.sqdist`); when every
  weight is zero (all rows identical) the draw is row 0.
* Lloyd rounds through kernel K-B (:func:`.lloyd.lloyd_round`, unclamped
  ``‖c‖² − 2x·c``) or, for subvector widths below 128 that divide it,
  kernel K-C (:func:`.lloyd.lloyd_round_grouped`, see :func:`_auto_impl`);
  the normalized gradient ``max‖Δc‖ / max‖c‖`` stops a
  batch entry below ``epsilon``; a converging entry keeps the assignment
  against its pre-update centroids; entries that exhaust ``max_rounds``
  are reassigned against their final centroids.
* Empty clusters keep their previous centroid.

PyTorch runs eagerly, so one host loop serves the JAX package's ``fit``
and ``fit_with_events``: the events of its ``fit_with_events`` fire when
a handler is given. Randomness comes from an explicit ``torch.Generator``
on the data's device; the draws are not the JAX package's, so fits agree
in quality, not in bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import events as ev
from .._roadmap import not_ported
from ..events import EventHandler, _noop
from .distance import assign_chunked, sqdist_one
from .lloyd import (GROUP_WIDTH, lloyd_round, lloyd_round_grouped,
                    regroup_divisions)

#: Maximum Lloyd rounds (``kmeans.rs:114``).
MAX_ROUNDS = 100

#: Default convergence epsilon for f32 (``kmeans.rs:24-28``).
DEFAULT_EPSILON = 1e-6


class KMeansResult(NamedTuple):
    """``centroids [B, K, M]``, ``indices [B, N]`` int32, ``rounds [B]``
    int32 Lloyd rounds run, ``gradient [B]`` last normalized displacement."""
    centroids: torch.Tensor
    indices: torch.Tensor
    rounds: torch.Tensor
    gradient: torch.Tensor


def plusplus_init(x: torch.Tensor, k: int, generator: torch.Generator,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means++ seeding: ``x [B, N, M]`` → ``(centroids [B, K, M],
    indices [B, N] int32)``, ``indices`` the nearest chosen-so-far
    centroid."""
    b, n, m = x.shape
    dev = x.device
    batch = torch.arange(b, device=dev)
    ci = torch.randint(0, n, (b,), generator=generator, device=dev)
    centroids = torch.zeros((b, k, m), dtype=x.dtype, device=dev)
    centroids[:, 0] = x[batch, ci]
    indices = torch.zeros((b, n), dtype=torch.int32, device=dev)
    if k == 1:
        return centroids, indices
    w = sqdist_one(x, x[batch, ci])                         # [B, N]
    # Chosen rows carry weight 0. scatter_ with a Python scalar launches
    # no host-to-device copy, as indexed assignment of one would.
    w.scatter_(1, ci[:, None], 0.0)
    first = torch.zeros((b, n), dtype=x.dtype, device=dev)
    first[:, 0] = 1.0
    for i in range(1, k):
        # torch.multinomial refuses an all-zero row; draw row 0 there.
        probs = torch.where((w.sum(dim=1) > 0)[:, None], w, first)
        ci = torch.multinomial(probs, 1, generator=generator)[:, 0]
        c = x[batch, ci]
        centroids[:, i] = c
        d = sqdist_one(x, c)
        closer = d < w               # strict <, as in kmeans.rs:215
        w = torch.where(closer, d, w).scatter_(1, ci[:, None], 0.0)
        indices = torch.where(closer, i, indices).to(torch.int32) \
            .scatter_(1, ci[:, None], i)
    return centroids, indices


def _seed_cap(k: int) -> int:
    """Most rows k-means++ seeding draws from (``kmeans._seed_cap``)."""
    return max(4096, 32 * k)


def _subsampled_init(x: torch.Tensor, k: int, generator: torch.Generator,
                     *, need_indices: bool = True,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    b, n, _ = x.shape
    cap = _seed_cap(k)
    if n <= cap:
        return plusplus_init(x, k, generator)
    rows = torch.randint(0, n, (cap,), generator=generator, device=x.device)
    centroids, _ = plusplus_init(x[:, rows].contiguous(), k, generator)
    if not need_indices:
        # The first Lloyd round assigns against these centroids anyway.
        return centroids, torch.zeros((b, n), dtype=torch.int32,
                                      device=x.device)
    indices, _ = assign_chunked(x, centroids)
    return centroids, indices


def _means_grad(sums: torch.Tensor, counts: torch.Tensor,
                old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid means (empty clusters keep ``old``) and the gradient
    ``max_k ‖Δc‖ / max_k ‖c_new‖`` (``kmeans.rs:232-276``)."""
    empty = counts == 0
    mean = sums / torch.where(empty, 1.0, counts)[..., None]
    new = torch.where(empty[..., None], old, mean)
    dist = torch.linalg.vector_norm(old - new, dim=-1).amax(dim=-1)
    max_norm = torch.linalg.vector_norm(new, dim=-1).amax(dim=-1)
    grad = torch.where(max_norm > 0,
                       dist / torch.where(max_norm > 0, max_norm, 1.0), 0.0)
    return new, grad


#: The port's round kernels (``impl=``), by the JAX package's name:
#: ``"round"`` is ``"pallas"`` (K-B), ``"grouped"`` is ``"pallas_grouped"``
#: (K-C). The JAX package's ``"xla"`` formulation is what the plain
#: versions compute on a CPU tensor.
IMPLS = ("round", "grouped")


def _auto_impl(x: torch.Tensor) -> str:
    """The JAX package's ``_auto_impl`` shape rule: on a CUDA tensor,
    ``m < 128`` dividing 128 with ``m >= 8`` takes K-C, anything else K-B.
    A CPU tensor takes K-B's wrapper, which runs the plain version."""
    m = x.shape[2]
    if (x.device.type == "cuda" and m < GROUP_WIDTH
            and GROUP_WIDTH % m == 0 and m >= 8):
        return "grouped"
    return "round"


def _resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    if impl is not None and impl.endswith("_fast"):
        raise not_ported(f"impl={impl!r} (fast_math numerics)", 12)
    if impl is None:
        return _auto_impl(x)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r} (expected one of {IMPLS})")
    return impl


def fit(x: torch.Tensor, k: int, generator: torch.Generator, *,
        epsilon: float = DEFAULT_EPSILON, max_rounds: int = MAX_ROUNDS,
        handler: EventHandler = _noop, impl: str | None = None,
        ) -> KMeansResult:
    """k-means++ seeding then Lloyd rounds over ``x [B, N, M]`` f32.

    ``N == k`` is one vector a cluster (``kmeans.rs:158-169``).
    ``handler`` receives the clustering events of the JAX package's
    ``fit_with_events``. ``impl`` picks the round kernel (:data:`IMPLS`;
    ``None`` applies :func:`_auto_impl`); for ``"grouped"`` the data is
    regrouped once, outside the Lloyd loop, and the final reassignment
    goes through the same kernel."""
    impl = _resolve_impl(impl, x)
    b, n, m = x.shape
    dev = x.device
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if n == k:
        idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
        return KMeansResult(x.clone(), idx.contiguous(),
                            torch.zeros(b, dtype=torch.int32, device=dev),
                            torch.zeros(b, dtype=torch.float32, device=dev))
    handler(ev.StartingCentroidInitialization())
    centroids, indices = _subsampled_init(x, k, generator,
                                          need_indices=max_rounds == 0)
    handler(ev.FinishedCentroidInitialization())
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    gradient = torch.full((b,), float("inf"), device=dev)
    if max_rounds == 0:
        return KMeansResult(centroids, indices, rounds, gradient)

    if impl == "grouped":
        xg = regroup_divisions(x)

        def round_fn(c):
            return lloyd_round_grouped(xg, c)
    else:
        def round_fn(c):
            return lloyd_round(x, c)

    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for r in range(max_rounds):
        idx_f, sums, counts = round_fn(centroids)
        new_c, grad = _means_grad(sums, counts, centroids)
        centroids = torch.where(done[:, None, None], centroids, new_c)
        # A batch entry converging in this round keeps idx_f, the
        # assignment against its PRE-update centroids (kmeans.rs:130-136).
        indices = torch.where(done[:, None], indices, idx_f)
        rounds += (~done).to(torch.int32)
        gradient = torch.where(done, gradient, grad)
        done = done | (grad < epsilon)
        all_done = bool(done.all())
        if handler is not _noop:
            gh = gradient.cpu().numpy()
            handler(ev.StartingCentroidUpdate(r))
            handler(ev.FinishedCentroidUpdate(
                r, gh if b > 1 else float(gh[0])))
        if all_done:
            break
        handler(ev.StartingCentroidReassignment(r))
        handler(ev.FinishedCentroidReassignment(r))
    else:
        # max_rounds exhausted: the carried assignment of unconverged
        # entries predates their final centroid update.
        fresh = round_fn(centroids)[0]
        indices = torch.where(done[:, None], indices, fresh)
    return KMeansResult(centroids, indices, rounds, gradient)
