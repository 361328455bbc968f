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
* ``impl`` takes the JAX package's ``_fast`` suffix (:func:`_impl_parts`):
  ``"round_fast"``, ``"grouped_fast"`` or bare ``"_fast"`` (the kernel
  :func:`_auto_impl` picks) run every round and the final reassignment
  with ``fast_math`` numerics, one bf16 pass (:mod:`.lloyd`).
* ``train_cap`` trains on a uniform sample of at most that many rows and
  assigns the full data once afterwards (the JAX package's cap, which
  ``parallel.build`` sets at Deep10M scale).

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
from ..events import EventHandler, _noop
from ..utils.profiling import annotate, annotated
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


def _impl_parts(impl: str | None) -> "tuple[str | None, bool]":
    """Splits the ``_fast`` suffix off an ``impl`` string (the JAX
    package's ``kmeans._impl_parts``): ``"round_fast"`` → ``("round",
    True)``, bare ``"_fast"`` → ``(None, True)`` (the auto kernel with
    fast numerics), ``None`` → ``(None, False)``."""
    if impl is not None and impl.endswith("_fast"):
        return (impl[:-len("_fast")] or None), True
    return impl, False


def _resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    """Auto-resolves the kernel while preserving a ``_fast`` suffix; an
    unknown kernel name raises ``ValueError``."""
    base, fast = _impl_parts(impl)
    if base is None:
        base = _auto_impl(x)
    if base not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r} (expected one of {IMPLS},"
                         " each optionally with the suffix '_fast')")
    return base + "_fast" if fast else base


def _split(generator: torch.Generator) -> torch.Generator:
    """A generator on the same device, seeded by one draw of
    ``generator`` (the JAX package's ``random.split``)."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(generator.device).manual_seed(seed)


def _round_fn(x: torch.Tensor, impl: str, fast: bool):
    """The Lloyd round of a resolved kernel over ``x``: ``c → (indices,
    sums, counts)``; for ``"grouped"`` the data is regrouped here, once."""
    if impl == "grouped":
        xg = regroup_divisions(x)
        return lambda c: lloyd_round_grouped(xg, c, fast)
    return lambda c: lloyd_round(x, c, fast)


@annotated("fdb.kmeans.fit")
def fit(x: torch.Tensor, k: int, generator: torch.Generator, *,
        epsilon: float = DEFAULT_EPSILON, max_rounds: int = MAX_ROUNDS,
        handler: EventHandler = _noop, impl: str | None = None,
        train_cap: int | None = None) -> KMeansResult:
    """k-means++ seeding then Lloyd rounds over ``x [B, N, M]`` f32.

    ``N == k`` is one vector a cluster (``kmeans.rs:158-169``).
    ``handler`` receives the clustering events of the JAX package's
    ``fit_with_events``. ``impl`` picks the round kernel (:data:`IMPLS`;
    ``None`` applies :func:`_auto_impl`; a ``_fast`` suffix selects the
    ``fast_math`` numerics); for ``"grouped"`` the data is regrouped once,
    outside the Lloyd loop, and the final reassignment goes through the
    same kernel.

    ``train_cap`` (``None`` or not positive: no cap): when
    ``N > train_cap``, the fit trains on ``train_cap`` rows drawn
    uniformly with replacement by a generator split off ``generator``,
    then assigns the full ``x`` once against the trained centroids,
    through the rounds' kernel (the JAX package's ``_assign_only`` keeps
    the indices of a full round).
    ``rounds`` and ``gradient`` are the sub-fit's. As in the JAX package,
    an engaged cap returns the assignment made after the final update;
    the stop-before-reassignment rule holds for the sub-fit's own."""
    resolved = _resolve_impl(impl, x)
    impl, fast = _impl_parts(resolved)
    b, n, m = x.shape
    dev = x.device
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if n == k:
        idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
        return KMeansResult(x.clone(), idx.contiguous(),
                            torch.zeros(b, dtype=torch.int32, device=dev),
                            torch.zeros(b, dtype=torch.float32, device=dev))
    if train_cap is not None and train_cap > 0 and n > train_cap:
        if train_cap < k:
            raise ValueError(
                f"train_cap is smaller than k: {train_cap} < {k}")
        rows = torch.randint(0, n, (train_cap,), generator=_split(generator),
                             device=dev)
        sub = fit(x[:, rows].contiguous(), k, generator, epsilon=epsilon,
                  max_rounds=max_rounds, handler=handler, impl=resolved)
        with annotate("fdb.kmeans.assign"):
            idx = _round_fn(x, impl, fast)(sub.centroids)[0]
        return KMeansResult(sub.centroids, idx, sub.rounds, sub.gradient)
    handler(ev.StartingCentroidInitialization())
    with annotate("fdb.kmeans.seeding"):
        centroids, indices = _subsampled_init(x, k, generator,
                                              need_indices=max_rounds == 0)
    handler(ev.FinishedCentroidInitialization())
    if max_rounds == 0:
        return KMeansResult(centroids, indices,
                            torch.zeros(b, dtype=torch.int32, device=dev),
                            torch.full((b,), float("inf"), device=dev))

    round_fn = _round_fn(x, impl, fast)
    return lloyd_loop(centroids, indices, round_fn,
                      lambda c: round_fn(c)[0], epsilon=epsilon,
                      max_rounds=max_rounds, handler=handler)


@annotated("fdb.kmeans.lloyd")
def lloyd_loop(centroids: torch.Tensor, indices: torch.Tensor, round_fn,
               assign_fn, *, epsilon: float, max_rounds: int,
               handler: EventHandler = _noop) -> KMeansResult:
    """The Lloyd rounds from seeded ``centroids [B, K, M]`` (the JAX
    package's ``kmeans.lloyd_loop``, the one home of the convergence and
    freeze rules): ``round_fn(c) → (indices, sums, counts)``, whole sums
    over every row; ``assign_fn(c) → indices`` reassigns the entries that
    exhaust ``max_rounds`` (>= 1). The sharded fit passes rounds whose
    sums cross the mesh."""
    b = centroids.shape[0]
    dev = centroids.device
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    gradient = torch.full((b,), float("inf"), device=dev)
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
        with annotate("fdb.lloyd.sync"):        # the host waits for the round
            all_done = bool(done.all())
            gh = gradient.cpu().numpy() if handler is not _noop else None
        if gh is not None:
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
        fresh = assign_fn(centroids)
        indices = torch.where(done[:, None], indices, fresh)
    return KMeansResult(centroids, indices, rounds, gradient)
