"""Plain IVF-PQ over squared L2: the search and the build the benchmark's
configurations state, written out in PyTorch with no kernel, cache or
layout of the program's.

Search (:func:`search`): the ``nprobe`` partitions nearest the query, the
ADC key of every row they hold (the sum over divisions of ``‖(q − c_p)_d −
codebook[d, code_d]‖²``), the best ``rerank`` (or ``k``) of them, and,
with ``rerank``, the exact squared distances of those, the best ``k``.
Ties go to the lower corpus row. Squared distances take the expanded
form ``‖a‖² + ‖b‖² − 2 a·b`` with the cross term a matrix product, in the
arithmetic given (:mod:`.arith`).

Build (:func:`build`): k-means++ seeding on a subsample, Lloyd rounds to
convergence or 100 rounds on a capped uniform sample, one assignment of
every row, then per-division k-means on the capped residuals and the codes
of every row: the semantics of the flechasdb build, with the reference's
own random draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .arith import F64, Arith

MAX_ROUNDS = 100
EPSILON = 1e-6
COARSE_CAP = 2 << 20
PQ_CAP = 1 << 20


def sqdist(a: torch.Tensor, b: torch.Tensor, arith: Arith) -> torch.Tensor:
    """``a [..., N, M]``, ``b [..., K, M]`` → ``[..., N, K]`` ≥ 0."""
    a, b = arith.cast(a), arith.cast(b)
    aa = (a * a).sum(-1)[..., :, None]
    bb = (b * b).sum(-1)[..., None, :]
    return (aa + bb - 2.0 * arith.matmul(a, b.transpose(-1, -2))
            ).clamp_min_(0.0)


def _lex_smallest(keys: torch.Tensor, rows: torch.Tensor, n: int,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` smallest ``(key, row)`` pairs of each row of ``keys`` /
    ``rows [B, L]``, ascending; pads with ``+inf`` / ``-1``."""
    by_row = torch.argsort(rows, dim=1, stable=True)
    keys, rows = keys.gather(1, by_row), rows.gather(1, by_row)
    by_key = torch.argsort(keys, dim=1, stable=True)[:, :n]
    keys, rows = keys.gather(1, by_key), rows.gather(1, by_key)
    if keys.shape[1] < n:
        pad = n - keys.shape[1]
        keys = torch.nn.functional.pad(keys, (0, pad), value=math.inf)
        rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
    return keys, rows


class Partitions:
    """The rows of each partition, ascending: ``order[start[p]:start[p] +
    count[p]]``."""

    def __init__(self, pidx: torch.Tensor, p: int) -> None:
        pidx = pidx.long()
        self.order = torch.argsort(pidx, stable=True)
        self.count = torch.bincount(pidx, minlength=p)
        self.start = torch.cumsum(self.count, 0) - self.count


def search(x: torch.Tensor, q: torch.Tensor, centroids: torch.Tensor,
           codebooks: torch.Tensor, codes: torch.Tensor, pidx: torch.Tensor,
           *, k: int, nprobe: int, rerank: Optional[int] = None,
           arith: Arith = F64, chunk: int = 64,
           parts: Optional[Partitions] = None,
           rerank_arith: Optional[Arith] = None,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The IVF-PQ answer for ``q [B, M]``: ``(keys [B, k], rows [B, k])``,
    the keys ADC keys, or exact squared distances with ``rerank``; ``+inf``
    and row ``-1`` past the reachable rows. ``x`` is read only to rerank,
    in ``rerank_arith`` where it is given (else in ``arith``)."""
    dev = q.device
    dt = arith.dtype
    p = centroids.shape[0]
    d, c, sub = codebooks.shape
    parts = parts or Partitions(pidx, p)
    cents = arith.cast(centroids)
    cb = arith.cast(codebooks)
    cc = (cb * cb).sum(-1)                                   # [D, C]
    codes = codes.long()
    offs = torch.arange(d, device=dev) * c
    out_k, out_r = [], []
    for s in range(0, q.shape[0], chunk):
        qc = arith.cast(q[s:s + chunk])
        b = qc.shape[0]
        coarse = sqdist(qc, cents, arith)                    # [B, P]
        probed = torch.argsort(coarse, dim=1, stable=True)[:, :nprobe]
        g = b * nprobe
        r = (qc[:, None, :] - cents[probed]).reshape(g, d, sub)
        rr = (r * r).sum(-1)                                 # [G, D]
        rc = arith.matmul(r.transpose(0, 1), cb.transpose(1, 2))
        tables = (rr[..., None] + cc[None]
                  - 2.0 * rc.transpose(0, 1)).clamp_min_(0.0)  # [G, D, C]
        lens = parts.count[probed].reshape(-1)               # [G]
        g_of = torch.repeat_interleave(torch.arange(g, device=dev), lens)
        first = torch.cumsum(lens, 0) - lens
        pos = torch.arange(len(g_of), device=dev) - first[g_of]
        rows = parts.order[parts.start[probed.reshape(-1)][g_of] + pos]
        flat = tables.reshape(g, d * c)
        key = torch.zeros(len(rows), dtype=dt, device=dev)
        code_rows = codes[rows]
        for j in range(d):
            key += flat[g_of, offs[j] + code_rows[:, j]]
        qb = g_of // nprobe
        qlens = lens.reshape(b, nprobe).sum(1)
        qpos = torch.arange(len(rows), device=dev) - (
            torch.cumsum(qlens, 0) - qlens)[qb]
        width = max(int(qlens.max()), 1)
        kp = torch.full((b, width), math.inf, dtype=dt, device=dev)
        rp = torch.full((b, width), -1, dtype=torch.long, device=dev)
        kp[qb, qpos] = key
        rp[qb, qpos] = rows
        keys, rows = _lex_smallest(kp, rp, rerank or k)
        if rerank:
            ra = rerank_arith or arith
            qe = ra.cast(q[s:s + chunk])
            valid = rows >= 0
            xr = ra.cast(x[rows.clamp_min(0)])               # [B, R, M]
            exact = ((qe * qe).sum(-1)[:, None] + (xr * xr).sum(-1)
                     - 2.0 * ra.matmul(xr, qe[:, :, None])[..., 0]
                     ).clamp_min_(0.0)
            exact = exact.masked_fill(~valid, math.inf)
            keys, rows = _lex_smallest(exact, rows, k)
        out_k.append(keys)
        out_r.append(rows)
    return torch.cat(out_k), torch.cat(out_r)


def keys_of(x: torch.Tensor, q: torch.Tensor, centroids: torch.Tensor,
            codebooks: torch.Tensor, codes: torch.Tensor, pidx: torch.Tensor,
            rows: torch.Tensor, *, exact: bool) -> torch.Tensor:
    """The float64 key of each row of ``rows [B, k]`` for query ``q[b]``:
    its exact squared distance, or its ADC key in its own partition,
    each as a sum of squared differences; ``nan`` where the row is not a
    corpus row."""
    n = codes.shape[0]
    ok = (rows >= 0) & (rows < n)
    r = rows.clamp(0, n - 1).long()
    q64 = q.double()[:, None, :]
    if exact:
        diff = x[r].double() - q64
    else:
        d, c, sub = codebooks.shape
        resid = q64 - centroids.double()[pidx[r].long()]     # [B, k, M]
        words = codebooks.double()[torch.arange(d, device=q.device),
                                   codes[r].long()]          # [B, k, D, s]
        diff = resid - words.reshape(*r.shape, d * sub)
    return (diff * diff).sum(-1).masked_fill(~ok, math.nan)


# -- build ----------------------------------------------------------------

def _argmin(x: torch.Tensor, c: torch.Tensor, arith: Arith,
            chunk: int = 1 << 16) -> torch.Tensor:
    """Nearest centroid (first minimum): ``x [B, N, M]``, ``c [B, K, M]``
    → ``[B, N]`` int64."""
    b, n, _ = x.shape
    out = torch.empty((b, n), dtype=torch.long, device=x.device)
    for s in range(0, n, chunk):
        out[:, s:s + chunk] = sqdist(x[:, s:s + chunk], c, arith).argmin(-1)
    return out


def _plusplus(x: torch.Tensor, k: int, gen: torch.Generator,
              arith: Arith) -> torch.Tensor:
    """k-means++ seeds of ``x [B, N, M]``: ``[B, K, M]``."""
    b, n, m = x.shape
    dev = x.device
    batch = torch.arange(b, device=dev)
    pick = torch.randint(0, n, (b,), generator=gen, device=dev)
    cents = torch.empty((b, k, m), dtype=x.dtype, device=dev)
    cents[:, 0] = x[batch, pick]
    w = sqdist(x, cents[:, :1], arith)[..., 0]
    for i in range(1, k):
        total = w.sum(1, keepdim=True)
        probs = torch.where(total > 0, w, torch.ones_like(w))
        pick = torch.multinomial(probs.double(), 1, generator=gen)[:, 0]
        cents[:, i] = x[batch, pick]
        w = torch.minimum(w, sqdist(x, cents[:, i:i + 1], arith)[..., 0])
    return cents


def kmeans(x: torch.Tensor, k: int, gen: torch.Generator, arith: Arith,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched k-means of ``x [B, N, M]``: k-means++ on at most
    ``max(4096, 32k)`` rows, then Lloyd rounds until the largest centroid
    move is below ``EPSILON`` times the largest centroid norm, or
    ``MAX_ROUNDS``; empty clusters keep their centroid. Returns
    ``(centroids [B, K, M], indices [B, N])``, the indices against the
    final centroids."""
    b, n, m = x.shape
    x = arith.cast(x)
    cap = max(4096, 32 * k)
    sub = x
    if n > cap:
        sub = x[:, torch.randint(0, n, (cap,), generator=gen,
                                 device=x.device)]
    cents = _plusplus(sub, k, gen, arith)
    flat_off = (torch.arange(b, device=x.device) * k)[:, None]
    for _ in range(MAX_ROUNDS):
        idx = _argmin(x, cents, arith)
        sums = torch.zeros((b * k, m), dtype=x.dtype, device=x.device)
        sums.index_add_(0, (idx + flat_off).reshape(-1), x.reshape(-1, m))
        counts = torch.bincount((idx + flat_off).reshape(-1),
                                minlength=b * k).reshape(b, k)
        new = torch.where(counts[..., None] > 0,
                          sums.reshape(b, k, m)
                          / counts.clamp_min(1)[..., None].to(x.dtype),
                          cents)
        moved = (new - cents).norm(dim=-1).amax(-1)
        scale = new.norm(dim=-1).amax(-1).clamp_min(1e-30)
        cents = new
        if bool((moved / scale < EPSILON).all()):
            break
    return cents, _argmin(x, cents, arith)


def build(x: torch.Tensor, p: int, d: int, c: int, seed: int,
          arith: Arith, *, coarse_cap: int = COARSE_CAP,
          pq_cap: int = PQ_CAP,
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The IVF-PQ arrays of ``x [N, M]``: ``(centroids [P, M], indices
    [N], codebooks [D, C, M/D], codes [N, D])``."""
    n, m = x.shape
    gen = torch.Generator(x.device).manual_seed(seed)
    train = x
    if n > coarse_cap:
        train = x[torch.randint(0, n, (coarse_cap,), generator=gen,
                                device=x.device)]
    cents = kmeans(train[None], p, gen, arith)[0][0]
    idx = _argmin(x[None], cents[None], arith)[0]
    rows = (torch.randint(0, n, (pq_cap,), generator=gen, device=x.device)
            if n > pq_cap else torch.arange(n, device=x.device))
    resid = (arith.cast(x[rows]) - cents[idx[rows]]).reshape(-1, d, m // d)
    books = kmeans(resid.transpose(0, 1).contiguous(), c, gen, arith)[0]
    codes = torch.empty((n, d), dtype=torch.long, device=x.device)
    for s in range(0, n, 1 << 16):
        r = (arith.cast(x[s:s + (1 << 16)]) - cents[idx[s:s + (1 << 16)]]
             ).reshape(-1, d, m // d).transpose(0, 1)
        codes[s:s + (1 << 16)] = _argmin(r, books, arith).T
    return cents.float(), idx, books.float(), codes
