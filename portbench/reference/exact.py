"""Plain exact k-NN over squared L2: the answer the flat configuration
states, and the comparison of the program's answers with it.

:func:`search` scores every query against every row with
:func:`.ivfpq.sqdist` (the expanded form, its cross term a matrix product
in the arithmetic given) and keeps the ``k`` least keys, ties to the lower
row. :func:`numbers` reads the program's answers as the judge reads an
exact answer (:mod:`.judge`'s ``miss_pct`` and ``dist_err``, its
:data:`.judge.TIE`), the reference in float64.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .arith import F64, Arith
from .ivfpq import _lex_smallest, sqdist
from .judge import TIE

#: Keys a block of queries holds at once: ``[B_block, N]``.
BLOCK_KEYS = 1 << 28
#: Candidates kept past ``k`` before ties are settled by row.
MARGIN = 16


def _smallest(keys: torch.Tensor, k: int,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` least ``(key, row)`` pairs of each row of ``keys [B, N]``
    (column ``i`` is corpus row ``i``), ascending, ties to the lower row;
    ``+inf`` and row ``-1`` where fewer than ``k`` rows have a finite key.
    The ``k + MARGIN`` least keys hold every row tied with the ``k``-th
    wherever the last of them lies above it; a query where it does not
    is settled over all its keys."""
    n = keys.shape[1]
    kk = min(k + MARGIN, n)
    vals, rows = torch.topk(keys, kk, dim=1, largest=False, sorted=True)
    out_k, out_r = _lex_smallest(vals, rows, k)
    if kk < n:
        open_ = vals[:, kk - 1] <= vals[:, min(k, kk) - 1]
        if bool(open_.any()):
            every = torch.arange(n, device=keys.device).expand(
                int(open_.sum()), n)
            out_k[open_], out_r[open_] = _lex_smallest(keys[open_], every,
                                                       k)
    out_r = out_r.masked_fill(~torch.isfinite(out_k), -1)
    return out_k, out_r


def search(x: torch.Tensor, q: torch.Tensor, k: int, arith: Arith = F64,
           row_mask: Optional[torch.Tensor] = None,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact answer for ``q [B, M]`` over ``x [N, M]``: ``(keys [B,
    k], rows [B, k])``, the keys ``ivfpq.sqdist``'s in ``arith``; rows
    whose ``row_mask [N]`` entry is False are never answered; ``+inf`` and
    row ``-1`` past the rows left."""
    n = x.shape[0]
    xa = arith.cast(x)
    block = max(1, BLOCK_KEYS // max(n, 1))
    out_k, out_r = [], []
    for s in range(0, q.shape[0], block):
        keys = sqdist(arith.cast(q[s:s + block]), xa, arith)   # [b, N]
        if row_mask is not None:
            keys.masked_fill_(~row_mask[None, :], math.inf)
        ks, rs = _smallest(keys, k)
        del keys
        out_k.append(ks)
        out_r.append(rs)
    return torch.cat(out_k), torch.cat(out_r)


def keys_of(x: torch.Tensor, q: torch.Tensor,
            rows: torch.Tensor) -> torch.Tensor:
    """The float64 squared distance of each row of ``rows [B, k]`` to
    ``q[b]``, as a sum of squared differences; ``nan`` where the row is
    not a corpus row."""
    n = x.shape[0]
    ok = (rows >= 0) & (rows < n)
    diff = x[rows.clamp(0, n - 1).long()].double() - q.double()[:, None, :]
    return (diff * diff).sum(-1).masked_fill(~ok, math.nan)


def numbers(x: torch.Tensor, q: torch.Tensor, rows: torch.Tensor,
            dists: torch.Tensor, k: int,
            row_mask: Optional[torch.Tensor] = None) -> dict:
    """``miss_pct`` and ``dist_err`` of the program's answers ``rows [S,
    k]``, ``dists [S, k]`` to ``q [S, M]`` over ``x`` (a slot whose
    distance is not finite holds no row), as :func:`.judge.serve_numbers`
    defines them, against :func:`search` in float64."""
    rows = torch.where(torch.isfinite(dists), rows.long(), -1)
    ref_keys, ref_rows = search(x, q, k, F64, row_mask)
    got = keys_of(x, q, rows)
    kth = ref_keys[:, k - 1:k]
    scale = torch.where(torch.isfinite(kth) & (kth > 0), kth,
                        torch.ones_like(kth))
    valid = rows >= 0
    srt = torch.sort(rows, dim=1).values
    dup = torch.zeros_like(valid)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    bad = (valid & torch.isnan(got)) | dup
    worse = valid & (got > kth + TIE * scale)
    absent = ~valid & (ref_rows >= 0)
    miss = (bad | worse | absent).sum().item()
    err = ((dists.double() - got).abs() / scale)[valid & ~torch.isnan(got)]
    dist_err = float(err.max()) if err.numel() else 0.0
    if not math.isfinite(dist_err):
        dist_err = math.inf
    return {"miss_pct": 100.0 * miss / rows.numel(), "dist_err": dist_err}
