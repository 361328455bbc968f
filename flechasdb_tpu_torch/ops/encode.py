"""Encoding new vectors against a built index (the JAX package's
``ops/encode.py``).

Nothing is retrained: a vector goes to its nearest partition centroid and
its residual to the nearest codeword of each division, exactly as a query
would see it. Both argmins are :func:`.distance.assign_chunked` (full-f32
products, the first minimum on ties). With an OPQ rotation the residuals
are rotated, in full f32, before the codebook argmin: codes live in the
rotated space. Every product covers one block of
:data:`.distance.ASSIGN_CHUNK` rows, the rotation's too: the encode of a
block-aligned part of a batch runs the very products, on the very rows,
that the encode of the whole batch runs there, so it gives the same bits
(the sharded streamed build encodes such parts, ``streaming.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .adc import _rotated
from .distance import ASSIGN_CHUNK, assign_chunked


def encode(x: torch.Tensor, centroids: torch.Tensor,
           codebooks: torch.Tensor,
           rotation: Optional[torch.Tensor] = None,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [N, M]``, ``centroids [P, M]``, ``codebooks [D, C, M/D]`` and
    an optional OPQ ``rotation [M, M]`` → ``(pidx [N], codes [N, D])``, in
    the narrowest dtype that holds the index range, as the JAX package
    returns them: ``uint16`` pidx when P <= 65536, ``uint8`` codes when C
    <= 256, else ``int32``."""
    n, _ = x.shape
    p = centroids.shape[0]
    d, c, sub = codebooks.shape
    pidx = assign_chunked(x[None], centroids[None])[0][0]
    residues = x - centroids[pidx.long()]
    if rotation is not None and n:
        residues = torch.cat([_rotated(residues[s:s + ASSIGN_CHUNK], rotation)
                              for s in range(0, n, ASSIGN_CHUNK)])
    divided = residues.reshape(n, d, sub).transpose(0, 1)     # [D, N, m]
    codes = assign_chunked(divided, codebooks)[0]              # [D, N]
    pdt = torch.uint16 if p <= (1 << 16) else torch.int32
    cdt = torch.uint8 if c <= 256 else torch.int32
    return pidx.to(pdt), codes.T.to(cdt)
