"""The fused Lloyd round: K-B (``csrc/lloyd_round.cu``) over ``[B, N, M]``
data, K-C (``csrc/lloyd_grouped.cu``) over division-grouped data, and
their plain versions.

:func:`lloyd_round` keeps the contract of the JAX package's
``ops/pallas_kmeans.lloyd_round``: ``x [B, N, M]`` f32 and ``centroids
[B, K, M]`` f32 → ``(indices [B, N] int32, sums [B, K, M] f32, counts
[B, K] f32)``, where ``indices[b, i]`` is the FIRST argmin over k of
``‖c_k‖² − 2 x_i·c_k`` (no ``‖x‖²`` term, no clamp) and ``sums``/``counts``
are the member sums and sizes under that fresh assignment.

On a CUDA tensor it launches the kernel, whose product is 3xTF32 on the
tensor cores (tf32 hi and lo parts of each f32 operand, lo·hi + hi·lo +
hi·hi accumulated in f32: about 2⁻²¹ relative error, whatever the
process's TF32 flags), so it ranks as an f32 product does up to
near-ties; on a CPU tensor it runs :func:`lloyd_round_plain`. The source
note on what bounds the kernel and how its design answers is at the top
of ``csrc/lloyd_round.cu``.

:func:`lloyd_round_grouped` keeps the contract of the JAX package's
``pallas_kmeans.lloyd_round_grouped``: ``xg [G, N, 128]`` from
:func:`regroup_divisions` and ``centroids [B, K, m]`` (``128 % m == 0``)
→ the same three outputs as :func:`lloyd_round` on the ungrouped data.
On a CUDA tensor it launches K-C (m in 8, 16, 32, 64), one launch a
round with the cluster sums fused: the same 3xTF32 tensor-core product in
K-B's order, so its distances, and so its indices, equal K-B's on the
ungrouped data; on a CPU tensor it runs :func:`lloyd_round_grouped_plain`.
The source note is at the top of ``csrc/lloyd_grouped.cu``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .distance import full_f32

#: Rows a distance chunk of the plain version: bounds its [B, chunk, K]
#: transient.
_CHUNK = 16384

#: Width of a division-grouped row (``xg [G, N, 128]``).
GROUP_WIDTH = 128

#: Subvector widths K-C takes.
GROUPED_WIDTHS = (8, 16, 32, 64)


@full_f32()
def lloyd_round_plain(x: torch.Tensor, centroids: torch.Tensor,
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked ``‖c‖² − 2 x·cᵀ`` in f32, ``torch.argmin`` (first minimum)
    and ``index_add_`` sums."""
    b, n, m = x.shape
    k = centroids.shape[1]
    cc = (centroids * centroids).sum(dim=-1)                # [B, K]
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
    ct = centroids.transpose(1, 2)
    for s in range(0, n, _CHUNK):
        d = cc[:, None, :] - 2.0 * torch.bmm(x[:, s:s + _CHUNK], ct)
        idx[:, s:s + _CHUNK] = torch.argmin(d, dim=-1).to(torch.int32)
    flat = (idx.long() + k * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    sums = torch.zeros((b * k, m), dtype=torch.float32, device=x.device)
    sums.index_add_(0, flat, x.reshape(b * n, m))
    counts = torch.zeros(b * k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, flat, torch.ones(b * n, device=x.device))
    return idx, sums.reshape(b, k, m), counts.reshape(b, k)


def _check(x: torch.Tensor, centroids: torch.Tensor) -> None:
    if x.ndim != 3 or centroids.ndim != 3:
        raise ValueError("lloyd_round takes x [B, N, M] and centroids "
                         f"[B, K, M]; got {tuple(x.shape)}, "
                         f"{tuple(centroids.shape)}")
    if (x.shape[0] != centroids.shape[0]
            or x.shape[2] != centroids.shape[2]):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    _check_tensors("x", x, centroids)


def _check_tensors(name: str, x: torch.Tensor,
                   centroids: torch.Tensor) -> None:
    """Both f32 and contiguous, on one device."""
    for n, t in ((name, x), ("centroids", centroids)):
        if t.dtype != torch.float32:
            raise TypeError(f"{n} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if centroids.device != x.device:
        raise ValueError(f"centroids are on {centroids.device}, {name} on "
                         f"{x.device}")


def _check_grouped(xg: torch.Tensor, centroids: torch.Tensor) -> None:
    """Validates the grouped contract."""
    if xg.ndim != 3 or centroids.ndim != 3:
        raise ValueError("lloyd_round_grouped takes xg [G, N, 128] and "
                         f"centroids [B, K, m]; got {tuple(xg.shape)}, "
                         f"{tuple(centroids.shape)}")
    b, _, m = centroids.shape
    if xg.shape[2] != GROUP_WIDTH or m == 0 or GROUP_WIDTH % m:
        raise ValueError(f"grouped rows are {GROUP_WIDTH} wide and m must "
                         f"divide them: xg {tuple(xg.shape)}, m={m}")
    g = GROUP_WIDTH // m
    if xg.shape[0] != -(-b // g):
        raise ValueError(f"xg holds {xg.shape[0]} groups; B={b} divisions "
                         f"of width {m} need {-(-b // g)}")
    _check_tensors("xg", xg, centroids)


def regroup_divisions(x: torch.Tensor) -> torch.Tensor:
    """``[B, N, m]`` divided data (``128 % m == 0``) → ``[G, N, 128]``
    with ``g = 128 // m`` consecutive divisions' subvectors side by side
    in each row, and zero pad divisions when ``g ∤ B``."""
    b, n, m = x.shape
    if m == 0 or GROUP_WIDTH % m:
        raise ValueError(f"m={m} does not divide {GROUP_WIDTH}")
    g = GROUP_WIDTH // m
    gg = -(-b // g)
    xt = torch.nn.functional.pad(x.transpose(0, 1),
                                 (0, 0, 0, gg * g - b))      # [N, G·g, m]
    return xt.reshape(n, gg, GROUP_WIDTH).transpose(0, 1).contiguous()


def lloyd_round_grouped_plain(xg: torch.Tensor, centroids: torch.Tensor,
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Ungroups ``xg`` and runs :func:`lloyd_round_plain`."""
    b, _, m = centroids.shape
    gg, n, _ = xg.shape
    x = xg.reshape(gg, n, GROUP_WIDTH // m, m).transpose(1, 2) \
        .reshape(-1, n, m)[:b].contiguous()
    return lloyd_round_plain(x, centroids)


def lloyd_round_grouped(xg: torch.Tensor, centroids: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Lloyd round over division-grouped data; see the module
    docstring."""
    _check_grouped(xg, centroids)
    if xg.device.type == "cpu":
        return lloyd_round_grouped_plain(xg, centroids)
    if xg.device.type != "cuda":
        raise ValueError(f"unsupported device: {xg.device}")
    b, k, m = centroids.shape
    gg, n, _ = xg.shape
    if m not in GROUPED_WIDTHS:
        raise ValueError(f"K-C takes m in {GROUPED_WIDTHS}, got {m}")
    if k == 0:
        raise ValueError("lloyd_round_grouped needs at least one centroid")
    idx = torch.empty((b, n), dtype=torch.int32, device=xg.device)
    sums = torch.empty((b, k, m), dtype=torch.float32, device=xg.device)
    counts = torch.empty((b, k), dtype=torch.float32, device=xg.device)
    if b == 0 or n == 0:
        return idx, sums.zero_(), counts.zero_()
    if xg.data_ptr() % 16:
        xg = xg.clone()
    if centroids.data_ptr() % 16:
        centroids = centroids.clone()
    cc = (centroids * centroids).sum(dim=-1).contiguous()
    lib = _kernels.load()
    with torch.cuda.device(xg.device):
        rc = lib.fdb_lloyd_grouped(
            xg.data_ptr(), centroids.data_ptr(), cc.data_ptr(),
            idx.data_ptr(), sums.data_ptr(), counts.data_ptr(), b, gg, n, k,
            m, _kernels.stream_of(xg))
    _kernels.check(rc, "lloyd_grouped")
    _kernels.LAUNCHES["lloyd_grouped"] += 1
    return idx, sums, counts


def lloyd_round(x: torch.Tensor, centroids: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assignment + cluster-sum pass; see the module docstring."""
    _check(x, centroids)
    if x.device.type == "cpu":
        return lloyd_round_plain(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device: {x.device}")
    b, n, m = x.shape
    k = centroids.shape[1]
    if k == 0:
        raise ValueError("lloyd_round needs at least one centroid")
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
    sums = torch.empty((b, k, m), dtype=torch.float32, device=x.device)
    counts = torch.empty((b, k), dtype=torch.float32, device=x.device)
    if b == 0 or n == 0:
        return idx, sums.zero_(), counts.zero_()
    cc = (centroids * centroids).sum(dim=-1).contiguous()
    vec = m % 4 == 0 and x.data_ptr() % 16 == 0 \
        and centroids.data_ptr() % 16 == 0
    lib = _kernels.load()
    with torch.cuda.device(x.device):
        rc = lib.fdb_lloyd_round(
            x.data_ptr(), centroids.data_ptr(), cc.data_ptr(),
            idx.data_ptr(), sums.data_ptr(), counts.data_ptr(), b, n, k, m,
            int(vec), _kernels.stream_of(x))
    _kernels.check(rc, "lloyd_round")
    _kernels.LAUNCHES["lloyd_round"] += 1
    return idx, sums, counts
