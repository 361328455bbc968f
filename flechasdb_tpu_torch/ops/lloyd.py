"""The Lloyd round: K-B (``csrc/lloyd_round.cu``) over ``[B, N, M]``
data, K-C (``csrc/lloyd_grouped.cu``) over division-grouped data, the
cluster-sum pass after either (``csrc/cluster_sums.cu``), the
``fast_math`` variants of both (K-B fast, ``csrc/lloyd_round_fast.cu``;
K-C fast, ``csrc/lloyd_grouped_fast.cu``), and their plain versions.

:func:`lloyd_round` keeps the contract of the JAX package's
``ops/pallas_kmeans.lloyd_round``: ``x [B, N, M]`` f32 and ``centroids
[B, K, M]`` f32 → ``(indices [B, N] int32, sums [B, K, M] f32, counts
[B, K] f32)``, where ``indices[b, i]`` is the FIRST argmin over k of
``‖c_k‖² − 2 x_i·c_k`` (no ``‖x‖²`` term, no clamp) and ``sums``/``counts``
are the member sums and sizes under that fresh assignment.

On a CUDA tensor it launches the kernel for the assignment, whose
product is 3xTF32 on the tensor cores (tf32 hi and lo parts of each f32
operand, lo·hi + hi·lo + hi·hi accumulated in f32: about 2⁻²¹ relative
error, whatever the process's TF32 flags), so it ranks as an f32 product
does up to near-ties, then :func:`cluster_sums` for the sums and counts;
on a CPU tensor it runs :func:`lloyd_round_plain`. The source note on
what bounds the kernel and how its design answers is at the top of
``csrc/lloyd_round.cu``.

:func:`cluster_sums` adds each cluster's rows in an order that the
assignment and the shape alone fix (no float atomics), so a round on the
card returns the same bits every time it gets the same inputs, on any
card, and two builds with the same seed are equal. Two CUDA routes, picked
by :func:`sum_tiling` from the shape before the launch: the dense route
adds each tile of rows into tile-private sums (the rows of a tile in
ascending order into each cluster) and then the tiles in order, which
:func:`cluster_sums_ordered` models in plain PyTorch bit for bit; above
its K limit the sort route sorts the rows by cluster and adds fixed
chunks. The sums differ from the plain version's serial ``index_add_``
only by that order; the counts are exact.

:func:`lloyd_round_grouped` keeps the contract of the JAX package's
``pallas_kmeans.lloyd_round_grouped``: ``xg [G, N, 128]`` from
:func:`regroup_divisions` and ``centroids [B, K, m]`` (``128 % m == 0``)
→ the same three outputs as :func:`lloyd_round` on the ungrouped data.
On a CUDA tensor it launches K-C (m in 8, 16, 32, 64): the same 3xTF32
tensor-core product in K-B's order, so its distances, and so its indices,
equal K-B's on the ungrouped data; then :func:`cluster_sums_grouped`,
which reads each division's slice of ``xg`` through strides. On a CPU
tensor it runs :func:`lloyd_round_grouped_plain`. The source note is at
the top of ``csrc/lloyd_grouped.cu``.

``fast_math=True`` on either is the TPU kernels' ``fast_math`` branch:
the cross term is one bf16 pass (x and the centroids rounded to bf16, to
nearest even, their products accumulated in f32; ``‖c‖²`` stays f32 from
the f32 centroids) and the sums add the bf16-rounded x. On a CUDA tensor
:func:`lloyd_round` launches K-B fast (``csrc/lloyd_round_fast.cu``:
the centroids staged once in bf16, as :func:`stage_centroids`, then
``wgmma`` with the centroid tiles streamed by the TMA, on the tiling
:func:`fast_tiling` picks), counted under ``lloyd_round_fast``;
:func:`lloyd_round_grouped` launches K-C fast
(``csrc/lloyd_grouped_fast.cu``: the centroids staged once a round as
:func:`stage_grouped_centroids`, each grouped row read once by the TMA for
all its divisions and held as bf16 register fragments, each division's
k16 steps a warp's own ``mma.sync`` against K-B fast's ring of centroid
tiles, on the tiling
:func:`grouped_fast_tiling` picks; at m ≥ 16 its picks are K-B fast's on
the ungrouped data), counted under ``lloyd_grouped_fast``; both then run
the cluster-sum pass's fast variant. On a CPU tensor the plain version
computes the same function.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), back in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


@full_f32()
def lloyd_round_plain(x: torch.Tensor, centroids: torch.Tensor,
                      fast_math: bool = False,
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked ``‖c‖² − 2 x·cᵀ`` in f32, ``torch.argmin`` (first minimum)
    and ``index_add_`` sums. ``fast_math``: x and the centroids rounded to
    bf16 first (their products are exact in f32), ``‖c‖²`` from the f32
    centroids, and the sums of the rounded x."""
    b, n, m = x.shape
    k = centroids.shape[1]
    cc = (centroids * centroids).sum(dim=-1)                # [B, K]
    if fast_math:
        x, centroids = _bf16(x), _bf16(centroids)
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
    ct = centroids.transpose(1, 2)
    for s in range(0, n, _CHUNK):
        d = cc[:, None, :] - 2.0 * torch.bmm(x[:, s:s + _CHUNK], ct)
        idx[:, s:s + _CHUNK] = torch.argmin(d, dim=-1).to(torch.int32)
    # x is already rounded under fast_math.
    return (idx, *cluster_sums_plain(x, idx, k))


def cluster_sums_plain(x: torch.Tensor, idx: torch.Tensor, k: int,
                       fast_math: bool = False,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, N, M]`` and ``idx [B, N]`` → ``(sums [B, K, M], counts
    [B, K])`` by ``index_add_``; ``fast_math`` adds x rounded to bf16."""
    b, n, m = x.shape
    if fast_math:
        x = _bf16(x)
    flat = (idx.long() + k * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    sums = torch.zeros((b * k, m), dtype=torch.float32, device=x.device)
    sums.index_add_(0, flat, x.reshape(b * n, m))
    counts = torch.zeros(b * k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, flat, torch.ones(b * n, device=x.device))
    return sums.reshape(b, k, m), counts.reshape(b, k)


#: A block's shared memory on the H100, and the part of it the dense
#: route's ``[K, S]`` accumulator may take.
_SMEM_MAX = 232_448
_ACC_MAX = 160 << 10
#: The dense route's ring of stages and warps a block
#: (``csrc/cluster_sums.cu``: kStages, kDenseWarps).
_STAGES, _WARPS = 4, 8
#: The partials may take a tenth of x's bytes, or this many.
_PART_FLOOR = 16 << 20


class SumTiling(NamedTuple):
    """How the cluster-sum pass runs on a shape (:func:`sum_tiling`).
    ``route`` is ``"dense"`` or ``"sort"``; the dense route's block takes
    ``rows`` rows (``R``) of ``cols`` columns (``S``) through stages of
    ``stage_rows`` rows, in ``smem`` bytes of shared memory."""
    route: str
    cols: int = 0
    rows: int = 0
    stage_rows: int = 0
    smem: int = 0


def _align16(v: int) -> int:
    return (v + 15) & ~15


def _dense_smem(k: int, s: int, g: int, stage_rows: int) -> int:
    """Bytes of a dense block (``dense_layout`` in the CUDA source):
    accumulator, counts, the stages of x and idx, a row list for each of
    ``_WARPS`` warps, the ring slots' two barriers."""
    return (_align16(k * s * 4) + _align16(g * k * 4)
            + _align16(_STAGES * stage_rows * s * 4)
            + _align16(_STAGES * stage_rows * g * 4)
            + _align16(_WARPS * stage_rows * 4) + _align16(2 * _STAGES * 8))


def sum_tiling(b: int, n: int, k: int, m: int, g: int) -> SumTiling:
    """The cluster-sum pass's route and tiling for ``b`` divisions of
    ``n`` rows of width ``m``, ``g`` of them side by side in a row
    (K-C's grouped rows; 1 for K-B), over ``k`` clusters. A pure function
    of its arguments (no device query), so the order of the adds, and so
    the bits, are the same on every card. ``S``: the accumulator, ``K·S``
    floats, within ``_ACC_MAX``, and at most 128 columns (K-C: the whole
    128-float row); ``R``: the
    smallest power of two from 256 whose partials, ``B·T·K·m`` floats,
    stay within a tenth of x or ``_PART_FLOOR`` bytes; the stage rows: the
    largest power of two up to 256 (about 16 KB of x a stage) that fits
    the block. Where no ``S >= 8`` fits, the sort route."""
    if g > 1:
        s = GROUP_WIDTH if k * GROUP_WIDTH * 4 <= _ACC_MAX else 0
    else:
        cap = min(128, _ACC_MAX // (4 * k))
        step = 32 if cap >= 32 else 8
        s = m if m <= cap else cap // step * step
    if s == 0:
        return SumTiling("sort")
    stage = min(256, max(8, 1 << (16384 // (4 * s)).bit_length() - 1))
    while stage > 8 and _dense_smem(k, s, g, stage) > _SMEM_MAX:
        stage //= 2
    if _dense_smem(k, s, g, stage) > _SMEM_MAX:
        return SumTiling("sort")
    budget = max(b * n * m * 4 // 10, _PART_FLOOR)
    r = 256
    while r < n and -(-n // r) * b * k * m * 4 > budget:
        r *= 2
    return SumTiling("dense", s, r, stage, _dense_smem(k, s, g, stage))


def cluster_sums_ordered(x: torch.Tensor, idx: torch.Tensor, k: int,
                         fast_math: bool, tiling: SumTiling,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense route's sums in its order, in plain PyTorch: for each
    tile of ``tiling.rows`` rows, its rows in ascending order into each
    cluster from 0, then the tiles' sums added in tile order from 0; the
    counts by ``bincount``. ``x [B, N, M]`` (K-C's divisions ungrouped)
    and ``idx [B, N]`` as :func:`cluster_sums_plain`. Vectorised over the
    tiles, one row position a step: each step adds at most once to a
    sum, so every add is one f32 add in that order. For tests and
    ``chip_smoke.py``; no path calls it."""
    if tiling.route != "dense":
        raise ValueError("cluster_sums_ordered models the dense route")
    b, n, m = x.shape
    r = tiling.rows
    t = -(-n // r)
    if fast_math:
        x = _bf16(x)
    pad = t * r - n
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(b * t, r, m)
    # A padded row goes to cluster k, one past the last, and is dropped.
    ip = torch.nn.functional.pad(idx.long(), (0, pad), value=k) \
        .reshape(b * t, r)
    ip = ip + (k + 1) * torch.arange(b * t, device=x.device)[:, None]
    part = torch.zeros((b * t * (k + 1), m), dtype=torch.float32,
                       device=x.device)
    for p in range(r):
        at = ip[:, p]
        part[at] = part[at] + xp[:, p]
    part = part.reshape(b, t, k + 1, m)[:, :, :k]
    sums = torch.zeros((b, k, m), dtype=torch.float32, device=x.device)
    for tt in range(t):
        sums = sums + part[:, tt]
    flat = (idx.long() + k * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    counts = torch.bincount(flat, minlength=b * k).reshape(b, k)
    return sums, counts.to(torch.float32)


def _launch_sums(x: torch.Tensor, idx: torch.Tensor, b: int, n: int, k: int,
                 m: int, g: int, fast_math: bool,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launches the cluster-sum pass on ``b`` divisions of ``n`` rows:
    division ``j`` starts at float ``(j // g)·n·rs + (j % g)·m`` of ``x``,
    its rows ``rs = x.shape[-1]`` floats apart, on the route
    :func:`sum_tiling` picks. Allocates its outputs and its scratch, and
    never waits on the device."""
    lib = _kernels.load()
    tiling = sum_tiling(b, n, k, m, g)
    dev = x.device
    sums = torch.empty((b, k, m), dtype=torch.float32, device=dev)
    counts = torch.empty((b, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if tiling.route == "dense":
            t = -(-n // tiling.rows)
            part = torch.empty(b * t * k * m, dtype=torch.float32,
                               device=dev)
            pcnt = torch.empty(b * t * k, dtype=torch.int32, device=dev)
            rc = lib.fdb_cluster_sums_dense(
                x.data_ptr(), idx.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), part.data_ptr(), pcnt.data_ptr(), b, n,
                k, m, g, x.shape[-1], int(fast_math), tiling.cols,
                tiling.rows, tiling.stage_rows, _kernels.stream_of(x))
        else:
            ints, floats = ctypes.c_longlong(), ctypes.c_longlong()
            lib.fdb_cluster_sums_scratch(b, n, k, m, ctypes.byref(ints),
                                         ctypes.byref(floats))
            iwork = torch.empty(ints.value, dtype=torch.int32, device=dev)
            fwork = torch.empty(floats.value, dtype=torch.float32,
                                device=dev)
            rc = lib.fdb_cluster_sums(
                x.data_ptr(), idx.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), iwork.data_ptr(), fwork.data_ptr(), b, n,
                k, m, g, x.shape[-1], int(fast_math), _kernels.stream_of(x))
    _kernels.check(rc, "cluster_sums")
    _kernels.launched("cluster_sums")
    return sums, counts


def _check_sums(x: torch.Tensor, idx: torch.Tensor, b: int, n: int,
                k: int) -> None:
    if idx.shape != (b, n) or idx.dtype != torch.int32 \
            or not idx.is_contiguous() or idx.device != x.device:
        raise ValueError(f"idx must be a contiguous int32 [{b}, {n}] on "
                         f"{x.device}; got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    if k <= 0:
        raise ValueError(f"the cluster sums need k > 0, got {k}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= k):
        raise ValueError(f"idx must lie in [0, {k})")


def _sums_device(x: torch.Tensor) -> bool:
    """True on a CUDA tensor (the kernel runs), False on a CPU one."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {x.device}")
    return x.device.type == "cuda"


def cluster_sums(x: torch.Tensor, idx: torch.Tensor, k: int,
                 fast_math: bool = False,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, N, M]`` f32, ``idx [B, N]`` int32 in ``[0, k)`` → ``(sums
    [B, K, M], counts [B, K])`` f32: the member sums and sizes of the
    assignment, each sum in an order fixed by ``idx`` (see the module
    docstring); ``fast_math`` adds x rounded to bf16. A CPU tensor takes
    :func:`cluster_sums_plain`."""
    if x.ndim != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("cluster_sums takes a contiguous f32 x [B, N, M]")
    b, n, m = x.shape
    _check_sums(x, idx, b, n, k)
    if not _sums_device(x):
        return cluster_sums_plain(x, idx, k, fast_math)
    if b == 0 or n == 0:
        return (torch.zeros((b, k, m), device=x.device),
                torch.zeros((b, k), device=x.device))
    return _launch_sums(x, idx, b, n, k, m, 1, fast_math)


def cluster_sums_grouped(xg: torch.Tensor, idx: torch.Tensor, k: int,
                         m: int, fast_math: bool = False,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cluster_sums` of the ``B = idx.shape[0]`` divisions of
    width ``m`` in ``xg [G, N, 128]`` (:func:`regroup_divisions`), read
    in place. A CPU tensor ungroups and takes :func:`cluster_sums_plain`.
    """
    if (xg.ndim != 3 or xg.shape[2] != GROUP_WIDTH
            or xg.dtype != torch.float32 or not xg.is_contiguous()):
        raise ValueError("cluster_sums_grouped takes a contiguous f32 xg "
                         f"[G, N, {GROUP_WIDTH}]")
    if m <= 0 or GROUP_WIDTH % m:
        raise ValueError(f"m={m} does not divide {GROUP_WIDTH}")
    b, n = idx.shape[0], xg.shape[1]
    if xg.shape[0] != -(-b // (GROUP_WIDTH // m)):
        raise ValueError(f"xg holds {xg.shape[0]} groups; B={b} divisions "
                         f"of width {m} need {-(-b // (GROUP_WIDTH // m))}")
    _check_sums(xg, idx, b, n, k)
    if not _sums_device(xg):
        return cluster_sums_plain(_ungroup(xg, b, m), idx, k, fast_math)
    if b == 0 or n == 0:
        return (torch.zeros((b, k, m), device=xg.device),
                torch.zeros((b, k), device=xg.device))
    return _launch_sums(xg, idx, b, n, k, m, GROUP_WIDTH // m, fast_math)


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


def _ungroup(xg: torch.Tensor, b: int, m: int) -> torch.Tensor:
    """The ``[B, N, m]`` divisions of :func:`regroup_divisions`' ``xg``."""
    gg, n, _ = xg.shape
    return xg.reshape(gg, n, GROUP_WIDTH // m, m).transpose(1, 2) \
        .reshape(-1, n, m)[:b].contiguous()


def lloyd_round_grouped_plain(xg: torch.Tensor, centroids: torch.Tensor,
                              fast_math: bool = False,
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Ungroups ``xg`` and runs :func:`lloyd_round_plain`."""
    b, _, m = centroids.shape
    return lloyd_round_plain(_ungroup(xg, b, m), centroids, fast_math)


def lloyd_round_grouped(xg: torch.Tensor, centroids: torch.Tensor,
                        fast_math: bool = False,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Lloyd round over division-grouped data; see the module
    docstring."""
    _check_grouped(xg, centroids)
    if xg.device.type == "cpu":
        return lloyd_round_grouped_plain(xg, centroids, fast_math)
    if xg.device.type != "cuda":
        raise ValueError(f"unsupported device: {xg.device}")
    b, k, m = centroids.shape
    n = xg.shape[1]
    if m not in GROUPED_WIDTHS:
        raise ValueError(f"K-C takes m in {GROUPED_WIDTHS}, got {m}")
    if k == 0:
        raise ValueError("lloyd_round_grouped needs at least one centroid")
    if b == 0 or n == 0:
        return (torch.empty((b, n), dtype=torch.int32, device=xg.device),
                torch.zeros((b, k, m), device=xg.device),
                torch.zeros((b, k), device=xg.device))
    if xg.data_ptr() % 16:
        xg = xg.clone()
    idx = (_assign_grouped_fast(xg, centroids)[0] if fast_math
           else _assign_grouped(xg, centroids))
    return (idx, *_launch_sums(xg, idx, b, n, k, m, GROUP_WIDTH // m,
                               fast_math))


def _assign_grouped(xg: torch.Tensor, centroids: torch.Tensor,
                    ) -> torch.Tensor:
    """K-C's assignment on CUDA tensors (checked by the caller, B, N, K >
    0, ``xg`` 16-byte aligned): ``idx [B, N]``, counted once. Never waits
    on the device."""
    if centroids.data_ptr() % 16:
        centroids = centroids.clone()
    b, k, m = centroids.shape
    gg, n, _ = xg.shape
    idx = torch.empty((b, n), dtype=torch.int32, device=xg.device)
    cc = (centroids * centroids).sum(dim=-1).contiguous()
    lib = _kernels.load()
    with torch.cuda.device(xg.device):
        rc = lib.fdb_lloyd_grouped(
            xg.data_ptr(), centroids.data_ptr(), cc.data_ptr(),
            idx.data_ptr(), b, gg, n, k, m, _kernels.stream_of(xg))
    _kernels.check(rc, "lloyd_grouped")
    _kernels.launched("lloyd_grouped")
    return idx


#: K-B fast (``csrc/lloyd_round_fast.cu``): rows a block (three consumer
#: warpgroups of 64, the wgmma M), centroids a tile (wgmma N; Kp is a
#: multiple of two tiles), the columns of x a band holds at a time (the
#: widest band held resident), and the most ring slots.
_FAST_ROWS, _FAST_TILE, _FAST_CHUNK, _FAST_STAGES = 192, 64, 128, 8


class FastTiling(NamedTuple):
    """How K-B fast runs on a shape (:func:`fast_tiling`). ``regime``:
    ``"resident"`` (each band's x rounded to bf16 once and held as wgmma
    A fragments across every centroid tile) or ``"chunked"`` (``chunk``
    columns at a time, x read once a pair of tiles); ``rows`` a row
    block, ``row_blocks`` in all; the staged centroids ``[B, kp, mp]``;
    ``chunk`` columns of x a band holds; ``stages`` ring slots of one
    tile's chunk; ``smem`` bytes of shared memory a block."""
    regime: str
    rows: int
    row_blocks: int
    kp: int
    mp: int
    chunk: int
    stages: int
    smem: int


def fast_tiling(b: int, n: int, k: int, m: int) -> FastTiling:
    """K-B fast's tiling for ``b`` batch entries of ``n`` rows of width
    ``m`` over ``k`` centroids. A pure function of its arguments (no
    device query). Mp is m padded to a multiple of 64 (a TMA box's 128
    bytes of bf16), Kp k to a multiple of 128 (tile pairs: the kernel
    folds one tile while the next one's products run). Up to Mp = 128 a
    band is resident; above, it is taken 128 columns at a time. A block
    holds the f32 x slot of its three bands and as many ring slots, up to
    8, as its shared memory leaves."""
    mp = -(-m // 64) * 64
    kp = -(-k // (2 * _FAST_TILE)) * 2 * _FAST_TILE
    if mp <= _FAST_CHUNK:
        regime, chunk = "resident", mp
    else:
        regime, chunk = "chunked", _FAST_CHUNK
    # The alignment slack, the x slot (f32) and its two barriers; a ring
    # slot's boxes and its two barriers.
    fixed = 1024 + _FAST_ROWS * chunk * 4 + 16
    stage = _FAST_TILE * chunk * 2 + 16
    stages = min(_FAST_STAGES, (_SMEM_MAX - fixed) // stage)
    return FastTiling(regime, _FAST_ROWS, b * -(-n // _FAST_ROWS), kp, mp,
                      chunk, stages, fixed + stages * stage)


def stage_centroids(centroids: torch.Tensor, tiling: FastTiling,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``centroids [B, K, M]`` f32 → ``(cs [B, Kp, Mp]`` bf16, the
    centroids rounded to nearest even as ``astype(bfloat16)`` rounds, zero
    past K and M; ``ccp [B, Kp]`` f32, ``‖c‖²`` of the f32 centroids, +inf
    past K). K-B fast's operands, made once a round, as the TPU kernel
    makes its ``chi`` and ``cc`` outside its grid: the plain version of the
    kernel's own staging, which adds each ``‖c‖²`` in another fixed
    order."""
    b, k, m = centroids.shape
    dev = centroids.device
    cs = torch.zeros((b, tiling.kp, tiling.mp), dtype=torch.bfloat16,
                     device=dev)
    cs[:, :k, :m] = centroids
    ccp = torch.full((b, tiling.kp), float("inf"), dtype=torch.float32,
                     device=dev)
    ccp[:, :k] = (centroids * centroids).sum(dim=-1)
    return cs, ccp


def _assign_fast(x: torch.Tensor, centroids: torch.Tensor,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-B fast's assignment on CUDA tensors (checked by the caller, B, N,
    K > 0): one call stages the centroids on the card into ``cs`` and
    ``ccp`` (as :func:`stage_centroids`) and launches the kernel; counted
    once. Returns ``(idx, cs, ccp)``. x is copied only where the TMA
    cannot read it in place: not 16-byte aligned, or M % 4 != 0, where x
    and the centroids both get zero columns up to a multiple of 4 (they
    add nothing to a product or a norm). Never waits on the device."""
    if x.shape[2] % 4:
        pad = -x.shape[2] % 4
        x = torch.nn.functional.pad(x, (0, pad))
        centroids = torch.nn.functional.pad(centroids, (0, pad))
    elif x.data_ptr() % 16:
        x = x.clone()
    b, n, m = x.shape
    k = centroids.shape[1]
    tiling = fast_tiling(b, n, k, m)
    dev = x.device
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    cs = torch.empty((b, tiling.kp, tiling.mp), dtype=torch.bfloat16,
                     device=dev)
    ccp = torch.empty((b, tiling.kp), dtype=torch.float32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.fdb_lloyd_round_fast(
            x.data_ptr(), centroids.data_ptr(), cs.data_ptr(),
            ccp.data_ptr(), idx.data_ptr(), b, n, k, m, tiling.kp, tiling.mp,
            tiling.chunk, tiling.stages, _kernels.stream_of(x))
    _kernels.check(rc, "lloyd_round_fast")
    _kernels.launched("lloyd_round_fast")
    return idx, cs, ccp


#: K-C fast (``csrc/lloyd_grouped_fast.cu``): rows a block (three consumer
#: warpgroups of 64), and a ring slot's bytes, one tile of 64 staged rows
#: of 128 bf16.
_GROUPED_ROWS = 192
_GROUPED_STAGE = _FAST_TILE * GROUP_WIDTH * 2


class GroupedFastTiling(NamedTuple):
    """How K-C fast runs on a shape (:func:`grouped_fast_tiling`): ``rows``
    a row block of one group (twelve consumer warps of 16), ``groups`` of
    them ``row_blocks`` in all; ``g`` divisions a group, taken
    ``per_pass`` at a time in ``passes`` over the centroid tiles; the
    staged centroids ``[groups, kp, 128]`` and norms ``[groups·g, kp]``;
    ``stages`` ring slots of one tile; ``smem`` bytes of shared memory a
    block."""
    rows: int
    row_blocks: int
    groups: int
    g: int
    per_pass: int
    passes: int
    kp: int
    stages: int
    smem: int


def grouped_fast_tiling(b: int, n: int, k: int, m: int) -> GroupedFastTiling:
    """K-C fast's tiling for ``b`` divisions of width ``m`` (8, 16, 32 or
    64) over ``n`` grouped rows and ``k`` centroids. A pure function of its
    arguments (no device query), so the order of every product and compare,
    and so the bits, are the same on every card. Kp is k padded to the
    64-centroid tile; a block holds the f32 x slot of its 192 rows (96 KB,
    K-B fast's resident slot at Mp = 128) and as many ring slots, up to 8,
    as its shared memory leaves."""
    if m not in GROUPED_WIDTHS:
        raise ValueError(f"K-C fast takes m in {GROUPED_WIDTHS}, got {m}")
    g = GROUP_WIDTH // m
    gg = -(-b // g)
    # Divisions a pass over the centroid tiles: their running minima are
    # what a thread holds beside its fragments and two accumulator sets
    # (eight a pass spilled registers at m = 8, 16 and 32).
    per_pass = 4 if m <= 16 else 2
    kp = -(-k // _FAST_TILE) * _FAST_TILE
    # The alignment slack, the x slot (f32) and its two barriers; a ring
    # slot and its two barriers.
    fixed = 1024 + _GROUPED_ROWS * GROUP_WIDTH * 4 + 16
    stage = _GROUPED_STAGE + 16
    stages = min(_FAST_STAGES, (_SMEM_MAX - fixed) // stage)
    return GroupedFastTiling(_GROUPED_ROWS, gg * -(-n // _GROUPED_ROWS), gg, g,
                             per_pass, g // per_pass, kp, stages,
                             fixed + stages * stage)


def stage_grouped_centroids(centroids: torch.Tensor,
                            tiling: GroupedFastTiling,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``centroids [B, K, m]`` f32 → ``(cs [G, Kp, 128]`` bf16: row k of
    group j holds the k-th centroid of each of divisions ``j·g … j·g + g −
    1`` side by side, division i in columns ``i·m … i·m + m − 1``, rounded
    to nearest even as ``astype(bfloat16)`` rounds, zeros in the pad
    divisions and past K; ``ccp [G·g, Kp]`` f32, ``‖c‖²`` of the f32
    centroids, +inf in the pad divisions and past K). K-C fast's operands,
    made once a round, as the TPU kernel makes its block-diagonal ``bdhi``
    and ``cc`` outside its grid (``cs`` is ``bdhi`` with its zeros
    compacted away): the plain version of the kernel's own staging, which
    adds each ``‖c‖²`` in another fixed order."""
    b, k, m = centroids.shape
    gg, g, kp = tiling.groups, tiling.g, tiling.kp
    dev = centroids.device
    padded = torch.zeros((gg * g, kp, m), dtype=torch.float32, device=dev)
    padded[:b, :k] = centroids
    cs = padded.reshape(gg, g, kp, m).transpose(1, 2) \
        .reshape(gg, kp, GROUP_WIDTH).to(torch.bfloat16)
    ccp = torch.full((gg * g, kp), float("inf"), dtype=torch.float32,
                     device=dev)
    ccp[:b, :k] = (centroids * centroids).sum(dim=-1)
    return cs, ccp


def _assign_grouped_fast(xg: torch.Tensor, centroids: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-C fast's assignment on CUDA tensors (checked by the caller, B, N,
    K > 0, ``xg`` 16-byte aligned): one call stages the centroids on the
    card into ``cs`` and ``ccp`` (as :func:`stage_grouped_centroids`) and
    launches the kernel; counted once. Returns ``(idx, cs, ccp)``. Never
    waits on the device."""
    b, k, m = centroids.shape
    gg, n, _ = xg.shape
    tiling = grouped_fast_tiling(b, n, k, m)
    dev = xg.device
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    cs = torch.empty((gg, tiling.kp, GROUP_WIDTH), dtype=torch.bfloat16,
                     device=dev)
    ccp = torch.empty((gg * tiling.g, tiling.kp), dtype=torch.float32,
                      device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.fdb_lloyd_grouped_fast(
            xg.data_ptr(), centroids.data_ptr(), cs.data_ptr(),
            ccp.data_ptr(), idx.data_ptr(), b, gg, n, k, m, tiling.kp,
            tiling.stages, _kernels.stream_of(xg))
    _kernels.check(rc, "lloyd_grouped_fast")
    _kernels.launched("lloyd_grouped_fast")
    return idx, cs, ccp


def lloyd_round(x: torch.Tensor, centroids: torch.Tensor,
                fast_math: bool = False,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assignment, then the cluster-sum pass; see the module docstring."""
    _check(x, centroids)
    if x.device.type == "cpu":
        return lloyd_round_plain(x, centroids, fast_math)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device: {x.device}")
    b, n, m = x.shape
    k = centroids.shape[1]
    if k == 0:
        raise ValueError("lloyd_round needs at least one centroid")
    if b == 0 or n == 0:
        return (torch.empty((b, n), dtype=torch.int32, device=x.device),
                torch.zeros((b, k, m), device=x.device),
                torch.zeros((b, k), device=x.device))
    if fast_math:
        idx = _assign_fast(x, centroids)[0]
    else:
        idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
        cc = (centroids * centroids).sum(dim=-1).contiguous()
        vec = m % 4 == 0 and x.data_ptr() % 16 == 0 \
            and centroids.data_ptr() % 16 == 0
        lib = _kernels.load()
        with torch.cuda.device(x.device):
            rc = lib.fdb_lloyd_round(
                x.data_ptr(), centroids.data_ptr(), cc.data_ptr(),
                idx.data_ptr(), b, n, k, m, int(vec), _kernels.stream_of(x))
        _kernels.check(rc, "lloyd_round")
        _kernels.launched("lloyd_round")
    return (idx, *_launch_sums(x, idx, b, n, k, m, 1, fast_math))
