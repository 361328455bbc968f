#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``flechasdb_tpu_torch``) once on one
NVIDIA GPU and checks what comes out.

    python3 chip_smoke.py [--seed N]

Set-up: refuses to run without CUDA; prints the card's name and power
limit, the torch, CUDA and nvcc versions and both TF32 flags (set on,
as many applications set them: the port's cuBLAS ranking products must
still run in full f32, and K-B's 3xTF32 product does not read the flags;
every comparison below shows whether they hold); builds the kernels from
``flechasdb_tpu_torch/csrc`` and times the build.

1. Kernel parity. Each hand-written kernel runs against its plain
   PyTorch version on the card at the main paths' shapes: K-A (ADC bucket
   scan) packed D=12, packed D=8 and unpacked C=200; ``adc_lookup`` (K-A
   over pre-gathered codes) at G=640, D=8, C=256, L=1280 unpacked; K-B
   (fused Lloyd round) at the coarse fit (B=1, N=100k, K=100, M=1536), the
   PQ fit (B=12, N=100k, K=256, m=128), K=1024, the SIFT coarse fit (B=1,
   N=1M, K=1024, M=128) and duplicated centroids for the tie order; K-C
   (grouped Lloyd round) at the SIFT PQ shape (B=8, N=1M, K=256, m=16),
   GIST's division count with pad slots (B=60, N=100k, m=16), m=8, m=32
   and duplicated centroids, each also held to K-B's assignment on the
   ungrouped data (both rank with the same 3xTF32 tensor-core product in
   the same order, so the rows that differ are expected to be 0; the
   check allows near-ties). The kernels' ``ptxas`` registers and spills
   are printed for each K-C instance.
   Kernel and plain times are CUDA-event means over back-to-back warm
   calls (median of five); at the SIFT PQ shape K-B is timed on the
   ungrouped data beside K-C.
2. The headline slice. ``DatabaseBuilder(x, device="cuda")`` over
   bench.py's data (100,000 x 1536 unit rows; P=100, D=12, C=256), then
   ``query_batch`` over 64 queries and ``query`` over 8, k=10, nprobe=5.
   The results must agree with the same database queried on the CPU,
   where the plain versions run (rows up to distance ties, distances
   within rel 1e-4, abs 1e-5), and the build must have quantized well.
3. The SIFT1M-shaped path. 1,000,000 x 128 GMM rows and 1,000 queries
   (256 components, intrinsic 12; numpy, from the seed), built with P=1024,
   D=8 (m=16, so the PQ fit takes K-C) and C=256; all 1,000 queries at
   k=10, nprobe=10, without and with exact rerank of the top 100, through
   ``DeviceIndex(layout="bucketed")``'s ``query`` and ``query_rerank``,
   as the JAX package's sweep serves this configuration. Quality against
   exact ground truth on the card: recall@10, coarse@10 (the share of true
   neighbours whose partition was probed) and recall@10 after rerank.
   Then ``Database.query_batch``, which serves from the layout the JAX
   package's policy picks for this skewed corpus (masked), is timed with
   and without rerank. 64 of the queries, from the bucketed index and
   from ``query_batch``, must agree with the CPU plain path (the policy's
   layout), with and without rerank, and a masked ``DeviceIndex`` with
   the bucketed one; the masked layout's time for all 1,000 queries and
   its peak device memory, which must stay within its budget, are
   printed.

Launch counts are zeroed just before each path (the build and its
queries) and read just after; every kernel a path runs must have run.
The line before the last is the kernels' JSON record: a row per TPU
kernel of the JAX package, with its counterpart's launches over the two
paths, its time, its plain version's and its bound from this run's
inputs: the larger of bytes over 3.35 TB/s and operations over the rate
of the units the kernel runs on, the H100 SXM's published peaks (K-B,
K-C: TF32 tensor cores, 494.7 TFLOP/s; K-A: fp32, 67 TFLOP/s). The
operations are those the function needs (2·B·N·K·M for a Lloyd round),
not those of a route: the 3xTF32 product issues three times as many.
The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero with no result line.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N, M, P, D, C = 100_000, 1536, 100, 12, 256
K_TOP, NPROBE, N_BATCH, N_SINGLE = 10, 5, 64, 8
SIFT_N, SIFT_NQ, SIFT_M, SIFT_P, SIFT_D = 1_000_000, 1000, 128, 1024, 8
SIFT_NPROBE, RERANK, N_CHECK = 10, 100, 64
RTOL, ATOL = 1e-4, 1e-5          # the query path's parity tolerance
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3  # Lloyd sums: f32 atomics in any order
TIE_REL = 1e-5                   # Lloyd picks may differ only this close
FP32_FLOPS, HBM_BYTES = 67e12, 3.35e12   # H100 SXM published peaks
TF32_FLOPS = 494.7e12                     # H100 SXM dense TF32

SRC_A = "flechasdb_tpu_torch/csrc/adc_scan.cu"
SRC_B = "flechasdb_tpu_torch/csrc/lloyd_round.cu"
SRC_C = "flechasdb_tpu_torch/csrc/lloyd_grouped.cu"
REPLACES = {
    "indexed": "flechasdb_tpu/ops/pallas_scan.py:528",
    "pipe": "flechasdb_tpu/ops/pallas_scan.py:320",
    "lookup": "flechasdb_tpu/ops/pallas_scan.py:133",
    "round": "flechasdb_tpu/ops/pallas_kmeans.py:36",
    "grouped": "flechasdb_tpu/ops/pallas_kmeans.py:143",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Time of one warm call of ``fn``: the mean over ``reps`` back-to-back
    calls between two CUDA events, median of five such means."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS,
          ops: str = "operations") -> tuple[float, str]:
    """The least time (ms) for the work, and which of the two sets it:
    ``flops`` run at ``rate``, named ``ops`` when they bind."""
    by_bytes, by_ops = nbytes / HBM_BYTES * 1e3, flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, ops)


def lloyd_bound(x_bytes: int, b: int, n: int, k: int, m: int, rate: float,
                ops: str):
    """A Lloyd round reads x and the centroids once and writes indices,
    sums and counts; it needs 2·B·N·K·m flops, run at ``rate``, the peak
    of the units the kernel runs on (``ops`` names them)."""
    io = x_bytes + 4 * (b * k * m + b * k) + 4 * (b * n + b * k * m + b * k)
    return bound(io, 2.0 * b * n * k * m, rate, ops)


def scan_bound(codes, ftab, bidx, lengths, d: int):
    """K-A reads each probed bucket's live codes once, every table, the
    bucket indices and lengths (when given), and writes [G, L]; D adds a
    live slot."""
    g, l = ftab.shape[0], codes.shape[2]
    rows = codes.shape[1]
    buckets = bidx.long().unique()
    if lengths is None:               # adc_lookup: codes and tables only
        live_slots = float(len(buckets) * l)
        cell_slots = float(g * l)
        extra = 0
    else:
        first = {int(p): int(n) for p, n in zip(bidx.tolist(),
                                                lengths.tolist())}
        live_slots = float(sum(first[int(p)] for p in buckets.tolist()))
        cell_slots = float(lengths.sum())
        extra = 8 * g
    io = 4 * (rows * live_slots + ftab.numel() + g * l) + extra
    return bound(io, cell_slots * d)


def setup(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    from flechasdb_tpu_torch import _kernels
    nvcc = subprocess.run([_kernels._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _kernels.load()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s")
    if _kernels.build_log:
        log(_kernels.build_log.strip())
        for line in grouped_ptxas(_kernels.build_log):
            log(line)


def grouped_ptxas(build_log: str) -> list:
    """One line per K-C instance (its subvector width M) from ``ptxas -v``:
    registers, stack frame and spills."""
    out, name, frame = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "spill" in line:
            frame = line.strip()
        elif name and "Used" in line:
            w = re.search(r"grouped_round_kernelILi(\d+)E", name)
            if w:
                regs = re.search(r"Used (\d+) registers", line)
                out.append(f"K-C ptxas M={w.group(1)}: "
                           f"{regs.group(1) if regs else '?'} registers, "
                           f"{frame}")
            name = None
    return out


# --- phase 1: kernel parity -------------------------------------------------

def pack(torch, raw, d):
    p, _, l = raw.shape
    words = torch.zeros((p, -(-d // 4), l), dtype=torch.int32,
                        device=raw.device)
    for di in range(d):
        words[:, di // 4] |= raw[:, di] << (8 * (di % 4))
    return words


def parity_scan(torch, gen, d, c, packed, l=2048, g=N_BATCH * NPROBE):
    from flechasdb_tpu_torch.ops import scan
    dev = "cuda"
    raw = torch.randint(0, c, (P, d, l), generator=gen, device=dev,
                        dtype=torch.int32)
    codes = pack(torch, raw, d) if packed else raw
    ftab = torch.rand((g, d * c), generator=gen, device=dev)
    bidx = torch.randint(0, P, (g,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens = torch.randint(0, l + 1, (g,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = 0, l
    got = scan.adc_lookup_indexed(codes, ftab, bidx, lens, d=d)
    want = scan.adc_lookup_indexed_plain(codes, ftab, bidx, lens, d=d)
    torch.cuda.synchronize()
    err = scan_error(torch, got, want)
    ms = cuda_ms(torch, lambda: scan.adc_lookup_indexed(
        codes, ftab, bidx, lens, d=d), 20)
    plain_ms = cuda_ms(torch, lambda: scan.adc_lookup_indexed_plain(
        codes, ftab, bidx, lens, d=d), 20)
    log(f"K-A adc_scan D={d} C={c} rows={codes.shape[1]} G={g} L={l}: "
        f"max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def parity_lookup(torch, gen, g=640, d=8, c=256, l=1280):
    """``adc_lookup`` at the roofline's SIFT shape (benchmarks/roofline.py:
    166-182): 64 queries x nprobe 10 pre-gathered unpacked buckets."""
    from flechasdb_tpu_torch.ops import scan
    codes = torch.randint(0, c, (g, d, l), generator=gen, device="cuda",
                          dtype=torch.int32)
    ftab = torch.rand((g, d * c), generator=gen, device="cuda")
    got = scan.adc_lookup(codes, ftab, d=d)
    want = scan.adc_lookup_plain(codes, ftab, d=d)
    torch.cuda.synchronize()
    err = scan_error(torch, got, want)
    ms = cuda_ms(torch, lambda: scan.adc_lookup(codes, ftab, d=d), 50)
    plain_ms = cuda_ms(torch, lambda: scan.adc_lookup_plain(codes, ftab,
                                                            d=d), 50)
    bms, by = scan_bound(codes, ftab, torch.arange(g), None, d)
    log(f"adc_lookup (K-A) G={g} D={d} C={c} L={l} unpacked: max_abs_err "
        f"{err:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
        f"{bms:.4f} ms ({by})")
    return err, ms, plain_ms, bms, by


def scan_error(torch, got, want) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"K-A shape {got.shape} != {want.shape}")
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("K-A +inf slots differ from the plain version")
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    bound_ = ATOL + RTOL * want[fin].abs()
    if bool((diff > bound_).any()):
        raise AssertionError(f"K-A disagrees: max abs err "
                             f"{float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def parity_lloyd(torch, gen, b, n, k, m, dup=False, time_it=True,
                 grouped=False):
    """K-B (or, ``grouped``, K-C on the regrouped data) against its plain
    version; K-C also against K-B's assignment. Picks may differ only
    where two centroids are within TIE_REL of a tie."""
    from flechasdb_tpu_torch.ops import lloyd
    dev = "cuda"
    name = "K-C lloyd_grouped" if grouped else "K-B lloyd_round"
    x = torch.randn((b, n, m), generator=gen, device=dev)
    x /= x.norm(dim=(0, 2), keepdim=True)        # unit rows across B·m
    pick = torch.randint(0, n, (k,), generator=gen, device=dev)
    c = x[:, pick].contiguous()
    if dup:
        c[:, 7] = c[:, 3]
        c[:, k - 1] = c[:, 3]
    if grouped:
        xg = lloyd.regroup_divisions(x)

        def kernel():
            return lloyd.lloyd_round_grouped(xg, c)

        def plain():
            return lloyd.lloyd_round_grouped_plain(xg, c)
        x_bytes = xg.numel() * 4
    else:
        def kernel():
            return lloyd.lloyd_round(x, c)

        def plain():
            return lloyd.lloyd_round_plain(x, c)
        x_bytes = x.numel() * 4
    idx, sums, counts = kernel()
    p_idx, p_sums, p_counts = plain()
    torch.cuda.synchronize()
    if dup and bool(((idx == 7) | (idx == k - 1)).any()):
        raise AssertionError(f"{name} picked a later duplicate centroid")
    ties = tie_rows(x, c, idx, p_idx, f"{name} against its plain version")
    if grouped:
        # K-C splits, multiplies and accumulates as K-B does, so their
        # distances and picks are expected to be equal (0 rows differ).
        kb_ties = tie_rows(x, c, idx, lloyd.lloyd_round(x, c)[0],
                           "K-C against K-B")
    # Sums and counts checked against the plain scatter of the kernel's
    # own assignment, so tie rows do not blur the check.
    flat = (idx.long() + k * torch.arange(b, device=dev)[:, None]
            ).reshape(-1)
    ref = torch.zeros((b * k, m), device=dev).index_add_(
        0, flat, x.reshape(-1, m)).reshape(b, k, m)
    ref_counts = torch.bincount(flat, minlength=b * k).reshape(b, k)
    if not torch.equal(counts, ref_counts.float()):
        raise AssertionError(f"{name} counts differ")
    err = float((sums - ref).abs().max())
    if bool(((sums - ref).abs() > SUM_ATOL + SUM_RTOL * ref.abs()).any()):
        raise AssertionError(f"{name} sums disagree: max abs err {err}")
    if ties == 0 and not torch.equal(counts, p_counts):
        raise AssertionError(f"{name} counts differ from the plain version")
    ms = plain_ms = kb_ms = float("nan")
    if time_it:
        ms = cuda_ms(torch, kernel, 5)
        plain_ms = cuda_ms(torch, plain, 5)
        if grouped:
            kb_ms = cuda_ms(torch, lambda: lloyd.lloyd_round(x, c), 5)
    bms, by = lloyd_bound(x_bytes, b, n, k, m, TF32_FLOPS,
                          "operations (TF32 tensor cores)")
    log(f"{name} B={b} N={n} K={k} M={m}{' dup' if dup else ''}: "
        f"{ties} tie rows differ"
        + (f", {kb_ties} rows from K-B's (0 expected)" if grouped else "")
        + f"  sums max_abs_err {err:.3g}  "
        f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
        + (f"  K-B on the ungrouped data {kb_ms:.3f} ms" if grouped
           else "") + f"  bound {bms:.3f} ms ({by})")
    return err, ms, plain_ms, bms, by


def tie_rows(x, c, got, want, what: str):
    """The rows where two assignments of ``x`` to ``c`` differ; raises
    unless each such row's two centroids lie within TIE_REL of a tie
    (float64 distances, relative to the row's distance scale)."""
    mism = (got != want).nonzero()
    if len(mism):
        bb, ii = mism[:, 0], mism[:, 1]
        x64 = x[bb, ii].double()
        c64 = c.double()
        cc64 = (c64 * c64).sum(-1)

        def dist(kk):
            ck = c64[bb, kk.long()]
            return cc64[bb, kk.long()] - 2 * (x64 * ck).sum(-1)

        scale = (x64 * x64).sum(-1) + cc64.max()
        gap = (dist(got[bb, ii]) - dist(want[bb, ii])).abs()
        if bool((gap > TIE_REL * scale).any()):
            raise AssertionError(
                f"{what}: assignment differs beyond ties at {len(mism)} rows")
    return len(mism)


# --- phases 2 and 3: the paths ----------------------------------------------

def same_results(got, want, what: str) -> int:
    """Distances position by position; rows equal up to distance ties.
    Returns the number of rows that sat in a tie and swapped."""
    swapped = 0
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results != {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.isclose(g.squared_distance, w.squared_distance,
                          rtol=RTOL, atol=ATOL):
            raise AssertionError(
                f"{what}[{i}]: distance {g.squared_distance} != "
                f"{w.squared_distance}")
        if g.vector_id != w.vector_id:
            twin = [r for r in want if r.vector_id == g.vector_id]
            if not (twin and np.isclose(
                    twin[0].squared_distance, g.squared_distance,
                    rtol=RTOL, atol=ATOL)) and i != len(got) - 1:
                raise AssertionError(f"{what}[{i}]: row differs outside "
                                     "a distance tie")
            swapped += 1
    return swapped


def same_arrays(got, want, what: str) -> int:
    """:func:`same_results` for host ``(dists, rows)`` arrays."""
    gd, gr = got
    wd, wr = want
    if not np.array_equal(np.isinf(gd), np.isinf(wd)):
        raise AssertionError(f"{what}: +inf slots differ")
    fin = np.isfinite(wd)
    if not np.allclose(gd[fin], wd[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: distances differ")
    swapped = 0
    for b, i in zip(*np.nonzero((gr != wr) & fin)):
        twin = np.flatnonzero(wr[b] == gr[b, i])
        if not (twin.size and np.isclose(wd[b, twin[0]], gd[b, i],
                                         rtol=RTOL, atol=ATOL)) \
                and i != gr.shape[1] - 1:
            raise AssertionError(f"{what}[{b}, {i}]: row differs outside "
                                 "a distance tie")
        swapped += 1
    return swapped


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def build_db(torch, ft, x, p, d, c, seed):
    """Zeroes the launch counts and builds on the card: ``(db, seconds,
    launches after the build)``."""
    from flechasdb_tpu_torch import _kernels
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = (ft.DatabaseBuilder(x, device="cuda").with_partitions(p)
          .with_divisions(d).with_clusters(c).with_seed(seed).build())
    torch.cuda.synchronize()
    return db, time.perf_counter() - t0, dict(_kernels.LAUNCHES)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def slice_run(torch, seed: int):
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    x = rng.standard_normal((N, M), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(N, N_BATCH + N_SINGLE, replace=False)]
    q = q + 0.02 * rng.standard_normal(q.shape, dtype=np.float32)
    log(f"data {N}x{M} (numpy, seed {seed}): "
        f"{time.perf_counter() - t0:.3f} s")

    db, build_s, after_build = build_db(torch, ft, x, P, D, C, seed)
    batch, cold_ms = timed(lambda: db.query_batch(q[:N_BATCH], k=K_TOP,
                                                  nprobe=NPROBE))
    batch, warm_ms = timed(lambda: db.query_batch(q[:N_BATCH], k=K_TOP,
                                                  nprobe=NPROBE))
    singles, single_ms = [], []
    for v in q[N_BATCH:]:
        res, ms = timed(lambda: db.query(v, k=K_TOP, nprobe=NPROBE))
        singles.append(res)
        single_ms.append(ms)
    launches = dict(_kernels.LAUNCHES)
    layout = db._device_state().layout
    log(f"build: {build_s:.3f} s  launches after build {after_build}")
    log(f"query_batch({N_BATCH}): first {cold_ms:.3f} ms (builds the "
        f"device index), warm {warm_ms:.3f} ms; query: median "
        f"{statistics.median(single_ms):.3f} ms over {N_SINGLE}")
    log(f"launches over the slice: {launches}  layout {layout}")
    require(layout == "bucketed", f"layout {layout!r} is not bucketed")
    require(after_build["lloyd_round"] > 0, "the build launched no "
            "lloyd_round")
    require(launches["adc_scan"] > 0, "the queries launched no adc_scan")

    check_build(db, x, P, D, C)
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    swapped = 0
    for b, got in enumerate(batch):
        want = ref.query_batch(q[b:b + 1], k=K_TOP, nprobe=NPROBE)[0]
        swapped += same_results(got, want, f"query_batch[{b}]")
    for i, got in enumerate(singles):
        want = ref.query(q[N_BATCH + i], k=K_TOP, nprobe=NPROBE)
        swapped += same_results(got, want, f"query[{i}]")
    log(f"results agree with the CPU plain path ({swapped} tie swaps)")
    return launches, scan_at_main_path(torch, db._device_state(),
                                       q[:N_BATCH], NPROBE, "the slice's")


def check_build(db, x, p, d, c) -> None:
    """Shapes, ranges, and quantization that beats the data's spread."""
    n, m = x.shape
    require(db.partition_centroids.shape == (p, m), "centroid shape")
    require(db.codebooks.shape == (d, c, m // d), "codebook shape")
    require(db.codes.shape == (n, d) and int(db.codes.max()) < c, "codes")
    require(0 <= db.partition_indices.min()
            and db.partition_indices.max() < p, "partition indices")
    for a in (db.partition_centroids, db.codebooks, db.residues):
        require(bool(np.isfinite(a).all()), "non-finite build output")
    sub = np.random.default_rng(0).choice(n, min(n, 10_000), replace=False)
    coarse = db.residues[sub]
    spread = ((x[sub] - x[sub].mean(0)) ** 2).sum()
    recon = db.codebooks[np.arange(d)[None, :], db.codes[sub]]  # [n, D, m]
    pq_err = ((coarse - recon.reshape(len(sub), m)) ** 2).sum()
    coarse_err = (coarse ** 2).sum()
    log(f"quantization: coarse {coarse_err / spread:.4f} of the spread, "
        f"PQ {pq_err / coarse_err:.4f} of the residue energy")
    require(coarse_err < spread and pq_err < coarse_err,
            "the build did not quantize the data")


def scan_at_main_path(torch, index, q, nprobe, what):
    """K-A against its plain version on a path's own bucketed index and
    the tables of its query batch (these launches are not counted in the
    path's run, which has ended)."""
    from flechasdb_tpu_torch.ops import adc, bucketed, scan
    bk = index.buckets
    d, c, _ = index.codebooks.shape
    qd = torch.as_tensor(q, device="cuda")
    coarse = adc.coarse_scores(qd, index.centroids)
    probed = torch.sort(coarse, dim=1, stable=True).indices[:, :nprobe]
    tables = bucketed.probed_tables(qd, index.centroids, index.codebooks,
                                    probed, coarse=coarse)
    args = (bk.codes, tables.reshape(-1, d * c).contiguous(),
            probed.reshape(-1).to(torch.int32).contiguous(),
            bk.lengths[probed].reshape(-1).contiguous())
    got = scan.adc_lookup_indexed(*args, d=d)
    want = scan.adc_lookup_indexed_plain(*args, d=d)
    torch.cuda.synchronize()
    err = scan_error(torch, got, want)
    ms = cuda_ms(torch, lambda: scan.adc_lookup_indexed(*args, d=d), 20)
    plain_ms = cuda_ms(torch, lambda: scan.adc_lookup_indexed_plain(
        *args, d=d), 20)
    bms, by = scan_bound(*args, d)
    log(f"K-A adc_scan at {what} buckets: codes {tuple(bk.codes.shape)}"
        f" G={args[1].shape[0]}  max_abs_err {err:.3g}  kernel {ms:.4f} ms"
        f"  plain {plain_ms:.4f} ms  bound {bms:.4f} ms ({by})")
    return err, ms, plain_ms, bms, by


def ground_truth(torch, x, q, k: int) -> np.ndarray:
    """Exact k nearest rows on the card: f32 expanded distances pick 4k
    candidates, a subtract-then-square re-score orders them."""
    from flechasdb_tpu_torch.ops.distance import full_f32
    xd = torch.as_tensor(x, device="cuda")
    xx = (xd * xd).sum(1)
    out = []
    with full_f32():
        for s in range(0, len(q), 250):
            qd = torch.as_tensor(q[s:s + 250], device="cuda")
            d = xx[None, :] - 2.0 * qd @ xd.T
            cand = torch.topk(d, 4 * k, dim=1, largest=False).indices
            exact = ((xd[cand] - qd[:, None, :]) ** 2).sum(-1)
            order = torch.sort(exact, dim=1, stable=True).indices[:, :k]
            out.append(cand.gather(1, order).cpu().numpy())
    return np.concatenate(out)


def host_arrays(results, row_of, k: int):
    """``query_batch`` results as ``(dists [B, k], rows [B, k])`` corpus
    rows, ``+inf`` past the reachable vectors."""
    dists = np.full((len(results), k), np.inf, np.float32)
    rows = np.full((len(results), k), -1, np.int64)
    for b, rs in enumerate(results):
        dists[b, :len(rs)] = [r.squared_distance for r in rs]
        rows[b, :len(rs)] = [row_of[r.vector_id] for r in rs]
    return dists, rows


def sift_run(torch, seed: int):
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import _kernels, synth
    from flechasdb_tpu_torch.host import bucket_len
    from flechasdb_tpu_torch.serving import DeviceIndex

    t0 = time.perf_counter()
    x, q = synth.gmm_pair(np.random.default_rng(seed), SIFT_N, SIFT_NQ,
                          SIFT_M, n_clusters=256, intrinsic=12)
    log(f"SIFT data {SIFT_N}x{SIFT_M} + {SIFT_NQ} queries (numpy GMM, seed "
        f"{seed}): {time.perf_counter() - t0:.3f} s")

    db, build_s, after_build = build_db(torch, ft, x, SIFT_P, SIFT_D, C,
                                        seed)
    arrays = (db.partition_centroids, db.codebooks,
              db.codes.astype(np.int32), db.partition_indices)
    # The JAX package's sweep serves this configuration from buckets
    # whatever the skew (benchmarks/sweep.py:121-128); so does this path.
    index, index_ms = timed(lambda: DeviceIndex(
        *arrays, layout="bucketed", metric=db.metric, device="cuda"))
    orig, orig_ms = timed(db._device_originals)
    kw = dict(k=K_TOP, nprobe=SIFT_NPROBE)
    _, cold_ms = timed(lambda: index.query(q, **kw))
    adc_ms = []
    for _ in range(3):
        adc, ms = timed(lambda: index.query(q, **kw))
        adc_ms.append(ms)
    _, rr_cold_ms = timed(lambda: index.query_rerank(q, orig, rerank=RERANK,
                                                     **kw))
    rr_ms = []
    for _ in range(3):
        rr, ms = timed(lambda: index.query_rerank(q, orig, rerank=RERANK,
                                                  **kw))
        rr_ms.append(ms)
    launches = dict(_kernels.LAUNCHES)
    log(f"SIFT build: {build_s:.3f} s  launches after build {after_build}")
    log(f"SIFT DeviceIndex(layout='bucketed'): {index_ms:.3f} ms, buckets "
        f"{tuple(index.buckets.codes.shape)}; originals upload "
        f"{orig_ms:.3f} ms")
    log(f"SIFT DeviceIndex.query({SIFT_NQ}, k={K_TOP}, nprobe={SIFT_NPROBE})"
        f": first {cold_ms:.3f} ms, warm {statistics.median(adc_ms):.3f} ms "
        f"(median of 3: {', '.join(f'{v:.3f}' for v in adc_ms)}); "
        f"query_rerank({RERANK}): first {rr_cold_ms:.3f} ms, warm "
        f"{statistics.median(rr_ms):.3f} ms (median of 3: "
        f"{', '.join(f'{v:.3f}' for v in rr_ms)})")
    log(f"launches over the SIFT path: {launches}")
    require(after_build["lloyd_grouped"] > 0,
            "the SIFT build launched no lloyd_grouped")
    require(after_build["lloyd_round"] > 0,
            "the SIFT build launched no lloyd_round")
    require(launches["adc_scan"] > after_build["adc_scan"],
            "the SIFT queries launched no adc_scan")
    check_build(db, x, SIFT_P, SIFT_D, C)

    t0 = time.perf_counter()
    gt = ground_truth(torch, x, q, K_TOP)

    def recall(rows):
        return float(np.mean([len(set(rows[b].tolist()) & set(gt[b].tolist()))
                              / K_TOP for b in range(len(q))]))

    coarse = float(np.mean(
        [np.isin(db.partition_indices[gt[b]], adc[2][b]).mean()
         for b in range(len(q))]))
    r_adc, r_rr = recall(adc[1]), recall(rr[1])
    log(f"SIFT quality over {SIFT_NQ} queries ({time.perf_counter() - t0:.3f}"
        f" s): recall@10 {r_adc:.4f}  coarse@10 {coarse:.4f}  recall@10 "
        f"after rerank {RERANK} {r_rr:.4f}")
    require(coarse >= 0.95, f"coarse@10 {coarse} < 0.95")
    require(r_rr >= 0.9 and r_rr >= r_adc,
            f"rerank recall {r_rr} below 0.9 or the ADC recall {r_adc}")

    # Database.query_batch, which serves from the layout the policy picks
    # for this corpus (the JAX package's _choose_layout).
    counts = np.bincount(db.partition_indices, minlength=SIFT_P)
    _, qb_cold_ms = timed(lambda: db.query_batch(q, **kw))
    qb_res, qb_ms = timed(lambda: db.query_batch(q, **kw))
    qbr_res, qbr_ms = timed(lambda: db.query_batch(q, rerank=RERANK, **kw))
    log(f"SIFT partitions: largest {counts.max()}, smallest {counts.min()}, "
        f"bucket length {bucket_len(counts)}; Database.query_batch serves "
        f"from the {db._device_state().layout} layout: first {qb_cold_ms:.3f}"
        f" ms (builds its device index), warm {qb_ms:.3f} ms, rerank="
        f"{RERANK} {qbr_ms:.3f} ms")

    t0 = time.perf_counter()
    ref = ft.Database(**ft.to_arrays(db), device="cpu")
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    qc = q[:N_CHECK]
    swapped = 0
    for rr_depth, mine, got in ((None, adc, qb_res), (RERANK, rr, qbr_res)):
        want = ref.query_batch(qc, rerank=rr_depth, **kw)
        swapped += same_arrays((mine[0][:N_CHECK], mine[1][:N_CHECK]),
                               host_arrays(want, row_of, K_TOP),
                               f"SIFT bucketed rerank={rr_depth}")
        for b in range(N_CHECK):
            swapped += same_results(got[b], want[b],
                                    f"SIFT query_batch rerank={rr_depth} [{b}]")
    log(f"SIFT results of {N_CHECK} queries, from the bucketed index and from"
        f" Database.query_batch, agree with the CPU plain path "
        f"({ref._device_state().layout} layout), with and without rerank "
        f"({swapped} tie swaps; {time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    masked = DeviceIndex(*arrays, layout="masked", metric=db.metric,
                         device="cuda")
    masked.query(q, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, masked_ms = timed(lambda: masked.query(q, **kw))
    peak = torch.cuda.max_memory_allocated() - base
    m_d, m_r, m_p = masked.query(qc, **kw)
    b_d, b_r, b_p = index.query(qc, **kw)
    require(np.array_equal(m_p, b_p), "masked layout probed other partitions")
    swapped = same_arrays((m_d, m_r), (b_d, b_r), "masked vs bucketed")
    swapped += same_arrays(
        masked.query_rerank(qc, orig, rerank=RERANK, **kw),
        index.query_rerank(qc, orig, rerank=RERANK, **kw),
        "masked vs bucketed, rerank")
    log(f"masked layout ({masked._masked_batch_limit()} queries a chunk): "
        f"warm DeviceIndex.query of {SIFT_NQ} queries {masked_ms:.3f} ms, "
        f"peak device memory above its inputs {peak / 2**20:.1f} MiB of a "
        f"{masked.hbm_budget_bytes / 2**20:.0f} MiB budget; gives the "
        f"bucketed results for {N_CHECK} queries, with and without rerank "
        f"({swapped} tie swaps; {time.perf_counter() - t0:.3f} s)")
    require(peak <= masked.hbm_budget_bytes,
            f"the masked scan took {peak} bytes, over its budget")
    return launches, scan_at_main_path(torch, index, q, SIFT_NPROBE,
                                       "the SIFT path's")


def row(name, route, source, replaces, launches, err, ms, plain_ms, bms,
        by):
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    import torch
    t_all = time.perf_counter()
    setup(torch)

    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    a_cases = [parity_scan(torch, gen, 12, 256, True),
               parity_scan(torch, gen, 8, 256, True),
               parity_scan(torch, gen, 12, 200, False)]
    lookup = parity_lookup(torch, gen)
    b_cases = [parity_lloyd(torch, gen, 1, N, P, M),
               parity_lloyd(torch, gen, D, N, C, M // D),
               parity_lloyd(torch, gen, 1, 65_536, 1024, 128),
               parity_lloyd(torch, gen, 1, SIFT_N, SIFT_P, SIFT_M),
               parity_lloyd(torch, gen, D, N, C, M // D, dup=True,
                            time_it=False)]
    c_cases = [parity_lloyd(torch, gen, 8, SIFT_N, C, 16, grouped=True),
               parity_lloyd(torch, gen, 60, N, C, 16, grouped=True,
                            time_it=False),
               parity_lloyd(torch, gen, 16, N, C, 8, grouped=True,
                            time_it=False),
               parity_lloyd(torch, gen, 4, N, C, 32, grouped=True,
                            time_it=False),
               parity_lloyd(torch, gen, 8, N, C, 16, dup=True, grouped=True,
                            time_it=False)]
    log(f"phase 1 (kernel parity): {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    slice_launches, a_main = slice_run(torch, args.seed)
    log(f"phase 2 (100k x 1536 slice): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sift_launches, a_sift = sift_run(torch, args.seed)
    log(f"phase 3 (SIFT path): {time.perf_counter() - t0:.3f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    launches = {k: slice_launches[k] + sift_launches[k]
                for k in slice_launches}
    a_err = max(e[0] for e in a_cases + [a_main, a_sift])
    kernels = [
        row("adc_scan", "cuda", SRC_A, REPLACES["indexed"],
            launches["adc_scan"], a_err, *a_main[1:]),
        row("adc_scan", "cuda", SRC_A, REPLACES["pipe"],
            launches["adc_scan"], a_err, *a_sift[1:]),
        row("adc_lookup", "cuda", SRC_A, REPLACES["lookup"],
            launches["adc_lookup"], *lookup),
        row("lloyd_round", "cuda", SRC_B, REPLACES["round"],
            launches["lloyd_round"], max(e[0] for e in b_cases),
            *b_cases[1][1:]),
        row("lloyd_grouped", "cuda", SRC_C, REPLACES["grouped"],
            launches["lloyd_grouped"], max(e[0] for e in c_cases),
            *c_cases[0][1:]),
    ]
    log(f"total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
