// Cluster sums in a fixed order, for K-B and K-C (sm_90a).
//
// Replaces the sum half of the TPU kernels `_round_kernel`
// (flechasdb_tpu/ops/pallas_kmeans.py:121-140) and `_grouped_round_kernel`
// (:208-224), which add one-hot products over a tile of rows into a
// resident output block, the tiles in grid order. Given a Lloyd round's
// assignment idx [B, N] (K-B's or K-C's):
//
//     sums[b, k]   = sum of x_b[i] over the rows with idx[b, i] == k
//     counts[b, k] = number of such rows
//
// with x_b[i] = x[b / g, i, (b % g) M : (b % g + 1) M], rows rs floats
// apart: g = 1, rs = M for K-B's [B, N, M]; g = 128 / m, rs = 128 for K-C's
// division-grouped [GG, N, 128]. FAST adds the rows rounded to bf16
// (round_bf16, to nearest even), as the TPU kernels' fast_math branch sums
// its bf16 xhi.
//
// What bounds it: bytes. x read once, idx once, sums and counts written:
// 0.185 ms at K-B's PQ shape (B=12, N=100k, K=256, m=128), 0.154 at the
// SIFT coarse shape (N=1M, K=1024, M=128), 0.162 at K-C's SIFT PQ shape
// (B=8, N=1M, K=256, m=16), at 3.35 TB/s.
//
// Order. Every sum is taken in an order that idx and the shape alone fix,
// never the scheduling: no float atomics, no launch shape from the SM
// count or an occupancy query. So the same x and idx give the same bits
// in every launch, in every process, on any card that runs this binary.
//
// Two routes, picked by shape before the launch (ops/lloyd.py,
// sum_tiling, is the one place that picks; it hands the tiling over).
//
// The dense route (fdb_cluster_sums_dense): the TPU kernel's structure,
// tile-private partials added over the tiles in tile order. Two launches.
//  1. tile_sums: block (tile t of R rows, column slice s of S columns,
//     batch entry or K-C group). A producer warp streams the tile's rows
//     of the slice, in row order, through a ring of kStages shared-memory
//     stages: x by the TMA (one 1-D bulk copy a stage where the slice is
//     whole rows, one 2-D tensor copy where it is not), idx by 4-byte
//     cp.async, each stage completing on its slot's "full" mbarrier. So x
//     is read once, coalesced. The consumer warps take each stage as soon
//     as it lands and free its slot on an "empty" mbarrier: no
//     block-wide barrier a stage, so a warp with more rows in one stage
//     catches up in the next. A thread owns 1 column, or 4 as a float4
//     (K-B, S a multiple of 128): shared-memory instructions, not bytes,
//     bound the adds. It adds each row into a [K, S] f32 accumulator in
//     shared memory (acc[k][column], the column's own cluster k: lanes on
//     consecutive columns hit consecutive banks), the rows in ascending
//     order for every (k, column). For K-C, S = 128: the whole row of xg,
//     all g divisions, each column under its own division's cluster, so
//     xg is read once and not once a division. kGroup rows are in flight
//     a thread: their accumulator words are loaded together; a row whose
//     cluster an earlier row of the group also has takes that row's fresh
//     sum instead, and the stores go in row order, so the adds are exactly
//     the serial ones. K-B's narrower slices (S = 32 at K = 1024) give
//     each warp a class of clusters (k mod W): it lists its class's rows
//     of the stage (a ballot) and adds only those, and a cluster's rows
//     stay in one warp, in order. A stage all of one cluster (a skewed
//     cluster) is added by its warp straight from the stage, 16 rows in
//     flight, in registers; a run of one cluster after a group of it, 16
//     rows at a time the same way. The warps that hold a division's first
//     column count their rows with shared integer atomics (exact in any
//     order). The tile's dense [K, S] partial and its counts go to scratch.
//  2. combine_tiles: a thread an output (b, k, column) adds its T
//     partials in tile order, from 0, and writes sums; a thread a (b, k)
//     adds its tile counts and writes counts as f32.
// The tiling is a pure function of (B, N, K, M, g), never of the card:
// S such that the accumulator, K S 4 bytes, stays within 160 KiB (at most
// 128 columns; for K-C, S = 128); R the smallest power of two (from 256)
// whose partials, B T K M 4 bytes, stay within a tenth of x or 16 MiB;
// the stage rows such that all of it fits a block's 227 KB. Plain f32 adds
// only (no contraction, no reassociation), bf16 rounding to nearest even,
// so the route equals ops/lloyd.cluster_sums_ordered bit for bit.
//
// The sort route (fdb_cluster_sums), where no S >= 8 fits (K above 5120
// at K-B, above 320 at K-C), unchanged from before the dense route:
//  1. tile_count: one warp a tile of kTileRows rows counts them into its
//     own slot hist[b, t, :], 32 rows a step: __match_any_sync groups the
//     step's lanes by cluster and the group's lowest lane adds its size.
//  2. tile_scan: for each cluster, an exclusive scan of the tile counts in
//     tile order, and their total.
//  3. cluster_scan: for each batch entry, exclusive scans over k of the
//     totals (each cluster's segment of perm) and of the segments' chunk
//     counts ceil(total / kChunkRows); counts = totals, as f32.
//  4. place: each row number to perm[b, segment start + tile offset +
//     rank]: each segment lists its cluster's rows in ascending order.
//  5. chunk_sum: one block a chunk of at most kChunkRows rows of one
//     segment, gathered through perm, added in a fixed order.
//  6. combine: one block a cluster adds its chunks' partials in order.
// Its scratch (fdb_cluster_sums_scratch): hist B T K ints (T = ceil(N /
// 1024)), 3 B K + B ints, perm B N ints, B (ceil(N / 256) + K) M floats.
// Where K <= kSmemK the counting passes keep a warp's counters in shared
// memory; above it they work on the tile's hist slot in place.
//
// On the H100 (PERF.md section 6, profile_lloyd.py): the dense route
// takes 0.35 ms at K-B's PQ shape, 0.41 at the SIFT coarse shape, 0.50 at
// K-C's SIFT PQ shape and 0.038 at K = 1024, 65,536 rows (bounds 0.185,
// 0.154, 0.162, 0.010). ptxas (nvcc 12.9, sm_90a, -O3), registers a
// thread: tile_sums with a float4 a thread and lists 128 (FAST 133); one
// column a thread and lists 56-67 (a 4-byte spill in one instance); K-C's
// walk 40 with a 12-byte spill; combine_tiles 32. The sort route's kernels
// take 32 to 96, no spills.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kTileRows = 1024;   // rows a tile of the counting passes
constexpr int kSteps = kTileRows / 32;
constexpr int kTileWarps = 4;     // tiles a block of the counting passes
constexpr int kChunkRows = 256;   // rows a chunk of the segmented sum
constexpr int kSumThreads = 256;
constexpr int kSumCols = 4;       // columns in flight a thread, M >= 256
constexpr int kScanThreads = 1024;
constexpr int kSmemK = 3072;      // shared counters: 4 warps x K x 4 B <= 48 KB
constexpr unsigned kFull = 0xffffffffu;

// The tile's assignments: step s of lane l is row r0 + 32 s + l; -1 past n.
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ ib,
                                          int r0, int n, int lane,
                                          int (&k)[kSteps]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int r = r0 + 32 * s + lane;
    k[s] = r < n ? __ldg(ib + r) : -1;
  }
}

// Pass 1. hist is zeroed beforehand when !SMEM.
template <bool SMEM>
__global__ void __launch_bounds__(32 * kTileWarps)
tile_count(const int32_t* __restrict__ idx, int32_t* __restrict__ hist,
           int N, int K, int T) {
  extern __shared__ int32_t cnt_s[];  // SMEM: kTileWarps x K
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = blockIdx.x * kTileWarps + warp;  // warp-uniform
  const int b = blockIdx.y;
  if (t >= T) return;
  int k[kSteps];
  load_tile(idx + (size_t)b * N, t * kTileRows, N, lane, k);
  int32_t* h = hist + ((size_t)b * T + t) * K;
  int32_t* cnt = SMEM ? cnt_s + warp * K : h;
  if (SMEM) {
    for (int e = lane; e < K; e += 32) cnt[e] = 0;
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const unsigned grp = __match_any_sync(kFull, k[s]);
    if (k[s] >= 0 && lane == __ffs(grp) - 1) cnt[k[s]] += __popc(grp);
    __syncwarp();
  }
  if (SMEM) {
    for (int e = lane; e < K; e += 32) h[e] = cnt[e];
  }
}

// Pass 2: 32 clusters a block (x), their tiles split over 32 warps (y).
__global__ void __launch_bounds__(kScanThreads)
tile_scan(int32_t* __restrict__ hist, int32_t* __restrict__ total, int K,
          int T) {
  __shared__ int32_t part[32][33];
  const int kl = threadIdx.x, w = threadIdx.y;
  const int k = blockIdx.x * 32 + kl, b = blockIdx.y;
  const int per = (T + 31) / 32;
  const int t0 = min(T, w * per), t1 = min(T, t0 + per);
  int32_t* h = hist + (size_t)b * T * K + k;
  int32_t run = 0;
  if (k < K) {
    for (int t = t0; t < t1; ++t) run += h[(size_t)t * K];
  }
  part[w][kl] = run;
  __syncthreads();
  if (w == 0) {
    int32_t acc = 0;
    for (int i = 0; i < 32; ++i) {
      const int32_t v = part[i][kl];
      part[i][kl] = acc;
      acc += v;
    }
    if (k < K) total[(size_t)b * K + k] = acc;
  }
  __syncthreads();
  run = part[w][kl];
  if (k < K) {
    for (int t = t0; t < t1; ++t) {
      const int32_t v = h[(size_t)t * K];
      h[(size_t)t * K] = run;
      run += v;
    }
  }
}

// Pass 3: one block a batch entry. start [B, K]; first [B, K + 1], whose
// last entry is the entry's number of chunks.
__global__ void __launch_bounds__(kScanThreads)
cluster_scan(const int32_t* __restrict__ total, int32_t* __restrict__ start,
             int32_t* __restrict__ first, float* __restrict__ counts,
             int K) {
  __shared__ int32_t wa[32], wc[32], sum_a, sum_c;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int32_t carry_a = 0, carry_c = 0;
  for (int k0 = 0; k0 < K; k0 += kScanThreads) {
    const int k = k0 + threadIdx.x;
    const int32_t a = k < K ? total[(size_t)b * K + k] : 0;
    const int32_t c = (a + kChunkRows - 1) / kChunkRows;
    int32_t ia = a, ic = c;  // inclusive within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t va = __shfl_up_sync(kFull, ia, off);
      const int32_t vc = __shfl_up_sync(kFull, ic, off);
      if (lane >= off) {
        ia += va;
        ic += vc;
      }
    }
    if (lane == 31) {
      wa[warp] = ia;
      wc[warp] = ic;
    }
    __syncthreads();
    if (warp == 0) {
      const int32_t va = wa[lane], vc = wc[lane];
      int32_t sa = va, sc = vc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t ua = __shfl_up_sync(kFull, sa, off);
        const int32_t uc = __shfl_up_sync(kFull, sc, off);
        if (lane >= off) {
          sa += ua;
          sc += uc;
        }
      }
      wa[lane] = sa - va;
      wc[lane] = sc - vc;
      if (lane == 31) {
        sum_a = sa;
        sum_c = sc;
      }
    }
    __syncthreads();
    if (k < K) {
      start[(size_t)b * K + k] = carry_a + wa[warp] + ia - a;
      first[(size_t)b * (K + 1) + k] = carry_c + wc[warp] + ic - c;
      counts[(size_t)b * K + k] = (float)a;
    }
    carry_a += sum_a;
    carry_c += sum_c;
    __syncthreads();  // wa, wc and the sums are rewritten next step
  }
  if (threadIdx.x == 0) first[(size_t)b * (K + 1) + K] = carry_c;
}

// Pass 4. !SMEM: the tile's hist slot is its counters.
template <bool SMEM>
__global__ void __launch_bounds__(32 * kTileWarps)
place(const int32_t* __restrict__ idx, int32_t* __restrict__ hist,
      const int32_t* __restrict__ start, int32_t* __restrict__ perm, int N,
      int K, int T) {
  extern __shared__ int32_t cnt_s[];  // SMEM: kTileWarps x K
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = blockIdx.x * kTileWarps + warp;  // warp-uniform
  const int b = blockIdx.y;
  if (t >= T) return;
  int k[kSteps];
  const int r0 = t * kTileRows;
  load_tile(idx + (size_t)b * N, r0, N, lane, k);
  int32_t* h = hist + ((size_t)b * T + t) * K;
  const int32_t* st = start + (size_t)b * K;
  int32_t* cnt = SMEM ? cnt_s + warp * K : h;
  for (int e = lane; e < K; e += 32) cnt[e] = h[e] + st[e];
  __syncwarp();
  int32_t* pb = perm + (size_t)b * N;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const unsigned grp = __match_any_sync(kFull, k[s]);
    if (k[s] >= 0) pb[cnt[k[s]] + __popc(grp & below)] = r0 + 32 * s + lane;
    __syncwarp();  // every lane has read its counter before it moves
    if (k[s] >= 0 && lane == __ffs(grp) - 1) cnt[k[s]] += __popc(grp);
    __syncwarp();
  }
}

// Adds `rows` rows of M floats (row i at row(i)) into out[0, M) in a fixed
// order. M < kSumThreads: thread (q, j) takes column j of rows q, q + R,
// ..., then the R partials of a column meet in a fixed tree. Wider rows:
// each thread takes kSumCols columns kSumThreads apart at once, over every
// row in order. FAST adds each value rounded to bf16.
template <bool FAST, typename Row>
__device__ __forceinline__ void block_rows_sum(Row row, int rows, int M,
                                               float* __restrict__ out) {
  if (M >= kSumThreads) {  // block-uniform
    for (int j0 = threadIdx.x; j0 < M; j0 += kSumCols * kSumThreads) {
      float acc[kSumCols] = {};
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        const float* p = row(i);
#pragma unroll
        for (int u = 0; u < kSumCols; ++u) {
          const int col = j0 + u * kSumThreads;
          if (col < M) acc[u] += FAST ? round_bf16(p[col]) : p[col];
        }
      }
#pragma unroll
      for (int u = 0; u < kSumCols; ++u) {
        const int col = j0 + u * kSumThreads;
        if (col < M) out[col] = acc[u];
      }
    }
    return;
  }
  __shared__ float red[kSumThreads];
  int cw = kSumThreads;  // M rounded up to a power of two
  while (cw > 1 && cw / 2 >= M) cw /= 2;
  const int R = kSumThreads / cw;
  const int q = threadIdx.x / cw, j = threadIdx.x % cw;
  float acc = 0.f;
  if (j < M) {
#pragma unroll 8
    for (int i = q; i < rows; i += R) {
      const float v = row(i)[j];
      acc += FAST ? round_bf16(v) : v;
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = R / 2; half > 0; half /= 2) {
    if (q < half) red[threadIdx.x] += red[threadIdx.x + half * cw];
    __syncthreads();
  }
  if (q == 0 && j < M) out[j] = red[j];
}

// Pass 5: block (c, b) sums chunk c of entry b into part[b, c].
template <bool FAST>
__global__ void __launch_bounds__(kSumThreads)
chunk_sum(const float* __restrict__ x, const int32_t* __restrict__ perm,
          const int32_t* __restrict__ start,
          const int32_t* __restrict__ total,
          const int32_t* __restrict__ first, float* __restrict__ part,
          int N, int K, int M, int g, int rs, int CB) {
  const int b = blockIdx.y, c = blockIdx.x;
  const int32_t* fb = first + (size_t)b * (K + 1);
  if (c >= fb[K]) return;  // block-uniform
  // The cluster whose chunks hold c: the last k with fb[k] <= c (an empty
  // cluster shares its first chunk with the next).
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (fb[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int off = (c - fb[lo]) * kChunkRows;
  const int rows = min(kChunkRows, total[(size_t)b * K + lo] - off);
  const int32_t* pr = perm + (size_t)b * N + start[(size_t)b * K + lo] + off;
  const float* xb = x + (size_t)(b / g) * N * rs + (size_t)(b % g) * M;
  block_rows_sum<FAST>(
      [&](int i) { return xb + (size_t)__ldg(pr + i) * rs; }, rows, M,
      part + ((size_t)b * CB + c) * M);
}

// Pass 6: block (k, b) adds cluster k's partials in chunk order.
__global__ void __launch_bounds__(kSumThreads)
combine(const float* __restrict__ part, const int32_t* __restrict__ first,
        float* __restrict__ sums, int K, int M, int CB) {
  const int b = blockIdx.y, k = blockIdx.x;
  const int32_t* fb = first + (size_t)b * (K + 1);
  const int c0 = fb[k];
  const float* pb = part + ((size_t)b * CB + c0) * M;
  block_rows_sum<false>([&](int i) { return pb + (size_t)i * M; },
                        fb[k + 1] - c0, M, sums + ((size_t)b * K + k) * M);
}

struct Sizes {
  long long tiles, chunks;  // T and CB, a batch entry
  long long hist, total, start, first, perm, ints, floats;
};

Sizes sizes(int B, int N, int K, int M) {
  Sizes s;
  s.tiles = ((long long)N + kTileRows - 1) / kTileRows;
  s.chunks = ((long long)N + kChunkRows - 1) / kChunkRows + K;
  s.hist = (long long)B * s.tiles * K;
  s.total = (long long)B * K;
  s.start = (long long)B * K;
  s.first = (long long)B * (K + 1);
  s.perm = (long long)B * N;
  s.ints = s.hist + s.total + s.start + s.first + s.perm;
  s.floats = (long long)B * s.chunks * M;
  return s;
}

template <bool SMEM, bool FAST>
cudaError_t launch(const float* x, const int32_t* idx, float* sums,
                   float* counts, int32_t* iw, float* part, int B, int N,
                   int K, int M, int g, int rs, cudaStream_t st) {
  const Sizes s = sizes(B, N, K, M);
  const int T = (int)s.tiles, CB = (int)s.chunks;
  int32_t* hist = iw;
  int32_t* total = hist + s.hist;
  int32_t* start = total + s.total;
  int32_t* first = start + s.start;
  int32_t* perm = first + s.first;
  const size_t smem = SMEM ? (size_t)kTileWarps * K * sizeof(int32_t) : 0;
  const dim3 tiles((T + kTileWarps - 1) / kTileWarps, B);
  cudaError_t err;
  if (!SMEM) {
    err = cudaMemsetAsync(hist, 0, (size_t)s.hist * sizeof(int32_t), st);
    if (err != cudaSuccess) return err;
  }
  tile_count<SMEM><<<tiles, 32 * kTileWarps, smem, st>>>(idx, hist, N, K, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tile_scan<<<dim3((K + 31) / 32, B), dim3(32, 32), 0, st>>>(hist, total, K,
                                                            T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cluster_scan<<<B, kScanThreads, 0, st>>>(total, start, first, counts, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  place<SMEM><<<tiles, 32 * kTileWarps, smem, st>>>(idx, hist, start, perm,
                                                    N, K, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_sum<FAST><<<dim3(CB, B), kSumThreads, 0, st>>>(
      x, perm, start, total, first, part, N, K, M, g, rs, CB);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  combine<<<dim3(K, B), kSumThreads, 0, st>>>(part, first, sums, K, M, CB);
  return cudaGetLastError();
}

// --- The dense route --------------------------------------------------------

constexpr int kStages = 4;         // shared-memory stages of the ring
constexpr int kGroup = 4;          // rows in flight a thread
constexpr int kRun = 16;           // rows of a one-cluster run in flight
constexpr int kDenseWarps = 8;     // column groups x cluster classes
constexpr int kCombineThreads = 256;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on sm_90
// How a stage of x is copied: the TMA, one bulk copy (the slice whole
// rows) or one 2-D tensor copy (a slice of the rows), 16-byte aligned; or
// 4-byte cp.async (x not 16-byte aligned).
constexpr int kBulk = 0, kTensor = 1, kScalar = 2;

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~size_t(15);
}

// A block's shape and its shared memory: kStages x stages of x [RS][S]
// f32, acc [K][S] f32, cnt [g][K] i32, kStages stages of idx [RS][g] i32,
// kDenseWarps lists of RS packed rows (u32), and each ring slot's two
// mbarriers (u64).
// ops/lloyd.py (_dense_smem) adds up the same bytes to pick RS. A thread
// holds CPT consecutive columns (4, as a float4, for K-B where S is a
// multiple of 128, 4 divides M and x allows 16-byte copies; else 1), a
// warp 32 CPT of them. K-C (g > 1) takes one warp a column group (W = 1);
// K-B splits the clusters over W = kDenseWarps / cgs classes.
struct Dense {
  int S, R, RS, T, ns, cgs, W, cpt;
  size_t acc_off, cnt_off, is_off, list_off, bar_off, bytes;
};

Dense dense_layout(int N, int K, int M, int g, int rs, int S, int R, int RS,
                   bool vec) {
  Dense d;
  d.S = S;
  d.R = R;
  d.RS = RS;
  d.T = (N + R - 1) / R;
  d.ns = (rs + S - 1) / S;
  d.cpt = g == 1 && vec && S % 128 == 0 && M % 4 == 0 ? 4 : 1;
  d.cgs = (S + 32 * d.cpt - 1) / (32 * d.cpt);
  d.W = g > 1 || d.cgs >= kDenseWarps ? 1 : kDenseWarps / d.cgs;
  // The stages first: a tensor copy lands on 128-byte boundaries.
  size_t o = align16((size_t)kStages * RS * S * 4);
  d.acc_off = o;
  o += align16((size_t)K * S * 4);
  d.cnt_off = o;
  o += align16((size_t)g * K * 4);
  d.is_off = o;
  o += align16((size_t)kStages * RS * g * 4);
  d.list_off = o;
  o += align16((size_t)kDenseWarps * RS * 4);
  d.bar_off = o;
  o += align16((size_t)2 * kStages * 8);
  d.bytes = o;
  return d;
}

// The ring's mbarriers (hopper.cuh): a slot's "full" barrier completes
// when its x (TMA bulk copies, counted in bytes) and its idx (cp.async,
// one arrival a producer lane) have landed; its "empty" barrier when
// every consumer warp is done with it.

// CPT consecutive floats at p (16-byte aligned when CPT is 4).
template <int CPT>
struct Cols {
  float v[CPT];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (CPT == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (CPT == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  }
};

// Adds kGroup rows into this thread's columns: row u's values at
// xc + xo[u] into ac + k[u] S (k[u] < 0: not this thread's row), in row
// order. The accumulator words are loaded together; a row whose cluster
// an earlier row of the group also has takes that row's fresh sums
// instead, and the stores go in row order, so every add is the serial one.
// Returns whether the group was kGroup rows of one cluster, and leaves
// the last row's cluster and fresh sums in (ck, cv).
template <bool FAST, int CPT>
__device__ __forceinline__ bool add_rows(const float* __restrict__ xc,
                                         float* __restrict__ ac, int S,
                                         const int (&k)[kGroup],
                                         const int (&xo)[kGroup], int& ck,
                                         Cols<CPT>& cv) {
  Cols<CPT> v[kGroup], res[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    v[u] = Cols<CPT>{};
    res[u] = Cols<CPT>{};
    if (k[u] >= 0) {
      v[u].load(xc + xo[u]);
      res[u].load(ac + k[u] * S);
    }
  }
  bool one = k[0] >= 0;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    one = one && k[u] == k[0];
#pragma unroll
    for (int p = 0; p < u; ++p) {
      if (k[p] == k[u]) res[u] = res[p];
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      res[u].v[i] += FAST ? round_bf16(v[u].v[i]) : v[u].v[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (k[u] >= 0) res[u].store(ac + k[u] * S);
  }
  ck = k[kGroup - 1];
  cv = res[kGroup - 1];
  return one;
}

// Block (t, s, G): rows [t R, t R + R) of columns [s S, s S + S) of group
// G's rows (K-B: batch entry G, g = 1, rs = M; K-C: S = rs = g M, s = 0).
// Writes part [B, T, K, M] and pcnt [B, T, K]. The last warp produces:
// it fills the ring's slots in stage order, x by the TMA (COPY kBulk:
// one bulk copy a stage, the slice being whole rows; kTensor: one 2-D
// tensor copy of the stage's box) or by 4-byte cp.async (kScalar), idx
// by 4-byte cp.async as
// is[r][j] (-1 for a row past the tile or a pad division). The others
// consume each stage as soon as it lands, with no block-wide barrier, and
// free its slot. LISTED (K-B, W > 1): a consumer warp adds only its
// class's rows, from a list of packed rows (k in the high half, r S in
// the low), and a stage all of one cluster from the stage itself;
// otherwise every consumer warp walks all rows. The counts: the warps
// that hold a division's first column, in the first slice, add their
// rows' with shared integer atomics, exact in any order.
template <bool FAST, int COPY, bool LISTED, int CPT>
__global__ void __launch_bounds__(32 * (kDenseWarps + 1))
tile_sums(const float* __restrict__ x, const int32_t* __restrict__ idx,
          float* __restrict__ part, int32_t* __restrict__ pcnt, int B,
          int N, int K, int M, int g, int rs, Dense d,
          const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + d.acc_off);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + d.cnt_off);
  int32_t* is = reinterpret_cast<int32_t*>(smem + d.is_off);
  uint32_t* lists = reinterpret_cast<uint32_t*>(smem + d.list_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + d.bar_off);
  uint64_t* empty = full + kStages;
  const int S = d.S, RS = d.RS, W = d.W;
  const int nc = d.cgs * W;  // consumer warps; warp nc produces
  const int t = blockIdx.x, s = blockIdx.y, G = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = warp % d.cgs, w = warp / d.cgs;  // column group, class
  const int nth = blockDim.x;
  const int c0 = s * S, width = min(S, rs - c0);
  const int r0 = t * d.R, rend = min(N, r0 + d.R);
  const int nst = (rend - r0 + RS - 1) / RS;
  const float* xg = x + (size_t)G * N * rs + c0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 33);  // the producer's 32 lanes and its expect_tx
      mbar_init(empty + i, nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const Cols<CPT> zero{};
  for (int e = threadIdx.x * CPT; e < K * S; e += nth * CPT) {
    zero.store(acc + e);
  }
  for (int e = threadIdx.x; e < g * K; e += nth) cnt[e] = 0;
  __syncthreads();  // barriers set up, acc and cnt zeroed

  if (warp == nc) {
    const int rsh = __ffs(RS) - 1;
    for (int st = 0; st < nst; ++st) {
      const int slot = st % kStages;
      if (st >= kStages) mbar_wait(empty + slot, (st / kStages - 1) & 1);
      const int rb = r0 + st * RS, rows = min(RS, rend - rb);
      float* xb = xs + (size_t)slot * RS * S;
      int32_t* ib = is + (size_t)slot * RS * g;
      const float* xr = xg + (size_t)rb * rs;
      for (int e = lane; e < RS * g; e += 32) {
        const int j = e >> rsh, r = e & (RS - 1), b = G * g + j;
        if (r < rows && b < B) {
          cp_async<4>(reinterpret_cast<float*>(ib + r * g + j),
                      reinterpret_cast<const float*>(idx + (size_t)b * N +
                                                     rb + r),
                      true);
        } else {
          ib[r * g + j] = -1;
        }
      }
      if (COPY == kScalar) {
        for (int e = lane; e < rows * width; e += 32) {
          const int r = e / width, v = e - r * width;
          cp_async<4>(xb + r * S + v, xr + (size_t)r * rs + v, true);
        }
      }
      mbar_cp_async_arrive(full + slot);
      __syncwarp();
      if (lane == 0) {
        // A tensor copy moves the whole box, zeros past x's edges too.
        const uint32_t bytes = COPY == kBulk     ? rows * rs * 4
                               : COPY == kTensor ? RS * S * 4
                                                 : 0;
        mbar_expect_tx(full + slot, bytes);
        if (COPY == kBulk) bulk_copy(xb, xr, bytes, full + slot);
        if (COPY == kTensor) {
          tensor_copy(xb, &map, c0, G * N + rb, full + slot);
        }
      }
    }
  } else {
    // This thread's first column and its division (local to the group);
    // the divisions whose first column this warp holds, which it counts.
    const int c = (cg * 32 + lane) * CPT;
    const int jl = (c0 + min(c, width - 1)) / M;
    const bool col_on = c < width && G * g + jl < B;
    const int a_lo = c0 + cg * 32 * CPT;
    const int a_hi = c0 + min(width, (cg + 1) * 32 * CPT) - 1;
    const int jc_lo = (a_lo + M - 1) / M;
    const int jc_hi = a_lo <= a_hi ? a_hi / M : jc_lo - 1;
    uint32_t* list = lists + (size_t)warp * RS;
    for (int st = 0; st < nst; ++st) {
      const int slot = st % kStages;
      mbar_wait(full + slot, (st / kStages) & 1);
      const int rows = min(RS, rend - (r0 + st * RS));
      const float* xb = xs + (size_t)slot * RS * S;
      const int32_t* ib = is + (size_t)slot * RS * g;
      // LISTED: the warp's list, and uni: every row so far is of the
      // stage's first cluster kf (one vote a chunk until one fails). The
      // counts: a warp counts its class's rows of the divisions whose
      // first column it holds; a chunk all of kf takes one add.
      int len = 0;
      const int kf = ib[0];
      bool uni = LISTED;
      for (int q = 0; q < rows; q += 32) {
        const int r = q + lane;
        if (LISTED) {
          const int k = r < rows ? ib[r] : -1;
          if (uni) uni = __all_sync(kFull, r >= rows || k == kf);
          if (jc_lo <= jc_hi) {  // this warp counts division 0
            if (uni) {
              if (lane == 0 && (kf & (W - 1)) == w) {
                atomicAdd(&cnt[kf], min(32, rows - q));
              }
            } else if (k >= 0 && (k & (W - 1)) == w) {
              atomicAdd(&cnt[k], 1);
            }
          }
          const bool mine = k >= 0 && (k & (W - 1)) == w;
          const unsigned bal = __ballot_sync(kFull, mine);
          if (mine) {
            list[len + __popc(bal & ((1u << lane) - 1u))] =
                (uint32_t)k << 16 | (uint32_t)(r * S);
          }
          len += __popc(bal);
        } else {
          for (int j = jc_lo; j <= jc_hi; ++j) {
            const int k = r < rows ? ib[r * g + j] : -1;
            if (k >= 0) atomicAdd(&cnt[j * K + k], 1);
          }
        }
      }
      __syncwarp();
      if (col_on) {
        const float* xc = xb + c;
        float* ac = acc + c;
        int k[kGroup], xo[kGroup];
        int ck = -1;
        Cols<CPT> cv;
        if (LISTED && uni) {
          // One cluster: its warp adds the stage's rows in order, kRun
          // of them in flight, in registers.
          if ((kf & (W - 1)) == w) {
            cv.load(ac + kf * S);
            for (int i = 0; i < rows; i += kRun) {
              Cols<CPT> xv[kRun];
#pragma unroll
              for (int u = 0; u < kRun; ++u) {
                if (i + u < rows) xv[u].load(xc + (i + u) * S);
              }
#pragma unroll
              for (int u = 0; u < kRun; ++u) {
                if (i + u < rows) {
#pragma unroll
                  for (int j = 0; j < CPT; ++j) {
                    cv.v[j] += FAST ? round_bf16(xv[u].v[j]) : xv[u].v[j];
                  }
                }
              }
            }
            cv.store(ac + kf * S);
          }
        } else if (LISTED) {
          // After a group of one cluster (k is the same in every lane
          // here), the next kRun rows, if all of that cluster too, are
          // added in registers: a skewed cluster's run waits on no
          // shared-memory round trip between its rows.
          bool run = false;
          for (int i = 0; i < len;) {
            if (run && i + kRun <= len) {
              int xr[kRun];
              bool same = true;
#pragma unroll
              for (int u = 0; u < kRun; ++u) {
                const uint32_t e = list[i + u];
                same = same && (int)(e >> 16) == ck;
                xr[u] = (int)(e & 0xffffu);
              }
              if (same) {
                Cols<CPT> xv[kRun];
#pragma unroll
                for (int u = 0; u < kRun; ++u) xv[u].load(xc + xr[u]);
#pragma unroll
                for (int u = 0; u < kRun; ++u) {
#pragma unroll
                  for (int j = 0; j < CPT; ++j) {
                    cv.v[j] += FAST ? round_bf16(xv[u].v[j]) : xv[u].v[j];
                  }
                }
                cv.store(ac + ck * S);
                i += kRun;
                continue;
              }
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              const uint32_t e = i + u < len ? list[i + u] : 0u;
              k[u] = i + u < len ? (int)(e >> 16) : -1;
              xo[u] = (int)(e & 0xffffu);
            }
            run = add_rows<FAST, CPT>(xc, ac, S, k, xo, ck, cv);
            i += kGroup;
          }
        } else {
          const int32_t* kc = ib + jl;
          for (int i = 0; i < rows; i += kGroup) {
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              k[u] = i + u < rows ? kc[(i + u) * g] : -1;
              xo[u] = (i + u) * S;
            }
            add_rows<FAST, CPT>(xc, ac, S, k, xo, ck, cv);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }
  __syncthreads();  // every stage added

  // The partial: thread (kq, column) writes rows kq, kq + kstep, ...
  const int T = d.T;
  const int ct = min(nth, (width + CPT - 1) / CPT), kstep = nth / ct;
  const int cc = threadIdx.x % ct * CPT, a = c0 + cc, b = G * g + a / M;
  if (threadIdx.x < ct * kstep && cc < width && b < B) {
    float* pb = part + ((size_t)b * T + t) * K * M + a % M;
    for (int k = threadIdx.x / ct; k < K; k += kstep) {
      Cols<CPT> v;
      v.load(acc + k * S + cc);
      v.store(pb + (size_t)k * M);
    }
  }
  if (s == 0) {
    for (int e = threadIdx.x; e < g * K; e += nth) {
      const int j = e / K, k = e % K, bj = G * g + j;
      if (bj < B) pcnt[((size_t)bj * T + t) * K + k] = cnt[e];
    }
  }
}

// Thread e < B K M: sums[e] = the T partials of its (b, k, column) added
// in tile order from 0; the next B K threads: counts from the tile counts.
__global__ void __launch_bounds__(kCombineThreads)
combine_tiles(const float* __restrict__ part, const int32_t* __restrict__ pcnt,
              float* __restrict__ sums, float* __restrict__ counts, int B,
              int T, int K, int M) {
  const long long e = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  const long long km = (long long)K * M, nsum = B * km;
  if (e < nsum) {
    const float* p = part + (e / km) * T * km + e % km;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) acc += p[(size_t)t * km];
    sums[e] = acc;
  } else if (e < nsum + (long long)B * K) {
    const long long f = e - nsum;
    const int32_t* p = pcnt + (f / K) * T * K + f % K;
    int32_t n = 0;
#pragma unroll 8
    for (int t = 0; t < T; ++t) n += p[(size_t)t * K];
    counts[f] = (float)n;
  }
}

template <bool FAST, int COPY, bool LISTED, int CPT>
cudaError_t launch_dense(const float* x, const int32_t* idx, float* sums,
                         float* counts, float* part, int32_t* pcnt, int B,
                         int N, int K, int M, int g, int rs, const Dense& d,
                         const CUtensorMap& map, cudaStream_t st) {
  auto kernel = tile_sums<FAST, COPY, LISTED, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.T, d.ns, (B + g - 1) / g);
  kernel<<<grid, 32 * (d.cgs * d.W + 1), d.bytes, st>>>(
      x, idx, part, pcnt, B, N, K, M, g, rs, d, map);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = (long long)B * K * (M + 1);
  combine_tiles<<<(unsigned)((outs + kCombineThreads - 1) / kCombineThreads),
                  kCombineThreads, 0, st>>>(part, pcnt, sums, counts, B, d.T,
                                            K, M);
  return cudaGetLastError();
}

// Picks the instance: the copy (kBulk where the slice is whole rows,
// kTensor for a slice of them, kScalar where x is not 16-byte aligned),
// the list (W > 1) and the columns a thread.
template <bool FAST>
cudaError_t launch_dense(const float* x, const int32_t* idx, float* sums,
                         float* counts, float* part, int32_t* pcnt, int B,
                         int N, int K, int M, int g, int rs, const Dense& d,
                         bool vec, cudaStream_t st) {
  CUtensorMap map{};
#define FDB_DENSE(COPY, LISTED, CPT)                                        \
  return launch_dense<FAST, COPY, LISTED, CPT>(x, idx, sums, counts, part, \
                                               pcnt, B, N, K, M, g, rs, d, \
                                               map, st)
  if (!vec) {
    if (d.W > 1) FDB_DENSE(kScalar, true, 1);
    FDB_DENSE(kScalar, false, 1);
  }
  if (d.S == rs) {
    if (d.cpt == 4) {
      if (d.W > 1) FDB_DENSE(kBulk, true, 4);
      FDB_DENSE(kBulk, false, 4);
    }
    if (d.W > 1) FDB_DENSE(kBulk, true, 1);
    FDB_DENSE(kBulk, false, 1);
  }
  // x as rows of rs floats, (B + g - 1) / g N of them; a box is a stage.
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)rs,
                              (cuuint64_t)((B + g - 1) / g) * N};
  const cuuint64_t strides[1] = {(cuuint64_t)rs * 4};
  const cuuint32_t box[2] = {(cuuint32_t)d.S, (cuuint32_t)d.RS};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  if (d.cpt == 4) {
    if (d.W > 1) FDB_DENSE(kTensor, true, 4);
    FDB_DENSE(kTensor, false, 4);
  }
  if (d.W > 1) FDB_DENSE(kTensor, true, 1);
  FDB_DENSE(kTensor, false, 1);
#undef FDB_DENSE
}

}  // namespace

// The scratch fdb_cluster_sums needs: *ints int32 and *floats f32 elements.
extern "C" void fdb_cluster_sums_scratch(int B, int N, int K, int M,
                                         long long* ints,
                                         long long* floats) {
  const Sizes s = sizes(B, N, K, M);
  *ints = s.ints;
  *floats = s.floats;
}

// x: B divisions of N rows, division b at x + (b / g) N rs + (b % g) M,
// its rows rs floats apart (16-byte alignment not needed); idx [B, N] int32
// in [0, K) -> sums [B, K, M] f32, counts [B, K] f32. iwork and fwork hold
// the elements fdb_cluster_sums_scratch gives. fast: add x rounded to
// bf16. All on the current device, on `stream`. Returns a cudaError_t.
extern "C" int fdb_cluster_sums(const void* x, const void* idx, void* sums,
                                void* counts, void* iwork, void* fwork, int B,
                                int N, int K, int M, int g, int rs, int fast,
                                void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ii = static_cast<const int32_t*>(idx);
  auto* sf = static_cast<float*>(sums);
  auto* cf = static_cast<float*>(counts);
  auto* iw = static_cast<int32_t*>(iwork);
  auto* fw = static_cast<float*>(fwork);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool smem = K <= kSmemK;
  if (fast) {
    return smem ? launch<true, true>(xf, ii, sf, cf, iw, fw, B, N, K, M, g,
                                     rs, s)
                : launch<false, true>(xf, ii, sf, cf, iw, fw, B, N, K, M, g,
                                      rs, s);
  }
  return smem ? launch<true, false>(xf, ii, sf, cf, iw, fw, B, N, K, M, g, rs,
                                    s)
              : launch<false, false>(xf, ii, sf, cf, iw, fw, B, N, K, M, g,
                                     rs, s);
}

// The dense route (see the note at the top). x, idx, sums, counts as for
// fdb_cluster_sums; part holds B T K M floats and pcnt B T K ints, T =
// ceil(N / R). S, R and RS come from ops/lloyd.py's sum_tiling: for K-B
// (g = 1) S <= M = rs; for K-C S = rs = g M. Refuses (cudaErrorInvalidValue)
// a tiling whose block would need more than a block's shared memory.
extern "C" int fdb_cluster_sums_dense(const void* x, const void* idx,
                                      void* sums, void* counts, void* part,
                                      void* pcnt, int B, int N, int K, int M,
                                      int g, int rs, int fast, int S, int R,
                                      int RS, void* stream) {
  if (S <= 0 || R <= 0 || RS <= 0 || (g > 1 ? S != rs : S > M)) {
    return cudaErrorInvalidValue;
  }
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && rs % 4 == 0 &&
                   S % 4 == 0;
  const Dense d = dense_layout(N, K, M, g, rs, S, R, RS, vec);
  // The list packs k and r S in 16 bits each; g is a power of two.
  if (d.bytes > kSmemMax || (RS & (RS - 1)) != 0 || (g & (g - 1)) != 0 ||
      K > 65535 || (long long)RS * S > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* ii = static_cast<const int32_t*>(idx);
  auto* sf = static_cast<float*>(sums);
  auto* cf = static_cast<float*>(counts);
  auto* pf = static_cast<float*>(part);
  auto* pc = static_cast<int32_t*>(pcnt);
  const cudaStream_t st = (cudaStream_t)stream;
  return fast ? launch_dense<true>(xf, ii, sf, cf, pf, pc, B, N, K, M, g, rs,
                                  d, vec, st)
              : launch_dense<false>(xf, ii, sf, cf, pf, pc, B, N, K, M, g, rs,
                                    d, vec, st);
}
