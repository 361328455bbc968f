// Cluster sums in a fixed order, for K-B and K-C (sm_90a).
//
// Replaces the sum half of the TPU kernels `_round_kernel`
// (flechasdb_tpu/ops/pallas_kmeans.py:121-140) and `_grouped_round_kernel`
// (:208-224), which add one-hot products into a resident output block in
// grid order. Given a Lloyd round's assignment idx [B, N] (K-B's or K-C's):
//
//     sums[b, k]   = sum of x_b[i] over the rows with idx[b, i] == k
//     counts[b, k] = number of such rows
//
// with x_b[i] = x[b / g, i, (b % g) M : (b % g + 1) M], rows rs floats
// apart: g = 1, rs = M for K-B's [B, N, M]; g = 128 / m, rs = 128 for K-C's
// division-grouped [GG, N, 128].
//
// Order. Every sum is taken in an order that idx alone fixes, never the
// scheduling: no float atomics, and no launch shape from an occupancy
// query. So the same x and idx give the same bits in every launch, in
// every process, on any card that runs this binary.
//  1. tile_count: one warp a tile of kTileRows rows counts them into its
//     own slot hist[b, t, :], 32 rows a step: __match_any_sync groups the
//     step's lanes by cluster and the group's lowest lane adds its size.
//     Integer adds, so the counts are exact.
//  2. tile_scan: for each cluster, an exclusive scan of the tile counts in
//     tile order, and their total.
//  3. cluster_scan: for each batch entry, exclusive scans over k of the
//     totals (each cluster's segment of perm) and of the segments' chunk
//     counts ceil(total / kChunkRows) (each cluster's first chunk);
//     counts = totals, converted to f32 once.
//  4. place: the tile's warp again writes each row number to perm[b,
//     segment start + tile offset + rank], the rank from the same match
//     groups: each segment lists its cluster's rows in ascending order.
//  5. chunk_sum: one block a chunk of at most kChunkRows rows of one
//     segment. Below 256 columns, thread (q, j) adds column j of rows q,
//     q + R, ... in order (R = kSumThreads / column width, rounded up to a
//     power of two), then the R partials meet in a fixed tree; from 256
//     columns on, a thread adds its columns over every row in order. One
//     partial row a chunk. Fixed chunks keep a skewed cluster (half a
//     million rows) from serialising on one block.
//  6. combine: one block a cluster adds its chunks' partials the same way
//     into sums[b, k] (zeros for an empty cluster).
// The sums are in another order than the plain version's serial
// index_add_ or the TPU's MXU accumulation, but always the same one.
//
// What bounds it: bytes. It reads x once (rows gathered through perm; a
// row's M floats are contiguous), idx twice and perm once, and writes sums
// and counts. The scratch, allocated by the wrapper
// (fdb_cluster_sums_scratch): hist B * T * K ints (T = ceil(N / 1024)),
// the totals, starts and first chunks (3 B K + B ints), perm B * N ints,
// and at most B * (ceil(N / 256) + K) * M floats of partials. At the SIFT
// coarse shape (B=1, N=1M, K=1024, M=128) that is 4.0 MB of hist, 4.0 MB of
// perm and 2.5 MB of partials; at the headline coarse shape (N=100k, K=100,
// M=1536) 0.04, 0.4 and 3.0 MB; at the SIFT PQ shape (B=8, N=1M, K=256,
// m=16) 8.0, 32.0 and 2.1 MB.
//
// Where K <= kSmemK, the two counting passes keep a warp's counters in
// shared memory; above it (K=4096 at m=16, say) they work on the tile's
// hist slot in place, with the same steps in the same order.
//
// FAST: the rows are added rounded to bf16 (round_bf16, to nearest even),
// as the TPU kernels' fast_math branch sums its bf16 xhi.
//
// On the H100 at K-B's PQ shape (B=12, N=100k, K=256, M=128) the pass takes
// 0.48 ms against a 0.185 ms bound, 0.41 of it chunk_sum's gather; at
// K-C's SIFT PQ shape (B=8, N=1M, K=256, m=16) 0.82 ms against 0.162, of it
// chunk_sum 0.54, place 0.16 and tile_count 0.08 (profile_lloyd.py).
// ptxas (nvcc 12.9, sm_90a, -O3), registers a thread: tile_count 48, place
// 96, chunk_sum 40, combine, tile_scan and cluster_scan 32; no spills.

#include <cuda_runtime.h>
#include <stdint.h>

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
