// K-C: grouped Lloyd round (assignment + cluster sums) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_grouped_round_kernel`
// (flechasdb_tpu/ops/pallas_kmeans.py, reached by `lloyd_round_grouped`), the
// PQ training round for subvector widths m < 128 with 128 % m == 0. Its data
// is division-grouped: xg [GG, N, 128] holds g = 128 / m consecutive
// divisions' subvectors side by side in each 512-byte row (zeros in the pad
// divisions of the last group). For every division b < B and row i:
//
//     idx[b, i]    = first argmin_k (cc[b, k] - 2 x_b[i] . c[b, k])
//     sums[b, k]   = sum of x_b[i] over the rows with idx[b, i] == k
//     counts[b, k] = number of such rows
//
// with x_b[i] = xg[b / g, i, (b % g) m : (b % g + 1) m] and cc = |c|^2 from
// the caller: the contract of K-B (lloyd_round.cu) on grouped data.
//
// What bounds it on the H100: arithmetic. The assignment is 2*B*N*K*m flops
// (65.5 GFLOP at B=8, N=1M, K=256, m=16, >= 0.98 ms at 67 TFLOP/s fp32)
// over one read of xg (512 MB there, >= 0.15 ms). The TPU kernel folds g
// divisions into one MXU pass through a block-diagonal [g*K, 128] centroid
// operand; on the CUDA cores that would multiply zeros, so none of it is
// kept. Here a block takes T rows of one group, all g divisions: each warp
// owns one division and 32*R rows (R = 64 / m rows a thread), holds those
// rows' m-wide subvectors in registers (64 floats a thread, read once with
// 16-byte loads), and walks the division's centroids from shared memory.
// The lanes of a warp share the division, so every centroid read is a
// 16-byte broadcast that feeds 4*R FMAs. The centroids of all g divisions
// (128 floats a centroid index) stream through shared memory in chunks of
// 128 centroid indices (64 KB, opted in above 48 KB), so any K fits. Full
// FP32 FMAs, no TF32 or bf16, in increasing m; K-B's 3xTF32 tensor-core
// product rounds differently, so the two assignments agree up to
// near-ties, not bit for bit. Each thread walks k in increasing
// order with a strict `<` over every chunk, so the first minimum wins with
// no merge. Pad divisions are loaded by no one and written nowhere.
//
// The sums are a second, bytes-bound launch that reads xg in place: a warp
// reads one 512-byte row with one 16-byte load a lane and adds each lane's
// four floats to its division's cluster with f32 atomics (not
// bit-reproducible from run to run: their order varies); counts are exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // floats in an xg row
constexpr int kKC = 128;     // centroid indices a shared-memory chunk
constexpr int kScatterThreads = 256;
constexpr int kScatterRows = 32;

// Tiling for subvector width M (8, 16, 32 or 64).
template <int M>
struct Tile {
  static constexpr int G = kLanes / M;      // divisions a row
  static constexpr int R = 64 / M;          // rows a thread
  static constexpr int W = G > 8 ? G : 8;   // warps a block
  static constexpr int CHUNKS = W / G;      // row chunks a division
  static constexpr int T = 32 * R * CHUNKS; // rows a block
  static constexpr int THREADS = 32 * W;
  static constexpr size_t SMEM = (size_t)(kLanes + G) * kKC * sizeof(float);
};

template <int M>
__global__ void __launch_bounds__(Tile<M>::THREADS)
grouped_assign_kernel(const float* __restrict__ xg,
                      const float* __restrict__ c,
                      const float* __restrict__ cc,
                      int32_t* __restrict__ idx, int B, int N, int K) {
  using S = Tile<M>;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                   // [G][kKC][M]
  float* ccs = smem + kLanes * kKC;   // [G][kKC]

  const int gi = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int dl = warp % S::G;         // division within the group
  const int b = gi * S::G + dl;       // division overall
  const bool live = b < B;            // warp-uniform
  const int row0 = blockIdx.x * S::T + (warp / S::G) * 32 * S::R + lane;
  const int n_live = min(S::G, B - gi * S::G);

  float x[S::R][M];
#pragma unroll
  for (int r = 0; r < S::R; ++r) {
    const int row = row0 + 32 * r;
#pragma unroll
    for (int q = 0; q < M; q += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && row < N) {
        v = *reinterpret_cast<const float4*>(
            xg + ((size_t)gi * N + row) * kLanes + dl * M + q);
      }
      x[r][q] = v.x;
      x[r][q + 1] = v.y;
      x[r][q + 2] = v.z;
      x[r][q + 3] = v.w;
    }
  }

  float best[S::R];
  int best_k[S::R];
#pragma unroll
  for (int r = 0; r < S::R; ++r) {
    best[r] = INFINITY;
    best_k[r] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    __syncthreads();  // the previous chunk is no longer read
    const int per_div = kc * M / 4;   // float4s of one division's chunk
    for (int e = threadIdx.x; e < n_live * per_div; e += S::THREADS) {
      const int d = e / per_div, off = e % per_div;
      reinterpret_cast<float4*>(cs + d * kKC * M)[off] =
          reinterpret_cast<const float4*>(
              c + ((size_t)(gi * S::G + d) * K + k0) * M)[off];
    }
    for (int e = threadIdx.x; e < n_live * kc; e += S::THREADS) {
      const int d = e / kc, kk = e % kc;
      ccs[d * kKC + kk] = cc[(size_t)(gi * S::G + d) * K + k0 + kk];
    }
    __syncthreads();
    if (live) {
      const float* cd = cs + dl * kKC * M;
      const float* ccd = ccs + dl * kKC;
#pragma unroll 2
      for (int kk = 0; kk < kc; ++kk) {
        float acc[S::R];
#pragma unroll
        for (int r = 0; r < S::R; ++r) acc[r] = 0.f;
#pragma unroll
        for (int q = 0; q < M; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(cd + kk * M + q);
#pragma unroll
          for (int r = 0; r < S::R; ++r) {
            acc[r] = fmaf(x[r][q], v.x, acc[r]);
            acc[r] = fmaf(x[r][q + 1], v.y, acc[r]);
            acc[r] = fmaf(x[r][q + 2], v.z, acc[r]);
            acc[r] = fmaf(x[r][q + 3], v.w, acc[r]);
          }
        }
        const float ck = ccd[kk];
#pragma unroll
        for (int r = 0; r < S::R; ++r) {
          const float dist = ck - 2.f * acc[r];
          if (dist < best[r]) {
            best[r] = dist;
            best_k[r] = k0 + kk;
          }
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < S::R; ++r) {
      const int row = row0 + 32 * r;
      if (row < N) idx[(size_t)b * N + row] = best_k[r];
    }
  }
}

__global__ void __launch_bounds__(kScatterThreads)
grouped_scatter_kernel(const float* __restrict__ xg,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ sums, float* __restrict__ counts,
                       int B, int N, int K, int M) {
  const int gi = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int col = 4 * (threadIdx.x % 32);
  const int b = gi * (kLanes / M) + col / M;
  const int j = col % M;
  if (b >= B) return;  // a pad division: nothing to add
  const int r0 = (int)blockIdx.x * kScatterRows;
  const int r_end = min(N, r0 + kScatterRows);
  for (int r = r0 + warp; r < r_end; r += kScatterThreads / 32) {
    const int k = idx[(size_t)b * N + r];
    const float4 v = *reinterpret_cast<const float4*>(
        xg + ((size_t)gi * N + r) * kLanes + col);
    float* s = sums + ((size_t)b * K + k) * M + j;
    atomicAdd(s, v.x);
    atomicAdd(s + 1, v.y);
    atomicAdd(s + 2, v.z);
    atomicAdd(s + 3, v.w);
    if (j == 0) atomicAdd(counts + (size_t)b * K + k, 1.f);
  }
}

template <int M>
cudaError_t launch_assign(const float* xg, const float* c, const float* cc,
                          int32_t* idx, int B, int GG, int N, int K,
                          cudaStream_t s) {
  using S = Tile<M>;
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_assign_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + S::T - 1) / S::T, GG);
  grouped_assign_kernel<M><<<grid, S::THREADS, S::SMEM, s>>>(xg, c, cc, idx,
                                                             B, N, K);
  return cudaGetLastError();
}

}  // namespace

// xg [GG, N, 128] f32, c [B, K, M] f32, cc [B, K] f32 -> idx [B, N] int32,
// sums [B, K, M] f32, counts [B, K] f32 (zeroed here, on the stream).
// M in {8, 16, 32, 64}, GG = ceil(B / (128 / M)); xg and c 16-byte aligned.
// All on the current device (the caller selects it). Returns a cudaError_t.
extern "C" int fdb_lloyd_grouped(const void* xg, const void* c,
                                 const void* cc, void* idx, void* sums,
                                 void* counts, int B, int GG, int N, int K,
                                 int M, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(sums, 0, (size_t)B * K * M * sizeof(float), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counts, 0, (size_t)B * K * sizeof(float), s);
  if (err != cudaSuccess) return err;

  const auto* xf = static_cast<const float*>(xg);
  const auto* cf = static_cast<const float*>(c);
  const auto* ccf = static_cast<const float*>(cc);
  auto* idxi = static_cast<int32_t*>(idx);
  switch (M) {
    case 8:
      err = launch_assign<8>(xf, cf, ccf, idxi, B, GG, N, K, s);
      break;
    case 16:
      err = launch_assign<16>(xf, cf, ccf, idxi, B, GG, N, K, s);
      break;
    case 32:
      err = launch_assign<32>(xf, cf, ccf, idxi, B, GG, N, K, s);
      break;
    case 64:
      err = launch_assign<64>(xf, cf, ccf, idxi, B, GG, N, K, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const dim3 sgrid((N + kScatterRows - 1) / kScatterRows, GG);
  grouped_scatter_kernel<<<sgrid, kScatterThreads, 0, s>>>(
      xf, idxi, static_cast<float*>(sums), static_cast<float*>(counts), B, N,
      K, M);
  return cudaGetLastError();
}
