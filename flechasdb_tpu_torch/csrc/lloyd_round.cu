// K-B: the Lloyd round's assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel `_round_kernel` (flechasdb_tpu/ops/pallas_kmeans.py
// :36, reached by `lloyd_round`). For every batch entry b and row i:
//
//     idx[b, i]  = first argmin_k (cc[b, k] - 2 x[b, i] . c[b, k])
//
// with cc[b, k] = |c[b, k]|^2 given by the caller. No |x|^2 term and no clamp:
// the argmin does not need them. The round's cluster sums and counts are
// the next launch, cluster_sums.cu, which adds them in an order that idx
// fixes, so a round gives the same bits every time.
//
// What bounds it on the H100: the assignment is 2*N*K*M flops over N*M*4
// bytes of x, K/2 flops a byte (50 to 512 on the build's shapes). At the
// dense TF32 tensor-core rate, 494.7 TFLOP/s, against 3.35 TB/s, the flops
// bind above K = 295 and the bytes of x below. It runs as 3xTF32 on the
// tensor cores: each f32 operand v is split once, as its fragment is
// loaded, into hi, v rounded to tf32, and lo = v - hi, and x . c
// accumulates lo.hi, hi.lo, then hi.hi in f32, the order of CUTLASS's
// OpMultiplyAddFastF32. That is the structure of the TPU kernel's
// hand-split bf16x3 product with about 2^-21 relative error where bf16x3
// has 2^-16, and it ignores the process's TF32 flags. The three passes are
// the route's cost, not the function's: the kernel issues three times the
// flops its bound counts. The split is integer arithmetic (split_tf32):
// cvt.rna.tf32.f32 compiles to a compare-and-select sequence, with which
// the kernel took 8-19% longer on an H100.
//
// Design: warp-level mma.sync.m16n8k8 (tf32 in, f32 accumulate). A block
// of 8 warps takes 128 rows x 128 centroids (each warp 32 x 64: 2 x 8
// tiles, 64 f32 accumulators a thread) and walks M in chunks of 32 through
// a 3-stage ring of cp.async copies in dynamic shared memory (110.6 KB,
// opted in above 48 KB; two blocks fit an SM), so the loads of the next
// chunks overlap the products of this one behind one __syncthreads a
// chunk. The ring runs across centroid tiles too: the next tile's first
// chunks arrive during the argmin epilogue. Tile rows are padded to 36
// floats, so each fragment load (8 rows x 4 columns a warp) hits 32
// distinct banks. Copies past N, K or M write zeros (cp.async's zero
// fill), which pads M to a multiple of the chunk; an 8-wide step wholly
// past M is skipped. VEC copies 16 bytes at a time (M % 4 == 0 and
// aligned rows), otherwise 4, so any M fits.
//
// Argmin: after a centroid tile's last chunk each thread folds cc[k] -
// 2 acc into a running (min, k) for each of its 4 rows, k increasing, with
// a strict `<` (padded centroids count as +inf). The 4 lanes of a quad
// that share a row merge by shuffles, then the 2 warps that split the
// centroids merge through shared memory; both merges take the smaller k
// on equal distances, so the first minimum wins as in `jnp.argmin`.
// Duplicated centroids give bit-equal distances (equal inputs, the same
// MMA order), so the first of them wins. The N x K distance matrix never
// exists.
//
// fast_math is K-B fast, a kernel of its own (lloyd_round_fast.cu).
//
// ptxas (nvcc 12.9, sm_90a, -O3): assign_kernel 128 registers and no
// spills with 16-byte copies; the 4-byte-copy variant (M % 4 != 0 or
// unaligned rows, off the build's main shapes) 128 registers and 24 bytes
// of spill stores. Two blocks of 256 threads fit an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kBM = 128;               // rows a block
constexpr int kBN = 128;               // centroids a tile
constexpr int kBK = 32;                // M a pipeline stage
constexpr int kLd = kBK + 4;           // tile row stride (floats)
constexpr int kStages = 3;
constexpr int kWarpsM = 4;             // warps along rows
constexpr int kWarpsN = 2;             // warps along centroids
constexpr int kWM = kBM / kWarpsM;     // rows a warp
constexpr int kWN = kBN / kWarpsN;     // centroids a warp
constexpr int kMT = kWM / 16;          // m16 tiles a warp
constexpr int kNT = kWN / 8;           // n8 tiles a warp
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kStageFloats = (kBM + kBN) * kLd;
constexpr int kSmem = kStages * kStageFloats * (int)sizeof(float);
static_assert(kWarpsN == 2, "the cross-warp merge pairs two warps");
static_assert(kBM * kBK % (4 * kThreads) == 0 &&
                  kBN * kBK % (4 * kThreads) == 0,
              "a chunk splits evenly over the threads");

// Starts copying rows [r0, r0 + ROWS) x columns [m0, m0 + kBK) of a
// row-major [n, M] matrix into tile[ROWS][kLd], zeros past n or M. VEC:
// M % 4 == 0 and 16-byte-aligned rows, so each 16-byte copy lies wholly
// inside M or wholly past it.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_chunk(float* tile,
                                           const float* __restrict__ src,
                                           int r0, int n, int m0, int M) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  constexpr int PER_ROW = kBK / W;
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / PER_ROW, q = (e % PER_ROW) * W;
    const int gr = r0 + r, gm = m0 + q;
    const bool in = gr < n && gm < M;
    cp_async<4 * W>(tile + r * kLd + q, in ? src + (size_t)gr * M + gm : src,
                    in);
  }
}

// Starts step `it` of the ring: chunk it % n_m of centroid tile it / n_m,
// x's and c's, into slot it % kStages. Commits a group even past the last
// step, so that waiting for all but kStages - 2 groups always means that
// the oldest step has landed.
template <bool VEC>
__device__ __forceinline__ void load_step(float* smem, const float* xb,
                                          const float* cb, int it, int n_it,
                                          int n_m, int row0, int N, int K,
                                          int M) {
  if (it < n_it) {
    float* st = smem + (it % kStages) * kStageFloats;
    const int m0 = (it % n_m) * kBK;
    load_chunk<kBM, VEC>(st, xb, row0, N, m0, M);
    load_chunk<kBN, VEC>(st + kBM * kLd, cb, (it / n_m) * kBN, K, m0, M);
  }
  cp_async_commit();
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ cc, int32_t* __restrict__ idx,
              int N, int K, int M) {
  extern __shared__ __align__(16) float smem[];  // kStages x [x | c] tiles
  __shared__ float merge_v[kBM];
  __shared__ int merge_k[kBM];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane / 4, t = lane % 4;  // fragment row, column
  const float* xb = x + (size_t)b * N * M;
  const float* cb = c + (size_t)b * K * M;
  const float* ccb = cc + (size_t)b * K;

  const int n_m = (M + kBK - 1) / kBK;               // chunks a tile
  const int n_it = n_m * ((K + kBN - 1) / kBN);      // (tile, chunk) steps

  float acc[kMT][kNT][4];
  float best[kMT][2];
  int best_k[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      best[i][r] = INFINITY;
      best_k[i][r] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_step<VEC>(smem, xb, cb, s, n_it, n_m, row0, N, K, M);
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step it has landed; the slot of step it - 1 is free
    load_step<VEC>(smem, xb, cb, it + kStages - 1, n_it, n_m, row0, N, K, M);

    const float* st = smem + (it % kStages) * kStageFloats;
    const int m0 = (it % n_m) * kBK;
    const float* xs = st + (wm * kWM + g) * kLd + t;
    const float* cs = st + (kBM + wn * kWN + g) * kLd + t;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      if (m0 + kk < M) {  // block-uniform
        uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* p = xs + i * 16 * kLd + kk;
          split_tf32(p[0], ah[i][0], al[i][0]);
          split_tf32(p[8 * kLd], ah[i][1], al[i][1]);
          split_tf32(p[4], ah[i][2], al[i][2]);
          split_tf32(p[8 * kLd + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* q = cs + j * 8 * kLd + kk;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(q[0], bh0, bl0);
          split_tf32(q[4], bh1, bl1);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            mma_tf32(acc[i][j], al[i], bh0, bh1);
            mma_tf32(acc[i][j], ah[i], bl0, bl1);
            mma_tf32(acc[i][j], ah[i], bh0, bh1);
          }
        }
      }
    }

    if (it % n_m == n_m - 1) {  // the centroid tile is complete: fold it
      const int k0 = (it / n_m) * kBN + wn * kWN + 2 * t;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + j * 8 + h;
          const float ck = k < K ? __ldg(ccb + k) : INFINITY;
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float d = ck - 2.f * acc[i][j][2 * r + h];
              if (d < best[i][r]) {
                best[i][r] = d;
                best_k[i][r] = k;
              }
              acc[i][j][2 * r + h] = 0.f;
            }
          }
        }
      }
    }
  }

  // Merge the quad's lanes, then the two warps of a row band: smaller
  // distance, then smaller k.
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = best[i][r];
      int k = best_k[i][r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int ok = __shfl_xor_sync(0xffffffffu, k, off);
        if (ov < v || (ov == v && ok < k)) {
          v = ov;
          k = ok;
        }
      }
      best[i][r] = v;
      best_k[i][r] = k;
      const int row = wm * kWM + i * 16 + r * 8 + g;
      if (wn == 1 && t == 0) {
        merge_v[row] = v;
        merge_k[row] = k;
      }
    }
  }
  __syncthreads();
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wm * kWM + i * 16 + r * 8 + g;
        const float ov = merge_v[row];
        const int ok = merge_k[row];
        int k = best_k[i][r];
        if (ov < best[i][r] || (ov == best[i][r] && ok < k)) k = ok;
        if (row0 + row < N) idx[(size_t)b * N + row0 + row] = k;
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_assign(const float* x, const float* c, const float* cc,
                          int32_t* idx, int B, int N, int K, int M,
                          cudaStream_t s) {
  // Set at every launch on purpose: the attribute belongs to the current
  // device, which may differ from the last launch's, and the host call is
  // small beside a round.
  const cudaError_t err = cudaFuncSetAttribute(
      assign_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM, B);
  assign_kernel<VEC><<<grid, kThreads, kSmem, s>>>(x, c, cc, idx, N, K, M);
  return cudaGetLastError();
}

}  // namespace

// x [B, N, M] f32, c [B, K, M] f32, cc [B, K] f32 -> idx [B, N] int32.
// vec: M % 4 == 0 and x, c 16-byte aligned. All on the current device (the
// caller selects it). Returns a cudaError_t.
extern "C" int fdb_lloyd_round(const void* x, const void* c, const void* cc,
                               void* idx, int B, int N, int K, int M, int vec,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* xf = static_cast<const float*>(x);
  const auto* cf = static_cast<const float*>(c);
  const auto* ccf = static_cast<const float*>(cc);
  auto* idxi = static_cast<int32_t*>(idx);
  return vec ? launch_assign<true>(xf, cf, ccf, idxi, B, N, K, M, s)
             : launch_assign<false>(xf, cf, ccf, idxi, B, N, K, M, s);
}
