// K-C: the grouped Lloyd round's assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel `_grouped_round_kernel`
// (flechasdb_tpu/ops/pallas_kmeans.py:143, reached by `lloyd_round_grouped`),
// the PQ training round for subvector widths m < 128 with 128 % m == 0. Its
// data is division-grouped: xg [GG, N, 128] holds g = 128 / m consecutive
// divisions' subvectors side by side in each 512-byte row (zeros in the pad
// divisions of the last group). For every division b < B and row i:
//
//     idx[b, i]    = first argmin_k (cc[b, k] - 2 x_b[i] . c[b, k])
//
// with x_b[i] = xg[b / g, i, (b % g) m : (b % g + 1) m] and cc = |c|^2 from
// the caller: the contract of K-B (lloyd_round.cu) on grouped data. The
// round's sums and counts are the next launch, cluster_sums.cu, which
// reads the division's slice of xg through strides and adds in an order
// that idx fixes. Fusing them here, in a fixed order, would need a
// warp-private [K, m] region for each of the 8 warps: 256 KB at K=256,
// m=32, over the 227 KB a block may have; so they are not fused.
//
// What bounds it on the H100: at the SIFT PQ shape (B=8, N=1M, K=256, m=16)
// the function is 2*B*N*K*m = 65.5 GFLOP, 0.13 ms at the dense TF32
// tensor-core rate (494.7 TFLOP/s), over one read of xg, 512 MB, 0.15 ms at
// 3.35 TB/s: bytes bind, barely. The route costs more than the function:
// the 3xTF32 product issues three MMAs where the bound counts one, and
// every distance costs four fold instructions a thread (an FFMA, a compare
// and two selects) while an m16n8k8 MMA yields four distances a thread, so
// a thread issues 16 fold instructions for every 6 MMAs at m=16 and for
// every 3 at m=8: the argmin fold, not the tensor cores, sets the pace at
// small m. The TPU kernel folds g divisions into one MXU pass through a
// block-diagonal [g*K, 128] centroid operand; on Hopper that would
// multiply zeros, so none of it is kept.
//
// Design. One block owns one division b (pad divisions get no block) and
// walks row tiles of BM rows, blockIdx.x, blockIdx.x + gridDim.x, ...; the
// host sizes gridDim.x so that all B x gridDim.x blocks are resident at
// once. The block stages its division's centroids in shared memory once,
// split once into tf32 hi and lo (split_tf32, as in K-B), with cc; padded
// centroids read zeros and cc = +inf. Where they do not fit beside the
// rest (m=64, K=300), it walks centroid tiles over K instead, staging each
// again for every row tile. Row tiles (the division's m-wide slice of BM
// rows of xg) stream through two cp.async slots, the next tile's copy in
// flight while this one is ranked; rows are padded to m + 4 floats, so
// each fragment load (8 rows x 4 columns) hits 32 distinct banks; copies
// past N write zeros. Each of the 8 warps takes MT m16 tiles of rows (two
// for m <= 16, one above): it splits its x fragments once into registers
// and walks all centroids in groups of two n8 tiles, the product as 3xTF32
// mma.sync.m16n8k8 in K-B's order for each 8-wide step (lo.hi, hi.lo,
// hi.hi into f32). Two accumulator sets take turns, so the next group's
// MMAs are issued before this group is folded. The centroids' split pairs
// sit as {hi[t], hi[t+4], lo[t], lo[t+4]}, one 16-byte load a fragment,
// with the 8-wide steps of odd centroids swapped (m >= 16) so that a
// quarter warp's loads hit distinct banks. The same split, the same MMA
// order and the same cc give K-B's distances bit for bit, so the two
// assignments are equal.
//
// Argmin: each thread folds cc[k] - 2 acc into a running (min, k) for its
// rows, k increasing, with a strict `<`; the 4 lanes of a quad that share
// a row merge by shuffles, taking the smaller k on equal distances, so the
// first minimum wins as in `jnp.argmin` (duplicated centroids give
// bit-equal distances, so the first of them wins).
//
// The fast_math branch of the same TPU kernel is K-C fast, a kernel of its
// own (lloyd_grouped_fast.cu).
//
// ptxas (nvcc 12.9, sm_90a, -O3), registers a thread: m=8 126, m=16 116,
// m=32 109, m=64 160; no spills in any.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kLanes = 128;          // floats in an xg row
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = 32;              // centroid tiles are multiples of this
constexpr int kSmemMax = 232448;     // opt-in shared memory a block (227 KB)

// Tiling for subvector width M (8, 16, 32 or 64).
template <int M>
struct Shape {
  static constexpr int G = kLanes / M;         // divisions a group
  static constexpr int S = M / 8;              // 8-wide k-steps
  static constexpr int H = M / 2;              // uint4 a staged centroid
  static constexpr int LD = M + 4;             // x tile row stride (floats)
  static constexpr int MT = M <= 16 ? 2 : 1;   // m16 row tiles a warp
  static constexpr int BM = 16 * MT * kWarps;  // rows a tile
  static constexpr int XTILE = BM * LD;        // floats of an x slot
  static constexpr int NJ = 2;                 // n8 tiles a product group
  static constexpr int MINB = M <= 32 ? 2 : 1; // blocks an SM, for ptxas
  static_assert(kKT % (2 * 8 * NJ) == 0, "tiles hold whole group pairs");
};

// Stages centroids [k0, k0 + kt) of the division, split, into cent (kt x H
// uint4, entry (k, s, t) = {hi, hi, lo, lo} of elements 8s + t and
// 8s + t + 4, step s swapped with s ^ 1 for odd k when M >= 16) and their
// |c|^2 into ccs; zeros and +inf past K.
template <int M>
__device__ __forceinline__ void stage_centroids(uint4* cent, float* ccs,
                                                const float* __restrict__ cb,
                                                const float* __restrict__ ccb,
                                                int k0, int kt, int K) {
  using S = Shape<M>;
  for (int e = threadIdx.x; e < kt * S::H; e += kThreads) {
    const int k = e / S::H, s = (e % S::H) / 4, t = e % 4;
    float v0 = 0.f, v1 = 0.f;
    if (k0 + k < K) {
      const float* p = cb + (size_t)(k0 + k) * M + 8 * s + t;
      v0 = p[0];
      v1 = p[4];
    }
    uint4 q;
    split_tf32(v0, q.x, q.z);
    split_tf32(v1, q.y, q.w);
    const int sw = M >= 16 ? (k & 1) : 0;
    cent[k * S::H + 4 * (s ^ sw) + t] = q;
  }
  for (int k = threadIdx.x; k < kt; k += kThreads) {
    ccs[k] = k0 + k < K ? ccb[k0 + k] : INFINITY;
  }
}

// Starts copying the division's slice of rows [row0, row0 + BM) into an
// x slot (rows LD floats apart), zeros past N.
template <int M>
__device__ __forceinline__ void load_x(float* slot, const float* xb, int row0,
                                       int N) {
  using S = Shape<M>;
  constexpr int Q = M / 4;  // 16-byte copies a row
#pragma unroll
  for (int i = 0; i < S::BM * Q / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / Q, q = 4 * (e % Q);
    const bool in = row0 + r < N;
    cp_async<16>(slot + r * S::LD + q,
                 in ? xb + (size_t)(row0 + r) * kLanes + q : xb, in);
  }
}

// Shared memory (dynamic): cent [kt x H] uint4 | x slots [2 x XTILE] |
// ccs [kt].
template <int M>
__global__ void __launch_bounds__(kThreads, Shape<M>::MINB)
grouped_round_kernel(const float* __restrict__ xg,
                     const float* __restrict__ c,
                     const float* __restrict__ cc,
                     int32_t* __restrict__ idx, int N, int K, int kt) {
  using S = Shape<M>;
  extern __shared__ __align__(16) float smem[];
  uint4* cent = reinterpret_cast<uint4*>(smem);
  float* xs = smem + (size_t)kt * S::H * 4;
  float* ccs = xs + 2 * S::XTILE;

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row, column
  const float* xb = xg + (size_t)(b / S::G) * N * kLanes + (b % S::G) * M;
  const float* cb = c + (size_t)b * K * M;
  const float* ccb = cc + (size_t)b * K;
  const int n_tiles = (N + S::BM - 1) / S::BM;
  const int n_kt = (K + kt - 1) / kt;
  // This lane's first centroid entry: row g of an n8 tile, column t, with
  // the odd rows' steps swapped.
  const int sg = M >= 16 ? (g & 1) : 0;
  const uint4* cw = cent + g * S::H + t;

  if (n_kt == 1) stage_centroids<M>(cent, ccs, cb, ccb, 0, kt, K);
  int tile = blockIdx.x;
  if (tile < n_tiles) load_x<M>(xs, xb, tile * S::BM, N);
  cp_async_commit();

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other slot is free
    if (tile + (int)gridDim.x < n_tiles) {
      load_x<M>(xs + ((it + 1) & 1) * S::XTILE, xb,
                (tile + gridDim.x) * S::BM, N);
    }
    cp_async_commit();

    // The warp's rows: MT m16 tiles, split once.
    const float* xt = xs + (it & 1) * S::XTILE + warp * 16 * S::MT * S::LD;
    uint32_t ah[S::MT][S::S][4];
    uint32_t al[S::MT][S::S][4];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
#pragma unroll
      for (int s = 0; s < S::S; ++s) {
        const float* p = xt + (16 * i + g) * S::LD + 8 * s + t;
        split_tf32(p[0], ah[i][s][0], al[i][s][0]);
        split_tf32(p[8 * S::LD], ah[i][s][1], al[i][s][1]);
        split_tf32(p[4], ah[i][s][2], al[i][s][2]);
        split_tf32(p[8 * S::LD + 4], ah[i][s][3], al[i][s][3]);
      }
    }
    float best[S::MT][2];
    int best_k[S::MT][2];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        best[i][r] = INFINITY;
        best_k[i][r] = 0;
      }
    }

    for (int ki = 0; ki < n_kt; ++ki) {
      if (n_kt > 1) {
        __syncthreads();  // the previous centroid tile is no longer read
        stage_centroids<M>(cent, ccs, cb, ccb, ki * kt, kt, K);
        __syncthreads();
      }
      // x . c for NJ n8 tiles from n8 tile j0 on: 3xTF32 in K-B's order.
      auto products = [&](float (&acc)[S::MT][S::NJ][4], int j0) {
#pragma unroll
        for (int i = 0; i < S::MT; ++i) {
#pragma unroll
          for (int j = 0; j < S::NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
          }
        }
#pragma unroll
        for (int s = 0; s < S::S; ++s) {
          uint4 bf[S::NJ];
#pragma unroll
          for (int j = 0; j < S::NJ; ++j) {
            bf[j] = cw[(j0 + j) * 8 * S::H + 4 * (s ^ sg)];
          }
#pragma unroll
          for (int j = 0; j < S::NJ; ++j) {
#pragma unroll
            for (int i = 0; i < S::MT; ++i) {
              mma_tf32(acc[i][j], al[i][s], bf[j].x, bf[j].y);
              mma_tf32(acc[i][j], ah[i][s], bf[j].z, bf[j].w);
              mma_tf32(acc[i][j], ah[i][s], bf[j].x, bf[j].y);
            }
          }
        }
      };
      // cc - 2 x . c into the running first minimum, k increasing.
      auto fold = [&](const float (&acc)[S::MT][S::NJ][4], int j0) {
#pragma unroll
        for (int j = 0; j < S::NJ; ++j) {
          const int kl = (j0 + j) * 8 + 2 * t;
          const float2 ck = *reinterpret_cast<const float2*>(ccs + kl);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int i = 0; i < S::MT; ++i) {
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float d = (h ? ck.y : ck.x) - 2.f * acc[i][j][2 * r + h];
                if (d < best[i][r]) {
                  best[i][r] = d;
                  best_k[i][r] = ki * kt + kl + h;
                }
              }
            }
          }
        }
      };
      // Two accumulator sets in turn: the next group's products are issued
      // before this group is folded.
      const int nj = kt / 8;
      float acc0[S::MT][S::NJ][4], acc1[S::MT][S::NJ][4];
      products(acc0, 0);
      for (int j0 = 0; j0 < nj; j0 += 2 * S::NJ) {
        products(acc1, j0 + S::NJ);
        fold(acc0, j0);
        if (j0 + 2 * S::NJ < nj) products(acc0, j0 + 2 * S::NJ);
        fold(acc1, j0 + S::NJ);
      }
    }

    // Merge the quad's lanes: smaller distance, then smaller k. Every lane
    // of the quad ends with the row's pick.
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best[i][r], off);
          const int ok = __shfl_xor_sync(0xffffffffu, best_k[i][r], off);
          if (ov < best[i][r] || (ov == best[i][r] && ok < best_k[i][r])) {
            best[i][r] = ov;
            best_k[i][r] = ok;
          }
        }
      }
    }
    const int wrow0 = tile * S::BM + warp * 16 * S::MT;
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      const int row = wrow0 + 16 * i + g + 8 * t;  // lane t < 2 writes it
      if (t < 2 && row < N) {
        idx[(size_t)b * N + row] = t ? best_k[i][1] : best_k[i][0];
      }
    }
  }
}

template <int M>
cudaError_t launch(const float* xg, const float* c, const float* cc,
                   int32_t* idx, int B, int N, int K, cudaStream_t s) {
  using S = Shape<M>;
  // As many centroids as fit beside the x slots, a multiple of kKT (all
  // of K if it can).
  const size_t fixed = 2 * S::XTILE * sizeof(float);
  const size_t per_k = S::H * 16 + sizeof(float);  // a staged centroid
  const int k_pad = (K + kKT - 1) / kKT * kKT;
  const size_t fit = (kSmemMax - fixed) / per_k / kKT * kKT;
  const int kt = fit < (size_t)k_pad ? (int)fit : k_pad;
  const size_t bytes = fixed + kt * per_k;

  // Set at every launch on purpose: the attribute belongs to the current
  // device, which may differ from the last launch's.
  cudaError_t err = cudaFuncSetAttribute(
      grouped_round_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grouped_round_kernel<M>, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  // Every block resident at once: B rows of row-tile walkers. The
  // assignment of a row does not depend on which walker takes it.
  const int n_tiles = (N + S::BM - 1) / S::BM;
  const int fill = per_sm * sms / B;
  const int walkers = fill < 1 ? 1 : fill < n_tiles ? fill : n_tiles;
  const dim3 grid(walkers, B);
  grouped_round_kernel<M><<<grid, kThreads, bytes, s>>>(
      xg, c, cc, idx, N, K, kt);
  return cudaGetLastError();
}

}  // namespace

// xg [GG, N, 128] f32, c [B, K, M] f32, cc [B, K] f32 -> idx [B, N] int32.
// M in {8, 16, 32, 64}, GG = ceil(B / (128 / M)); xg and c 16-byte aligned.
// All on the current device (the caller selects it). Returns a
// cudaError_t.
extern "C" int fdb_lloyd_grouped(const void* xg, const void* c,
                                 const void* cc, void* idx, int B, int GG,
                                 int N, int K, int M, void* stream) {
  (void)GG;  // implied by B and M; the wrapper checks it
  const auto* xf = static_cast<const float*>(xg);
  const auto* cf = static_cast<const float*>(c);
  const auto* ccf = static_cast<const float*>(cc);
  auto* idxi = static_cast<int32_t*>(idx);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 8:
      return launch<8>(xf, cf, ccf, idxi, B, N, K, s);
    case 16:
      return launch<16>(xf, cf, ccf, idxi, B, N, K, s);
    case 32:
      return launch<32>(xf, cf, ccf, idxi, B, N, K, s);
    case 64:
      return launch<64>(xf, cf, ccf, idxi, B, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}
