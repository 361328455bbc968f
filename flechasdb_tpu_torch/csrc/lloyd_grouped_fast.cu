// K-C fast: the grouped Lloyd round's fast_math assignment for Hopper
// (sm_90a).
//
// Replaces the `fast_math=True` branch of the TPU kernel
// `_grouped_round_kernel` (flechasdb_tpu/ops/pallas_kmeans.py:188-190,
// reached by `lloyd_round_grouped`; its block-diagonal bf16 centroids made
// outside the grid at :266-277). Its data is division-grouped: xg [GG, N,
// 128] holds g = 128 / m consecutive divisions' subvectors side by side in
// each 512-byte row (zeros in the pad divisions of the last group). For
// every division b < B and row i:
//
//     idx[b, i] = first argmin_k (cc[b, k] - 2 bf16(x_b[i]) . bf16(c[b, k]))
//
// with x_b[i] = xg[b / g, i, (b % g) m : (b % g + 1) m], cc = |c|^2 of the
// f32 centroids, bf16 rounding to nearest even (as XLA's astype(bfloat16)),
// the products exact in f32 and summed in f32: K-B fast's contract
// (lloyd_round_fast.cu) on grouped data. The round's sums and counts are
// the next launch, cluster_sums.cu.
//
// What bounds it on the H100: one read of xg, GG N 512 bytes (512 MB at
// the SIFT PQ shape, B=8, N=1M, K=256, m=16: 0.153 ms at 3.35 TB/s),
// against 2 B N K m bf16 operations (0.068 ms at 989.4 TFLOP/s). The
// route costs more than the function: every distance is folded into a
// running first minimum by compares, min/max and selects, which issue on
// the SM's 16-lane ALU pipe, half the rate of the FP32 pipe. At m = 16 a
// k16 step yields one distance a row and centroid (B N K = 2.05 G at SIFT
// PQ), so the fold, not the bytes or the tensor cores, sets the pace.
//
// The design, against what held the mma.sync variant back (once the FAST
// instances of lloyd_grouped.cu; profile_kcfast.py weighs the parts):
// 1. x once, whole rows. A block is persistent over row blocks of 192 rows
//    of one group, twelve consumer warps of 16 rows each (three
//    warpgroups). A producer lane brings a row block's 96 KB of xg by the
//    TMA into an f32 slot, and each warp rounds its rows to bf16 once,
//    into the A fragments of the row's eight k16 steps (32 registers,
//    hopper.cuh's load_a), then frees the slot for the next row block's x.
//    The mma.sync variant copied each division's 64-byte slice of a row
//    with cp.async into every division's own block and rounded it from
//    f32 fragments with 2-way bank conflicts. The TPU kernel reads each
//    row once for all g divisions too, through its block-diagonal operand.
// 2. The centroids are staged once a round on the card by
//    grouped_fast_staging, launched just before from the same entry: cs
//    [GG, Kp, 128] bf16, row k of group G holding the k-th centroid of
//    each of its divisions side by side in that division's columns (the
//    TPU's block-diagonal operand with its zeros compacted away), zeros in
//    the pad divisions and past K; ccp [GG g, Kp] f32, |c|^2 of the f32
//    centroids in K-B fast's order, +inf in the pad divisions and past K.
//    Its plain version is ops/lloyd.py's stage_grouped_centroids. The
//    producer lane streams each tile of 64 staged rows (two 128-byte
//    swizzled TMA boxes) through K-B fast's ring of full/empty mbarriers
//    (hopper.cuh), once for every pass of a row block.
// 3. Products: mma.sync m16n8k16 bf16, a warp's own. For division j only
//    its own k steps are issued: step j at m = 16, steps 2j, 2j + 1 at m =
//    32, four at m = 64; at m = 8 two divisions share a step and each
//    zeroes the other's half of the centroid fragments, the TPU's
//    block-diagonal zeros made in registers. The B fragments come from the
//    swizzled tile by ldmatrix, conflict-free. A wgmma.m64n64k16 variant
//    (A from registers, two accumulator sets, one division's wgmma running
//    while the other's was folded) was slower on an H100: its products are
//    16 deep, so the wgmma round trips and the warpgroup's four warps
//    waiting on each other cost more than the tensor cores saved. Where a
//    division starts a k16 step (m >= 16) its products are K-B fast's on
//    the ungrouped data step for step (there the steps past m multiply
//    zeros and add exact zeros), and its norms are staged in K-B fast's
//    order, so its distances and picks are K-B fast's.
// 4. The fold. A thread keeps a running (min, k) a division for each of
//    its two rows. A tile's 16 distances of a row go through a tree of
//    fminf (value only); then the first position holding the minimum is
//    found from the root down, taking the left subtree wherever its
//    minimum equals the tile's: 2.3 ALU instructions a distance in all,
//    where the mma.sync variant's compare-and-two-selects chain took 3.0
//    (SASS, profile_kcfast.py). Its update is a compare and a select in
//    one PTX block (select_lt), so the compiler cannot sink the index work
//    into a branch: the fold stays one basic block and the rows' chains
//    interleave. The running minimum is replaced only by a strictly
//    smaller one (padded centroids have cc = +inf and never win); the
//    quad's lanes merge by shuffles, the smaller k on equal distances, so
//    the first minimum wins as in `jnp.argmin`.
// 5. Registers. A consumer thread holds the fragments (32), one
//    accumulator set (32) and the running minima of a pass's divisions
//    (four at m <= 16, two above: 16), in the 160 a consumer takes by
//    setmaxnreg (the producer warpgroup keeps 32). The group's divisions
//    are taken a pass at a time over the same fragments, the centroid
//    tiles streamed once a pass (two passes at m = 16 and 32, four at
//    m = 8); eight divisions a pass spilled at m = 8, 16 and 32.
//
// A row's products are issued in one fixed order whichever block takes it,
// and the fold is a fixed function of them, so two calls give the same
// bits and duplicated centroids bit-equal distances (the first of them
// wins).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kLanes = 128;     // floats in an xg row
constexpr int kSteps = 8;       // k16 steps in a row
constexpr int kBand = 64;       // rows a consumer warpgroup
constexpr int kTile = 64;       // centroids a tile
constexpr int kNC = 3;          // consumer warpgroups
constexpr int kXBoxes = 4;      // a band: 4 boxes of 64 rows x 32 floats
constexpr int kCBoxes = 2;      // a tile: 2 boxes of 64 centroids x 64 bf16
constexpr int kXBytes = kNC * kXBoxes * kBox;
constexpr int kStage = kCBoxes * kBox;
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;
// Registers a thread after setmaxnreg: an SM quarter holds one warp of
// each warpgroup, 3 x 160 + 32 of its 512 a lane.
constexpr int kProducerRegs = 32, kConsumerRegs = 160;

// Subvector width M: G divisions a group, S k16 steps a division (m = 8
// shares one), P divisions a pass over the centroid tiles (their running
// minima are what a thread holds beside its fragments and accumulators),
// NP passes.
template <int M>
struct Div {
  static constexpr int G = kLanes / M;
  static constexpr int S = M >= 16 ? M / 16 : 1;
  static constexpr int P = M <= 16 ? 4 : 2;
  static constexpr int NP = G / P;
  static_assert(M == 8 || M == 16 || M == 32 || M == 64, "M");
  static_assert(P >= 2, "a pass's last products come before its last fold");
};

// What ops/lloyd.py's grouped_fast_tiling picked, and what follows.
struct Plan {
  int b;        // divisions
  int kp;       // staged centroids a division, a multiple of kTile
  int stages;   // ring slots
  int rb, nrb;  // row blocks a group, and in all
};

int smem_bytes(int stages) {
  return 1024 + kXBytes + stages * kStage + (2 + 2 * stages) * 8;
}

// Four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; thread (g, t) receives row g, columns 2t and
// 2t + 1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The accumulators of n8 tile j, as mma_bf16 takes them.
__device__ __forceinline__ float (&n8(float (&d)[32], int j))[4] {
  return *reinterpret_cast<float(*)[4]>(d + 4 * j);
}

// Division q of the group against the 64 centroids of the tile at `tile`
// (two 128-byte-swizzled boxes of 64 rows): d[4 j + 2 r + h] = row g + 8 r
// of the warp's 16, centroid 8 j + 2 t + h. Its S k16 steps (M >= 16), or
// at M = 8 step q / 2 with the B registers of the other division's half of
// its columns zeroed. lrow, khalf and rx place this lane's row of each
// ldmatrix: an x4 loads two n8 tiles' b0 and b1.
template <int M>
__device__ __forceinline__ void products(float (&d)[32],
                                         const uint32_t (&a)[kSteps][4],
                                         uint32_t tile, int q, uint32_t lrow,
                                         int khalf, int rx) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Div<M>::S; ++i) {
    const int s = M == 8 ? q / 2 : q * Div<M>::S + i;
    const uint32_t row =
        tile + (s / 4) * kBox + lrow + (((2 * (s % 4) + khalf) ^ rx) << 4);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, row + jj * 16 * 128);
      if (M == 8) {  // the other division's half of the step's columns
        if (q & 1) {
          b[0] = b[2] = 0u;
        } else {
          b[1] = b[3] = 0u;
        }
      }
      mma_bf16(n8(d, 2 * jj), a[s], b[0], b[1]);
      mma_bf16(n8(d, 2 * jj + 1), a[s], b[2], b[3]);
    }
  }
}

// u < v ? a : b, one compare and one select whatever the outcome: the
// compiler may not sink the work that makes a into a branch, so the fold
// stays one basic block, where the chains of several rows interleave.
__device__ __forceinline__ int select_lt(float u, float v, int a, int b) {
  int r;
  asm("{\n.reg .pred p;\nsetp.lt.f32 p, %3, %4;\nselp.b32 %0, %1, %2, p;\n}\n"
      : "=r"(r)
      : "r"(a), "r"(b), "f"(u), "f"(v));
  return r;
}

// Folds one tile's distances into the running first minimum of this
// thread's two rows. A row's 16 distances, i = 2 j + h at k = k0 + 8 j +
// 2 t + h, go through a tree of fminf; then the first i holding the
// minimum is found from the root down, taking the left subtree wherever
// its minimum equals the tile's (the left holds the lower i). It replaces
// the running minimum only if strictly smaller.
__device__ __forceinline__ void fold(const float (&d)[32],
                                     const float2 (&ck)[8], int k0t,
                                     float (&best)[2], int (&bk)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[16], w[8], y[4], z[2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[2 * j] = fmaf(-2.f, d[4 * j + 2 * r], ck[j].x);
      v[2 * j + 1] = fmaf(-2.f, d[4 * j + 2 * r + 1], ck[j].y);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = fminf(v[2 * j], v[2 * j + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = fminf(w[2 * j], w[2 * j + 1]);
    z[0] = fminf(y[0], y[1]);
    z[1] = fminf(y[2], y[3]);
    const float tm = fminf(z[0], z[1]);
    // i = 8 b3 + 4 b2 + 2 b1 + b0, each bit set where the left subtree's
    // minimum exceeds the tile's.
    const bool b3 = z[0] != tm;
    const bool b2 = (b3 ? y[2] : y[0]) != tm;
    const float wl = b3 ? (b2 ? w[6] : w[4]) : (b2 ? w[2] : w[0]);
    const bool b1 = wl != tm;
    const float v0 = b1 ? (b2 ? v[6] : v[2]) : (b2 ? v[4] : v[0]);
    const float v1 = b1 ? (b2 ? v[14] : v[10]) : (b2 ? v[12] : v[8]);
    const bool b0 = (b3 ? v1 : v0) != tm;
    // Column 8 j + h of the thread's 16: 32 b3 + 16 b2 + 8 b1 + b0.
    const int col = (b3 ? 32 : 0) + (b2 ? 16 : 0) + (b1 ? 8 : 0) + b0;
    bk[r] = select_lt(tm, best[r], k0t + col, bk[r]);
    best[r] = fminf(tm, best[r]);
  }
}

// Grid: persistent, block r takes row blocks r, r + gridDim.x, ... (row
// block r of group r / rb). Warpgroups 0 .. kNC - 1 consume (warp 4 w + i
// the rows 64 w + 16 i .. 64 w + 16 i + 15 of a row block, with its own
// products); in warpgroup kNC one lane issues the centroid tiles' copies
// and another x's, each in the order the consumers use them: for a row
// block, its x once, and the group's tiles 0 .. Kp / 64 - 1 once a pass.
// x's lane refills the x slot as soon as the consumers have taken the
// last one.
template <int M>
__global__ void __launch_bounds__(128 * (kNC + 1), 1)
grouped_fast_assign(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const float* __restrict__ ccp,
                    int32_t* __restrict__ idx, int N, Plan f) {
  using D = Div<M>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = xs + kXBytes;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(ring + f.stages * kStage);
  uint64_t* x_empty = x_full + 1;
  uint64_t* full = x_full + 2;
  uint64_t* empty = full + f.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = f.kp / kTile;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);  // the producer's expect_tx
    mbar_init(x_empty, 4 * kNC);
    for (int i = 0; i < f.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * kNC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kNC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == 4 * kNC && lane == 0) {  // the centroid tiles
      int slot = 0;
      uint32_t phase = 0;
      for (int r = blockIdx.x; r < f.nrb; r += gridDim.x) {
        const int grp = r / f.rb;
        for (int p = 0; p < D::NP; ++p) {
          for (int j = 0; j < n_tiles; ++j) {
            mbar_wait(empty + slot, phase ^ 1);
            mbar_expect_tx(full + slot, kStage);
            for (int q = 0; q < kCBoxes; ++q) {
              tensor_copy(ring + (slot * kCBoxes + q) * kBox, &cmap, q * 64,
                          grp * f.kp + j * kTile, full + slot);
            }
            if (++slot == f.stages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (warp == 4 * kNC + 1 && lane == 0) {  // x, as its slot frees
      uint32_t xphase = 0;
      for (int r = blockIdx.x; r < f.nrb; r += gridDim.x) {
        const int grp = r / f.rb;
        const int row = grp * N + (r - grp * f.rb) * kBand * kNC;
        mbar_wait(x_empty, xphase ^ 1);
        xphase ^= 1;
        mbar_expect_tx(x_full, kXBytes);
        for (int i = 0; i < kNC; ++i) {
          for (int q = 0; q < kXBoxes; ++q) {
            tensor_copy(xs + (i * kXBoxes + q) * kBox, &xmap, q * 32,
                        row + kBand * i, x_full);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  // Shared-memory addresses, 32 bits each: the consumers' state is kept
  // small beside the fragments and the minima.
  const uint32_t bars = smem_addr(x_full);  // x_full, x_empty, full, empty
  const uint32_t ring0 = smem_addr(ring);
  const unsigned char* band = xs + wg * kXBoxes * kBox;
  // This lane's row of an ldmatrix.x4 (matrix lane / 8: n8 tile lane / 16,
  // k half (lane / 8) % 2; row lane % 8).
  const uint32_t lrow = (8 * (lane >> 4) + (lane & 7)) * 128;
  const int khalf = (lane >> 3) & 1, rx = lane & 7;
  int slot = 0;  // the next slot to wait on
  uint32_t phase = 0, xphase = 0;
  uint32_t a[kSteps][4];

  for (int r = blockIdx.x; r < f.nrb; r += gridDim.x) {
    const int grp = r / f.rb;
    const int row0 = (r - grp * f.rb) * kBand * kNC + kBand * wg + 16 * w4 + g;
    // The row block's x into the A fragments; the x slot is then free for
    // the next.
    mbar_wait(bars, xphase);
    xphase ^= 1;
    load_a<kSteps>(a, band, w4, g, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8);

#pragma unroll
    for (int p = 0; p < D::NP; ++p) {
      const int div0 = grp * D::G + p * D::P;  // the pass's first division
      // This thread's columns 2 t, 2 t + 1 of each n8 tile.
      const float* ccb = ccp + (size_t)div0 * f.kp + 2 * t;
      float best[D::P][2];
      int bk[D::P][2];
#pragma unroll
      for (int q = 0; q < D::P; ++q) {
        best[q][0] = best[q][1] = INFINITY;
        bk[q][0] = bk[q][1] = 0;
      }
      for (int j = 0; j < n_tiles; ++j) {
        // One tile for every division of the pass, the slot freed once
        // the last division's products have read it.
        const uint32_t at = ring0 + slot * kStage;
        mbar_wait(bars + 16 + 8 * slot, phase);
        // Division q + 1's products are issued before division q is
        // folded, so the tensor cores work beside the fold (at m = 64, one
        // division's four steps at a time: two sets spill there).
        constexpr bool ahead = D::S <= 2;
        float d0[32], d1[32];
        if (ahead) products<M>(d0, a, at, p * D::P, lrow, khalf, rx);
#pragma unroll
        for (int q = 0; q < D::P; ++q) {
          float(&d)[32] = q & 1 && ahead ? d1 : d0;
          if (!ahead) {
            products<M>(d, a, at, p * D::P + q, lrow, khalf, rx);
          } else if (q + 1 < D::P) {
            products<M>(q & 1 ? d0 : d1, a, at, p * D::P + q + 1, lrow,
                        khalf, rx);
          }
          if (q + (ahead ? 2 : 1) == D::P) {  // the tile's last products
            __syncwarp();
            if (lane == 0) mbar_arrive(bars + 16 + 8 * (f.stages + slot));
          }
          float2 ck[8];
          load_cc(ck, ccb + (size_t)q * f.kp + j * kTile, 0);
          fold(d, ck, j * kTile + 2 * t, best[q], bk[q]);
        }
        if (++slot == f.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      // The quad's lanes hold the same rows at other columns: the smaller
      // distance, then the smaller k.
#pragma unroll
      for (int q = 0; q < D::P; ++q) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float v = best[q][rr];
          int k = bk[q][rr];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int ok = __shfl_xor_sync(0xffffffffu, k, off);
            if (ov < v || (ov == v && ok < k)) {
              v = ov;
              k = ok;
            }
          }
          const int row = row0 + 8 * rr;
          if (t == 0 && row < N && div0 + q < f.b) {
            idx[(size_t)(div0 + q) * N + row] = k;
          }
        }
      }
    }
  }
}

// Warp w of block i stages division d = r / Kp's centroid k = r % Kp, r =
// 8 i + w: its m values rounded to bf16 (to nearest even) into columns
// (d % g) m ... of row k of group d / g of cs [GG, Kp, 128], and its
// |c|^2 in f32 into ccp [GG g, Kp], as K-B fast's stage_kernel adds it
// at Mp = 64: lane l adds columns l and l + 32, then the lanes merge by a
// shuffle tree. Zeros and +inf in the pad divisions and past K.
__global__ void __launch_bounds__(256)
grouped_fast_staging(const float* __restrict__ c,
                     __nv_bfloat16* __restrict__ cs, float* __restrict__ ccp,
                     int rows, int B, int K, int M, int Kp) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int d = r / Kp, k = r - d * Kp, g = kLanes / M;
  const bool live = d < B && k < K;
  const float* src = c + ((size_t)d * K + k) * M;
  __nv_bfloat16* dst = cs + ((size_t)(d / g) * Kp + k) * kLanes + (d % g) * M;
  float acc = 0.f;
  for (int j = lane; j < 64; j += 32) {
    const float v = live && j < M ? src[j] : 0.f;
    acc = fmaf(v, v, acc);
    if (j < M) dst[j] = __float2bfloat16_rn(v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) ccp[r] = live ? acc : INFINITY;
}

template <int M>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& cm,
                   const float* ccp, int32_t* idx, int N, const Plan& f,
                   cudaStream_t s) {
  const int bytes = smem_bytes(f.stages);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = grouped_fast_assign<M>;
  // Set at every launch: the attribute belongs to the current device.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // One block an SM; which block takes a row block does not change its
  // bits.
  const int grid = f.nrb < sms ? f.nrb : sms;
  kernel<<<grid, 128 * (kNC + 1), bytes, s>>>(xm, cm, ccp, idx, N, f);
  return cudaGetLastError();
}

}  // namespace

// xg [GG, N, 128] f32 (16-byte aligned) and c [B, K, M] f32, M in {8, 16,
// 32, 64}, GG = ceil(B / (128 / M)) -> idx [B, N] int32, through cs [GG,
// Kp, 128] bf16 (16-byte aligned) and ccp [GG 128 / M, Kp] f32, which
// grouped_fast_staging fills first. Kp (a multiple of 64, >= K) and
// stages come from ops/lloyd.py's grouped_fast_tiling. Refuses anything
// else (cudaErrorInvalidValue). On the current device, on `stream`.
// Returns a cudaError_t.
extern "C" int fdb_lloyd_grouped_fast(const void* xg, const void* c,
                                      void* cs, void* ccp, void* idx, int B,
                                      int GG, int N, int K, int M, int Kp,
                                      int stages, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 ||
      (M != 8 && M != 16 && M != 32 && M != 64) ||
      GG != (B + kLanes / M - 1) / (kLanes / M) || Kp < K ||
      Kp % kTile != 0 || stages < 2 || stages > kMaxStages ||
      reinterpret_cast<uintptr_t>(xg) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cs) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = GG * (kLanes / M) * Kp;
  grouped_fast_staging<<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(c), static_cast<__nv_bfloat16*>(cs),
      static_cast<float*>(ccp), rows, B, K, M, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Plan f;
  f.b = B;
  f.kp = Kp;
  f.stages = stages;
  f.rb = (N + kBand * kNC - 1) / (kBand * kNC);
  f.nrb = GG * f.rb;
  // xg as GG N rows of 128 floats, boxes of 64 rows x 32 floats; the
  // staged centroids as GG Kp rows of 128 bf16, boxes of 64 rows x 64.
  // Both 128-byte swizzled; zeros past the edges.
  CUtensorMap xm{}, cm{};
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)kLanes, (cuuint64_t)GG * N};
  const cuuint64_t xstrides[1] = {(cuuint64_t)kLanes * 4};
  const cuuint32_t xbox[2] = {32, kBand};
  const cuuint64_t cdims[2] = {(cuuint64_t)kLanes, (cuuint64_t)GG * Kp};
  const cuuint64_t cstrides[1] = {(cuuint64_t)kLanes * 2};
  const cuuint32_t cbox[2] = {64, kTile};
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(xg),
             xdims, xstrides, xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&cm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cs, cdims, cstrides,
             cbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const auto* cc = static_cast<const float*>(ccp);
  auto* out = static_cast<int32_t*>(idx);
  switch (M) {
    case 8:
      return launch<8>(xm, cm, cc, out, N, f, s);
    case 16:
      return launch<16>(xm, cm, cc, out, N, f, s);
    case 32:
      return launch<32>(xm, cm, cc, out, N, f, s);
    default:
      return launch<64>(xm, cm, cc, out, N, f, s);
  }
}
