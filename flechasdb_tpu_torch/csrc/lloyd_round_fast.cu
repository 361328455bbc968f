// K-B fast: the Lloyd round's fast_math assignment for Hopper (sm_90a).
//
// Replaces the `fast_math=True` branch of the TPU kernel `_round_kernel`
// (flechasdb_tpu/ops/pallas_kmeans.py:81-96, reached by `lloyd_round`,
// its centroids made bf16 once outside the grid at :421-422). For every
// batch entry b and row i:
//
//     idx[b, i] = first argmin_k (cc[b, k] - 2 bf16(x[b, i]) . bf16(c[b, k]))
//
// with cc = |c|^2 of the f32 centroids, bf16 rounding to nearest even (as
// XLA's astype(bfloat16)), the products exact in f32 and summed in f32.
// The round's sums and counts are the next launch, cluster_sums.cu.
//
// What bounds it on the H100: x, B N M 4 bytes, read once, against 2 B N
// K M bf16 operations at 989.4 TFLOP/s; at 3.35 TB/s the bytes of x bind
// below K = 590 and the operations above (the headline coarse and PQ
// shapes by bytes; K = 1024 and the SIFT coarse shape by operations).
//
// The design, against the four costs of the mma.sync variant it replaces
// (once the FAST branch of lloyd_round.cu):
// 1. x was streamed again for every centroid tile. Here a block is
//    persistent over row blocks of 192 rows, three consumer warpgroups of
//    one 64-row band each. A producer lane brings a row block's x by the
//    TMA into an f32 slot in shared memory, and each warpgroup rounds its
//    band to bf16 once, into wgmma A fragments held in registers across
//    every centroid tile ("resident", M <= 128). Above M = 128 a band is
//    taken 128 columns at a time and x is read once a pair of centroid
//    tiles ("chunked"; once at K <= 128, as on the headline coarse shape).
//    A resident band of 256 columns would need an x slot of 192 KB for
//    three warpgroups, or two warpgroups and half as many rows a block;
//    no path runs 128 < M <= 256.
// 2. Operands were rounded at every fragment read. The centroids are
//    rounded once a round, as the TPU kernel rounds them outside its grid,
//    by stage_kernel, launched just before from the same entry: a
//    zero-padded [B, Kp, Mp] bf16 buffer (Kp a multiple of 128, Mp of 64)
//    and cc padded with +inf past K, which the wrapper allocates. Its
//    plain version is ops/lloyd.py's stage_centroids. Staged with PyTorch
//    operations (six launches) the round at K = 1024, 65,536 rows, was
//    host-bound and slower than the mma.sync variant's on an H100. x is
//    rounded once a row block, above.
// 3. mma.sync with its operands rounded from f32 tiles. Here
//    wgmma.mma_async.m64n64k16 bf16: A the band's fragments in registers
//    (the m16n8k16 layout), B a 64-centroid x 64-column box in shared
//    memory, 128-byte swizzled as the TMA writes it
//    (CU_TENSOR_MAP_SWIZZLE_128B). A producer lane streams each tile's
//    boxes through a ring of up to 8 slots with full/empty mbarriers
//    (hopper.cuh); no block-wide barrier after the set-up. A stays in
//    registers: as a bf16 tile in shared memory each warpgroup would read
//    A as well as B from shared memory for every centroid tile, twice the
//    shared-memory traffic (a variant built so was slower on an H100).
// 4. The argmin fold did not overlap the products. Two accumulator sets,
//    tiles in groups of four: the next tile's wgmmas are issued, then
//    wgmma.wait_group 1 and this tile's distances are folded while the
//    tensor cores run (three folds of four; the other warpgroups'
//    products run beside the fourth). The fold is a tree of depth 4 a
//    row, not a chain of 16 dependent compares.
//
// The centroids' L2 traffic: every row block reads its batch entry's
// staged centroids, B ceil(N / 192) Kp Mp 2 bytes a round: 1.37 GB at the
// SIFT coarse shape (B=1, N=1M, K=1024, M=128) beside 0.51 GB of x, 0.41
// GB at the PQ shape (B=12, N=100k, K=256, m=128) beside 0.61 GB, 0.20 GB
// at the headline coarse shape (B=1, N=100k, K=100, M=1536) beside 0.61
// GB. profile_kbfast.py's variant that never reloads them from L2 is
// barely faster on an H100 (PERF.md section 5), so a cluster that
// multicasts each tile was not built. Three warpgroups is the most whose
// fragments and two accumulator sets fit the register file: the producer
// warpgroup gives back registers (setmaxnreg, 40 a thread) and each
// consumer takes 152.
//
// Argmin: each thread folds fmaf(-2, acc, cc[k]), equal bit for bit to
// cc - 2 (x . c) (the doubling is exact), into a running (min,
// k) for each of its two rows: a tile's 16 distances of a row by a tree
// that keeps the lower k on equal distances, then the running minimum
// replaced only by a strictly smaller one (padded centroids have cc =
// +inf and never win); the quad's lanes merge by shuffles, the smaller k
// on equal distances, so the first minimum wins as in `jnp.argmin`. A
// row's products are issued in one fixed order whichever block takes it,
// so two calls give the same bits and duplicated centroids bit-equal
// distances (the first of them wins). Columns past M are zeros on both
// sides (the TMA's fill, the staging's padding) and add exact zeros.
//
// ptxas (nvcc 12.9, sm_90a, -O3): each of the three instances (KS = 4 and
// 8 resident, 8 chunked) 128 registers at entry, 152 a consumer thread
// after setmaxnreg, no spills; 0 wgmma serialization warnings.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBand = 64;       // rows a consumer warpgroup (wgmma M)
constexpr int kTile = 64;       // centroids a tile (wgmma N)
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;
constexpr int kNC = 3;           // consumer warpgroups
// Registers a thread after setmaxnreg: an SM quarter holds one warp of
// each warpgroup, 3 x 152 + 40 of its 512 a lane.
constexpr int kProducerRegs = 40, kConsumerRegs = 152;

// What ops/lloyd.py's fast_tiling picked, and what follows from it.
struct Fast {
  int kp;        // the staged centroids are [B, kp, Mp]
  int nch;       // chunks of 16 KS columns a band: 1 when resident
  int stages;    // ring slots
  int rb, nrb;   // row blocks a batch entry, and in all
};

// Shared memory: the x slot (kNC bands of KS / 2 boxes of 64 rows x 32
// floats), the ring (stages x KS / 4 boxes of 64 centroids x 64 bf16),
// then the barriers, from a 1024-byte boundary (the swizzle's period).
template <int KS>
struct Layout {
  static constexpr int kXBoxes = KS / 2;
  static constexpr int kCBoxes = KS / 4;
  static constexpr int kXBytes = kNC * kXBoxes * kBox;
  static constexpr int kStage = kCBoxes * kBox;
  static int bytes(int stages) {
    return 1024 + kXBytes + stages * kStage + (2 + 2 * stages) * 8;
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// wgmma issue and wait statements: before an issue and after the wait
// that completes it, never between (ptxas would serialize the wgmmas).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a box of 128-byte rows, 128-byte swizzled, K-major:
// start address / 16, leading offset 1 (unused when swizzled), 1024 bytes
// between groups of 8 rows, layout 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t box_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d (+)= a b: a the warpgroup's 64 x 16 bf16 slice in registers (each
// warp's 16 rows in the m16n8k16 A layout), b 16 x 64 bf16 from the
// descriptor; scale_d 0 starts the sums afresh. d[4 j + 2 r + h] is row
// g + 8 r of the warp's 16, column 8 j + 2 t + h (g = lane / 4, t = lane
// % 4).
__device__ __forceinline__ void wgmma64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The KS k16 steps of one tile chunk in the ring slot at `slot` into d,
// as one commit group. Step s reads box s / 4, 32 bytes a step into its
// rows (the swizzle is applied by the hardware from the address).
template <int KS>
__device__ __forceinline__ void issue(float (&d)[32],
                                      const uint32_t (&a)[KS][4],
                                      uint32_t slot, bool fresh) {
  const uint64_t desc = box_desc(slot);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint64_t step = (uint64_t)(((s / 4) * kBox + (s % 4) * 32) >> 4);
    wgmma64(d, a[s], desc + step, fresh && s == 0 ? 0u : 1u);
  }
}

// Folds one tile's distances into the running first minimum of this
// thread's two rows. A row's 16 distances, i = 2 j + h at k = k0 + 8 j +
// 2 t + h, are reduced as a tree of depth 4, the lower i kept on equal
// distances, so the tile's first minimum comes out with 4 dependent steps
// in place of 16; it replaces the running one only if strictly smaller.
__device__ __forceinline__ void fold(const float (&d)[32],
                                     const float2 (&ck)[8], int k0, int t,
                                     float (&best)[2], int (&bk)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[16];
    int ix[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[2 * j] = fmaf(-2.f, d[4 * j + 2 * r], ck[j].x);
      v[2 * j + 1] = fmaf(-2.f, d[4 * j + 2 * r + 1], ck[j].y);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) ix[i] = i;
#pragma unroll
    for (int w = 1; w < 16; w *= 2) {
#pragma unroll
      for (int i = 0; i < 16; i += 2 * w) {
        if (v[i + w] < v[i]) {
          v[i] = v[i + w];
          ix[i] = ix[i + w];
        }
      }
    }
    if (v[0] < best[r]) {
      best[r] = v[0];
      bk[r] = k0 + 8 * (ix[0] >> 1) + 2 * t + (ix[0] & 1);
    }
  }
}

// Grid: persistent, block r takes row blocks r, r + gridDim.x, ...
// Warpgroups 0 .. kNC - 1 consume (warpgroup w the rows 64 w .. 64 w + 63
// of a row block); in warpgroup kNC one lane issues the centroid tiles'
// copies and another x's, each in the order the consumers use them: for
// a row block, resident, its x once and tiles 0 .. Kp / 64 - 1; chunked,
// for each tile pair and each chunk, the chunk's x and the pair's two
// tiles' chunk. x's lane refills the x slot as soon as the consumers have
// taken the last one, so the next row block's x lands while this one
// computes.
template <int KS, bool CHUNKED>
__global__ void __launch_bounds__(128 * (kNC + 1), 1)
assign_fast_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const float* __restrict__ ccp, int32_t* __restrict__ idx,
                   int N, Fast f) {
  using L = Layout<KS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = xs + L::kXBytes;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(ring + f.stages * L::kStage);
  uint64_t* x_empty = x_full + 1;
  uint64_t* full = x_full + 2;
  uint64_t* empty = full + f.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = f.kp / kTile;
  const int pairs = CHUNKED ? n_tiles / 2 : 1;

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
      const int per = CHUNKED ? 2 : n_tiles;  // tiles a pass over the chunks
      int slot = 0;
      uint32_t phase = 0;
      for (int r = blockIdx.x; r < f.nrb; r += gridDim.x) {
        const int b = r / f.rb;
        for (int p = 0; p < pairs; ++p) {
          for (int c = 0; c < f.nch; ++c) {
            for (int j = p * per; j < (p + 1) * per; ++j) {
              mbar_wait(empty + slot, phase ^ 1);
              mbar_expect_tx(full + slot, L::kStage);
              for (int q = 0; q < L::kCBoxes; ++q) {
                tensor_copy(ring + (slot * L::kCBoxes + q) * kBox, &cmap,
                            (c * L::kCBoxes + q) * 64, b * f.kp + j * kTile,
                            full + slot);
              }
              if (++slot == f.stages) {
                slot = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    } else if (warp == 4 * kNC + 1 && lane == 0) {  // x, as its slot frees
      uint32_t xphase = 0;
      for (int r = blockIdx.x; r < f.nrb; r += gridDim.x) {
        const int b = r / f.rb;
        const int row = b * N + (r - b * f.rb) * kBand * kNC;
        for (int p = 0; p < pairs; ++p) {
          for (int c = 0; c < f.nch; ++c) {
            mbar_wait(x_empty, xphase ^ 1);
            xphase ^= 1;
            mbar_expect_tx(x_full, L::kXBytes);
            for (int i = 0; i < kNC; ++i) {
              for (int q = 0; q < L::kXBoxes; ++q) {
                tensor_copy(xs + (i * L::kXBoxes + q) * kBox, &xmap,
                            (c * L::kXBoxes + q) * 32, row + kBand * i,
                            x_full);
              }
            }
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  // Shared-memory addresses, 32 bits each: the consumers' state is kept
  // small, the two accumulator sets and the fragments taking 96 of the
  // 152 registers at KS = 8.
  const uint32_t bars = smem_addr(x_full);  // x_full, x_empty, full, empty
  const unsigned char* band = xs + wg * L::kXBoxes * kBox;
  int slot = 0;  // the next slot to wait on
  uint32_t phase = 0, xphase = 0;
  uint32_t a[KS][4];
  float d0[32], d1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;

  // The next chunk of x into the A fragments (the wgmmas that read the
  // last ones have completed); the x slot is then free for the next.
  auto take_x = [&]() {
    mbar_wait(bars, xphase);
    xphase ^= 1;
    load_a<KS>(a, band, w4, g, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8);
  };
  // Waits for the next ring slot and issues its KS steps into d.
  auto next = [&](float(&d)[32], bool fresh) {
    mbar_wait(bars + 16 + 8 * slot, phase);
    fence_acc(d);
    wgmma_fence();
    issue<KS>(d, a, bars - f.stages * L::kStage + slot * L::kStage, fresh);
    if (++slot == f.stages) {
      slot = 0;
      phase ^= 1;
    }
  };
  // Frees the slot `back` places behind the next one (slots are freed in
  // the order they were taken, one or two behind).
  auto release = [&](int back) {
    __syncwarp();
    const int s = slot >= back ? slot - back : slot - back + f.stages;
    if (lane == 0) mbar_arrive(bars + 16 + 8 * (f.stages + s));
  };

  for (int r = blockIdx.x; r < f.nrb; r += gridDim.x) {
    const int b = r / f.rb;
    const int row0 = (r - b * f.rb) * kBand * kNC + kBand * wg + 16 * w4 + g;
    const float* ccb = ccp + (size_t)b * f.kp;
    float best[2] = {INFINITY, INFINITY};
    int bk[2] = {0, 0};
    float2 ck[8];
    if constexpr (!CHUNKED) {
      // Tiles in groups of four, then a pair, ping-ponging between the
      // two accumulator sets: every fold but a group's last runs beside
      // the next tile's products. No wgmma is in flight across the loop's
      // back edge: ptxas serializes the wgmmas when an accumulator issued
      // in one iteration is read in the next (C7514).
      take_x();
      int j = 0;
      for (; j + 4 <= n_tiles; j += 4) {
        next(d0, true);
        wgmma_commit();
        next(d1, true);
        wgmma_commit();
        load_cc(ck, ccb + j * kTile, t);
        wgmma_wait<1>();
        fence_acc(d0);
        release(2);
        fold(d0, ck, j * kTile, t, best, bk);
        next(d0, true);
        wgmma_commit();
        load_cc(ck, ccb + (j + 1) * kTile, t);
        wgmma_wait<1>();
        fence_acc(d1);
        release(2);
        fold(d1, ck, (j + 1) * kTile, t, best, bk);
        next(d1, true);
        wgmma_commit();
        load_cc(ck, ccb + (j + 2) * kTile, t);
        wgmma_wait<1>();
        fence_acc(d0);
        release(2);
        fold(d0, ck, (j + 2) * kTile, t, best, bk);
        load_cc(ck, ccb + (j + 3) * kTile, t);
        wgmma_wait<0>();
        fence_acc(d1);
        release(1);
        fold(d1, ck, (j + 3) * kTile, t, best, bk);
      }
      if (j < n_tiles) {
        next(d0, true);
        wgmma_commit();
        next(d1, true);
        wgmma_commit();
        load_cc(ck, ccb + j * kTile, t);
        wgmma_wait<1>();
        fence_acc(d0);
        release(2);
        fold(d0, ck, j * kTile, t, best, bk);
        load_cc(ck, ccb + (j + 1) * kTile, t);
        wgmma_wait<0>();
        fence_acc(d1);
        release(1);
        fold(d1, ck, (j + 1) * kTile, t, best, bk);
      }
    } else {
      for (int p = 0; p < pairs; ++p) {
        for (int c = 0; c < f.nch; ++c) {
          take_x();
          next(d0, c == 0);
          next(d1, c == 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(d0);
          fence_acc(d1);
          release(2);
          release(1);
        }
        load_cc(ck, ccb + 2 * p * kTile, t);
        fold(d0, ck, 2 * p * kTile, t, best, bk);
        load_cc(ck, ccb + (2 * p + 1) * kTile, t);
        fold(d1, ck, (2 * p + 1) * kTile, t, best, bk);
      }
    }
    // The quad's lanes hold the same rows at other columns: the smaller
    // distance, then the smaller k.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float v = best[rr];
      int k = bk[rr];
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
      if (t == 0 && row < N) idx[(size_t)b * N + row] = k;
    }
  }
}

// Warp w of block i stages row r = 8 i + w of cs [B, Kp, Mp] and ccp
// [B, Kp] (r = b Kp + k): centroid k of batch entry b rounded to bf16 (to
// nearest even), zeros past M, and its |c|^2 in f32, lane l adding
// columns l, l + 32, ... and the lanes then merged by a shuffle tree (a
// fixed order: duplicated centroids get equal norms); zeros and +inf past
// K.
__global__ void __launch_bounds__(256)
stage_kernel(const float* __restrict__ c, __nv_bfloat16* __restrict__ cs,
             float* __restrict__ ccp, int rows, int K, int M, int Kp,
             int Mp) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int b = r / Kp, k = r - b * Kp;
  const float* src = c + ((size_t)b * K + k) * M;
  __nv_bfloat16* dst = cs + (size_t)r * Mp;
  float acc = 0.f;
  for (int j = lane; j < Mp; j += 32) {
    const float v = k < K && j < M ? src[j] : 0.f;
    acc = fmaf(v, v, acc);
    dst[j] = __float2bfloat16_rn(v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) ccp[r] = k < K ? acc : INFINITY;
}

template <int KS, bool CHUNKED>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& cm,
                   const float* ccp, int32_t* idx, int N, const Fast& f,
                   cudaStream_t s) {
  const int bytes = Layout<KS>::bytes(f.stages);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = assign_fast_kernel<KS, CHUNKED>;
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

// x [B, N, M] f32 (M % 4 == 0, 16-byte aligned) and c [B, K, M] f32 ->
// idx [B, N] int32, through cs [B, Kp, Mp] bf16 (16-byte aligned) and ccp
// [B, Kp] f32, which stage_kernel fills first. chunk and stages come from
// ops/lloyd.py's fast_tiling: chunk Mp (64 or 128, resident) or 128 (Mp >
// 128, chunked). Refuses anything else (cudaErrorInvalidValue). On the
// current device, on `stream`. Returns a cudaError_t.
extern "C" int fdb_lloyd_round_fast(const void* x, const void* c, void* cs,
                                    void* ccp, void* idx, int B, int N, int K,
                                    int M, int Kp, int Mp, int chunk,
                                    int stages, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || M <= 0 || M % 4 != 0 || Mp < M ||
      Mp % 64 != 0 || Kp < K || Kp % (2 * kTile) != 0 || stages < 2 ||
      stages > kMaxStages || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cs) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const bool chunked = Mp > 128;
  if (chunk != (chunked ? 128 : Mp)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * Kp;
  stage_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(c), static_cast<__nv_bfloat16*>(cs),
      static_cast<float*>(ccp), rows, K, M, Kp, Mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Fast f;
  f.kp = Kp;
  f.nch = (Mp + chunk - 1) / chunk;
  f.stages = stages;
  f.rb = (N + kBand * kNC - 1) / (kBand * kNC);
  f.nrb = B * f.rb;
  // x as B N rows of M floats, boxes of 64 rows x 32 floats; the staged
  // centroids as B Kp rows of Mp bf16, boxes of 64 rows x 64. Both
  // 128-byte swizzled; zeros past the edges.
  CUtensorMap xm{}, cm{};
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)M, (cuuint64_t)B * N};
  const cuuint64_t xstrides[1] = {(cuuint64_t)M * 4};
  const cuuint32_t xbox[2] = {32, kBand};
  const cuuint64_t cdims[2] = {(cuuint64_t)Mp, (cuuint64_t)B * Kp};
  const cuuint64_t cstrides[1] = {(cuuint64_t)Mp * 2};
  const cuuint32_t cbox[2] = {64, kTile};
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x),
             xdims, xstrides, xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&cm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(cs),
             cdims, cstrides, cbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const auto* cc = static_cast<const float*>(ccp);
  auto* out = static_cast<int32_t*>(idx);
  if (chunked) return launch<8, true>(xm, cm, cc, out, N, f, s);
  if (chunk == 64) return launch<4, false>(xm, cm, cc, out, N, f, s);
  return launch<8, false>(xm, cm, cc, out, N, f, s);
}
