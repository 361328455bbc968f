// The probed partitions' L2 ADC tables for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves the tables to XLA
// (`probed_tables`, flechasdb_tpu/ops/bucketed.py:125), and the port first
// did the same in PyTorch: the expansion rr + cc - 2 rc and a clamp, five
// passes over the [B, nprobe, D, C] output and its intermediates. This
// kernel was added to write each table once and touch nothing else in
// device memory.
//
// What it computes. For every cell g = b*nprobe + j (query b's j-th probe,
// partition p = probed[b, j]), every division d and every codeword c,
//
//     out[g, d, c] = sum_s (q[b, d*sub + s] - cent[p, d*sub + s]
//                           - cb[d, c, s])^2
//
// in f32, summed in ascending s: the difference form, >= 0 by
// construction, so no clamp. Without centroids (the OPQ route, where the
// wrapper rotates the residuals first) q holds the cells' residuals [G, M]
// and nothing is subtracted. A partition outside [0, P) gives NaN tables
// and is never read.
//
// What bounds it on the H100: bytes written. At the GIST1M serving batch
// (10,000 cells, D=60, C=256) it writes 614 MB and reads under 9 MB
// (queries, probed centroids, codebooks): 0.186 ms at 3.35 TB/s. Its
// 2*cells*C*M operations (4.9 GFLOP) at the f32 rate take 0.073 ms, but
// the difference form needs a subtract and an FMA a term, so the
// instruction rate comes close to the byte time: the arithmetic has to
// stay lean.
//
// What the design does about that bound:
// - A block takes a band of divisions and a chunk of cells; a thread owns
//   four consecutive codewords of one division and stores their sums as
//   one float4 along C, so a warp writes 512 contiguous bytes a cell. The
//   output is written once, with streaming stores (evict first), so that
//   614 MB of tables do not push the query and centroid rows out of L2.
// - The band's codebook slice is staged in shared memory once a block (in
//   tiles of s when it exceeds 64 KB, then once a tile and cell group),
//   16 bytes a load where sub % 4 == 0, and reused across all of the
//   block's cells, laid out so that a quarter warp's 16-byte reads of four
//   codewords fall in distinct banks.
// - Each warp lies in one division and forms its own residual slices for
//   each group of kCells cells in shared memory (16-byte loads of the
//   query and centroid rows where sub % 4 == 0: one load a lane at both
//   serving shapes), behind warp barriers only, so one warp's loads
//   overlap the others' arithmetic; each group's probes are read a group
//   ahead. Every lane reads the same slice, a broadcast. The thread keeps
//   kCells x 4 sums in registers and walks s four at a time: per step 4
//   codeword and kCells residual loads feed kCells x 32 arithmetic
//   instructions.
// - Two blocks an SM, 16 warps, with no register spilled; the grid is one
//   wave of them, split over bands and cell chunks, so the codebook is
//   staged as few times as the card's parallelism allows.
// Measured on an H100 (SXM, 700 W) at the GIST1M batch, against the
// designs this one replaced: scalar staging a thread at a time cost 0.14
// ms of a 0.43-ms kernel (the loads' round trips, one after another, and
// L2 misses on rows the output had evicted); three blocks an SM spilled
// registers and ran slower than two; a register pipeline of the next
// group's scalar loads ran slower still. Stores alone take 0.21 ms.
// Any D, C and sub: codewords past C, divisions past D, cells past G and s
// past sub are masked or zero-padded (a zero residual against a zero
// codeword adds 0); float4 stores need C % 4 == 0, else scalar stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;        // the most threads a block
constexpr int kCells = 8;            // cells a thread sums at once
constexpr int kCbFloats = 16384;     // the codebook tile: 64 KB
// The residual tiles: kCells x ST floats a warp, where (threads / 32) x ST
// <= kCbFloats / 128.
constexpr int kResFloats = kCells * (kCbFloats / 128);
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = (kCbFloats + kResFloats) * sizeof(float);

struct Args {
  const float* q;          // [B, M], or [G, M] residuals when cent is null
  const float* cent;       // [P, M] or null
  const int64_t* probed;   // [B, nprobe], rows ld apart
  const float* cb;         // [D, C, sub]
  float* out;              // [G, D, C]
  int G, nprobe, ld, P, D, C, sub;
  int QB;    // codeword quads a division a block (a multiple of 32)
  int DB;    // divisions a block
  int ST;    // s a tile (a multiple of 4)
  int tiles; // s tiles: ceil(sub / ST)
  int cpb;   // cells a block (a multiple of kCells)
  int vec;     // float4 stores
  int vec_in;  // float4 loads of the rows and the codebook
};

// The codebook tile t of the block's band: cbs[dl][k][i][ql][j] holds
// cb[d0 + dl, 4 (q0 + ql) + i, t*ST + 4k + j], 0 outside the codebook.
// Read in the codebook's own order, four s a load where sub allows it
// (a.vec_in), a few loads in flight a thread.
__device__ __forceinline__ void stage_codebook(const Args& a, float* cbs,
                                               int d0, int q0, int t) {
  const int cw = 4 * a.QB;  // codewords a division of the block
  const int steps = a.ST >> 2;
  const int s0 = t * a.ST;
  if (a.vec_in) {
    const int n = a.DB * cw * steps;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int k = e % steps;
      const int rest = e / steps;
      const int cl = rest % cw;
      const int dl = rest / cw;
      const int d = d0 + dl, c = 4 * q0 + cl, s = s0 + 4 * k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < a.D && c < a.C && s < a.sub) {
        v = __ldg(reinterpret_cast<const float4*>(
            a.cb + ((size_t)d * a.C + c) * a.sub + s));
      }
      *reinterpret_cast<float4*>(
          cbs + (((dl * steps + k) * 4 + (cl & 3)) * a.QB + (cl >> 2)) * 4) =
          v;
    }
    return;
  }
  const int n = a.DB * cw * a.ST;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int sp = e % a.ST;
    const int rest = e / a.ST;
    const int cl = rest % cw;
    const int dl = rest / cw;
    const int d = d0 + dl, c = 4 * q0 + cl, s = s0 + sp;
    float v = 0.f;
    if (d < a.D && c < a.C && s < a.sub) {
      v = __ldg(a.cb + ((size_t)d * a.C + c) * a.sub + s);
    }
    cbs[(((dl * steps + (sp >> 2)) * 4 + (cl & 3)) * a.QB + (cl >> 2)) * 4 +
        (sp & 3)] = v;
  }
}

// Lane x < kCells: the partition that cell g0 + x probes (unread without
// centroids or past G).
__device__ __forceinline__ int64_t probe_of(const Args& a, int g0,
                                            int lane) {
  const int g = g0 + lane;
  if (a.cent == nullptr || lane >= kCells || g >= a.G) return -1;
  const int b = g / a.nprobe;
  return __ldg(a.probed + (size_t)b * a.ld + (g - b * a.nprobe));
}

// Lane x < kCells: cell g0 + x's query row (its residual row without
// centroids) in qrow and its centroid row in crow, p being the partition
// it probes: qrow -1 past G, crow -1 without centroids and -2 for a
// partition outside [0, P).
__device__ __forceinline__ void cell_rows(const Args& a, int g0, int lane,
                                          int64_t p, int& qrow, int& crow) {
  const int g = g0 + lane;
  qrow = crow = -1;
  if (lane < kCells && g < a.G) {
    if (a.cent == nullptr) {
      qrow = g;
    } else {
      qrow = g / a.nprobe;
      crow = (p < 0 || p >= a.P) ? -2 : (int)p;
    }
  }
}

// The residual tile t of cells g0..g0+kCells-1 in division d, staged by
// one warp for itself: rs[cell][sp] = (q - cent)[d, t*ST + sp], 0 outside
// the cells, D and sub, NaN for a partition outside the contract. A lane
// takes four consecutive s at once where the rows allow 16-byte loads
// (a.vec_in), else one; the rows come from the lanes below kCells.
__device__ __forceinline__ void stage_residuals(const Args& a, float* rs,
                                                int g0, int d, int t,
                                                int lane, int64_t p) {
  int qrow, crow;
  cell_rows(a, g0, lane, p, qrow, crow);
  const size_t M = (size_t)a.D * a.sub;
  const int w = a.vec_in ? 4 : 1;  // s a lane loads at once
  const int per = a.ST / w;        // loads a cell
  const int n = kCells * per;
  for (int r = 0; 32 * r < n; ++r) {
    const int e = 32 * r + lane;
    const int cell = min(e / per, kCells - 1);
    const int qo = __shfl_sync(0xffffffffu, qrow, cell);
    const int co = __shfl_sync(0xffffffffu, crow, cell);
    if (e >= n) continue;
    const int s = t * a.ST + w * (e - cell * per);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qo >= 0 && d < a.D && s < a.sub) {
      const size_t m = (size_t)d * a.sub + s;
      if (w == 4) {
        v = __ldg(reinterpret_cast<const float4*>(a.q + qo * M + m));
        if (co >= 0) {
          const float4 c =
              __ldg(reinterpret_cast<const float4*>(a.cent + co * M + m));
          v = make_float4(v.x - c.x, v.y - c.y, v.z - c.z, v.w - c.w);
        }
      } else {
        v.x = __ldg(a.q + qo * M + m);
        if (co >= 0) v.x -= __ldg(a.cent + co * M + m);
      }
      if (co == -2) v.x = v.y = v.z = v.w = __int_as_float(0x7fc00000);
    }
    if (w == 4) {
      *reinterpret_cast<float4*>(rs + 4 * e) = v;
    } else {
      rs[e] = v.x;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    probed_tables_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  float* cbs = smem;  // DB * 4QB * ST
  // This warp's residuals, kCells * ST (a warp lies in one division).
  float* rs = smem + (size_t)a.DB * 4 * a.QB * a.ST +
              (size_t)(threadIdx.x >> 5) * kCells * a.ST;

  const int ql = threadIdx.x % a.QB;
  const int dl = threadIdx.x / a.QB;
  const int d0 = blockIdx.y * a.DB;
  const int q0 = blockIdx.z * a.QB;
  const int d = d0 + dl;
  const int c0 = 4 * (q0 + ql);
  const bool active = d < a.D && c0 < a.C;
  const int steps = a.ST >> 2;
  const float* cbt = cbs + (size_t)dl * steps * 16 * a.QB + 4 * ql;

  const int first = blockIdx.x * a.cpb;
  const int last = min(first + a.cpb, a.G);
  // Each group's probes are read a group ahead, so the residual loads wait
  // for one read and not two.
  int64_t next = probe_of(a, first, lane);
  for (int g0 = first; g0 < last; g0 += kCells) {
    const int64_t p = next;
    next = probe_of(a, g0 + kCells, lane);
    float acc[kCells][4];
#pragma unroll
    for (int x = 0; x < kCells; ++x) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[x][i] = 0.f;
    }
    for (int t = 0; t < a.tiles; ++t) {
      if (a.tiles > 1 || g0 == first) {
        __syncthreads();  // the last tile's readers are done
        stage_codebook(a, cbs, d0, q0, t);
        __syncthreads();
      }
      __syncwarp();  // this warp's readers of the last residuals are done
      stage_residuals(a, rs, g0, d, t, lane, p);
      __syncwarp();
      for (int k = 0; k < steps; ++k) {
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = *reinterpret_cast<const float4*>(cbt +
                                                  (k * 4 + i) * 4 * a.QB);
        }
#pragma unroll
        for (int x = 0; x < kCells; ++x) {
          const float4 r =
              *reinterpret_cast<const float4*>(rs + x * a.ST + 4 * k);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float e = r.x - w[i].x;
            acc[x][i] = fmaf(e, e, acc[x][i]);
            e = r.y - w[i].y;
            acc[x][i] = fmaf(e, e, acc[x][i]);
            e = r.z - w[i].z;
            acc[x][i] = fmaf(e, e, acc[x][i]);
            e = r.w - w[i].w;
            acc[x][i] = fmaf(e, e, acc[x][i]);
          }
        }
      }
    }
    // Streaming stores: the tables are read once, by the scan, and should
    // not push the query and centroid rows out of L2.
    if (active) {
#pragma unroll
      for (int x = 0; x < kCells; ++x) {
        const int g = g0 + x;
        if (g >= last) break;
        float* o = a.out + ((size_t)g * a.D + d) * a.C + c0;
        if (a.vec) {
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (c0 + i < a.C) __stcs(o + i, acc[x][i]);
          }
        }
      }
    }
  }
}

// Per-device values read once: the SM count and the blocks an SM holds at
// the largest shared-memory size (0 until read), and whether the kernel's
// shared-memory maximum is raised.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];
std::atomic<bool> g_smem_raised[kMaxDevices];

}  // namespace

// q [B, M] f32 (or [G, M] residuals with cent null), cent [P, M] f32,
// probed [B, nprobe] int64 with rows ld apart (unread with cent null), cb
// [D, C, sub] f32, out [G, D, C] f32 with G = B*nprobe, on the current
// device (the caller selects it). Returns a cudaError_t.
extern "C" int fdb_probed_tables(const void* q, const void* cent,
                                 const void* probed, const void* cb,
                                 void* out, int G, int nprobe, int ld, int P,
                                 int D, int C, int sub, void* stream) {
  if (G <= 0 || nprobe <= 0 || D <= 0 || C <= 0 || sub <= 0) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.q = static_cast<const float*>(q);
  a.cent = static_cast<const float*>(cent);
  a.probed = static_cast<const int64_t*>(probed);
  a.cb = static_cast<const float*>(cb);
  a.out = static_cast<float*>(out);
  a.G = G;
  a.nprobe = nprobe;
  a.ld = ld;
  a.P = P;
  a.D = D;
  a.C = C;
  a.sub = sub;
  // Quads of codewords a division: a multiple of 32, at most 256; the
  // divisions a block fill its kThreads threads.
  const int cq = (C + 3) / 4;
  a.QB = min((cq + 31) / 32 * 32, kThreads);
  a.DB = min(kThreads / a.QB, D);
  const int threads = a.QB * a.DB;
  const int sub4 = (sub + 3) / 4 * 4;
  a.ST = min(sub4, max(4, kCbFloats / (4 * threads) / 4 * 4));
  a.tiles = (sub + a.ST - 1) / a.ST;
  a.vec = C % 4 == 0 && (uintptr_t)out % 16 == 0;
  a.vec_in = sub % 4 == 0 && (uintptr_t)q % 16 == 0 &&
             (uintptr_t)cent % 16 == 0 && (uintptr_t)cb % 16 == 0;
  const size_t smem =
      ((size_t)4 * threads * a.ST + (size_t)kCells * (threads / 32) * a.ST) *
      sizeof(float);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem &&
      !g_smem_raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(probed_tables_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    g_smem_raised[dev].store(true, std::memory_order_relaxed);
  }
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probed_tables_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;

  // One wave: the resident blocks over bands and quad chunks, then the
  // cells split evenly over what is left, kCells at a time.
  const int bands = (D + a.DB - 1) / a.DB;
  const int chunks = (cq + a.QB - 1) / a.QB;
  const long long cols = (long long)bands * chunks;
  const long long groups = (G + kCells - 1) / kCells;
  long long x = (long long)per_sm * sms / cols;
  x = x < 1 ? 1 : (x > groups ? groups : x);
  a.cpb = (int)((groups + x - 1) / x) * kCells;
  x = (G + a.cpb - 1) / a.cpb;
  if (bands > 65535 || chunks > 65535 || x > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)x, (unsigned)bands, (unsigned)chunks);
  probed_tables_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
