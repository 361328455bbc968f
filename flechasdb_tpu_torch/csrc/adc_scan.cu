// K-A: ADC bucket scan for Hopper (sm_90a).
//
// Replaces three TPU kernels of flechasdb_tpu/ops/pallas_scan.py that
// compute one function: `_indexed_kernel` (reached by
// `adc_lookup_indexed(pipeline="blocked")`, the route the D=12 headline
// takes), `_pipe_kernel` (the same contract with a fused length mask and a
// dead-tile skip) and `_lookup_kernel` (`adc_lookup`: pre-gathered codes,
// run here with the identity bucket index and no lengths). For every
// gather cell g,
//
//     out[g, l] = sum_d ftab[g, d*C + code(bcodes[bidx[g]], d, l)]
//
// summed in ascending d, and +inf for l >= lengths[g].
//
// What bounds it on the H100: bytes. Per cell it reads one bucket's live
// codes (rows x L int32), one D x C f32 table, and writes L floats; the
// arithmetic is D adds a live slot. At the SIFT path's shape the [G, L]
// output (mostly +inf padding) is two thirds of the bytes.
//
// What the first design lost, and what this one does about it:
// - It staged the whole table in shared memory, so a table over 227 KB
//   (D=256, C=256, or D=64, C=1024) could not launch at all. Here the
//   table walks through shared memory in chunks of divisions (at most
//   32 KB, or 8 code rows), two chunk buffers filled by 16-byte cp.async,
//   the next chunk in flight while the current one is summed; each slot's
//   partial sums stay in registers across chunks.
// - It copied the table with scalar loads, waited on __syncthreads, and
//   only then issued its first code load: two global-memory latencies in
//   a row. Here each thread issues its code loads for a chunk (one 16-byte
//   int4 load a row, four slots along L) right after the table copy is
//   issued and before waiting on it, and loads the next chunk's codes
//   before summing the current one.
// - Its slot loop had a break and a continue in its body and a byte loop
//   with a runtime trip count, so loads of different slots did not
//   overlap. Here a thread owns four adjacent slots with no early exit;
//   the row and byte loops unroll at compile time (packed codes: two or
//   three words, the D=8 and D=12 paths, or up to eight; unpacked: up to
//   eight rows), with runtime predicates for a ragged last chunk.
// - One block per 2048-slot tile gave the headline (G=320, L=1152) 320
//   blocks with 4.5 slots a thread. Here a block is one cell and one
//   L-tile of 4 x threads slots: the host picks the tiles a cell and the
//   threads a block (a multiple of 32, at most 256) from G, L and the SM
//   count so that there are at least four blocks an SM where the work
//   allows it (the headline: 640 blocks of 160 threads on 132 SMs). A
//   block handles one cell: with several blocks an SM resident, their
//   single load round trips overlap, where a block walking many cells
//   would chain the lengths reads of dead tiles.
// - cudaFuncSetAttribute ran on every launch over 48 KB. The entry point
//   now reads the SM count once a device and raises each instance's
//   shared-memory maximum once a device, to the 227 KB a block may hold.
// Kept: the fused length mask, and the dead-tile skip (a tile wholly past
// lengths[g] loads no table and no codes and writes +inf); groups past the
// fill count load no codes, and pad slots' codes are zeroed so that they
// index the table in range.
// Table re-reads: each live L-tile of a cell stages that cell's table, so
// a table is read from L2 once per live tile (the headline: 2 tiles a
// cell; the SIFT path: 1024-slot tiles, 1 or 2 live a cell). The bound
// counts it once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"  // cp.async helpers

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSlots = 4;                 // slots a thread: one int4 a row
constexpr int kChunkBytes = 32 * 1024;    // a table chunk, at most
constexpr int kMaxRows = 8;               // code rows a chunk, at most
constexpr int kBlocksPerSM = 4;           // the grid's target, work allowing
constexpr size_t kMaxSmem = 232448;       // 227 KB: a block's opt-in maximum
constexpr size_t kDefaultSmem = 48 * 1024;

struct ScanArgs {
  const int32_t* codes;    // [P, rows, L]
  const float* ftab;       // [G, D*C]
  const int32_t* bidx;     // [G]
  const int32_t* lengths;  // [G] or null
  float* out;              // [G, L]
  int L, D, C, rows;
  int tiles;     // L-tiles a cell
  int kd;        // divisions a table chunk
  int chunks;    // chunks a table
  int vec;       // int4 code loads and float4 stores (L % 4 == 0, aligned)
  int tab16;     // 16-byte table copies (C % 4 == 0, aligned)
};

// Copies divisions [k*kd, k*kd + kd) of cell g's table into dst.
__device__ __forceinline__ void stage_table(const ScanArgs& a, int g, int k,
                                            float* dst) {
  const int d0 = k * a.kd;
  const int n = min(a.kd, a.D - d0) * a.C;
  const float* src = a.ftab + ((size_t)g * a.D + d0) * a.C;
  if (a.tab16) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
      cp_async<16>(dst + i, src + i, true);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      cp_async<4>(dst + i, src + i, true);
    }
  }
}

// The code rows of chunk k for slots l .. l+3 of bucket `bucket`; zeros
// for slots at or past len (pad slots) and for rows past the chunk.
template <int kRows, bool kPacked>
__device__ __forceinline__ void load_codes(const ScanArgs& a, int bucket,
                                           int k, int l, int len,
                                           int4 (&c)[kRows]) {
  const int d0 = k * a.kd;
  const int nd = min(a.kd, a.D - d0);
  const int r0 = kPacked ? d0 / 4 : d0;
  const int nr = kPacked ? (nd + 3) / 4 : nd;
  const bool live = l < len;
  const int32_t* base = a.codes + ((size_t)bucket * a.rows + r0) * a.L + l;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int4 v = make_int4(0, 0, 0, 0);
    if (live && r < nr) {
      const int32_t* p = base + (size_t)r * a.L;
      if (a.vec) {
        v = __ldg(reinterpret_cast<const int4*>(p));
      } else {
        v.x = __ldg(p);
        if (l + 1 < a.L) v.y = __ldg(p + 1);
        if (l + 2 < a.L) v.z = __ldg(p + 2);
        if (l + 3 < a.L) v.w = __ldg(p + 3);
      }
    }
    c[r] = v;
  }
  if (live && l + kSlots > len) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (l + 1 >= len) c[r].y = 0;
      if (l + 2 >= len) c[r].z = 0;
      if (l + 3 >= len) c[r].w = 0;
    }
  }
}

// acc[i] += the chunk's table entries for slot i, in ascending d.
template <int kRows, bool kPacked>
__device__ __forceinline__ void accumulate(const ScanArgs& a, int k,
                                           const int4 (&c)[kRows],
                                           const float* tab,
                                           float (&acc)[kSlots]) {
  const int nd = min(a.kd, a.D - k * a.kd);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint32_t w[kSlots] = {(uint32_t)c[r].x, (uint32_t)c[r].y,
                                (uint32_t)c[r].z, (uint32_t)c[r].w};
    if constexpr (kPacked) {
      // Four byte codes a word, division 4r + b in byte b, read unsigned:
      // byte 3 holds the int32 sign bit.
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * r + b < nd) {
          const float* row = tab + (4 * r + b) * a.C;
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            acc[i] += row[(w[i] >> (8 * b)) & 0xFFu];
          }
        }
      }
    } else {
      if (r < nd) {
        const float* row = tab + r * a.C;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) acc[i] += row[w[i]];
      }
    }
  }
}

// Chunk k of a live tile: stages chunk k+1 and loads its codes into nxt
// (when there is one), waits for chunk k and sums it from cur.
template <int kRows, bool kPacked>
__device__ __forceinline__ void chunk_step(const ScanArgs& a, int g,
                                           int bucket, int k, int l, int len,
                                           float* smem,
                                           const int4 (&cur)[kRows],
                                           int4 (&nxt)[kRows],
                                           float (&acc)[kSlots]) {
  const int stride = a.kd * a.C;  // floats between the two chunk buffers
  const bool more = k + 1 < a.chunks;
  if (more) {
    stage_table(a, g, k + 1, smem + ((k + 1) & 1) * stride);
    load_codes<kRows, kPacked>(a, bucket, k + 1, l, len, nxt);
  }
  cp_async_commit();
  cp_async_wait<1>();  // chunk k has landed; chunk k+1 may be in flight
  __syncthreads();
  if (l < len) {
    accumulate<kRows, kPacked>(a, k, cur, smem + (k & 1) * stride, acc);
  }
  if (more) __syncthreads();  // chunk k's buffer is free for chunk k+2
}

// One block: cell g = blockIdx.x / tiles, slots [l0, l0 + 4 x threads).
template <int kRows, bool kPacked>
__global__ void __launch_bounds__(kMaxThreads)
adc_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x / a.tiles;
  const int l0 = (blockIdx.x - g * a.tiles) * kSlots * blockDim.x;
  const int l = l0 + kSlots * threadIdx.x;
  const int len =
      a.lengths != nullptr ? min(max(__ldg(a.lengths + g), 0), a.L) : a.L;
  float acc[kSlots] = {0.f, 0.f, 0.f, 0.f};

  if (l0 < len) {
    const int bucket = __ldg(a.bidx + g);
    int4 even[kRows], odd[kRows];  // codes of the even and odd chunks
    stage_table(a, g, 0, smem);
    cp_async_commit();
    load_codes<kRows, kPacked>(a, bucket, 0, l, len, even);
    for (int k = 0; k < a.chunks; k += 2) {
      chunk_step<kRows, kPacked>(a, g, bucket, k, l, len, smem, even, odd,
                                 acc);
      if (k + 1 < a.chunks) {
        chunk_step<kRows, kPacked>(a, g, bucket, k + 1, l, len, smem, odd,
                                   even, acc);
      }
    }
  }

  if (l >= a.L) return;
  float v[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) v[i] = l + i < len ? acc[i] : INFINITY;
  float* o = a.out + (size_t)g * a.L + l;
  if (a.vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (l + i < a.L) o[i] = v[i];
    }
  }
}

// Per-device values the entry point reads at every launch, each looked up
// once: the SM count (0 until read), and for each kernel instance whether
// its shared-memory maximum is raised. The maximum is one value a kernel,
// so it is raised once, to the most a block may opt into, and never
// lowered by a smaller table.
constexpr int kMaxDevices = 64;
constexpr int kInstances = 4;
std::atomic<int> g_sms[kMaxDevices];
std::atomic<bool> g_smem_raised[kMaxDevices][kInstances];

template <int kRows, bool kPacked>
cudaError_t launch(const ScanArgs& a, int blocks, int threads, size_t smem,
                   int dev, int instance, cudaStream_t stream) {
  auto* kernel = adc_scan_kernel<kRows, kPacked>;
  if (smem > kDefaultSmem &&
      !g_smem_raised[dev][instance].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    g_smem_raised[dev][instance].store(true, std::memory_order_relaxed);
  }
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// bcodes [P, rows, L] int32, ftab [G, D*C] f32, bidx [G] int32,
// lengths [G] int32 or null, out [G, L] f32, on the current device (the
// caller selects it). Returns a cudaError_t.
extern "C" int fdb_adc_scan(const void* bcodes, const void* ftab,
                            const void* bidx, const void* lengths, void* out,
                            int G, int rows, int L, int D, int C, int packed,
                            void* stream) {
  if (G <= 0 || L <= 0 || D <= 0 || C <= 0) return cudaErrorInvalidValue;
  // Divisions a chunk: at most kChunkBytes of table and kMaxRows code rows
  // (whole words when packed); the whole table when it fits.
  const int fit = kChunkBytes / (4 * C);
  int kd = packed ? min(4 * kMaxRows, max(4, fit / 4 * 4))
                  : min(kMaxRows, max(1, fit));
  kd = min(kd, D);
  const int chunks = (D + kd - 1) / kd;
  const size_t smem = (size_t)(chunks > 1 ? 2 : 1) * kd * C * sizeof(float);
  // Two chunks of the smallest size (one division, a word of four packed)
  // exceed shared memory only for C > 29056 (C > 7264 packed).
  if (smem > kMaxSmem) return cudaErrorInvalidValue;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }

  // L-tiles a cell and threads a block: the fewest tiles of at most 256
  // four-slot groups, split further (down to 32 groups a tile) until there
  // are kBlocksPerSM blocks an SM; threads a block rounded up to a warp.
  const int groups = (L + kSlots - 1) / kSlots;
  int tiles = (groups + kMaxThreads - 1) / kMaxThreads;
  while ((long long)G * tiles < (long long)kBlocksPerSM * sms &&
         (groups + tiles) / (tiles + 1) >= 32) {
    ++tiles;
  }
  const int threads = ((groups + tiles - 1) / tiles + 31) / 32 * 32;
  tiles = (groups + threads - 1) / threads;
  const long long blocks = (long long)G * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;

  ScanArgs a;
  a.codes = static_cast<const int32_t*>(bcodes);
  a.ftab = static_cast<const float*>(ftab);
  a.bidx = static_cast<const int32_t*>(bidx);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = static_cast<float*>(out);
  a.L = L;
  a.D = D;
  a.C = C;
  a.rows = rows;
  a.tiles = tiles;
  a.kd = kd;
  a.chunks = chunks;
  a.vec = L % 4 == 0 && (uintptr_t)bcodes % 16 == 0 &&
          (uintptr_t)out % 16 == 0;
  a.tab16 = C % 4 == 0 && (uintptr_t)ftab % 16 == 0;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = (int)blocks;
  const int rows_a_chunk = packed ? (kd + 3) / 4 : kd;
  if (!packed) return launch<kMaxRows, false>(a, n, threads, smem, dev, 0, s);
  if (rows_a_chunk <= 2) return launch<2, true>(a, n, threads, smem, dev, 1, s);
  if (rows_a_chunk == 3) return launch<3, true>(a, n, threads, smem, dev, 2, s);
  return launch<kMaxRows, true>(a, n, threads, smem, dev, 3, s);
}
