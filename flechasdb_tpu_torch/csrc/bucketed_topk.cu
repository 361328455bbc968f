// The bucketed top-k for Hopper (sm_90a): each query's kk smallest ADC
// keys over the live slots of its probed buckets.
//
// Replaces no TPU kernel. The JAX package selects with XLA (`lax.top_k`
// over every slot, flechasdb_tpu/ops/bucketed.py), and the port first did
// the same with a stable sort of all [B, nprobe*L] keys. On the card that
// sort cost far more than the scan before it: most slots are padding that
// K-A writes as +inf, and the sort moves every key and an int64 index
// through several radix passes to keep kk of them. This kernel was added
// to select from the live slots alone.
//
// What it computes. vdist [G = B*nprobe, L] f32 holds K-A's keys, cell
// g = b*nprobe + j being query b's j-th probe; lengths[g] is the fill count
// of that cell's bucket. For each query it returns the first kk entries of
// torch.sort(vdist.reshape(B, nprobe*L), dim=1, stable=True), bit for bit:
// keys ascending, equal keys by the lower flat index j*L + slot (the
// lax.top_k rule), -0 equal to +0. Slots at or past lengths[g] count as +inf
// at their flat index and are never read. It writes the values (the input's
// own bits; +inf for a pad slot), the flat indices, and each entry's corpus
// row brows[bidx[g], slot].
//
// What bounds it on the H100: bytes. The live keys are read once (4 bytes
// each: 18.2M, 73 MB a batch at the Deep10M cell, 23% of the slots), then
// each cell's candidates are written and read back (8 bytes each, at most
// kk a tile). At 3.35 TB/s that is about 25 us a batch at Deep10M.
//
// What the design does about that bound:
// - Stage 1, one block a tile of kTile slots of one cell (the grid has
//   G * ceil(L / kTile) blocks, thousands at every serving shape). A tile
//   wholly past the cell's length returns at once; so long, sparse buckets
//   cost their live slots only. A live tile copies its live keys into
//   shared memory once, coalesced (float4 where aligned), as
//   order-preserving bits, and finds its kk smallest (key, slot) pairs by a
//   radix select over those bits in shared memory: 11-bit digits, a
//   2048-bin histogram a pass, stopping as soon as the bin that holds the
//   kk-th key holds exactly the keys still needed (typically after two
//   passes). Equal keys at the threshold are resolved by the slot bits, the
//   low bits of the same composite key. A tile with kk live keys or fewer
//   skips the select and copies them. The candidates go to a [G, tiles, C]
//   scratch (C = min(kk, kTile)), unordered.
// - Every member of a query's kk smallest is among its own tile's kk
//   smallest (the order within a tile is the global order restricted to
//   it), so stage 2 needs no more. Pad slots enter only where they can
//   win: a pad slot s >= kk has s entries of its own cell before it, so
//   only pad slots below kk exist, and only in tile 0 (kk <= kTile), which
//   writes them as +inf entries beside its live keys.
// - Stage 2, one block a query: the same radix select over the query's
//   candidates (read from L2; nprobe * C a query, 3,200 at Deep10M) by
//   (key, flat index), a bitonic sort of the kk winners in shared memory,
//   and the outputs, rows included, so the index arithmetic the sort's
//   route needs (a gather, a division, a modulo and an index) launches
//   nothing more. Values are read back from vdist at the winners' slots, so
//   a -0 stays -0.
// kk is at most kMaxK (1024): stage 2 sorts its winners in one block. The
// wrapper routes a larger kk to the stable sort. Flat indices are 32-bit,
// so nprobe * L is at most 2^32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;       // slots a stage-1 block
constexpr int kTileBits = 12;     // log2(kTile)
constexpr int kMaxK = 1024;       // the largest kk
constexpr int kBits = 11;         // a radix digit
constexpr int kBins = 1 << kBits;
constexpr int kThreads1 = 256;    // stage 1
constexpr int kThreads2 = 512;    // stage 2
constexpr uint32_t kInfOrder = 0xff800000u;  // order_bits(+inf)

typedef unsigned long long u64;

struct Args {
  const float* vdist;      // [G, L]
  const int32_t* lengths;  // [G]
  const int32_t* bidx;     // [G]
  const int32_t* brows;    // [P, L]
  u64* cand;               // [G, tiles, C]: (order bits << 32) | slot
  float* dist;             // [B, kk]
  int64_t* idx;            // [B, kk]
  int32_t* rows;           // [B, kk]
  int nprobe, L, kk, tiles, C;
  int flat_bits;           // bits of the largest flat index, nprobe*L - 1
  int vec;                 // float4 loads of vdist (L % 4 == 0, aligned)
};

// Float bits to unsigned bits of the same order, -0 as +0.
__device__ __forceinline__ uint32_t order_bits(uint32_t b) {
  if (b == 0x80000000u) b = 0;
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ u64 high(u64 k, int shift) {
  return shift >= 64 ? 0 : k >> shift;
}

__device__ __forceinline__ int cell_length(const Args& a, int g) {
  return min(max(__ldg(a.lengths + g), 0), a.L);
}

// Candidates tile t of a cell of length len gives: tile 0 its kk smallest
// slots, pad slots below kk included; a later tile its live slots' kk
// smallest, none when it lies wholly past len.
__device__ __forceinline__ int tile_count(const Args& a, int len, int t) {
  const int t0 = t * kTile;
  const int end = min(t0 + kTile, a.L);
  if (t == 0) return min(a.kk, end);
  const int live = min(len, end) - t0;
  return live > 0 ? min(a.kk, live) : 0;
}

struct Select {
  unsigned int hist[kBins];
  int warp_sums[32];
  u64 prefix;  // the digits chosen so far
  int shift;   // bits below them
  int need;    // keys still to take among those that match prefix
  int stop;
  int count;   // winners written
};

// Exclusive prefix sum over the block; every thread calls it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < warps) warp_sums[lane] = w;
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + incl - v;
}

// Block-wide radix select of the kk smallest of n distinct keys of `width`
// bits (item i's key from key(i, &k), false for an item that is none). On
// return, item i is among them iff high(k, s.shift) <= s.prefix, and
// s.count is 0. Needs n' >= kk items, n' those key() accepts.
template <class Key>
__device__ void radix_select(const Key& key, int n, int kk, int width,
                             Select& s) {
  if (threadIdx.x == 0) {
    s.prefix = 0;
    s.shift = width;
    s.need = kk;
    s.stop = 0;
    s.count = 0;
  }
  const int per = kBins / blockDim.x;  // bins a thread scans
  for (;;) {
    __syncthreads();
    const int shift = s.shift;
    if (s.stop || shift == 0) break;
    const int bits = min(kBits, shift);
    const int low = shift - bits;
    const u64 prefix = s.prefix;
    const int need = s.need;
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) s.hist[i] = 0;
    __syncthreads();
    const u64 mask = (1ull << bits) - 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      u64 k;
      if (key(i, k) && high(k, shift) == prefix) {
        atomicAdd(&s.hist[(k >> low) & mask], 1u);
      }
    }
    __syncthreads();
    const int b0 = threadIdx.x * per;
    int local = 0;
    for (int q = 0; q < per; ++q) local += s.hist[b0 + q];
    int below = block_exclusive_sum(local, s.warp_sums);
    if (below < need && need <= below + local) {
      for (int q = 0; q < per; ++q) {
        const int c = s.hist[b0 + q];
        if (below + c >= need) {
          s.prefix = (prefix << bits) | (u64)(b0 + q);
          s.shift = low;
          s.need = need - below;
          s.stop = c == need - below;
          break;
        }
        below += c;
      }
    }
  }
}

// Stage 1: block = (cell g, tile t).
__global__ void __launch_bounds__(kThreads1)
topk_cells_kernel(const Args a) {
  __shared__ __align__(16) uint32_t keys[kTile];
  __shared__ Select s;
  const int g = blockIdx.x / a.tiles;
  const int t = blockIdx.x - g * a.tiles;
  const int len = cell_length(a, g);
  const int cnt = tile_count(a, len, t);
  if (cnt == 0) return;
  const int t0 = t * kTile;
  const int live = max(0, min(len, min(t0 + kTile, a.L)) - t0);
  const float* src = a.vdist + (size_t)g * a.L + t0;
  u64* out = a.cand + ((size_t)g * a.tiles + t) * a.C;

  if (live <= a.kk) {  // every live key, then tile 0's pad slots
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const uint32_t u =
          i < live ? order_bits(__float_as_uint(__ldg(src + i))) : kInfOrder;
      out[i] = ((u64)u << 32) | (uint32_t)(t0 + i);
    }
    return;
  }

  int i0 = 0;
  if (a.vec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    uint4* keys4 = reinterpret_cast<uint4*>(keys);
    for (int i = threadIdx.x; i < live / 4; i += blockDim.x) {
      const float4 v = __ldg(src4 + i);
      keys4[i] = make_uint4(
          order_bits(__float_as_uint(v.x)), order_bits(__float_as_uint(v.y)),
          order_bits(__float_as_uint(v.z)), order_bits(__float_as_uint(v.w)));
    }
    i0 = live / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < live; i += blockDim.x) {
    keys[i] = order_bits(__float_as_uint(__ldg(src + i)));
  }
  // (radix_select's first barrier orders these stores before any read.)

  const auto key = [=](int i, u64& k) {
    k = ((u64)keys[i] << kTileBits) | (u64)i;
    return true;
  };
  radix_select(key, live, a.kk, 32 + kTileBits, s);
  const int shift = s.shift;
  const u64 prefix = s.prefix;
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    u64 k;
    key(i, k);
    if (high(k, shift) <= prefix) {
      const int pos = atomicAdd(&s.count, 1);
      if (pos < a.kk) out[pos] = ((u64)keys[i] << 32) | (uint32_t)(t0 + i);
    }
  }
}

// Stage 2: block = query b.
__global__ void __launch_bounds__(kThreads2)
topk_merge_kernel(const Args a) {
  __shared__ Select s;
  __shared__ u64 win[kMaxK];
  const int b = blockIdx.x;
  const size_t g0 = (size_t)b * a.nprobe;
  const int per_cell = a.tiles * a.C;
  const int n = a.nprobe * per_cell;
  const u64* cand = a.cand + g0 * per_cell;
  const u64 flat_mask = (1ull << a.flat_bits) - 1;

  const auto key = [=](int p, u64& k) {
    const int j = p / per_cell;
    const int r = p - j * per_cell;
    const int t = r / a.C;
    if (r - t * a.C >= tile_count(a, cell_length(a, (int)g0 + j), t)) {
      return false;
    }
    const u64 e = __ldg(cand + p);
    const u64 flat = (u64)j * a.L + (e & 0xffffffffull);
    k = ((e >> 32) << a.flat_bits) | flat;
    return true;
  };
  radix_select(key, n, a.kk, 32 + a.flat_bits, s);
  const int shift = s.shift;
  const u64 prefix = s.prefix;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    u64 k;
    if (key(p, k) && high(k, shift) <= prefix) {
      const int pos = atomicAdd(&s.count, 1);
      if (pos < a.kk) win[pos] = k;
    }
  }
  int n2 = 1;
  while (n2 < a.kk) n2 <<= 1;
  for (int i = a.kk + threadIdx.x; i < n2; i += blockDim.x) win[i] = ~0ull;

  // Bitonic sort of win[0, n2), ascending.
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 x = win[lo], y = win[hi];
        if ((x > y) == ((lo & size) == 0)) {
          win[lo] = y;
          win[hi] = x;
        }
      }
    }
  }
  __syncthreads();

  for (int r = threadIdx.x; r < a.kk; r += blockDim.x) {
    const u64 flat = win[r] & flat_mask;
    const int j = (int)(flat / (u64)a.L);
    const int slot = (int)(flat - (u64)j * a.L);
    const size_t g = g0 + j;
    const size_t o = (size_t)b * a.kk + r;
    a.dist[o] = slot < cell_length(a, (int)g) ? __ldg(a.vdist + g * a.L + slot)
                                              : INFINITY;
    a.idx[o] = (int64_t)flat;
    a.rows[o] = __ldg(a.brows + (size_t)__ldg(a.bidx + g) * a.L + slot);
  }
}

int tiles_of(int L) { return (L + kTile - 1) / kTile; }

}  // namespace

// The scratch a call takes, in 8-byte entries.
extern "C" long long fdb_bucketed_topk_scratch(int G, int L, int kk) {
  return (long long)G * tiles_of(L) * (kk < kTile ? kk : kTile);
}

// vdist [B*nprobe, L] f32, lengths [B*nprobe] int32, bidx [B*nprobe] int32,
// brows [P, L] int32; cand the scratch fdb_bucketed_topk_scratch gives ->
// dist [B, kk] f32, idx [B, kk] int64, rows [B, kk] int32. All on the
// current device, on `stream`. Returns a cudaError_t.
extern "C" int fdb_bucketed_topk(const void* vdist, const void* lengths,
                                 const void* bidx, const void* brows,
                                 void* cand, void* dist, void* idx,
                                 void* rows, int B, int nprobe, int L, int kk,
                                 void* stream) {
  if (B <= 0 || nprobe <= 0 || L <= 0 || kk <= 0 || kk > kMaxK) {
    return cudaErrorInvalidValue;
  }
  const long long slots = (long long)nprobe * L;
  if (kk > slots || slots > (1ll << 32)) return cudaErrorInvalidValue;
  const int tiles = tiles_of(L);
  const long long blocks = (long long)B * nprobe * tiles;
  const long long per_query = (long long)nprobe * tiles * kk;
  if (blocks > 0x7fffffffLL || per_query > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.vdist = static_cast<const float*>(vdist);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.bidx = static_cast<const int32_t*>(bidx);
  a.brows = static_cast<const int32_t*>(brows);
  a.cand = static_cast<u64*>(cand);
  a.dist = static_cast<float*>(dist);
  a.idx = static_cast<int64_t*>(idx);
  a.rows = static_cast<int32_t*>(rows);
  a.nprobe = nprobe;
  a.L = L;
  a.kk = kk;
  a.tiles = tiles;
  a.C = kk < kTile ? kk : kTile;
  int bits = 1;
  while (bits < 32 && ((slots - 1) >> bits) != 0) ++bits;
  a.flat_bits = bits;
  a.vec = L % 4 == 0 && (uintptr_t)vdist % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_cells_kernel<<<(int)blocks, kThreads1, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<B, kThreads2, 0, s>>>(a);
  return cudaGetLastError();
}
