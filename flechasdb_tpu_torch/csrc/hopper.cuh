// Hopper (sm_90a) helpers shared by the kernels that stream tiles with the
// TMA: the mbarrier operations of a producer/consumer ring, the bulk and
// tensor copies that complete on them, and cuTensorMapEncodeTiled looked
// up through the CUDA runtime (the cluster-sum pass, cluster_sums.cu; K-B
// fast, lloyd_round_fast.cu; K-C fast, lloyd_grouped_fast.cu); then the
// bf16 A fragments of x and the norms' loads that K-B fast and K-C fast
// share.
// The definitions sit in an anonymous namespace, so each kernel's
// translation unit keeps its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // smem_addr

namespace {

// A ring slot's "full" barrier completes when its copies have landed
// (TMA copies count bytes, cp.async one arrival a lane); its "empty"
// barrier when every consumer is done with it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// bar: the barrier's shared-memory address.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_addr(bar));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// Waits until the phase of bar with this parity has completed. A fresh
// barrier is in phase 0, and the phase before it (parity 1) counts as
// completed, so a producer's first wait on an empty slot passes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_addr(bar), parity);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The box of the 2-D tensor map at (col, row), into dst; zeros past the
// tensor's edges (the whole box's bytes count on bar all the same).
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda); null where the installed CUDA lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// --- bf16 A fragments and norms for the Lloyd kernels' fast variants --------

constexpr int kBox = 64 * 128;  // bytes of a TMA box: 64 rows of 128 bytes

// A band of 64 rows as A fragments, rounded to bf16 once: KS k16 steps
// from KS / 2 boxes of 64 rows x 32 floats, each row 128 bytes whose
// 16-byte unit u sits at u ^ (row % 8) (the TMA's 128-byte swizzle).
// Register e of step s holds row 16 w4 + g + 8 (e & 1), columns 16 s + 2 t
// + 8 (e >> 1) and the next, the lower column in the low half.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4],
                                       const unsigned char* band, int w4,
                                       int g, int t) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w4 + g + 8 * (e & 1);
      const int col = 16 * (s % 2) + 2 * t + 8 * (e >> 1);  // in box s / 2
      const int unit = (col >> 2) ^ (row & 7);
      const float2 v = *reinterpret_cast<const float2*>(
          band + (s / 2) * kBox + row * 128 + unit * 16 + (col & 3) * 4);
      a[s][e] = pack_bf16(v.x, v.y);
    }
  }
}

// The 16 |c|^2 of this thread's columns of a 64-centroid tile, 8 j + 2 t +
// h, loaded before the wait for the tile's products so that their latency
// hides behind it.
__device__ __forceinline__ void load_cc(float2 (&ck)[8],
                                        const float* __restrict__ cct,
                                        int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ck[j] = __ldg(reinterpret_cast<const float2*>(cct + 8 * j + 2 * t));
  }
}

}  // namespace
