// Device helpers shared by the Lloyd-round kernels K-B (lloyd_round.cu) and
// K-C (lloyd_grouped.cu): cp.async copies, the tf32 split and the m16n8k8
// tf32 MMA. Both kernels split and multiply with these same functions, in
// the same order, which is what makes their distances equal bit for bit.
// The definitions sit in an anonymous namespace, so each kernel's
// translation unit keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies BYTES (16 or 4) from global to shared memory without waiting;
// writes zeros instead when !in.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// v = hi + lo + e with |e| <= 2^-21 |v|, in three integer and float
// instructions. The tensor cores read a tf32 operand's 19 high bits and
// ignore the 13 low ones, so hi goes in as v's bits plus half a tf32 ulp
// (v rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds); its low bits are cleared only to form v - hi, exact in f32,
// which goes in as lo and is read truncated.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));
}

// d += a b: a 16 x 8 tf32 (row major), b 8 x 8 tf32 (column major), d
// 16 x 8 f32, in the PTX fragment layouts of m16n8k8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
