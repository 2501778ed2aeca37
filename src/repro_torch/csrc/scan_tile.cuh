// Device functions shared by the scan's kernels (rwkv_scan.cu and
// rwkv_scan_bwd.cu): element loads, the 3xTF32 mma.sync products, and the
// mbarriers and TMA bulk copies that bring tiles ahead.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// --- TF32 tensor-core products ------------------------------------------

// x = hi + lo for 3xTF32: hi is x rounded to TF32 (to nearest, ties away
// from zero, by integer add and mask: finite inputs below FLT_MAX only),
// lo the exact remainder, whose bits past TF32's the tensor core drops:
// hi + lo then carries 22 of x's 24 bits.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void store_split(float* p, float x) {
  unsigned hi, lo;
  split(x, hi, lo);
  *reinterpret_cast<float2*>(p) =
      make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// d += a b, one m16n8k8 TF32 product (fragments as the PTX ISA lays them
// out: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (t, g), b1 (t + 4, g); d (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), with g = lane / 4 and t = lane % 4).
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: big += a_hi b_hi, small += a_hi b_lo + a_lo b_hi (a_lo b_lo is
// below fp32's last bit).
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const unsigned (&ah)[4],
                                     const unsigned (&al)[4], float2 b0,
                                     float2 b1) {
  const unsigned b0h = __float_as_uint(b0.x), b0l = __float_as_uint(b0.y);
  const unsigned b1h = __float_as_uint(b1.x), b1l = __float_as_uint(b1.y);
  mma(small, al, b0h, b1h);
  mma(small, ah, b0l, b1l);
  mma(big, ah, b0h, b1h);
}

// --- mbarriers and bulk copies --------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// `bytes` (a multiple of 16) from global to shared memory, completing on
// `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace
