// Warp-level tensor-core helpers shared by csrc/gallery_match.cu and
// csrc/fused_match.cu: 16-byte cp.async staging, ldmatrix, the TF32
// m16n8k8 mma.sync, the hi/lo TF32 split of 3xTF32, and the
// first-occurrence comparison of an argmax.  ops/_build.py keys each
// library by this header too, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// c += a * b on one m16n8 tile of TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo + (about 2^-22 |x|), with hi = rna(x) and lo = rna(x - hi),
// where rna rounds a float32 to TF32 (10 explicit mantissa bits) to
// nearest with ties away from zero, as cvt.rna.tf32.f32 does, and clears
// the 13 low bits, so x - hi is exact.  It is done on the bits: adding
// half a TF32 ulp to the magnitude carries into the kept bits exactly
// when rna rounds up.  The same value as the conversion for every finite
// x, and 15% faster for the whole float32 gallery kernel on an H100 (the
// conversion issues at a fraction of the integer rate).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// (v, i) beats (best_v, best_i) when larger, or equal at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

}  // namespace
