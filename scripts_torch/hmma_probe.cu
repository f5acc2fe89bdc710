// Peak rate of warp-level mma.sync on one card: every warp issues chains
// of independent m16n8k16 bf16 or m16n8k8 TF32 products into fp32
// accumulators, with nothing else in the loop.  It bounds what a kernel
// built on mma.sync (csrc/gallery_match.cu) can reach, below the dense
// wgmma peak that the data sheet quotes.  Built and timed by
// scripts_torch/gallery_sweep.py --probe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;  // independent accumulators per warp

template <bool kBf16>
__global__ void hmma_loop(float* out, int iters) {
  // 1.0 in each operand (bf16 pairs 0x3f80, TF32 0x3f800000).
  const uint32_t one = kBf16 ? 0x3f803f80u : 0x3f800000u;
  const uint32_t a0 = one, a1 = one, a2 = one, a3 = one, b0 = one, b1 = one;
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (kBf16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// TFLOP/s of `blocks` blocks of `threads` threads, each warp issuing
// iters * kChains products; bf16 nonzero for m16n8k16 bf16, else m16n8k8
// TF32.  out holds blocks * threads floats.  Returns a negative number
// when a CUDA call fails.
double hmma_probe_tflops(int bf16, int blocks, int threads, int iters, float* out) {
  cudaEvent_t start, stop;
  if (cudaEventCreate(&start) != cudaSuccess || cudaEventCreate(&stop) != cudaSuccess) return -1;
  auto launch = [&]() {
    if (bf16)
      hmma_loop<true><<<blocks, threads>>>(out, iters);
    else
      hmma_loop<false><<<blocks, threads>>>(out, iters);
  };
  launch();  // warm-up
  cudaEventRecord(start);
  launch();
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  if (cudaGetLastError() != cudaSuccess || ms <= 0.f) return -2;
  const double flop_per_mma = bf16 ? 2.0 * 16 * 8 * 16 : 2.0 * 16 * 8 * 8;
  const double mmas = (double)blocks * (threads / 32) * iters * kChains;
  return mmas * flop_per_mma / (ms * 1e-3) / 1e12;
}

}  // extern "C"
