// Fused projection-and-match for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   face_detection_recognization_pca_tpu/ops/pallas_kernels.py::_match_kernel
// (launched by fused_match_pallas).  Per crop b it computes
//   feats  = crops[b] @ m + bias                       (fp32 FMAs)
//   cos[n] = feats . gallery_t[:, n] / (|feats| * gnorm[n]), 0 where that
//            denominator is <= 0, plus mask[n] (mask may be null = all 0)
//   ids[b] = first-occurrence argmax of cos, conf[b] = its max.
//
// What bounds it at the tracker's shapes (B = 64 crops, D = 96*96 = 9216,
// k = 64, N = 256): the projection is 75.5 MFLOP over 2.4 MB of crops and
// 2.4 MB of m, a few microseconds of fp32 FMA or HBM time, so what limits
// it is how many SMs share the work and how well they hide latency.  One
// block per crop would make every block read all of m through one SM.
// Instead:
//   1. project_partial: a (B/8) x (D/d_split) grid.  Each block stages a
//      32-row slice of m and the matching 8 crop columns in shared memory
//      and accumulates an (8 x k) partial product in registers.  Partials
//      go to a scratch (splits, B, k) buffer that the wrapper allocates.
//   2. match_epilogue: one block per crop sums the partials in a fixed
//      order (so results do not change from run to run), adds the bias,
//      takes the norm by a tree reduction, scores the N gallery columns
//      (coalesced reads of gallery_t) and reduces (value, index) pairs
//      with ties going to the lower index.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit) with torch.profiler:
// at d_split 512 (18 splits, ~1 block per SM, 16 serial staging rounds)
// phase 1 took 41 us; at d_split 128 (72 splits, 576 blocks, several per
// SM) 21 us, with the epilogue at 10 us.  Below that phase 1 stays near
// 19 us: it is then bound by its two shared-memory loads per FMA and by
// re-reading m once per 8-crop tile.  Register blocking (each thread an
// outer product of crop and feature fragments) is the next step.
// The Pallas kernel's sequential K grid axis becomes the split loop plus
// the epilogue's fixed-order sum; ragged B and D edges are masked here,
// so nothing is padded.  No tensor cores and no TF32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 8;   // crops per projection block
constexpr int kTileD = 32;  // rows of m staged per step
constexpr int kMaxK = 256;
constexpr int kOutPerThread = kTileB * kMaxK / kThreads;
static_assert(kTileB * kTileD == kThreads, "one staged crop value per thread");

__global__ void __launch_bounds__(kThreads)
project_partial(const float* __restrict__ crops, const float* __restrict__ m,
                float* __restrict__ partial, int B, int D, int K, int d_split) {
  __shared__ float cs[kTileB][kTileD];
  __shared__ float ms[kTileD][kMaxK];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kTileB;
  const int split = blockIdx.y;
  const int d_begin = split * d_split;
  const int d_end = min(D, d_begin + d_split);

  float acc[kOutPerThread];
#pragma unroll
  for (int r = 0; r < kOutPerThread; ++r) acc[r] = 0.f;

  for (int d0 = d_begin; d0 < d_end; d0 += kTileD) {
    {
      const int b = tid / kTileD, dd = tid % kTileD;
      const int gb = b0 + b, gd = d0 + dd;
      cs[b][dd] = (gb < B && gd < d_end) ? crops[(size_t)gb * D + gd] : 0.f;
    }
    for (int e = tid; e < kTileD * K; e += kThreads) {
      const int dd = e / K, j = e % K;
      const int gd = d0 + dd;
      ms[dd][j] = gd < d_end ? m[(size_t)gd * K + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kOutPerThread; ++r) {
      const int o = tid + r * kThreads;
      if (o < kTileB * K) {
        const int b = o / K, j = o % K;
        float a = acc[r];
#pragma unroll 8
        for (int dd = 0; dd < kTileD; ++dd) a = fmaf(cs[b][dd], ms[dd][j], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kOutPerThread; ++r) {
    const int o = tid + r * kThreads;
    if (o < kTileB * K) {
      const int b = o / K, j = o % K;
      if (b0 + b < B) partial[((size_t)split * B + b0 + b) * K + j] = acc[r];
    }
  }
}

// (v, i) beats (best_v, best_i) when larger, or equal at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

__global__ void __launch_bounds__(kThreads)
match_epilogue(const float* __restrict__ partial, int n_split,
               const float* __restrict__ bias,
               const float* __restrict__ gallery_t,
               const float* __restrict__ gnorm,
               const float* __restrict__ mask, int B, int K, int N,
               int* __restrict__ ids, float* __restrict__ conf) {
  __shared__ float feats[kMaxK];
  __shared__ float red_v[kThreads];
  __shared__ int red_i[kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int j = tid; j < K; j += kThreads) {
    float f = 0.f;
    for (int s = 0; s < n_split; ++s) f += partial[((size_t)s * B + b) * K + j];
    feats[j] = f + bias[j];
  }
  __syncthreads();

  float sq = 0.f;
  for (int j = tid; j < K; j += kThreads) sq = fmaf(feats[j], feats[j], sq);
  red_v[tid] = sq;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red_v[tid] += red_v[tid + w];
    __syncthreads();
  }
  const float fnorm = sqrtf(red_v[0]);
  __syncthreads();  // red_v is reused below

  // Each thread walks its columns in ascending order; its initial index N
  // loses every tie, so even an all -inf row reports the first column.
  float best = -INFINITY;
  int best_i = N;
  for (int n = tid; n < N; n += kThreads) {
    float dot = 0.f;
    for (int j = 0; j < K; ++j) dot = fmaf(feats[j], gallery_t[(size_t)j * N + n], dot);
    const float denom = fnorm * gnorm[n];
    float c = denom > 0.f ? dot / denom : 0.f;
    if (mask != nullptr) c += mask[n];
    if (beats(c, n, best, best_i)) {
      best = c;
      best_i = n;
    }
  }
  red_v[tid] = best;
  red_i[tid] = best_i;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w && beats(red_v[tid + w], red_i[tid + w], red_v[tid], red_i[tid])) {
      red_v[tid] = red_v[tid + w];
      red_i[tid] = red_i[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    ids[b] = red_i[0];
    conf[b] = red_v[0];
  }
}

}  // namespace

extern "C" {

// K must lie in [1, kMaxK]; the wrapper checks it.  partial is scratch of
// ceil(D / d_split) * B * K floats.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int fused_match_launch(const float* crops, const float* m, const float* bias,
                       const float* gallery_t, const float* gnorm,
                       const float* mask, float* partial, int* ids,
                       float* conf, int B, int D, int K, int N, int d_split,
                       cudaStream_t stream) {
  const int n_split = (D + d_split - 1) / d_split;
  const dim3 grid((B + kTileB - 1) / kTileB, n_split);
  project_partial<<<grid, kThreads, 0, stream>>>(crops, m, partial, B, D, K, d_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  match_epilogue<<<B, kThreads, 0, stream>>>(partial, n_split, bias, gallery_t, gnorm,
                                              mask, B, K, N, ids, conf);
  return (int)cudaGetLastError();
}

const char* fused_match_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
