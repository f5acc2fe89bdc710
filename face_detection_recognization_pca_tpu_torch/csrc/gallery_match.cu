// Streaming cosine argmax against a large gallery, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   face_detection_recognization_pca_tpu/ops/pallas_kernels.py:232
//   _gallery_match_kernel (launched by gallery_match_pallas)
// and computes what it computes.  For feature row b and gallery row n:
//   cos[b, n] = dot(feats[b], gallery[n]) * frinv[b] * grinv[n] + gmask[n]
//   grinv[n]  = 1 / gnorm[n] where gnorm[n] > 0, else 0
//   gmask[n]  = -inf where gnorm[n] < 0 (the sentinel of an invalid row),
//               else 0
//   idx[b] = first-occurrence argmax of cos[b, :], best[b] = its max.
// frinv (1 / |feats[b]|, 0 for a zero-norm feature) comes from the
// wrapper, which takes it from the caller's float32 features before any
// rounding to bf16, as the Pallas wrapper does.
//
// What bounds it at the JAX target shape (B 1024, k 128, N 131072): the
// products are 2 B k N = 34.4 GFLOP of fp32 FMAs over 67 MB of gallery,
// about 512 FLOP per byte.  The H100's fp32 FMA rate (67 TFLOP/s, about
// 0.51 ms here) bounds it, not HBM (67 MB at 3.35 TB/s is 20 us).  So the
// design keeps the FMA pipes fed from registers and shared memory, and
// reads the gallery from HBM about once:
//   1. gallery_match_tiles: one 256-thread block per (64-row B tile,
//      128-row N tile).  The block index runs over B tiles first, so
//      the B/64 blocks that read one gallery tile are scheduled together
//      and share it through the 50 MB L2: the Hopper form of the
//      one-batch-tile lesson in pallas_kernels.py:288-293.  k is walked
//      in chunks of 32 staged in shared memory, with the next chunk
//      loaded into registers while this one is used.  Each thread keeps
//      a 4 x 8 tile of dots in registers (32 FMAs for three 16-byte
//      shared-memory reads).  The epilogue applies the norms and the
//      mask, reduces each row over the tile in (value, index) pairs, an
//      equal value going to the lower index, and writes a partial
//      (best, idx) to a (tiles, B) scratch.
//   2. gallery_match_combine: the TPU kernel carries (best, idx) across a
//      sequential grid axis, which Hopper does not have.  Here each row's
//      tiles are walked in ascending order with strict >, in 32 stripes
//      of consecutive tiles whose winners are then taken in stripe order
//      with strict > again.  That is the first occurrence across tiles,
//      the same on every run.
// bf16 operands are read as bf16, widened with __bfloat162float, and
// summed in fp32.  No tensor cores (mma / wgmma), no TMA and no TF32 yet.
// Ragged B, N and k edges are masked in the loads, so nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTileB = 64;     // feature rows per block, 4 per thread
constexpr int kTileN = 128;    // gallery rows per block, 8 per thread
constexpr int kChunk = 32;     // k per shared-memory stage
constexpr int kPad = 4;        // keeps rows 16-byte aligned and stores conflict-free
constexpr int kFeatLoads = kTileB * kChunk / kThreads;  // 8 per thread
constexpr int kGalLoads = kTileN * kChunk / kThreads;   // 16 per thread
constexpr int kCombineRows = 32;
constexpr int kStripes = 32;
static_assert(kTileB == 16 * 4 && kTileN == 16 * 8, "thread tile is 4 x 8");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Element e of a (rows x kChunk) tile of a row-major matrix: a warp reads
// 8 consecutive k of 4 consecutive rows (four 32-byte segments for f32),
// and the transposing store into a row pitch of rows + kPad (4 mod 32
// words) lands on 32 distinct banks.
__device__ __forceinline__ void row_major_coords(int e, int& r, int& c) {
  const int lo = e & 31, hi = e >> 5;
  c = (lo & 7) + ((hi & 3) << 3);
  r = (lo >> 3) + ((hi >> 2) << 2);
}

// (v, i) beats (best_v, best_i) when larger, or equal at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

// kGalleryRows: the gallery is (N, K) row-major (the rows of a
// `gallery.T` view); otherwise it is (K, N) row-major.
// Two blocks per SM: left free, ptxas gives this kernel 165-186
// registers, one block fits an SM and its 8 warps leave the loads'
// latency exposed.  Capped at 128 registers it spills about 128 bytes a
// thread, and was still faster on an H100 at B 1024, k 128, N 131072
// (float32 1.48 -> 1.32 ms, bf16 2.76 -> 1.60 ms a call).
template <typename T, bool kGalleryRows>
__global__ void __launch_bounds__(kThreads, 2)
gallery_match_tiles(const T* __restrict__ feats, const float* __restrict__ frinv,
                    const T* __restrict__ gallery, const float* __restrict__ gnorm,
                    int B, int K, int N, int b_tiles,
                    float* __restrict__ part_best, int* __restrict__ part_idx) {
  __shared__ __align__(16) float fs[kChunk][kTileB + kPad];
  __shared__ __align__(16) float gs[kChunk][kTileN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bt = blockIdx.x % b_tiles, nt = blockIdx.x / b_tiles;
  const int b0 = bt * kTileB, n0 = nt * kTileN;

  float fa[kFeatLoads], ga[kGalLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kFeatLoads; ++i) {
      int r, c;
      row_major_coords(tid + i * kThreads, r, c);
      const int gb = b0 + r, gk = k0 + c;
      fa[i] = (gb < B && gk < K) ? widen(feats[(size_t)gb * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGalLoads; ++i) {
      const int e = tid + i * kThreads;
      int r, c;
      if (kGalleryRows) {
        row_major_coords(e, r, c);
      } else {
        r = e % kTileN;  // a warp reads 32 consecutive gallery columns
        c = e / kTileN;
      }
      const int gn = n0 + r, gk = k0 + c;
      const size_t at = kGalleryRows ? (size_t)gn * K + gk : (size_t)gk * N + gn;
      ga[i] = (gn < N && gk < K) ? widen(gallery[at]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kFeatLoads; ++i) {
      int r, c;
      row_major_coords(tid + i * kThreads, r, c);
      fs[c][r] = fa[i];
    }
#pragma unroll
    for (int i = 0; i < kGalLoads; ++i) {
      const int e = tid + i * kThreads;
      int r, c;
      if (kGalleryRows) {
        row_major_coords(e, r, c);
      } else {
        r = e % kTileN;
        c = e / kTileN;
      }
      gs[c][r] = ga[i];
    }
  };

  // Thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3
  // and 64 + tx*4 .. 64 + tx*4+3: each 16-byte read of a quarter warp
  // covers 128 consecutive bytes, so the reads do not conflict.
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    stash();
    __syncthreads();
    if (k0 + kChunk < K) fetch(k0 + kChunk);
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&fs[kk][ty * 4]);
      const float4 g0 = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float4 g1 = *reinterpret_cast<const float4*>(&gs[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
  }

  float grinv[8], gmask[8];
  int col[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    const float g = col[j] < N ? gnorm[col[j]] : 0.f;
    grinv[j] = g > 0.f ? 1.f / g : 0.f;
    gmask[j] = g < 0.f ? -INFINITY : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    const float fr = b < B ? frinv[b] : 0.f;
    // A thread with no column inside N keeps index INT_MAX, which loses
    // every tie; tile 0 always holds column 0, so a row of all -inf
    // still reports a real column.
    float best = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (col[j] < N) {
        const float v = acc[i][j] * fr * grinv[j] + gmask[j];
        if (beats(v, col[j], best, best_i)) {
          best = v;
          best_i = col[j];
        }
      }
    }
    // The 16 threads of a row are 16 consecutive lanes of one warp.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (beats(ov, oi, best, best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (tx == 0 && b < B) {
      part_best[(size_t)nt * B + b] = best;
      part_idx[(size_t)nt * B + b] = best_i;
    }
  }
}

// One block per 32 rows: lane = row, warp = stripe of consecutive tiles.
// Reads of one tile's partials are 32 consecutive words per warp.
__global__ void __launch_bounds__(kCombineRows * kStripes)
gallery_match_combine(const float* __restrict__ part_best, const int* __restrict__ part_idx,
                      int B, int n_tiles, int* __restrict__ idx, float* __restrict__ best) {
  __shared__ float stripe_best[kStripes][kCombineRows];
  __shared__ int stripe_idx[kStripes][kCombineRows];
  const int lane = threadIdx.x % kCombineRows;
  const int stripe = threadIdx.x / kCombineRows;
  const int b = blockIdx.x * kCombineRows + lane;
  const int per = (n_tiles + kStripes - 1) / kStripes;
  const int t_end = min(n_tiles, (stripe + 1) * per);

  float v = -INFINITY;
  int vi = 0;
  if (b < B) {
    for (int t = stripe * per; t < t_end; ++t) {
      const float p = part_best[(size_t)t * B + b];
      if (p > v) {
        v = p;
        vi = part_idx[(size_t)t * B + b];
      }
    }
  }
  stripe_best[stripe][lane] = v;
  stripe_idx[stripe][lane] = vi;
  __syncthreads();
  if (stripe == 0 && b < B) {
    // (-inf, row 0) when every score is -inf, as the TPU kernel's
    // initial (best, idx) that strict > never replaces.
    float bv = -INFINITY;
    int bi = 0;
    for (int s = 0; s < kStripes; ++s) {
      if (stripe_best[s][lane] > bv) {
        bv = stripe_best[s][lane];
        bi = stripe_idx[s][lane];
      }
    }
    idx[b] = bi;
    best[b] = bv;
  }
}

template <typename T, bool kGalleryRows>
cudaError_t launch_tiles(const void* feats, const float* frinv, const void* gallery,
                         const float* gnorm, int B, int K, int N, int b_tiles, int blocks,
                         float* part_best, int* part_idx, cudaStream_t stream) {
  gallery_match_tiles<T, kGalleryRows><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), frinv, static_cast<const T*>(gallery), gnorm, B, K, N,
      b_tiles, part_best, part_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the (tiles, B) scratch that part_best and part_idx each need.
int gallery_match_scratch_tiles(int N) { return (N + kTileN - 1) / kTileN; }

// feats (B, K) row-major; gallery (N, K) row-major when gallery_rows is
// nonzero, else (K, N) row-major; both bf16 when bf16 is nonzero, else
// float32.  frinv (B,), gnorm (N,) float32; part_best / part_idx scratch
// of gallery_match_scratch_tiles(N) * B each; idx (B,) int32 and best
// (B,) float32 out.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue for a grid too large).
int gallery_match_launch(const void* feats, const float* frinv, const void* gallery,
                         const float* gnorm, float* part_best, int* part_idx, int* idx,
                         float* best, int B, int K, int N, int bf16, int gallery_rows,
                         cudaStream_t stream) {
  const int b_tiles = (B + kTileB - 1) / kTileB;
  const int n_tiles = gallery_match_scratch_tiles(N);
  const long long blocks = (long long)b_tiles * n_tiles;
  if (B < 1 || K < 1 || N < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    err = gallery_rows
              ? launch_tiles<__nv_bfloat16, true>(feats, frinv, gallery, gnorm, B, K, N,
                                                  b_tiles, (int)blocks, part_best, part_idx,
                                                  stream)
              : launch_tiles<__nv_bfloat16, false>(feats, frinv, gallery, gnorm, B, K, N,
                                                   b_tiles, (int)blocks, part_best, part_idx,
                                                   stream);
  } else {
    err = gallery_rows
              ? launch_tiles<float, true>(feats, frinv, gallery, gnorm, B, K, N, b_tiles,
                                          (int)blocks, part_best, part_idx, stream)
              : launch_tiles<float, false>(feats, frinv, gallery, gnorm, B, K, N, b_tiles,
                                           (int)blocks, part_best, part_idx, stream);
  }
  if (err != cudaSuccess) return (int)err;
  gallery_match_combine<<<(B + kCombineRows - 1) / kCombineRows, kCombineRows * kStripes, 0,
                          stream>>>(part_best, part_idx, B, n_tiles, idx, best);
  return (int)cudaGetLastError();
}

const char* gallery_match_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
