// Fused projection-and-match for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   face_detection_recognization_pca_tpu/ops/pallas_kernels.py:122
//   _match_kernel (launched by fused_match_pallas)
// and computes what it computes.  Per crop b:
//   feats  = crops[b] @ m + bias
//   cos[n] = feats . gallery_t[:, n] / (|feats| * gnorm[n]), 0 where that
//            denominator is <= 0, plus mask[n] (mask may be null = all 0)
//   ids[b] = first-occurrence argmax of cos, conf[b] = its max (column 0
//            at -inf when every column is -inf).
//
// What bounds it at the tracker's shapes (B = 64 crops, D = 96*96 = 9216,
// k = 64, N = 256): 4.8 MB of crops and m, read once, take 1.43 us at
// 3.35 TB/s; the 77.6 MFLOP take 0.47 us as 3xTF32 at the 495 TFLOP/s
// TF32 peak, but mma.sync reaches about 315 (scripts_torch/hmma_probe.cu),
// and one SM draws only some 20 bytes a cycle from L2.  So the work has
// to be spread over most SMs, m read once, and the split-D sums brought
// together with few trips between SMs.  The design:
//   1. Projection.  One 512-thread block per (D split of d_split rows,
//      64-feature k chunk, 64-crop B tile), so crops and m are each read
//      once: 96 blocks at d_split 96.  Each block walks its split in
//      32-deep steps through a ring of kStages shared-memory stages,
//      filled by 16-byte cp.async (zero-filled past the B, D and k edges;
//      element loads where a row start is not 16-byte aligned, which the
//      wrapper decides).  Its 16 warps each take one k8 slice of every
//      step and 16 columns, and multiply on the tensor cores: mma.sync
//      m16n8k8 TF32 three times (3xTF32: lo*hi + hi*lo, then hi*hi, into
//      the same fp32 accumulators), the crop tile [b][d] as A by
//      ldmatrix and m's (D, k) rows as B.  The slices are added in slice
//      order.
//   2. Clusters.  Blocks of 8 consecutive splits form a thread-block
//      cluster, and each adds 8 of the 64 crops' rows of the 8 partials
//      in rank order through distributed shared memory, into one (B, k)
//      partial per cluster in a scratch buffer: 8 times less scratch than
//      one partial per block.
//   3. The same launch finishes.  Each cluster takes a ticket on its B
//      tile's counter (__threadfence, a cluster barrier, atomicAdd); the
//      last cluster to arrive finishes the tile with all 8 of its blocks.
//      Block q adds the clusters' partials of crops 8q..8q+7 in ascending
//      order (the same bits on every run), adds the bias, writes the
//      features over cluster 0's partial and takes their norms; then it
//      scores 32-column gallery tiles q, q + 8, ... for all 64 crops on
//      the tensor cores (the same ring and 3xTF32 products, the features
//      as A), keeps a running (best, column) per crop with strict >, and
//      the 8 blocks' bests are taken in rank order, ties to the lower
//      column.  The counter is reset to 0 for the next call and for
//      CUDA-graph replays.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit), device-only (a CUDA
// graph of 50 calls, scripts_torch/fused_sweep.py): 15.6 us, from the
// SIMT two-launch kernel's 31.5 us; crops @ m alone takes 11.4 us.
// Without its tail the kernel takes 8.8 us (1.3 us of it is what any
// launch in a graph costs), without the scores 13.0 us.  By SM cycles
// (fused_sweep.py --phases): the projection's 3 steps 6,900, where
// mma.sync at the rate of scripts_torch/hmma_probe.cu would need about
// 2,000; each cluster barrier about 1,000; the distributed sum 1,850;
// fence and barrier 2,150; the ticket 3,100; the tail's sums and norms
// 2,200; its scores 4,900.  The trips between SMs, more than bytes or
// products, hold the kernel back.
//
// Any k >= 1, ragged B and D, masks, ties and zero norms.  Nothing is
// padded in device memory.  There is no SIMT projection and no
// single-pass TF32 path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;    // blocks of consecutive D splits that reduce together
constexpr int kTileB = 64;     // crops per block
constexpr int kTileK = 64;     // features per projection block
constexpr int kTileN = 32;     // gallery columns per scoring tile
constexpr int kChunk = 32;     // depth (of D, or of k) of one staged step
constexpr int kSlices = kChunk / 8;           // warps along the depth: a k8 slice each
constexpr int kColGroups = kWarps / kSlices;  // warps along the columns
constexpr int kStages = 3;     // the ring of staged steps
constexpr int kMTiles = kTileB / 16;
constexpr int kRowsPerRank = kTileB / kCluster;  // crops each block of the last cluster finishes
constexpr int kBatch = 12;     // partials the tail loads at once per thread
// Pitches keep every row start 16-byte aligned for cp.async and ldmatrix
// and put the rows that one ldmatrix phase or fragment load touches on
// distinct banks (36 = 4 mod 32 for [row][depth] tiles; 72 and 40 = 8 mod
// 32 for [depth][column] tiles).
constexpr int kPitchA = kChunk + 4;
constexpr int kSizeA = kTileB * kPitchA;

// A product of kCols columns: the projection's (kTileK) or the scores'
// (kTileN).  Each warp takes kWarpCols of them and one k8 slice.
template <int kCols>
struct Cols {
  static constexpr int kWarpCols = kCols / kColGroups;
  static constexpr int kNTiles = kWarpCols / 8;
  static constexpr int kPitch = kCols + 8;
  static constexpr int kSizeB = kChunk * kPitch;
  static constexpr int kSizeRed = kSlices * kTileB * kPitch;  // [slice][row][column]
  static_assert(kWarpCols % 8 == 0, "whole n8 tiles per warp");
};
using Proj = Cols<kTileK>;
using Score = Cols<kTileN>;
static_assert(Score::kSizeB <= Proj::kSizeB && Score::kSizeRed <= Proj::kSizeRed,
              "the scores use the projection's stages");
constexpr size_t kSmemBytes =
    ((size_t)kStages * (kSizeA + Proj::kSizeB) + Proj::kSizeRed) * sizeof(float);
constexpr int kOutPerThread = kTileB * kTileK / kThreads;
static_assert(kWarps % kSlices == 0, "warps tile the depth");
static_assert(kTileB % 16 == 0 && kTileB % kCluster == 0 && kRowsPerRank <= kWarps,
              "whole m16 tiles, and a warp per finished row");
static_assert((kTileB * kTileK) % kThreads == 0 && kThreads % kTileN == 0 && kTileN == 32,
              "whole outputs per thread; a warp's lanes span one scoring tile's columns");

// An (R x C) tile of a row-major matrix with leading dimension ld, of
// which rows_left rows and cols_left columns lie inside the matrix, into
// shared memory at pitch P, zero outside.  kAsync: 16-byte cp.async, for
// which every row start is 16-byte aligned and cols_left is a multiple of
// 4; else element loads.
template <int R, int C, int P, bool kAsync>
__device__ __forceinline__ void fill_tile(float* dst, const float* src, size_t ld, int rows_left,
                                          int cols_left, int tid) {
  if constexpr (kAsync) {
    constexpr int kPerRow = C / 4;
    static_assert(C % 4 == 0, "whole 16-byte copies");
    for (int q = tid; q < R * kPerRow; q += kThreads) {
      const int r = q / kPerRow, c = (q % kPerRow) * 4;
      const bool valid = r < rows_left && c < cols_left;
      cp_async16(dst + r * P + c, valid ? src + r * ld + c : src, valid);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < R * C; e += kThreads) {
      const int r = e / C, c = e % C;
      dst[r * P + c] = (r < rows_left && c < cols_left) ? src[r * ld + c] : 0.f;
    }
  }
}


// The warp's share of one staged step: depth ks..ks+7 of it, all kTileB
// rows by columns col0..col0+kWarpCols-1.  A is [row][depth] at pitch
// kPitchA (ldmatrix: an 8 x 8 b16 matrix is 8 rows of 4 floats, lane
// (g, t) getting float t of row g, which is the TF32 A fragment), B is
// [depth][column] at pitch Cols<kCols>::kPitch.  Lane (g, t) = (lane / 4,
// lane % 4) holds acc[i][j] = rows i*16 + g and + 8 by columns col0 +
// j*8 + 2t and + 1.  3xTF32: lo*hi + hi*lo, then hi*hi, into the same
// accumulators.
template <int kCols>
__device__ __forceinline__ void slice_products(float (&acc)[kMTiles][Cols<kCols>::kNTiles][4],
                                               const float* sa, const float* sb, int ks, int col0,
                                               int lane) {
  using C = Cols<kCols>;
  const int g = lane >> 2, t = lane & 3;
  uint32_t bh[C::kNTiles][2], bl[C::kNTiles][2];
#pragma unroll
  for (int j = 0; j < C::kNTiles; ++j) {
    split_tf32(sb[(ks + t) * C::kPitch + col0 + j * 8 + g], bh[j][0], bl[j][0]);
    split_tf32(sb[(ks + t + 4) * C::kPitch + col0 + j * 8 + g], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    uint32_t x[4], ah[4], al[4];
    ldsm_x4(sa + (i * 16 + (lane & 15)) * kPitchA + ks + (lane >> 4) * 4, x[0], x[1], x[2], x[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(x[q]), ah[q], al[q]);
#pragma unroll
    for (int j = 0; j < C::kNTiles; ++j) {
      mma_tf32(acc[i][j], al, bh[j]);
      mma_tf32(acc[i][j], ah, bl[j]);
      mma_tf32(acc[i][j], ah, bh[j]);
    }
  }
}

// A (kTileB x kCols) product of A rows a[0..rows_left) over depth
// [0, depth) (leading dimension lda) and B rows b[0..depth) of columns
// [0, cols_left) (leading dimension ldb), both read from device memory
// through the ring of kStages stages, into red[slice][row][column]; the
// caller adds the slices in slice order.  Each warp takes one k8 slice of
// every staged step and 16 columns, so the 16 warps share the latency of
// mma.sync, and the next steps' copies are in flight during this one's
// products.
template <int kCols, bool kAsync>
__device__ __forceinline__ void tile_product(float* red, float* sa, float* sb, const float* a,
                                             size_t lda, int rows_left, const float* b, size_t ldb,
                                             int cols_left, int depth, int tid) {
  using C = Cols<kCols>;
  const int lane = tid & 31, warp = tid >> 5;
  const int slice = warp % kSlices, col0 = warp / kSlices * C::kWarpCols;
  const int steps = depth > 0 ? (depth + kChunk - 1) / kChunk : 0;
  int fetched = 0;
  auto fetch = [&](int stage) {
    if (fetched < steps) {
      const int d0 = fetched * kChunk;
      fill_tile<kTileB, kChunk, kPitchA, kAsync>(sa + stage * kSizeA, a + d0, lda, rows_left,
                                                 depth - d0, tid);
      fill_tile<kChunk, kCols, C::kPitch, kAsync>(sb + stage * C::kSizeB, b + d0 * ldb, ldb,
                                                  depth - d0, cols_left, tid);
      ++fetched;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  float acc[kMTiles][C::kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < C::kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  int read = 0, write = kStages - 1;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed, for this thread
    __syncthreads();               // for all threads; stage `write` is free
    fetch(write);
    slice_products<kCols>(acc, sa + read * kSizeA, sb + read * C::kSizeB, slice * 8, col0, lane);
    read = read + 1 == kStages ? 0 : read + 1;
    write = write + 1 == kStages ? 0 : write + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free, and the last tile's reads of red are done
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < C::kNTiles; ++j)
        *reinterpret_cast<float2*>(red + (slice * kTileB + i * 16 + hr * 8 + g) * C::kPitch +
                                   col0 + j * 8 + 2 * t) =
            make_float2(acc[i][j][hr * 2], acc[i][j][hr * 2 + 1]);
  __syncthreads();
}

// Row r, column c of a tile: the slices' sums added in slice order.
template <int kCols>
__device__ __forceinline__ float slice_sum(const float* red, int r, int c) {
  constexpr int P = Cols<kCols>::kPitch;
  float v = red[r * P + c];
#pragma unroll
  for (int w = 1; w < kSlices; ++w) v += red[(w * kTileB + r) * P + c];
  return v;
}

// Block (split, k chunk, B tile) in a cluster of kCluster consecutive
// splits.  partial: (clusters, B, K) scratch, where clusters =
// gridDim.x / kCluster; counters: one per B tile, 0 on entry and left 0.
template <bool kAsync>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
fused_match_kernel(const float* __restrict__ crops, const float* __restrict__ m,
                   const float* __restrict__ bias, const float* __restrict__ gallery_t,
                   const float* __restrict__ gnorm, const float* __restrict__ mask,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int* __restrict__ ids, float* __restrict__ conf,
                   int B, int D, int K, int N, int d_split) {
  extern __shared__ __align__(16) float smem[];
  float* const sa = smem;                           // kStages [row][depth] stages
  float* const sb = sa + kStages * kSizeA;          // kStages [depth][column] stages
  float* const red = sb + kStages * Proj::kSizeB;   // [slice][row][column]
  __shared__ int is_last;
  __shared__ float fnorm_own[kRowsPerRank];         // this rank's finished rows
  __shared__ float fnorm[kTileB];
  __shared__ float cand_best[kTileB];               // this block's best per row
  __shared__ int cand_idx[kTileB];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_clusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  const int bt = blockIdx.z, b0 = bt * kTileB, j0 = blockIdx.y * kTileK;
  const int rows = min(kTileB, B - b0);
  const int d_begin = blockIdx.x * d_split, d_end = min(D, d_begin + d_split);

  // ---- 1. This block's (kTileB x 64) product over its D split, its
  // slices added in place in red (slice 0), then the cluster's 8 partials
  // added in rank order, each block adding kRowsPerRank rows through
  // distributed shared memory, into the scratch row of this cluster.
  tile_product<kTileK, kAsync>(red, sa, sb, crops + (size_t)b0 * D + d_begin, D, rows,
                               m + (size_t)d_begin * K + j0, K, K - j0, d_end - d_begin, tid);
#pragma unroll
  for (int q = 0; q < kOutPerThread; ++q) {
    const int o = q * kThreads + tid, r = o / kTileK, c = o % kTileK;
    red[r * Proj::kPitch + c] = slice_sum<kTileK>(red, r, c);  // read before written, per o
  }
  cluster.sync();  // every block's partial is in its red
  {
    constexpr int kRankOut = kRowsPerRank * kTileK;
    for (int o = tid; o < kRankOut; o += kThreads) {
      const int r = rank * kRowsPerRank + o / kTileK, c = o % kTileK;
      float v = 0.f;
#pragma unroll
      for (int p = 0; p < kCluster; ++p)
        v += cluster.map_shared_rank(red, p)[r * Proj::kPitch + c];
      if (r < rows && j0 + c < K) partial[((size_t)cid * B + b0 + r) * K + j0 + c] = v;
    }
  }
  __threadfence();  // the cluster's partial is visible before its ticket
  cluster.sync();   // and no block reads another's red any more

  // ---- 2. The last cluster of this B tile to arrive finishes it. ----
  if (rank == 0 && tid == 0) {
    const int last = atomicAdd(&counters[bt], 1) == n_clusters * (int)gridDim.y - 1;
    for (int p = 0; p < kCluster; ++p) *cluster.map_shared_rank(&is_last, p) = last;
    if (last) counters[bt] = 0;  // for the next call and for CUDA-graph replays
  }
  cluster.sync();
  if (!is_last) return;
  __threadfence();

  // Rank q finishes crops r0..r0+7, warp w crop r0 + w: its partials
  // summed over the clusters in ascending order, plus the bias, written
  // over cluster 0's partial (which only this warp reads), and its norm,
  // the lanes' squares added in a fixed order.  Each lane loads its two
  // columns of kBatch clusters at once before it adds them.
  const int r0 = rank * kRowsPerRank;
  const int own_rows = max(0, min(kRowsPerRank, rows - r0));
  const size_t stride = (size_t)B * K;
  if (warp < kRowsPerRank) {
    float* const feats = partial + (size_t)(b0 + r0 + warp) * K;  // row of cluster 0
    float sq = 0.f;
    for (int jl = lane; warp < own_rows && jl < K; jl += 64) {
      float f[2] = {0.f, 0.f};
      for (int c0 = 0; c0 < n_clusters; c0 += kBatch) {
        float v[kBatch][2];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = jl + 32 * h;
            v[i][h] = c0 + i < n_clusters && j < K ? __ldcg(feats + (c0 + i) * stride + j) : 0.f;
          }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          f[0] += v[i][0];
          f[1] += v[i][1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jl + 32 * h;
        if (j < K) {
          const float x = f[h] + bias[j];
          feats[j] = x;
          sq = fmaf(x, x, sq);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) fnorm_own[warp] = sqrtf(sq);
  }
  // The cluster barrier's release and acquire make every rank's features
  // (device memory) and norms (shared memory) visible to the others.
  cluster.sync();
  if (tid < kTileB) fnorm[tid] = *cluster.map_shared_rank(&fnorm_own[tid % kRowsPerRank],
                                                          tid / kRowsPerRank);

  // Scores: rank q takes the kTileN-column tiles q, q + 8, ... in
  // ascending order.  Thread tid scores column tid % 32 of each for rows
  // tid / 32 + 16 i, so strict > keeps the first occurrence; a column past
  // N scores -inf and never wins, and a row with no winner keeps index
  // INT_MAX, which loses every tie.
  constexpr int kRowStep = kThreads / kTileN;
  constexpr int kRowsPerThread = kTileB / kRowStep;
  const int c = tid % kTileN, rt = tid / kTileN;
  float run_best[kRowsPerThread];
  int run_idx[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    run_best[i] = -INFINITY;
    run_idx[i] = INT_MAX;
  }
  const float* const feats0 = partial + (size_t)b0 * K;
  for (int n0 = rank * kTileN; n0 < N; n0 += kCluster * kTileN) {
    const int col = n0 + c;
    const float gv = col < N ? gnorm[col] : 0.f;
    const float mv = col >= N ? -INFINITY : mask != nullptr ? mask[col] : 0.f;
    tile_product<kTileN, kAsync>(red, sa, sb, feats0, K, rows, gallery_t + n0, N, N - n0, K, tid);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rt + i * kRowStep;
      const float denom = fnorm[r] * gv;  // the plain version's order of operations
      const float v = (denom > 0.f ? slice_sum<kTileN>(red, r, c) / denom : 0.f) + mv;
      if (v > run_best[i]) {
        run_best[i] = v;
        run_idx[i] = col;
      }
    }
  }
  // This block's best per row, over the 32 lanes of its warp, an equal
  // value going to the lower column.
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float v = run_best[i];
    int vi = run_idx[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
      if (beats(ov, oi, v, vi)) {
        v = ov;
        vi = oi;
      }
    }
    if (lane == 0) {
      cand_best[rt + i * kRowStep] = v;
      cand_idx[rt + i * kRowStep] = vi;
    }
  }
  cluster.sync();  // every rank's candidates are in
  if (tid < own_rows) {  // the ranks' candidates in rank order: ascending column tiles
    const int r = r0 + tid;
    float best = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int p = 0; p < kCluster; ++p) {
      const float v = *cluster.map_shared_rank(&cand_best[r], p);
      const int vi = *cluster.map_shared_rank(&cand_idx[r], p);
      if (beats(v, vi, best, best_i)) {
        best = v;
        best_i = vi;
      }
    }
    ids[b0 + r] = best_i == INT_MAX ? 0 : best_i;  // an all -inf row: column 0
    conf[b0 + r] = best;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <bool kAsync>
cudaError_t launch(const float* crops, const float* m, const float* bias, const float* gallery_t,
                   const float* gnorm, const float* mask, float* partial, int* counters, int* ids,
                   float* conf, int B, int D, int K, int N, int d_split, dim3 grid,
                   cudaStream_t stream) {
  auto kernel = fused_match_kernel<kAsync>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(crops, m, bias, gallery_t, gnorm, mask, partial,
                                                 counters, ids, conf, B, D, K, N, d_split);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int clusters(int D, int d_split) {
  return ((D + d_split - 1) / d_split + kCluster - 1) / kCluster;
}

}  // namespace

extern "C" {

// Counters that fused_match_launch needs for B crops: one per B tile.
int fused_match_counters(int B) { return (B + kTileB - 1) / kTileB; }

// Floats of partial scratch that fused_match_launch needs.
long long fused_match_scratch_floats(int B, int D, int K, int d_split) {
  return (long long)clusters(D, d_split) * B * K;
}

// crops (B, D), m (D, K), bias (K,), gallery_t (K, N), gnorm (N,), mask
// (N,) or null, all float32 row-major; partial: scratch of
// fused_match_scratch_floats(B, D, K, d_split) floats; counters:
// fused_match_counters(B) ints, all 0 (the kernel leaves them 0); ids
// (B,) int32 and conf (B,) float32 out.  d_split is a positive multiple
// of 32.  fill16 nonzero stages by 16-byte cp.async: crops, m, gallery_t
// and partial must start on 16 bytes and D, K and N be multiples of 4,
// else element loads are used.  Launches one kernel on `stream`, does not
// synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for
// shapes out of range, cudaErrorMisalignedAddress for fill16 on rows that
// are not aligned).
int fused_match_launch(const float* crops, const float* m, const float* bias,
                       const float* gallery_t, const float* gnorm, const float* mask,
                       float* partial, int* counters, int* ids, float* conf, int B, int D, int K,
                       int N, int d_split, int fill16, cudaStream_t stream) {
  if (B < 1 || D < 1 || K < 1 || N < 1 || d_split < kChunk || d_split % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(clusters(D, d_split) * kCluster, (K + kTileK - 1) / kTileK,
                  fused_match_counters(B));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (fill16 && (!aligned16(crops) || !aligned16(m) || !aligned16(gallery_t) ||
                 !aligned16(partial) || D % 4 != 0 || K % 4 != 0 || N % 4 != 0))
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t err =
      fill16 ? launch<true>(crops, m, bias, gallery_t, gnorm, mask, partial, counters, ids, conf,
                            B, D, K, N, d_split, grid, stream)
             : launch<false>(crops, m, bias, gallery_t, gnorm, mask, partial, counters, ids, conf,
                             B, D, K, N, d_split, grid, stream);
  return (int)err;
}

const char* fused_match_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
