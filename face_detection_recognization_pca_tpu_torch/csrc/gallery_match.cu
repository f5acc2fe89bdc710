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
// products are 2 B k N = 34.4 GFLOP over 67 MB of float32 gallery (34 MB
// in bf16), about 512 FLOP per byte, so the tensor cores bound it, not
// HBM: 35 us of bf16 at the 989 TFLOP/s dense peak, and 0.21 ms for
// float32 as 3xTF32 (three TF32 products at 495 TFLOP/s).  Warp-level
// mma.sync, which this kernel uses, peaks lower: 628 TFLOP/s bf16 and 315
// TF32 measured on an H100 (scripts_torch/hmma_probe.cu).  The epilogue is
// a second floor: 134 M cosines at about 5 CUDA-core instructions each.
// The design:
//   1. gallery_match_tiles: one 256-thread block per (128-row B tile,
//      group of 16 consecutive 128-row N tiles), 8 warps of 64 x 32.  The
//      block index runs over B tiles first, so the B/128 blocks that read
//      one gallery tile run together and share it through the 50 MB L2:
//      the Hopper form of the one-batch-tile lesson in
//      pallas_kernels.py:288-293.  Its 128 feature rows are loaded into
//      shared memory once and stay there (for k up to 192 in bf16, 128 in
//      float32; a larger k streams them beside the gallery), so L2 feeds
//      the SMs the gallery alone: reloading the feature tile for every N
//      tile doubled that traffic, and at about 4.5 TB/s it bounded the
//      loop.  The gallery is walked in (N tile, k chunk of 128 bytes: 64
//      bf16 or 32 float32) steps through a ring of shared-memory stages,
//      filled by 16-byte cp.async (zero-filled past the B and N edges)
//      while earlier stages are multiplied; the ring runs on across N
//      tiles, so the next tile's loads hide behind this tile's products
//      and epilogue.  Where a row start is not 16-byte aligned (k = 100,
//      an offset view) the same tiles are filled by element loads; the
//      wrapper picks the fill.
//      Products run on the tensor cores by warp-level mma.sync:
//        bf16: m16n8k16 with fragments from ldmatrix (.trans for a
//          (k, N) gallery).  Products of bf16 values are exact in fp32.
//        float32: m16n8k8 TF32 three times (3xTF32).  Each operand is
//          split as its fragment is loaded, hi = rna_tf32(x) and
//          lo = rna_tf32(x - hi) (to nearest, ties away from zero, as
//          cvt.rna.tf32.f32 rounds), and lo*hi + hi*lo are summed before
//          hi*hi into the same fp32 accumulators, which keeps float32
//          parity (about 2^-22 of each product).  There is no single-pass
//          TF32 path.
//      Each tile's epilogue works on the accumulator fragments in
//      registers: norms and mask in the order of the plain version, then
//      a running (best, column) per row and thread, strict > over columns
//      met in ascending order.  At the end of the block the running bests
//      are reduced over the 4 lanes of a quad and the 4 warps that share
//      rows, an equal value going to the lower column, and one partial
//      (best, idx) per row goes to a (groups, B) scratch.
//   2. gallery_match_combine: the TPU kernel carries (best, idx) across a
//      sequential grid axis, which Hopper does not have.  Here each row's
//      groups are walked in ascending order with strict >, in 32 stripes
//      of consecutive groups whose winners are then taken in stripe order
//      with strict > again.  That is the first occurrence across groups,
//      the same on every run.
// Ragged B, N and k edges are zero-filled in shared memory, so nothing is
// padded in device memory.  No wgmma, TMA or clusters yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along B x 4 along N
constexpr int kTileB = 128;    // feature rows per block
constexpr int kTileN = 128;    // gallery rows per block
constexpr int kWarpB = 64;     // a warp's rows: 4 m16 tiles
constexpr int kWarpN = 32;     // a warp's columns: 4 n8 tiles
constexpr int kWarpsN = kTileN / kWarpN;
constexpr int kTilesPerBlock = 16;  // consecutive N tiles a block walks
constexpr int kCombineRows = 32;
constexpr int kStripes = 32;
static_assert(kTileB == 2 * kWarpB && kWarpsN * 2 * 32 == kThreads, "8 warps, 2 x 4");

// Shared-memory geometry.  A chunk holds kChunk values of k (128 bytes
// of a row in both types).  Feature chunks are [b][k] and gallery chunks
// [n][k] (rows layout) or [k][n]; the pitches keep every row start
// 16-byte aligned for cp.async and ldmatrix, and put the 8 rows an
// ldmatrix phase or a fragment load touches on distinct banks.  The
// feature tile has kASlots chunk slots: all of its k when k fits (k <= 192
// in bf16, <= 128 in float32), and it then stays for the block's life;
// else a ring of kStages chunks beside the gallery's.  The gallery has a
// ring of kStages chunks.  108 KB in all, so that two blocks fit an SM.
template <typename T, bool kRows>
struct Smem {
  static constexpr int kChunk = sizeof(T) == 2 ? 64 : 32;
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int kPitchA = kChunk + kVec;
  static constexpr int kPitchB = kRows ? kChunk + kVec : kTileN + 8;
  static constexpr int kSizeA = kTileB * kPitchA;
  static constexpr int kSizeB = kRows ? kTileN * kPitchB : kChunk * kPitchB;
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kASlots = sizeof(T) == 2 ? 3 : 4;
  static_assert(kASlots >= kStages, "the feature ring fits the slots");
  static constexpr size_t kBytes =
      ((size_t)kASlots * kSizeA + (size_t)kStages * kSizeB) * sizeof(T);
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// c += a * b on one m16n8 tile of bf16 operands, fp32 accumulators; the
// TF32 form, the hi/lo split and the rest are in mma_sync.cuh.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An (R x C) tile of a row-major matrix with leading dimension ld, of
// which rows_left rows and cols_left columns lie inside the matrix, into
// shared memory at pitch P, zero outside.  kAsync: 16-byte cp.async, for
// which every row start is 16-byte aligned and cols_left is a whole
// number of 16-byte pieces; else element loads.
template <typename T, int R, int C, int P, bool kAsync>
__device__ __forceinline__ void fill_tile(T* dst, const T* src, size_t ld, int rows_left,
                                          int cols_left, int tid) {
  if constexpr (kAsync) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kPerRow = C / kVec;
    static_assert(C % kVec == 0 && (R * kPerRow) % kThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < R * kPerRow / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / kPerRow, c = (q % kPerRow) * kVec;
      const bool valid = r < rows_left && c < cols_left;
      cp_async16(dst + r * P + c, valid ? src + r * ld + c : src, valid);
    }
  } else {
    static_assert((R * C) % kThreads == 0, "whole elements per thread");
#pragma unroll 4
    for (int i = 0; i < R * C / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / C, c = e % C;
      dst[r * P + c] = (r < rows_left && c < cols_left) ? src[r * ld + c] : zero<T>();
    }
  }
}

// The feature chunk at k0 of B tile b0, and the gallery chunk at (n0, k0).
template <typename T, bool kRows, bool kAsync>
__device__ __forceinline__ void fill_feats(T* sa, const T* feats, int B, int K, int b0, int k0,
                                           int tid) {
  using S = Smem<T, kRows>;
  fill_tile<T, kTileB, S::kChunk, S::kPitchA, kAsync>(sa, feats + (size_t)b0 * K + k0, K,
                                                      B - b0, K - k0, tid);
}
template <typename T, bool kRows, bool kAsync>
__device__ __forceinline__ void fill_gallery(T* sb, const T* gallery, int K, int N, int n0, int k0,
                                             int tid) {
  using S = Smem<T, kRows>;
  if constexpr (kRows) {
    fill_tile<T, kTileN, S::kChunk, S::kPitchB, kAsync>(sb, gallery + (size_t)n0 * K + k0, K,
                                                        N - n0, K - k0, tid);
  } else {
    fill_tile<T, S::kChunk, kTileN, S::kPitchB, kAsync>(sb, gallery + (size_t)k0 * N + n0, N,
                                                        K - k0, N - n0, tid);
  }
}

// The warp's 64 x 32 products over one staged chunk of k.  Lane (g, t) =
// (lane / 4, lane % 4) holds, for m16 tile i and n8 tile j, acc[i][j] =
// rows g and g + 8 by columns 2t and 2t + 1 (the PTX ISA's fragment
// layout for m16n8 with fp32 accumulators).
template <typename T, bool kRows>
__device__ __forceinline__ void chunk_products(float (&acc)[4][4][4], const T* sa, const T* sb,
                                               int wm, int wn, int lane) {
  using S = Smem<T, kRows>;
  constexpr int PA = S::kPitchA, PB = S::kPitchB;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int ks = 0; ks < S::kChunk; ks += 16) {
      // B fragments of the 4 n8 tiles: {k 0-7, k 8-15} of each, two
      // tiles per ldmatrix.x4.
      uint32_t b[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n = wn * kWarpN + jj * 16;
        if constexpr (kRows) {
          const T* p = sb + (n + (lane & 7) + ((lane >> 4) << 3)) * PB + ks + ((lane >> 3) & 1) * 8;
          ldsm_x4(p, b[2 * jj][0], b[2 * jj][1], b[2 * jj + 1][0], b[2 * jj + 1][1]);
        } else {
          const T* p = sb + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * PB + n + (lane >> 4) * 8;
          ldsm_x4_trans(p, b[2 * jj][0], b[2 * jj][1], b[2 * jj + 1][0], b[2 * jj + 1][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldsm_x4(sa + (wm * kWarpB + i * 16 + (lane & 15)) * PA + ks + (lane >> 4) * 8, a[0], a[1],
                a[2], a[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j]);
      }
    }
  } else {
    // TF32 fragments hold one float per register: a0 = A[g][t],
    // a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; b0 =
    // B[k = t][n = g], b1 = B[k = t + 4][n = g].  An ldmatrix 8 x 8 b16
    // matrix is 8 rows of 4 floats, and gives lane (g, t) float t of row
    // g, so it loads them from [row][k] tiles as it loads bf16 fragments.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < S::kChunk; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
      if constexpr (kRows) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t x[4];
          ldsm_x4(sb + (wn * kWarpN + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * PB + ks +
                      ((lane >> 3) & 1) * 4,
                  x[0], x[1], x[2], x[3]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(__uint_as_float(x[q]), bh[2 * jj + (q >> 1)][q & 1],
                       bl[2 * jj + (q >> 1)][q & 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * kWarpN + j * 8 + g;
          split_tf32(sb[(ks + t) * PB + n], bh[j][0], bl[j][0]);
          split_tf32(sb[(ks + t + 4) * PB + n], bh[j][1], bl[j][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t x[4], ah[4], al[4];
        ldsm_x4(sa + (wm * kWarpB + i * 16 + (lane & 15)) * PA + ks + (lane >> 4) * 4, x[0], x[1],
                x[2], x[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(x[q]), ah[q], al[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], al, bh[j]);
          mma_tf32(acc[i][j], ah, bl[j]);
          mma_tf32(acc[i][j], ah, bh[j]);
        }
      }
    }
  }
}

// kGalleryRows: the gallery is (N, K) row-major (the rows of a
// `gallery.T` view); otherwise it is (K, N) row-major.  kAsync: the
// stages are filled by 16-byte cp.async, else by element loads.
// Block (bt, grp) scores B tile bt against N tiles grp * kTilesPerBlock
// onwards, in ascending order, and writes one partial per row for them.
template <typename T, bool kGalleryRows, bool kAsync>
__global__ void __launch_bounds__(kThreads, 2)
gallery_match_tiles(const T* __restrict__ feats, const float* __restrict__ frinv,
                    const T* __restrict__ gallery, const float* __restrict__ gnorm,
                    int B, int K, int N, int b_tiles,
                    float* __restrict__ part_best, int* __restrict__ part_idx) {
  using S = Smem<T, kGalleryRows>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sa = reinterpret_cast<T*>(smem_raw);  // kASlots feature chunks
  T* const sb = sa + S::kASlots * S::kSizeA;      // kStages gallery chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int bt = blockIdx.x % b_tiles, grp = blockIdx.x / b_tiles;
  const int b0 = bt * kTileB;
  const int tile0 = grp * kTilesPerBlock;
  const int tiles = min((N + kTileN - 1) / kTileN - tile0, kTilesPerBlock);
  const int chunks = (K + S::kChunk - 1) / S::kChunk;
  const int steps = tiles * chunks;  // (tile, chunk) pairs, chunk fastest
  // The feature tile is loaded once, with the first gallery chunk, when
  // all its chunks fit; else chunk by chunk with the gallery's.
  const bool resident = chunks <= S::kASlots;

  // The ring: step s lives in stage s % kStages, and step s + kStages - 1
  // is fetched while step s is multiplied, across tile boundaries, so the
  // next tile's loads overlap this tile's last chunk and its epilogue.
  int fetch_tile = tile0, fetch_chunk = 0, fetched = 0;
  auto fetch = [&](int stage) {
    if (fetched < steps) {
      if (!resident) {
        fill_feats<T, kGalleryRows, kAsync>(sa + stage * S::kSizeA, feats, B, K, b0,
                                            fetch_chunk * S::kChunk, tid);
      } else if (fetched == 0) {
        for (int c = 0; c < chunks; ++c)
          fill_feats<T, kGalleryRows, kAsync>(sa + c * S::kSizeA, feats, B, K, b0, c * S::kChunk,
                                              tid);
      }
      fill_gallery<T, kGalleryRows, kAsync>(sb + stage * S::kSizeB, gallery, K, N,
                                            fetch_tile * kTileN, fetch_chunk * S::kChunk, tid);
      ++fetched;
      if (++fetch_chunk == chunks) {
        fetch_chunk = 0;
        ++fetch_tile;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) fetch(s);

  // Thread (g, t) of warp (wm, wn) owns rows wm * 64 + i * 16 + hr * 8 + g
  // (i < 4, hr < 2) and, in every tile, columns wn * 32 + j * 8 + 2t + h
  // (j < 4, h < 2).  It keeps a running (best, column) per row over its
  // columns of all the block's tiles, which it meets in ascending order,
  // so strict > keeps the first occurrence.  A column past N scores -inf
  // like a sentinel row and so never wins; a row with no winner keeps
  // index INT_MAX, which loses every tie.
  float run_best[8];
  int run_idx[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    run_best[r] = -INFINITY;
    run_idx[r] = INT_MAX;
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  float gv[4][2];  // gnorm of the thread's columns of the current tile
  int read = 0, write = S::kStages - 1, chunk = 0, tile = tile0;
  for (int s = 0; s < steps; ++s) {
    if (chunk == 0) {  // loaded now, used in the tile's epilogue
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = tile * kTileN + wn * kWarpN + j * 8 + 2 * t + h;
          gv[j][h] = col < N ? gnorm[col] : -INFINITY;  // past N: a sentinel
        }
    }
    cp_async_wait<S::kStages - 2>();  // step s has landed, for this thread
    __syncthreads();                  // for all threads; stage `write` is free
    fetch(write);
    chunk_products<T, kGalleryRows>(acc, sa + (resident ? chunk : read) * S::kSizeA,
                                    sb + read * S::kSizeB, wm, wn, lane);
    read = read + 1 == S::kStages ? 0 : read + 1;
    write = write + 1 == S::kStages ? 0 : write + 1;
    if (++chunk < chunks) continue;

    // The tile's epilogue: acc * frinv * grinv + gmask, in the plain
    // version's order, into the running bests; then the next tile.
    chunk = 0;
    float grinv[4][2], gmask[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = gv[j][h];
        grinv[j][h] = x > 0.f ? __frcp_rn(x) : 0.f;
        gmask[j][h] = x < 0.f ? -INFINITY : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = i * 2 + hr, b = b0 + wm * kWarpB + i * 16 + hr * 8 + g;
        const float fr = b < B ? frinv[b] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // ascending columns
            const float v = acc[i][j][hr * 2 + h] * fr * grinv[j][h] + gmask[j][h];
            if (v > run_best[r]) {
              run_best[r] = v;
              run_idx[r] = tile * kTileN + wn * kWarpN + j * 8 + 2 * t + h;
            }
            acc[i][j][hr * 2 + h] = 0.f;
          }
      }
    ++tile;
  }

  // The 4 lanes of a quad hold the same rows; then the 4 warps along N,
  // through the gallery ring, which no copy or product uses any more.
  cp_async_wait<0>();
  __syncthreads();
  float(*red_best)[kTileB] = reinterpret_cast<float(*)[kTileB]>(sb);
  int(*red_idx)[kTileB] = reinterpret_cast<int(*)[kTileB]>(red_best + kWarpsN);
  static_assert(2 * kWarpsN * kTileB * 4 <= S::kStages * S::kSizeB * (int)sizeof(T), "fits");
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, run_best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, run_idx[r], off);
      if (beats(ov, oi, run_best[r], run_idx[r])) {
        run_best[r] = ov;
        run_idx[r] = oi;
      }
    }
    if (t == 0) {
      const int row = wm * kWarpB + (r >> 1) * 16 + (r & 1) * 8 + g;
      red_best[wn][row] = run_best[r];
      red_idx[wn][row] = run_idx[r];
    }
  }
  __syncthreads();
  if (tid < kTileB && b0 + tid < B) {
    float best = red_best[0][tid];
    int best_i = red_idx[0][tid];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) {
      if (beats(red_best[w][tid], red_idx[w][tid], best, best_i)) {
        best = red_best[w][tid];
        best_i = red_idx[w][tid];
      }
    }
    part_best[(size_t)grp * B + b0 + tid] = best;
    part_idx[(size_t)grp * B + b0 + tid] = best_i;
  }
}

// One block per 32 rows: lane = row, warp = stripe of consecutive groups
// of N tiles (n_tiles counts groups).  Reads of one group's partials are
// 32 consecutive words per warp.
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

template <typename T, bool kGalleryRows, bool kAsync>
cudaError_t launch_tiles(const void* feats, const float* frinv, const void* gallery,
                         const float* gnorm, int B, int K, int N, int b_tiles, int blocks,
                         float* part_best, int* part_idx, cudaStream_t stream) {
  auto kernel = gallery_match_tiles<T, kGalleryRows, kAsync>;
  constexpr size_t bytes = Smem<T, kGalleryRows>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, bytes, stream>>>(static_cast<const T*>(feats), frinv,
                                              static_cast<const T*>(gallery), gnorm, B, K, N,
                                              b_tiles, part_best, part_idx);
  return cudaGetLastError();
}

template <typename T, bool kGalleryRows>
cudaError_t launch_fill(int fill16, const void* feats, const float* frinv, const void* gallery,
                        const float* gnorm, int B, int K, int N, int b_tiles, int blocks,
                        float* part_best, int* part_idx, cudaStream_t stream) {
  return fill16 ? launch_tiles<T, kGalleryRows, true>(feats, frinv, gallery, gnorm, B, K, N,
                                                      b_tiles, blocks, part_best, part_idx, stream)
                : launch_tiles<T, kGalleryRows, false>(feats, frinv, gallery, gnorm, B, K, N,
                                                       b_tiles, blocks, part_best, part_idx,
                                                       stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Rows of the (groups, B) scratch that part_best and part_idx each need:
// one per group of kTilesPerBlock consecutive N tiles.
int gallery_match_scratch_tiles(int N) {
  return ((N + kTileN - 1) / kTileN + kTilesPerBlock - 1) / kTilesPerBlock;
}

// feats (B, K) row-major; gallery (N, K) row-major when gallery_rows is
// nonzero, else (K, N) row-major; both bf16 when bf16 is nonzero, else
// float32.  frinv (B,), gnorm (N,) float32; part_best / part_idx scratch
// of gallery_match_scratch_tiles(N) * B each; idx (B,) int32 and best
// (B,) float32 out.  fill16 nonzero stages tiles by 16-byte cp.async: it
// needs both base pointers and every row start 16-byte aligned (K, and
// for a (K, N) gallery N, a multiple of 16 bytes), else element loads
// are used.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue for a grid too large,
// cudaErrorMisalignedAddress for fill16 on rows that are not aligned).
int gallery_match_launch(const void* feats, const float* frinv, const void* gallery,
                         const float* gnorm, float* part_best, int* part_idx, int* idx,
                         float* best, int B, int K, int N, int bf16, int gallery_rows, int fill16,
                         cudaStream_t stream) {
  const int b_tiles = (B + kTileB - 1) / kTileB;
  const int n_tiles = gallery_match_scratch_tiles(N);  // groups of N tiles
  const long long blocks = (long long)b_tiles * n_tiles;
  if (B < 1 || K < 1 || N < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)(gallery_rows ? K : N) * (bf16 ? 2 : 4);
  if (fill16 && (!aligned16(feats) || !aligned16(gallery) || (K * (bf16 ? 2 : 4)) % 16 != 0 ||
                 row_bytes % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err;
  if (bf16) {
    err = gallery_rows
              ? launch_fill<__nv_bfloat16, true>(fill16, feats, frinv, gallery, gnorm, B, K, N,
                                                 b_tiles, (int)blocks, part_best, part_idx, stream)
              : launch_fill<__nv_bfloat16, false>(fill16, feats, frinv, gallery, gnorm, B, K, N,
                                                  b_tiles, (int)blocks, part_best, part_idx,
                                                  stream);
  } else {
    err = gallery_rows
              ? launch_fill<float, true>(fill16, feats, frinv, gallery, gnorm, B, K, N, b_tiles,
                                         (int)blocks, part_best, part_idx, stream)
              : launch_fill<float, false>(fill16, feats, frinv, gallery, gnorm, B, K, N, b_tiles,
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
