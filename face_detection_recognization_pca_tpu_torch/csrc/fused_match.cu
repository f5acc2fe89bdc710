// Fused projection-and-match for Hopper (sm_90a): TMA, mbarriers, wgmma.
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
// What bounds it: the bytes.  The crops (B x D float32) are read once and
// dominate (B 512, D 9216: 18.9 MB of 21.3, 6.36 us at 3.35 TB/s); the
// 3xTF32 projection's products would take 3.8 us at the 495 TFLOP/s TF32
// peak.  So the loads must stream the crops at close to HBM rate on every
// SM while the tensor cores keep up, and the sums over D come together once,
// in a fixed order, without trips between SMs.  Two kernels, one call:
//   1. The products (fused_match_products), about one wave of 288-thread
//      blocks: two consumer warpgroups and one producer warp.  A block is a
//      unit (B tile of 64 or 128 crops, 64-feature k chunk, range of whole
//      32-float D chunks); the wrapper sizes the ranges (at most 64 per B
//      tile) so that the units make one wave of the card's SMs.
//      - A TMA ring.  The producer warp keeps up to 8 stages in flight,
//        each a crop tile (tile rows x 32 floats) and the same 32 columns of
//        m's prepared hi and lo halves (64 features x 32 floats each), all
//        three 2-D TMA loads into 128-byte-swizzled shared memory, completed
//        on a full mbarrier and released by the consumers on an empty one.
//        Crops that TMA cannot take (a base off 16 bytes, or D not a
//        multiple of 4) are stored into the same layout by the producer
//        warp's own loads.  m is prepared once per model
//        (ops/fused_match.split_m): transposed to (k, D), K-major as wgmma's
//        tf32 B operand must be, and split into TF32 hi and lo.
//      - Products on wgmma.  Each consumer warp loads its 16 crop rows of a
//        stage by ldmatrix into the A-fragment layout and splits them into
//        hi and lo in registers; its warpgroup issues m64n64k8 tf32 wgmmas,
//        A from registers and B from the stage: lo*hi, hi*lo, then hi*hi
//        per 8-deep step, into one float32 accumulator (3xTF32).  In a
//        128-crop tile each warpgroup takes 64 rows of every chunk; in a
//        64-crop tile the two take alternate chunks, and their accumulators
//        are added, even chunks first.  Each unit writes its partial once,
//        laid out so that each finishing block's rows of every range lie in
//        one run.
//   2. The finish (fused_match_finish), a programmatic dependent launch of
//      4 or 8 crops per 256-thread block: it loads its gallery fragments,
//      norms, mask and bias while the products run, waits for them
//      (griddepcontrol), copies its rows of every range's partial by
//      cp.async (one run of memory, in four groups so that adding one
//      overlaps copying the next) and adds them in ascending D order, then
//      the bias; the norms sum the
//      squares in a fixed order.  The scores run on mma.sync, 3xTF32,
//      transposed (gallery columns by crops), each warp one 8-deep step of
//      k for all 256 columns of a block, and the warps' dots are added in
//      warp order; each crop keeps its first-occurrence best (strict >,
//      equal values to the lower column).  No counter, no ticket and no
//      cluster: the same call gives the same bits every time, and a CUDA
//      graph's replay equals the eager call.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, device-only (CUDA graph
// of 20 calls, scripts_torch/fused_sweep.py; k 64, N 256), against
// crops @ m and the bound: B 32 D 9216 9.91 us (10.69; 1.08), B 64 D 9216
// 10.09 us (11.49; 1.43), B 64 D 16384 11.09 us (13.21; 2.52), B 512
// D 9216 16.05 us (27.90; 6.36, a share of 0.40), B 768 D 16384 32.70 us
// (52.99; 16.30, 0.50); in chip_smoke.py phase 3, B 256 D 9216 (the CLI
// bench's shape) 13.38 us (17.83; 3.54, 0.26).  The products alone take
// 4.8 us at B 64 and 27 us at B 768; the finish's sums of 58 partials
// (4.5k SM cycles) and its scores (3.8k) hold the small shapes back
// (fused_sweep.py --phases).
// Any k >= 1, ragged B and D, masks, ties and zero norms.  The finish keeps
// its crops' features in shared memory up to k = 4,928; above that it writes
// them over its own rows of the partials, once they are added, and reads
// them back from there.  Nothing is padded in device memory but m's
// prepared copy.

#include <algorithm>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kConsumerWarps = 8;                     // two warpgroups
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // and one producer warp
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kChunk = 32;        // D floats per stage: one 128-byte swizzled row per crop
constexpr int kTileK = 64;        // features per unit: the wgmma's N
constexpr int kRingBytes = 192 * 1024;
constexpr int kMTileBytes = kTileK * kChunk * 4;      // one half of m's chunk: 8 KB

template <int kTB>
struct Plan {
  static constexpr int kCropBytes = kTB * kChunk * 4;
  static constexpr int kStageBytes = kCropBytes + 2 * kMTileBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 8 at 64 crops, 6 at 128
  static_assert(kStages >= 2 && kStages <= 8, "a ring of stages");
  static_assert(kStageBytes % 1024 == 0 && kCropBytes % 1024 == 0, "1024-byte swizzle atoms");
};
constexpr size_t kSmemBytes = 1024 + kRingBytes + 2 * 8 * sizeof(uint64_t);

// The finish kernel: 8 warps, crops per block at most, gallery columns
// scored at a time (one per thread), partials staged at a time at most, in
// groups of copies waited for one after the other.
constexpr int kFinishWarps = 8;
constexpr int kFinishThreads = kFinishWarps * 32;
constexpr int kFinishRows = 8;  // at most
constexpr int kGCols = 256;
constexpr int kMaxBatch = 64;
constexpr int kGroups = 4;
constexpr int kSmemLimit = 227 * 1024;
static_assert(kFinishRows * 16 <= kFinishThreads, "a float4 of the sums per thread");

// Floats of the finish kernel's staging area: `batch` partials, and later
// the warps' dots of one block of columns.
__host__ __device__ constexpr int finish_stage_floats(int batch) {
  return batch * kFinishRows * kTileK > kFinishWarps * kGCols * kFinishRows
             ? batch * kFinishRows * kTileK
             : kFinishWarps * kGCols * kFinishRows;
}
// The finish kernel's shared memory for `batch` partials, and for k
// features per crop where `feats` keeps them there.
size_t finish_smem(int K, int batch, bool feats) {
  const size_t kp = (size_t)(K + kTileK - 1) / kTileK * kTileK;
  return ((size_t)finish_stage_floats(batch) + (feats ? kFinishRows * (kp + 4) : 0)) *
         sizeof(float);
}
// Partials staged at a time: as many as fit, up to kMaxBatch; 0 when none
// fits beside k features in shared memory.
int finish_batch(int K, bool feats) {
  const size_t room = kSmemLimit - 8 * 1024;  // the static arrays
  for (int batch = kMaxBatch; batch >= 1; --batch)
    if (finish_smem(K, batch, feats) <= room) return batch;
  return 0;
}

// ---- mbarriers, TMA and wgmma (PTX) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A (box) tile of a 2-D tensor map at coordinates (c0 innermost, c1) into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (rows in groups of 8, 1024 bytes apart), at a 1024-aligned base.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64, the warpgroup's fragment) += a (64 x 8 tf32, registers) *
// b (8 x 64 tf32, K-major in shared memory at desc_b).
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One 128-byte row of a swizzled tile: 16-byte unit u of row r lies at
// unit u ^ (r % 8).
__device__ __forceinline__ int sw128_offset(int r, int col) {
  return r * 128 + ((((col >> 2) ^ (r & 7))) << 4) + (col & 3) * 4;
}

// The products.  kTma: crops by TMA (else by the producer's loads); kTB:
// crops per B tile.  Grid (splits, k chunks, B tiles); block (split, k
// chunk, tile) writes its rows [0, rows) into the (tiles, k chunks, kTB /
// group, splits, group, 64) scratch `partial`, where `group` (4 or 8) is
// the finish kernel's crops per block, so that each finishing block's rows
// of every split lie in one run.
template <bool kTma, int kTB>
__global__ void __launch_bounds__(kThreads, 1)
fused_match_products(const __grid_constant__ CUtensorMap map_crops,
                     const __grid_constant__ CUtensorMap map_mhi,
                     const __grid_constant__ CUtensorMap map_mlo,
                     const float* __restrict__ crops, float* __restrict__ partial, int B, int D,
                     int chunks_per_split, int group) {
  using P = Plan<kTB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* const empty = full + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kc = blockIdx.y, tile = blockIdx.z;
  const int splits = gridDim.x, k_chunks = gridDim.y;
  const int b0 = tile * kTB, j0 = kc * kTileK;
  const int rows = min(kTB, B - b0);
  const int n_chunks_all = (D + kChunk - 1) / kChunk;
  const int c_begin = split * chunks_per_split;
  const int n_chunks = min(chunks_per_split, n_chunks_all - c_begin);

  // The finishing kernel may start its blocks (which first load the
  // gallery) once every block of this one has started.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 32);                // the producer warp's lanes
      mbar_init(&empty[s], kConsumerWarps);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- phase: products ----
  if (warp == kConsumerWarps) {
    // The producer: crop and m tiles of this unit's chunks into the ring.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_mhi))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_mlo))
                   : "memory");
      if (kTma)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_crops))
                     : "memory");
    }
    for (int i = 0; i < n_chunks; ++i) {
      const int stage = i % P::kStages;
      mbar_wait(&empty[stage], ((i / P::kStages) & 1) ^ 1);
      uint8_t* const st = smem + stage * P::kStageBytes;
      const int d0 = (c_begin + i) * kChunk;
      if (lane == 0) {
        mbar_expect_tx(&full[stage], 2 * kMTileBytes + (kTma ? P::kCropBytes : 0));
        tma_load_2d(st + P::kCropBytes, &map_mhi, &full[stage], d0, j0);
        tma_load_2d(st + P::kCropBytes + kMTileBytes, &map_mlo, &full[stage], d0, j0);
        if (kTma) tma_load_2d(st, &map_crops, &full[stage], d0, b0);
      }
      if (!kTma) {
        // Column `lane` of every row, zero past B and D.
        const bool col_ok = d0 + lane < D;
#pragma unroll 8
        for (int r = 0; r < kTB; ++r) {
          const float v = r < rows && col_ok ? crops[(size_t)(b0 + r) * D + d0 + lane] : 0.f;
          *reinterpret_cast<float*>(st + sw128_offset(r, lane)) = v;
        }
      }
      mbar_arrive(&full[stage]);
    }
  } else {
    // The consumers.  A 128-crop tile: warpgroup wg takes rows 64 wg.. of
    // every chunk; a 64-crop tile: both take rows 0..63, wg the chunks of
    // its parity.  Warp q of the group holds rows 16 q..16 q + 15.
    const int wg = warp >> 2, q = warp & 3, g = lane >> 2, t = lane & 3;
    const int wg_row0 = kTB == 128 ? 64 * wg : 0;
    const bool active = wg_row0 < rows;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      const int stage = i % P::kStages;
      mbar_wait(&full[stage], (i / P::kStages) & 1);
      if (active && (kTB == 128 || (i & 1) == wg)) {
        const uint8_t* const st = smem + stage * P::kStageBytes;
        uint32_t ah[4][4], al[4][4];
        const int r = wg_row0 + 16 * q + (lane & 15);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t x[4];
          ldsm_x4(st + r * 128 + (((2 * ks + (lane >> 4)) ^ (r & 7)) << 4), x[0], x[1], x[2],
                  x[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), ah[ks][e], al[ks][e]);
        }
        const uint64_t dh = sw128_desc(st + P::kCropBytes);
        const uint64_t dl = sw128_desc(st + P::kCropBytes + kMTileBytes);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // 32 bytes further along K per step
          wgmma_m64n64k8(acc, al[ks], dh + 2 * ks);
          wgmma_m64n64k8(acc, ah[ks], dl + 2 * ks);
          wgmma_m64n64k8(acc, ah[ks], dh + 2 * ks);
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    // ---- phase: partial ----
    if (kTB == 64) {
      // Both groups are past the ring: group 1's accumulator goes through
      // the ring's first 16 KB and is added after group 0's.
      float* const xfer = reinterpret_cast<float*>(smem);
      const int t128 = tid & 127;
      named_sync(1, kConsumerThreads);
      if (wg == 1) {
#pragma unroll
        for (int e = 0; e < 32; ++e) xfer[e * 128 + t128] = acc[e];
      }
      named_sync(1, kConsumerThreads);
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] += xfer[e * 128 + t128];
      }
    }
    if (active && (kTB == 128 || wg == 0)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg_row0 + 16 * q + 8 * h + g;
        float* const pb =
            partial + ((((size_t)(tile * k_chunks + kc) * (kTB / group) + r / group) * splits +
                        split) * group + r % group) * kTileK;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (r < rows)
            *reinterpret_cast<float2*>(pb + 8 * j + 2 * t) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  // ---- phase: end ----
}


// The finish: kRows (4 or 8) crops per block, grid ceil(B / kRows), 256
// threads.  Each block adds its rows of every D range's partial in
// ascending order (up to `batch` partials at a time, one run of memory,
// copied into shared memory by cp.async in kGroups groups, so that adding
// one group overlaps copying the next), then the bias; squares
// each row's features in a fixed order for its norm; and scores them
// against gallery_t in blocks of kGCols columns on mma.sync, 3xTF32.  The
// scores are taken transposed, columns by crops (m16 by n8): warp w takes
// the k8 steps w, w + 8, ... for every column, its thread loading its own
// gallery fragments from device memory, so that each warp keeps 16
// independent accumulators; the eight warps' dots are then added in warp
// order.  Thread j scores column j of each block for every crop and keeps
// each crop's first-occurrence best.  The first block's gallery
// fragments, norms and mask, and the bias, are loaded before the wait for
// the products, which they do not depend on.  kSmemFeats keeps the crops'
// features in shared memory; otherwise (k too large for it) chunk c's
// features go over the block's first range of chunk c in `partial`, once
// every range of c is added, and are read from there.
template <int kRows, bool kSmemFeats>
__global__ void __launch_bounds__(kFinishThreads)
fused_match_finish(float* partial, const float* __restrict__ bias,
                   const float* __restrict__ gallery_t, const float* __restrict__ gnorm,
                   const float* __restrict__ mask, int* __restrict__ ids,
                   float* __restrict__ conf, int B, int K, int N, int tile_b, int splits,
                   int batch) {
  static_assert((kRows == 4 || kRows == 8) && kGCols == kFinishThreads,
                "at most n8 of crops; a column per thread");
  constexpr int kTiles = kGCols / 16;
  const int k_chunks = (K + kTileK - 1) / kTileK, fp = k_chunks * kTileK + 4;
  extern __shared__ uint8_t smem_raw[];
  float* const sP = reinterpret_cast<float*>(smem_raw);  // partials, then the warps' dots
  float* const sF = sP + finish_stage_floats(batch);     // [8][Kp + 4] where kSmemFeats
  __shared__ float s_fsq[kRows];
  __shared__ float s_fnorm[8];
  __shared__ float s_cand_best[kFinishWarps][kRows];
  __shared__ int s_cand_idx[kFinishWarps][kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kRows, rows = min(kRows, B - b0);
  const int tile = b0 / tile_b, r_in = b0 % tile_b;
  const int row = tid >> 4, col = (tid & 15) * 4;  // this thread's float4 of the sums
  // This block's rows of chunk c's partials: one run of `splits` ranges.
  auto run_of = [&](int c) {
    return partial +
           ((size_t)(tile * k_chunks + c) * (tile_b / kRows) + r_in / kRows) * splits * kRows *
               kTileK;
  };

  // This thread's A fragments of chunk c and columns [n0, n0 + kGCols):
  // gallery_t at k = 64 c + 8 warp + t (and + 4), columns n0 + 16 i + g
  // (and + 8), zero outside; and column n0 + tid's norm and mask.
  float ga[kTiles][4], gv = 0.f, mv = -INFINITY;
  auto load_gallery = [&](int c, int n0) {
    const int k = c * kTileK + 8 * warp + t;
    const float* const r0 = gallery_t + (size_t)k * N;
    const float* const r1 = r0 + 4 * (size_t)N;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int cg = n0 + 16 * i + g;
      ga[i][0] = k < K && cg < N ? r0[cg] : 0.f;
      ga[i][1] = k < K && cg + 8 < N ? r0[cg + 8] : 0.f;
      ga[i][2] = k + 4 < K && cg < N ? r1[cg] : 0.f;
      ga[i][3] = k + 4 < K && cg + 8 < N ? r1[cg + 8] : 0.f;
    }
    const int j = n0 + tid;
    gv = j < N ? gnorm[j] : 0.f;
    mv = j >= N ? -INFINITY : mask != nullptr ? mask[j] : 0.f;
  };
  auto load_bias = [&](int c) {
    const int j = c * kTileK + col;
    return make_float4(j < K ? bias[j] : 0.f, j + 1 < K ? bias[j + 1] : 0.f,
                       j + 2 < K ? bias[j + 2] : 0.f, j + 3 < K ? bias[j + 3] : 0.f);
  };
  // ---- phase: stage ----
  const bool one_block = k_chunks == 1 && N <= kGCols;
  if (one_block) load_gallery(0, 0);
  float4 bv = load_bias(0);
  // Rows kRows.. of the crops' features stay zero.
  if (kSmemFeats)
    for (int e = kRows * fp + tid; e < 8 * fp; e += kFinishThreads) sF[e] = 0.f;
  // ---- phase: wait ----
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the products are written

  // ---- phase: sums ----
  for (int c = 0; c < k_chunks; ++c) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += batch) {
      // Every thread copies its share of each group of splits by 16-byte
      // cp.async, all groups in flight at once; then group after group
      // lands and its splits are added, in ascending order.
      const int n = min(batch, splits - s0), per_group = (n + kGroups - 1) / kGroups;
      constexpr int kPerSplit = kRows * kTileK / 4;  // float4s
      const float4* const src =
          reinterpret_cast<const float4*>(run_of(c) + (size_t)s0 * kRows * kTileK);
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const int first = min(n, gi * per_group), end = min(n, first + per_group);
        for (int e = first * kPerSplit + tid; e < end * kPerSplit; e += kFinishThreads)
          cp_async16(reinterpret_cast<float4*>(sP) + e, src + e, true);
        cp_async_commit();
      }
      auto add = [&](int gi) {
        if (row < rows) {
          const int end = min(n, (gi + 1) * per_group);
#pragma unroll 4
          for (int s = gi * per_group; s < end; ++s) {
            const float4 x = reinterpret_cast<const float4*>(sP)[s * kPerSplit + tid];
            sum.x += x.x;
            sum.y += x.y;
            sum.z += x.z;
            sum.w += x.w;
          }
        }
      };
      static_assert(kGroups == 4, "one wait per group below");
      cp_async_wait<3>();
      __syncthreads();
      add(0);
      cp_async_wait<2>();
      __syncthreads();
      add(1);
      cp_async_wait<1>();
      __syncthreads();
      add(2);
      cp_async_wait<0>();
      __syncthreads();
      add(3);
      __syncthreads();  // sP is free again
    }
    if (row < kRows) {
      if (c > 0) bv = load_bias(c);
      float4 x = make_float4(sum.x + bv.x, sum.y + bv.y, sum.z + bv.z, sum.w + bv.w);
      if (row >= rows) x = make_float4(0.f, 0.f, 0.f, 0.f);
      // Every range of chunk c is added (the last __syncthreads above), so
      // its first range's rows are free.
      *reinterpret_cast<float4*>(kSmemFeats ? sF + row * fp + c * kTileK + col
                                            : run_of(c) + row * kTileK + col) = x;
      float sq = x.x * x.x;
      sq = fmaf(x.y, x.y, sq);
      sq = fmaf(x.z, x.z, sq);
      sq = fmaf(x.w, x.w, sq);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if ((tid & 15) == 0) s_fsq[row] = c == 0 ? sq : s_fsq[row] + sq;
    }
  }
  __syncthreads();
  // ---- phase: norms ----
  if (tid < 8) s_fnorm[tid] = tid < kRows ? sqrtf(s_fsq[tid]) : 0.f;
  __syncthreads();

  // ---- phase: scores ----
  float best[kRows];
  int best_i[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = -INFINITY;
    best_i[r] = INT_MAX;
  }
  float fnorm[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) fnorm[r] = s_fnorm[r];
  float* const dots = sP;  // [warp][column][crop of 8]
  for (int n0 = 0; n0 < N; n0 += kGCols) {
    float acc[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int c = 0; c < k_chunks; ++c) {
      if (!one_block) load_gallery(c, n0);
      if (8 * warp < K - c * kTileK) {
        // B: features of crop g at this warp's k + t and k + t + 4.
        const int k = c * kTileK + 8 * warp + t;
        uint32_t bh[2], bl[2];
        if (kSmemFeats) {
          split_tf32(sF[g * fp + k], bh[0], bl[0]);
          split_tf32(sF[g * fp + k + 4], bh[1], bl[1]);
        } else {
          const float* const f = run_of(c) + g * kTileK + 8 * warp + t;
          split_tf32(g < kRows ? f[0] : 0.f, bh[0], bl[0]);
          split_tf32(g < kRows ? f[4] : 0.f, bh[1], bl[1]);
        }
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(ga[i][e], ah[e], al[e]);
          mma_tf32(acc[i], al, bh);
          mma_tf32(acc[i], ah, bl);
          mma_tf32(acc[i], ah, bh);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dots + (warp * kGCols + 16 * i + g + 8 * h) * 8 + 2 * t) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    __syncthreads();
    // Column n0 + tid: the warps' dots in warp order, then every crop's
    // cosine; columns ascend across blocks, so strict > keeps the first.
    const int colg = n0 + tid;
    float dot[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) dot[r] = 0.f;
    for (int w = 0; w < kFinishWarps; ++w) {
      const float4* const d4 = reinterpret_cast<const float4*>(dots + (w * kGCols + tid) * 8);
      const float4 lo = d4[0], hi = d4[1];
      dot[0] += lo.x;
      dot[1] += lo.y;
      dot[2] += lo.z;
      dot[3] += lo.w;
      dot[4] += hi.x;
      dot[5] += hi.y;
      dot[6] += hi.z;
      dot[7] += hi.w;
    }
    if (colg < N) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float denom = fnorm[r] * gv;  // the plain version's order of operations
        const float v = (denom > 0.f ? dot[r] / denom : 0.f) + mv;
        if (v > best[r]) {
          best[r] = v;
          best_i[r] = colg;
        }
      }
    }
    __syncthreads();  // the dots are read
  }

  // ---- phase: argmax ----
  // Each crop's best over the warp's columns, then over the warps in
  // order; equal values go to the lower column, and a crop with no winner
  // (all -inf) is column 0.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = best[r];
    int vi = best_i[r];
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
      s_cand_best[warp][r] = v;
      s_cand_idx[warp][r] = vi;
    }
  }
  __syncthreads();
  if (tid < rows) {
    float v = s_cand_best[0][tid];
    int vi = s_cand_idx[0][tid];
    for (int w = 1; w < kFinishWarps; ++w)
      if (beats(s_cand_best[w][tid], s_cand_idx[w][tid], v, vi)) {
        v = s_cand_best[w][tid];
        vi = s_cand_idx[w][tid];
      }
    ids[b0 + tid] = vi == INT_MAX ? 0 : vi;
    conf[b0 + tid] = v;
  }
  // ---- phase: end ----
}

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library needs no link to libcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major float32 (rows, cols) matrix at `base` with row pitch `ld`
// floats, read in boxes of (box_rows, 32) into 128-byte-swizzled tiles;
// outside the matrix reads zeros.
bool tensor_map(CUtensorMap* map, const float* base, int rows, int cols, int ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  auto fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

template <bool kTma, int kTB>
cudaError_t launch_products(const CUtensorMap& mc, const CUtensorMap& mh, const CUtensorMap& ml,
                            const float* crops, float* partial, int B, int D, int K,
                            int splits, int chunks_per_split, int group, cudaStream_t stream) {
  auto kernel = fused_match_products<kTma, kTB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (K + kTileK - 1) / kTileK, (B + kTB - 1) / kTB);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(mc, mh, ml, crops, partial, B, D,
                                                 chunks_per_split, group);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Floats of partial scratch: (tiles, k chunks, tile_b / 8, splits, 8, 64).
long long fused_match_partial_floats(int B, int K, int tile_b, int splits) {
  return (long long)((B + tile_b - 1) / tile_b) * ((K + kTileK - 1) / kTileK) * splits * tile_b *
         kTileK;
}


// crops (B, D) float32 row-major; m_hi and m_lo (K, Dp) float32, m's
// transpose split into TF32 hi and lo (Dp >= D a multiple of 4, zero past
// D); bias (K,), gallery_t (K, N), gnorm (N,), mask (N,) or null; partial:
// scratch of fused_match_partial_floats floats; ids (B,) int32 and conf
// (B,) float32 out.  tile_b is 64 or 128; the D chunks (32 floats each) are
// cut into `splits` ranges of chunks_per_split, none of them empty; the
// finish takes finish_rows (4 or 8) crops per block.
// crops_tma nonzero loads the crops by TMA (crops on 16 bytes, D a
// multiple of 4), else by element loads.
// Launches the products and then the finish on `stream`, the second as a
// programmatic dependent launch; does not synchronise; returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes out of range,
// cudaErrorMisalignedAddress for rows that are not aligned,
// cudaErrorNotSupported when the tensor maps cannot be made).
int fused_match_launch(const float* crops, const float* m_hi, const float* m_lo,
                       const float* bias, const float* gallery_t, const float* gnorm,
                       const float* mask, float* partial, int* ids, float* conf, int B, int D,
                       int K, int N, int Dp, int tile_b, int splits, int chunks_per_split,
                       int finish_rows, int crops_tma, cudaStream_t stream) {
  const int n_chunks = (D + kChunk - 1) / kChunk;
  if (B < 1 || D < 1 || K < 1 || N < 1 || (tile_b != 64 && tile_b != 128) || splits < 1 ||
      chunks_per_split < 1 || (splits - 1) * chunks_per_split >= n_chunks ||
      (finish_rows != 4 && finish_rows != 8) ||
      splits * chunks_per_split < n_chunks || Dp < D || Dp % 4 != 0 ||
      (K + kTileK - 1) / kTileK > 65535 || (B + tile_b - 1) / tile_b > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(m_hi) || !aligned16(m_lo) || !aligned16(partial) ||
      (crops_tma && (!aligned16(crops) || D % 4 != 0)))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mc, mh, ml;
  if (!tensor_map(&mh, m_hi, K, Dp, Dp, kTileK) || !tensor_map(&ml, m_lo, K, Dp, Dp, kTileK) ||
      (crops_tma && !tensor_map(&mc, crops, B, D, D, tile_b)))
    return (int)cudaErrorNotSupported;
  if (!crops_tma) mc = mh;  // not read
  cudaError_t err;
  if (tile_b == 64)
    err = crops_tma ? launch_products<true, 64>(mc, mh, ml, crops, partial, B, D, K, splits,
                                                chunks_per_split, finish_rows, stream)
                    : launch_products<false, 64>(mc, mh, ml, crops, partial, B, D, K, splits,
                                                 chunks_per_split, finish_rows, stream);
  else
    err = crops_tma ? launch_products<true, 128>(mc, mh, ml, crops, partial, B, D, K, splits,
                                                 chunks_per_split, finish_rows, stream)
                    : launch_products<false, 128>(mc, mh, ml, crops, partial, B, D, K, splits,
                                                  chunks_per_split, finish_rows, stream);
  if (err != cudaSuccess) return (int)err;

  const bool feats = finish_batch(K, true) >= 1;  // the features fit in shared memory
  auto finish = finish_rows == 4 ? (feats ? fused_match_finish<4, true>
                                          : fused_match_finish<4, false>)
                                 : (feats ? fused_match_finish<8, true>
                                          : fused_match_finish<8, false>);
  const int batch = finish_batch(K, feats);
  const size_t smem = finish_smem(K, batch, feats);
  err = cudaFuncSetAttribute(finish, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((B + finish_rows - 1) / finish_rows);
  config.blockDim = dim3(kFinishThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, finish, partial, bias, gallery_t, gnorm, mask, ids, conf, B,
                           K, N, tile_b, splits, batch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_match_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
