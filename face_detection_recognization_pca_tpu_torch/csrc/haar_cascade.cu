// The Haar cascade's stages for Hopper (sm_90a): one launch per batch.
//
// Replaces no Pallas kernel: the JAX package evaluates the cascade in XLA
// (face_detection_recognization_pca_tpu/detect/haar.py).  In the port it
// takes the place of the card's plain path in detect/haar.py (per level,
// the dense stages as corner gathers and a float64 GEMM; then a nonzero
// compaction and five stage groups, each a gather, a GEMM and a nonzero
// that makes the host wait), about 600 launches a 16-frame 544p batch.
//
// What it computes.  For every window of every level and frame of a batch
// (the level integrals and window norms as detect/haar.py lays them out in
// two flat float64 buffers), whether it passes every stage:
//   rect sum  = sum over the stump's rects of wt * (d - b - c + a), the
//               rect's four integral corners, in float64
//   leaf      = rect sum < threshold * nf ? leaf0 : leaf1   (float64)
//   stage sum = sum of its stumps' leaves >= stage threshold (float64)
// and, per compaction boundary, how many windows of the batch got past it.
// The thresholds, leaves and weights are float32 in the cascade and are
// widened in registers; nothing is computed in float32.  Rect sums are
// added in another order than the GEMM's (as cuBLAS's order is not the
// CPU's).  The stage sums are exact in any order for the packaged
// cascades (tests/test_torch_haar.py checks it), so warp and thread
// evaluation give the same verdicts.
//
// What bounds it (16 frames of 960 x 544, 30 levels, 11.8M windows): a
// window runs every stump of each stage it enters, 594M stump
// evaluations counted stage by stage from the windows past each stage;
// 4 float64 instructions a rect (three corner subtractions and a
// multiply-add) and 3 a stump (threshold times norm, compare, stage
// sum), 6.7e9 instructions, 0.40 ms at the H100 SXM's 16.7e12 float64
// instructions/s (132 SMs x 64 lanes x 1.98 GHz); reading the integrals
// and norms once, 312 MB, 0.1 ms at 3.35 TB/s.  chip_smoke.py reckons it
// per batch.  In practice the reads of the corners from shared memory
// bound it: 8 float64 reads a stump of two rects, each warp-wide read two
// of the SM's 128-byte wavefronts, about 1.3 ms for the dense stages
// alone at 132 SMs.
//
// The design.
//   - Persistent blocks of 256 threads, as many as fit on the card, take
//     tiles of 16 x 16 windows of one level and frame from a counter; the
//     tiles' order and count come from the level table.
//   - A tile's integral rows (up to 55 x 55 float64 for a 24 x 24 window at
//     stride 2) come into shared memory by 8-byte cp.async.  For stride-2
//     levels the tile is stored as four parity planes (even and odd rows
//     by even and odd columns), so that the 16 windows of a row read 16
//     consecutive float64 at every corner: each warp-wide read is two
//     wavefronts, free of bank conflicts.  The corner offsets inside the
//     tile are packed per stump for both strides (ops/haar_cascade.py).
//   - The first stages up to the dense boundary run one window a thread,
//     all 256 windows of the tile; every thread reads the same stump, so
//     each table read is a broadcast.  The stumps of the first stages up
//     to kSharedStumps sit in shared memory, the rest are read by __ldg
//     (about 93 KB for the frontal cascade, held in L1).
//   - At each compaction boundary (the dense boundary, then 5, 8, 12 and
//     the last stage) the tile's survivors are listed in shared memory by
//     ballot and popc, in order.  A list longer than kWarpQueue runs one
//     window a thread; a shorter one runs one window a warp, its lanes
//     over the stage's stumps and the stage sum added across the warp by
//     shuffles, so that the few windows that reach the long tail stages
//     keep every lane busy.  This is the plain path's breadth-first
//     schedule, kept on chip; a window leaves at its first failed stage.
//   - Block-aggregated 64-bit atomics count the windows past each
//     boundary; the wrapper copies the counts to the host with the rows.
//   - One byte a window, written for every window of the tile, says
//     whether it passed; one nonzero on the host side lists them in level,
//     frame, y, x order.
// Any stump cascade of up to 3 rects a stump and float32 weights, any
// window size whose tile fits in shared memory, strides 1 and 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // windows per tile side
constexpr int kThreads = kTile * kTile;    // one window a thread in the first stages
constexpr int kWarps = kThreads / 32;
constexpr int kWarpQueue = 64;             // survivors up to this many: one window a warp
constexpr int kSharedStumps = 160;         // stumps of the first stages kept in shared memory
// The level table's rows, each n_levels long: int_start, win_start, frame_stride, ny, nx, step,
// w1, tile_start.
enum LevelField { kIntStart, kWinStart, kFrameStride, kNy, kNx, kStep, kW1, kTileStart };

struct Params {
  const double* integrals;
  const double* norms;
  const long long* levels;     // (8, n_levels): the LevelField rows
  const float4* common;        // (n_stumps, 2): weights[3], threshold | leaf0, leaf1, rect count, 0
  const int4* offsets;         // (2, n_stumps, 3): per stride, each rect's corners a, b, c, d
  const int4* stages;          // (n_stages,): first stump, end stump, threshold bits, 0
  const int* bounds;           // (n_bounds,): the stage after which each compaction falls
  unsigned char* passed;       // one byte a window
  unsigned long long* counts;  // (n_bounds + 1,): windows past each boundary; then the tile counter
  long long tiles;
  int n_levels, n_stumps, n_stages, n_bounds;
  int wh, ww;
  int plane_rows[2], plane_cols[2];  // per stride: the rows and columns of one parity plane
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// The leaf of stump k for the window whose patch starts at `win` in the tile.
template <bool kGlobal>
__device__ __forceinline__ double stump_leaf(const float4* common, const int4* offs, int k,
                                             const double* win, double nf) {
  const float4 a = load<kGlobal>(common + 2 * k);
  const float4 b = load<kGlobal>(common + 2 * k + 1);
  const int n = __float_as_int(b.z);
  const int4 r0 = load<kGlobal>(offs + 3 * k);
  double sum = (double)a.x * ((win[r0.w] - win[r0.y]) - (win[r0.z] - win[r0.x]));
  if (n > 1) {
    const int4 r1 = load<kGlobal>(offs + 3 * k + 1);
    sum += (double)a.y * ((win[r1.w] - win[r1.y]) - (win[r1.z] - win[r1.x]));
  }
  if (n > 2) {
    const int4 r2 = load<kGlobal>(offs + 3 * k + 2);
    sum += (double)a.z * ((win[r2.w] - win[r2.y]) - (win[r2.z] - win[r2.x]));
  }
  return sum < (double)a.w * nf ? (double)b.x : (double)b.y;
}

struct Table {
  const float4* sh_common;  // the first stages' stumps in shared memory
  const int4* sh_offs;      // their corner offsets for this tile's stride
  int n_sh_stages;          // stages wholly in shared memory
  const int4* offs;         // every stump's corner offsets for this stride, in device memory
};

// The sum of stage s's leaves over stumps first + lane0, first + lane0 + step, ...
__device__ __forceinline__ double stage_sum(const Params& p, const Table& t, int s, int4 st,
                                            int lane0, int step, const double* win, double nf) {
  double sum = 0.0;
  if (s < t.n_sh_stages) {
    for (int k = st.x + lane0; k < st.y; k += step)
      sum += stump_leaf<false>(t.sh_common, t.sh_offs, k, win, nf);
  } else {
    for (int k = st.x + lane0; k < st.y; k += step)
      sum += stump_leaf<true>(p.common, t.offs, k, win, nf);
  }
  return sum;
}

// One thread, one window: stages lo..hi-1, leaving at the first failed one.
__device__ __forceinline__ bool thread_passes(const Params& p, const Table& t, int lo, int hi,
                                              const double* win, double nf) {
  for (int s = lo; s < hi; ++s) {
    const int4 st = __ldg(p.stages + s);
    if (stage_sum(p, t, s, st, 0, 1, win, nf) < (double)__int_as_float(st.z)) return false;
  }
  return true;
}

// One warp, one window: each lane takes every 32nd stump of a stage and the
// warp adds the lanes' sums; every lane holds the same sum and verdict.
__device__ __forceinline__ bool warp_passes(const Params& p, const Table& t, int lo, int hi,
                                            const double* win, double nf) {
  const int lane = threadIdx.x & 31;
  for (int s = lo; s < hi; ++s) {
    const int4 st = __ldg(p.stages + s);
    double sum = stage_sum(p, t, s, st, lane, 32, win, nf);
    for (int m = 16; m; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (sum < (double)__int_as_float(st.z)) return false;
  }
  return true;
}

// Lists, in order, the entries i < n whose keep[i] is set: in[i] (or i where
// in is null) into out.  Every thread returns the count.
__device__ __forceinline__ int compact(const unsigned char* in, int n, const unsigned char* keep,
                                       unsigned char* out, int* warp_count) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  __syncthreads();
  const bool k = t < n && keep[t];
  const unsigned m = __ballot_sync(0xffffffffu, k);
  if (lane == 0) warp_count[warp] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (k) out[before + __popc(m & ((1u << lane) - 1u))] = in ? in[t] : (unsigned char)t;
  __syncthreads();
  return total;
}

struct Shared {
  double nf[kThreads];
  unsigned char queue[2][kThreads];
  unsigned char keep[kThreads];
  int warp_count[kWarps];
  long long tile[4];  // level, frame, first window row, first window column; level -1: done
};

__device__ __forceinline__ long long level_field(const Params& p, int l, LevelField f) {
  return p.levels[f * p.n_levels + l];
}

// Stride S: the tile of windows (iy0.., ix0..) of frame b of level l.
template <int S>
__device__ __forceinline__ void run_tile(const Params& p, Shared& sh, const Table& table,
                                         double* tile, int l, int b, int iy0, int ix0) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long int_start = level_field(p, l, kIntStart), win_start = level_field(p, l, kWinStart);
  const long long frame_stride = level_field(p, l, kFrameStride);
  const int ny = (int)level_field(p, l, kNy), nx = (int)level_field(p, l, kNx);
  const int w1 = (int)level_field(p, l, kW1);
  const int pr = p.plane_rows[S - 1], pc = p.plane_cols[S - 1];
  const int vy = min(kTile, ny - iy0), vx = min(kTile, nx - ix0);
  const int rows = (vy - 1) * S + p.wh + 1, cols = (vx - 1) * S + p.ww + 1;

  // Integral element (r, c) of the tile goes to parity plane (r % S, c % S)
  // at (r / S, c / S): ops/haar_cascade.corner_offset.
  const double* src = p.integrals + int_start + b * frame_stride + (long long)iy0 * S * w1 +
                      (long long)ix0 * S;
  for (int r = warp; r < rows; r += kWarps) {
    double* drow = tile + (r % S) * S * pr * pc + (r / S) * pc;
    const double* srow = src + (long long)r * w1;
    for (int c = lane; c < cols; c += 32) cp_async8(drow + (c % S) * pr * pc + c / S, srow + c);
  }
  const int i = t / kTile, j = t % kTile;
  const bool valid = i < vy && j < vx;
  const long long win = win_start + ((long long)b * ny + iy0 + i) * nx + ix0 + j;
  sh.nf[t] = valid ? p.norms[win] : 1.0;
  cp_async_wait_all();
  __syncthreads();

  // The first stages, one window a thread.
  const int first = __ldg(p.bounds);
  sh.keep[t] = valid && thread_passes(p, table, 0, first, tile + i * pc + j, sh.nf[t]);
  int n = compact(nullptr, kThreads, sh.keep, sh.queue[0], sh.warp_count);
  if (t == 0 && n) atomicAdd(p.counts, (unsigned long long)n);
  int cur = 0;
  for (int g = 1; g < p.n_bounds && n > 0; ++g) {
    const int lo = __ldg(p.bounds + g - 1), hi = __ldg(p.bounds + g);
    if (n > kWarpQueue) {
      if (t < n) {
        const int w = sh.queue[cur][t];
        sh.keep[t] = thread_passes(p, table, lo, hi, tile + (w / kTile) * pc + w % kTile, sh.nf[w]);
      }
    } else {
      for (int e = warp; e < n; e += kWarps) {
        const int w = sh.queue[cur][e];
        const bool ok = warp_passes(p, table, lo, hi, tile + (w / kTile) * pc + w % kTile, sh.nf[w]);
        if (lane == 0) sh.keep[e] = ok;
      }
    }
    n = compact(sh.queue[cur], n, sh.keep, sh.queue[cur ^ 1], sh.warp_count);
    cur ^= 1;
    if (t == 0 && n) atomicAdd(p.counts + g, (unsigned long long)n);
  }

  // n > 0 only when the last boundary (the last stage) was passed.
  sh.keep[t] = 0;
  __syncthreads();
  if (t < n) sh.keep[sh.queue[cur][t]] = 1;
  __syncthreads();
  if (valid) p.passed[win] = sh.keep[t];
}

__global__ void __launch_bounds__(kThreads, 4) haar_cascade_stages(const Params p) {
  extern __shared__ __align__(16) double tile[];
  __shared__ Shared sh;
  __shared__ float4 sh_common[2 * kSharedStumps];
  __shared__ int4 sh_offs[2][3 * kSharedStumps];
  __shared__ int n_sh_stages;
  const int t = threadIdx.x;

  if (t == 0) {
    int k = 0;
    while (k < p.n_stages && __ldg(p.stages + k).y <= kSharedStumps) ++k;
    n_sh_stages = k;
  }
  __syncthreads();
  const int n_sh = n_sh_stages ? __ldg(p.stages + n_sh_stages - 1).y : 0;
  for (int i = t; i < 2 * n_sh; i += kThreads) sh_common[i] = __ldg(p.common + i);
  for (int s = 0; s < 2; ++s)
    for (int i = t; i < 3 * n_sh; i += kThreads)
      sh_offs[s][i] = __ldg(p.offsets + (long long)s * 3 * p.n_stumps + i);

  for (;;) {
    if (t == 0) {
      const long long k = (long long)atomicAdd(p.counts + p.n_bounds, 1ull);
      sh.tile[0] = -1;
      if (k < p.tiles) {
        int l = 0;
        while (l + 1 < p.n_levels && level_field(p, l + 1, kTileStart) <= k) ++l;
        const long long tiles_x = (level_field(p, l, kNx) + kTile - 1) / kTile;
        const long long tiles_y = (level_field(p, l, kNy) + kTile - 1) / kTile;
        const long long local = k - level_field(p, l, kTileStart), per_frame = tiles_x * tiles_y;
        const long long rest = local % per_frame;
        sh.tile[0] = l;
        sh.tile[1] = local / per_frame;
        sh.tile[2] = rest / tiles_x * kTile;
        sh.tile[3] = rest % tiles_x * kTile;
      }
    }
    __syncthreads();
    const int l = (int)sh.tile[0];
    if (l < 0) break;
    const int b = (int)sh.tile[1], iy0 = (int)sh.tile[2], ix0 = (int)sh.tile[3];
    if (level_field(p, l, kStep) == 1) {
      const Table table{sh_common, sh_offs[0], n_sh_stages, p.offsets};
      run_tile<1>(p, sh, table, tile, l, b, iy0, ix0);
    } else {
      const Table table{sh_common, sh_offs[1], n_sh_stages, p.offsets + 3ll * p.n_stumps};
      run_tile<2>(p, sh, table, tile, l, b, iy0, ix0);
    }
    __syncthreads();
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// integrals and norms: the batch's float64 level integrals and window norms
// (detect/haar.py's layout); levels: (8, n_levels) int64 on the device
// (ops/haar_cascade.level_table), `tiles` tiles of tile x tile windows in
// all; common (n_stumps, 8) float32, offsets (2, n_stumps, 12) int32,
// stages (n_stages, 4) int32, bounds (n_bounds,) int32
// (ops/haar_cascade.pack_cascade); passed: one byte per window out;
// counts: n_bounds + 1 int64 of scratch, the first n_bounds the windows
// past each boundary out.  wh x ww is the cascade's window; `tile` must be
// this file's kTile.  Zeroes the counts and launches the kernel on
// `stream`; does not synchronise; returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments out of range, also a window whose
// tile does not fit in shared memory; cudaErrorMisalignedAddress for
// tables not on 16 bytes).
int haar_cascade_launch(const double* integrals, const double* norms, const long long* levels,
                        int n_levels, long long tiles, const float* common, const int* offsets,
                        int n_stumps, const int* stages, int n_stages, const int* bounds,
                        int n_bounds, int wh, int ww, int tile, unsigned char* passed,
                        long long* counts, cudaStream_t stream) {
  if (tile != kTile || n_levels < 1 || tiles < 1 || n_stumps < 1 || n_stages < 1 ||
      n_bounds < 1 || wh < 1 || ww < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(common) || !aligned16(offsets) || !aligned16(stages))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.integrals = integrals;
  p.norms = norms;
  p.levels = levels;
  p.common = reinterpret_cast<const float4*>(common);
  p.offsets = reinterpret_cast<const int4*>(offsets);
  p.stages = reinterpret_cast<const int4*>(stages);
  p.bounds = bounds;
  p.passed = passed;
  p.counts = reinterpret_cast<unsigned long long*>(counts);
  p.tiles = tiles;
  p.n_levels = n_levels;
  p.n_stumps = n_stumps;
  p.n_stages = n_stages;
  p.n_bounds = n_bounds;
  p.wh = wh;
  p.ww = ww;
  size_t smem = 0;
  for (int s = 1; s <= 2; ++s) {
    p.plane_rows[s - 1] = ((kTile - 1) * s + wh + 1 + s - 1) / s;
    p.plane_cols[s - 1] = ((kTile - 1) * s + ww + 1 + s - 1) / s;
    const size_t bytes = (size_t)s * s * p.plane_rows[s - 1] * p.plane_cols[s - 1] * sizeof(double);
    smem = bytes > smem ? bytes : smem;
  }
  cudaError_t err = cudaFuncSetAttribute(haar_cascade_stages,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, haar_cascade_stages, kThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)per_sm * sms < tiles ? (long long)per_sm * sms : tiles;
  if ((err = cudaMemsetAsync(counts, 0, sizeof(long long) * (n_bounds + 1), stream)) != cudaSuccess)
    return (int)err;
  haar_cascade_stages<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

const char* haar_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
