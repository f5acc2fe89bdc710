// The tracker's TM_CCOEFF_NORMED locate for Hopper (sm_90a): one launch per step.
//
// Replaces no Pallas kernel: the JAX package computes the numerator as XLA
// DFT-as-matmul (face_detection_recognization_pca_tpu/ops/dft_match.py) and
// the statistics, scores and argmax in XLA (its parallel/multistream.py).  In
// the port it takes the place of the plain route of
// parallel/multistream.locate_and_match on the card: centring, the twelve
// float32 DFT matmuls of ops/dft_match.make_circular_correlator, the four
// banded box-sum products and the elementwise epilogue and argmax, about 50
// launches a step whose intermediates of S x 192 x 192 go through device
// memory.
//
// What it computes, per window b of the step (S windows of win x win float32
// raw pixels, the step's 0-d mean mu, a template of tpl x tpl whose centred
// spectrum ops/ncc_locate.template_spectrum made once):
//   w        = window - mu                                    (float32)
//   num(y,x) = sum_uv w(y+u, x+v) t0(u, v)   by a 2-D FFT of w zero-padded
//              to m x m, times conj(T0), pruned inverse         (float32)
//   s1, s2   = box sums of w and w^2 over tpl x tpl            (float64)
//   var_n    = float32(s2 - s1^2 / n), at least 0,   n = tpl^2
//   score    = var_n > n ? clamp(num / sqrt(t_energy * var_n), -1, 1) : 0,
//              the division taken as num times 1 / sqrt(t_energy * var_n)
//   (ly, lx, conf) = the first maximum of score in y * out + x order, out =
//              win - tpl + 1, as torch.argmax takes it (a NaN counts as the
//              largest).
// Everything is float32 but the box sums, which are float64 (exact enough
// that s2 - s1^2/n does not cancel); no TF32 and no tensor cores.  Twiddles
// come from sincospi in float64.  A window's result depends on that window
// alone, so it is the same at any place in any batch.
//
// What bounds it (S 512, win 192, tpl 96): reading the windows once, 75.5 MB,
// 22.6 us at 3.35 TB/s; the arithmetic (two real FFTs of 192^2, the spectrum
// product, box sums and scores, 3.19 MFLOP a window) is 1.6 us at the card's
// 989 TFLOP/s.  In practice its instruction throughput bounds it, one block an
// SM: a window's 339 transforms of 192 points take 60 shuffles each, and the
// box sums' prefix scans and denominators about a fifth of its time, by
// clock64() read at each phase mark below.
//
// The design: one block of 384 threads per window, the m x (m/2 + 1) complex
// half-spectrum plane in dynamic shared memory, m = 192 for every window (a
// smaller one is zero-padded to it; row pitch m + 2 floats, 776 B, so a warp
// reading a column hits every bank once).
//   1. The window's rows come in by 16-byte loads, centred on mu in registers
//      as they arrive, into the plane's rows (zero beyond win).
//   2. The box sums from the plane: each thread slides one column's sums of
//      w and w^2 down the rows in float64, a chunk of kRows output rows at a
//      time into a float64 scratch; then each warp takes one row's prefix sum
//      and differences it.  Each score's reciprocal denominator (out x out
//      float32, 0 where var_n <= n) stays in shared memory.
//   3. The FFT of m = 192 = 32 x 6 points runs in one warp: a lane holds 6
//      points, the 6-point DFT is done in registers and the 32-point one
//      across lanes by shuffles.  Row pairs go as one complex transform
//      (rows 2p and 2p+1 as real and imaginary parts) and are split into
//      their half spectra in place.
//   4. Each of the m/2 + 1 columns is read once: its forward transform, the
//      product with the template's conjugate spectrum (read from L2, laid out
//      in the order the transform leaves the points in a warp), and its
//      inverse, all in registers; only the out rows the scores need go back.
//   5. The rows' inverse (pairs again, as one complex transform of the two
//      half spectra), only the out x out valid corner scored, in registers,
//      with the reciprocal denominators, each lane keeping its best.
//   6. The block's first maximum by shuffles and one pass over the warps.
// Shared memory at m 192, out 97: 36,864 B of box-sum scratch, 148,992 of
// plane, 37,636 of denominators: one block per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * kLanes;
constexpr int kRows = 12;   // box-sum output rows per pass, one warp each
constexpr int kR = 6;                // points a lane holds in a transform
constexpr int kM = kLanes * kR;      // the plane's side: every window is zero-padded to it
constexpr int kMaxOut = 128;         // the most scores a side; shared memory leaves room for 107
constexpr int kOutSteps = kMaxOut / kLanes;  // steps of 32 a warp takes over a row of scores
static_assert(kRows <= kWarps && kM <= kThreads, "a warp per row, a thread per column");

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
// a times S * i.
template <int S>
__device__ __forceinline__ float2 rot(float2 a) {
  return S > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 shfl_xor(float2 a, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, a.x, m), __shfl_xor_sync(0xffffffffu, a.y, m));
}
__device__ __forceinline__ float2 shfl(float2 a, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, a.x, lane), __shfl_sync(0xffffffffu, a.y, lane));
}

constexpr float kSin60 = 0.8660254037844386f;

// X[k] = sum_n x[n] exp(S 2 pi i n k / 3), in place.
template <int S>
__device__ __forceinline__ void dft3(float2& a, float2& b, float2& c) {
  const float2 t1 = cadd(b, c);
  const float2 t2 = make_float2(a.x - 0.5f * t1.x, a.y - 0.5f * t1.y);
  const float2 d = csub(b, c);
  const float2 r = rot<S>(make_float2(kSin60 * d.x, kSin60 * d.y));
  a = cadd(a, t1);
  b = cadd(t2, r);
  c = csub(t2, r);
}

// The 6-point DFT of v in registers, sign S, natural order in and out:
// 6 = 2 x 3, n = 3 na + nb, k = ka + 2 kb.
template <int S>
__device__ __forceinline__ void dft6(float2 (&v)[kR]) {
  float2 a[3], b[3];
#pragma unroll
  for (int nb = 0; nb < 3; ++nb) {
    a[nb] = cadd(v[nb], v[nb + 3]);
    b[nb] = csub(v[nb], v[nb + 3]);
  }
  b[1] = cmul(b[1], make_float2(0.5f, S * kSin60));   // exp(S 2 pi i / 6)
  b[2] = cmul(b[2], make_float2(-0.5f, S * kSin60));  // exp(S 2 pi i 2 / 6)
  dft3<S>(a[0], a[1], a[2]);
  dft3<S>(b[0], b[1], b[2]);
  v[0] = a[0];
  v[2] = a[1];
  v[4] = a[2];
  v[1] = b[0];
  v[3] = b[1];
  v[5] = b[2];
}

// A lane's twiddles for the forward sign; the inverse takes their conjugates.
// For each exchange across lanes at distance h, the lane's side: -1 where
// its bit h is set (the pair's upper point), 1 where not, and the pair's
// twiddle for the upper point, 1 for the lower.
struct Twiddles {
  float2 m[kR];   // exp(-2 pi i lane k1 / m), k1 < 6
  float2 pair[4]; // upper: exp(-pi i (lane & (h - 1)) / h), for h = 2, 4, 8, 16; lower: 1
  float side[5];  // h = 1, 2, 4, 8, 16
};

// The lane's twiddles, read from `table`: exp(-2 pi i e / m) for e < m.
__device__ __forceinline__ Twiddles twiddles(const float2* table, int lane) {
  Twiddles tw;
  constexpr int m = kM;
#pragma unroll
  for (int k1 = 0; k1 < kR; ++k1) tw.m[k1] = table[(lane * k1) % m];
#pragma unroll
  for (int b = 1; b <= 4; ++b) {
    const int h = 1 << b;  // exp(-pi i j / h) = table[j m / (2 h)]
    tw.pair[b - 1] = lane & h ? table[(lane & (h - 1)) * (m / (2 * h))] : make_float2(1.0f, 0.0f);
  }
#pragma unroll
  for (int b = 0; b <= 4; ++b) tw.side[b] = lane & (1 << b) ? -1.0f : 1.0f;
  return tw;
}

template <int S>
__device__ __forceinline__ float2 signed_tw(float2 w) { return S < 0 ? w : cconj(w); }

// The m-point DFT (m = 32 x 6) of the warp's points, sign S.  In: lane l holds
// x[32 n1 + l] in v[n1].  Out: lane l holds X[k1 + 6 brev5(l)] in v[k1].
template <int S>
__device__ __forceinline__ void fft_natural_in(float2 (&v)[kR], const Twiddles& tw) {
  dft6<S>(v);
#pragma unroll
  for (int k1 = 1; k1 < kR; ++k1) v[k1] = cmul(v[k1], signed_tw<S>(tw.m[k1]));
  // Decimation in frequency across the lanes, halves of 16, 8, 4, 2, 1: the
  // lower point becomes lo + hi, the upper (lo - hi) w.
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    const float side = tw.side[b];
#pragma unroll
    for (int k1 = 0; k1 < kR; ++k1) {
      const float2 p = shfl_xor(v[k1], 1 << b);
      const float2 d = make_float2(fmaf(side, v[k1].x, p.x), fmaf(side, v[k1].y, p.y));
      v[k1] = b == 0 ? d : cmul(d, signed_tw<S>(tw.pair[b - 1]));
    }
  }
}

// The m-point DFT of the warp's points, sign S.  In: lane l holds
// y[k1 + 6 brev5(l)] in v[k1].  Out: lane l holds Y[32 n1 + l] in v[n1].
template <int S>
__device__ __forceinline__ void fft_natural_out(float2 (&v)[kR], const Twiddles& tw) {
  // Decimation in time across the lanes, halves of 1, 2, 4, 8, 16: with t =
  // hi w, the lower point becomes lo + t, the upper lo - t.
#pragma unroll
  for (int b = 0; b <= 4; ++b) {
    const float side = tw.side[b];
#pragma unroll
    for (int k1 = 0; k1 < kR; ++k1) {
      const float2 t = b == 0 ? v[k1] : cmul(v[k1], signed_tw<S>(tw.pair[b - 1]));
      const float2 q = shfl_xor(t, 1 << b);
      v[k1] = make_float2(fmaf(side, t.x, q.x), fmaf(side, t.y, q.y));
    }
  }
#pragma unroll
  for (int k1 = 1; k1 < kR; ++k1) v[k1] = cmul(v[k1], signed_tw<S>(tw.m[k1]));
  dft6<S>(v);
}

__device__ __forceinline__ int brev5(int lane) { return (int)(__brev((unsigned)lane) >> 27); }

// torch.argmax's order: the larger score, a NaN above any number, then the
// smaller flat index.
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  if (isnan(s)) return !isnan(bs) || i < bi;
  if (isnan(bs)) return false;
  return s > bs || (s == bs && i < bi);
}

struct Params {
  const float* windows;   // (S, win, win)
  const float* mean;      // 0-d
  const float2* spectrum; // (m/2 + 1, 6, 32): conj(T0) / (2 m^2) in the column passes' order
  const float* t_energy;  // 0-d
  int* ly;
  int* lx;
  float* conf;
  int win, tpl, out;
};

__global__ void __launch_bounds__(kThreads, 1) ncc_locate_kernel(const Params p) {
  constexpr int m = kM;
  constexpr int pitch = m + 2;     // floats per plane row: m/2 + 1 complex
  constexpr int cpitch = pitch / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sums = reinterpret_cast<double*>(smem);                    // (2, kRows, m)
  float* plane = reinterpret_cast<float*>(sums + 2 * kRows * m);    // (m, pitch)
  float* rden = plane + m * pitch;                                   // (out, out)
  float* best_s = rden + p.out * p.out;                              // (kWarps,)
  int* best_i = reinterpret_cast<int*>(best_s + kWarps);             // (kWarps,)

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int win = p.win, tpl = p.tpl, out = p.out;
  const float mu = __ldg(p.mean);
  const float* src = p.windows + (size_t)blockIdx.x * win * win;

  // ---- 1. the window, centred, into the plane; zero beyond win.
  if ((win & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q = win / 4, n4 = win * q;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    constexpr int kBatch = 8;
    for (int e0 = t; e0 < n4; e0 += kBatch * kThreads) {
      float4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * kThreads;
        if (e < n4) v[i] = __ldg(src4 + e);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * kThreads;
        if (e < n4) {
          float2* d = reinterpret_cast<float2*>(plane + (e / q) * pitch + 4 * (e % q));
          d[0] = make_float2(v[i].x - mu, v[i].y - mu);
          d[1] = make_float2(v[i].z - mu, v[i].w - mu);
        }
      }
    }
  } else {
    for (int e = t; e < win * win; e += kThreads) plane[(e / win) * pitch + e % win] = src[e] - mu;
  }
  if (win < m) {
    for (int e = t; e < m * m; e += kThreads) {
      const int r = e / m, c = e % m;
      if (r >= win || c >= win) plane[r * pitch + c] = 0.0f;
    }
  }
  __syncthreads();

  // ---- 2. box sums and each score's reciprocal denominator, kRows output rows at a time.
  const float t_energy = __ldg(p.t_energy);
  {
    // Thread j slides column j's sums of w and w^2 down the rows, in float64.
    const int j = t;
    const bool active = j < win;
    double acc1 = 0.0, acc2 = 0.0;
    if (active) {
      double a1[4] = {0.0, 0.0, 0.0, 0.0}, a2[4] = {0.0, 0.0, 0.0, 0.0};
      int r = 0;
      for (; r + 4 <= tpl; r += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double w = plane[(r + i) * pitch + j];
          a1[i] += w;
          a2[i] += w * w;
        }
      }
      for (; r < tpl; ++r) {
        const double w = plane[r * pitch + j];
        a1[0] += w;
        a2[0] += w * w;
      }
      acc1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
      acc2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
    }
    const double inv_n = 1.0 / ((double)tpl * tpl);
    const float n_f = (float)(tpl * tpl);
    for (int y0 = 0; y0 < out; y0 += kRows) {
      if (active) {
        // The chunk's row differences first (rows past out repeat the last), then their sums.
        double d1[kRows], d2[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int y = min(y0 + i, out - 1);
          const double a = plane[(y + tpl - 1) * pitch + j], b = plane[max(y - 1, 0) * pitch + j];
          d1[i] = y > 0 ? a - b : 0.0;
          d2[i] = y > 0 ? a * a - b * b : 0.0;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc1 += d1[i];
          acc2 += d2[i];
          if (y0 + i < out) {
            sums[i * m + j] = acc1;
            sums[(kRows + i) * m + j] = acc2;
          }
        }
      }
      __syncthreads();
      const int y = y0 + warp;
      if (warp < kRows && y < out) {
        // Each lane's 6 consecutive columns, then the row's inclusive prefix.
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          double* row = sums + (s * kRows + warp) * m;
          double v[kR];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const int c = kR * lane + i;
            v[i] = c < win ? row[c] : 0.0;
            if (i) v[i] += v[i - 1];
          }
          double before = v[kR - 1];
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const double o = __shfl_up_sync(0xffffffffu, before, d);
            if (lane >= d) before += o;
          }
          before -= v[kR - 1];
#pragma unroll
          for (int i = 0; i < kR; ++i) row[kR * lane + i] = v[i] + before;
        }
        __syncwarp();
        const double* p1 = sums + warp * m;
        const double* p2 = sums + (kRows + warp) * m;
        // rden = 1 / sqrt(t_energy var_n) where var_n > n, else 0 (the score-0 rule).
#pragma unroll
        for (int i = 0; i < kOutSteps; ++i) {
          const int x = lane + 32 * i, xc = min(x, out - 1);
          const double s1 = p1[xc + tpl - 1] - (xc ? p1[xc - 1] : 0.0);
          const double s2 = p2[xc + tpl - 1] - (xc ? p2[xc - 1] : 0.0);
          float var = (float)(s2 - s1 * s1 * inv_n);
          var = var < 0.0f ? 0.0f : var;
          const float r = var > n_f ? 1.0f / sqrtf(t_energy * var) : 0.0f;
          if (x < out) rden[y * out + x] = r;
        }
      }
      __syncthreads();
    }
  }

  // The twiddles from float64, once per block, into the box sums' scratch.
  float2* table = reinterpret_cast<float2*>(sums);
  if (t < m) {
    double s, c;
    sincospi(-2.0 * t / m, &s, &c);
    table[t] = make_float2((float)c, (float)s);
  }
  __syncthreads();
  const Twiddles tw = twiddles(table, lane);

  // ---- 3. rows 2p and 2p+1 as one complex transform, split into their half spectra.
  for (int pr = warp; pr < m / 2; pr += kWarps) {
    float* ra = plane + 2 * pr * pitch;
    float* rb = ra + pitch;
    float2 v[kR];
    const int base = kR * brev5(lane);
#pragma unroll
    for (int k1 = 0; k1 < kR; ++k1) v[k1] = make_float2(ra[base + k1], rb[base + k1]);
    __syncwarp();
    fft_natural_out<-1>(v, tw);  // v[n1] = Z[32 n1 + lane]
    float2 mirror[kR];                     // Z[m - k] is at lane -k mod 32
#pragma unroll
    for (int r = 0; r < kR; ++r) mirror[r] = shfl(v[r], (32 - lane) & 31);
#pragma unroll
    for (int n1 = 0; n1 < kR; ++n1) {
      const int k = 32 * n1 + lane;
      if (k <= m / 2) {
        const float2 z = v[n1];
        const float2 q = lane ? mirror[kR - 1 - n1] : mirror[(kR - n1) % kR];
        // 2 A[k] = Z[k] + conj(Z[m-k]), 2 B[k] = -i (Z[k] - conj(Z[m-k])); the 1/2 is in the spectrum.
        reinterpret_cast<float2*>(ra)[k] = make_float2(z.x + q.x, z.y - q.y);
        reinterpret_cast<float2*>(rb)[k] = make_float2(z.y + q.y, q.x - z.x);
      }
    }
  }
  __syncthreads();

  // ---- 4. each column: forward, times the template's spectrum, inverse; out rows back.
  for (int c = warp; c <= m / 2; c += kWarps) {
    float2* col = reinterpret_cast<float2*>(plane) + c;
    float2 v[kR];
#pragma unroll
    for (int n1 = 0; n1 < kR; ++n1) v[n1] = col[(32 * n1 + lane) * cpitch];
    fft_natural_in<-1>(v, tw);
    const float2* spec = p.spectrum + (size_t)c * m + lane;
#pragma unroll
    for (int k1 = 0; k1 < kR; ++k1) v[k1] = cmul(v[k1], __ldg(spec + 32 * k1));
    fft_natural_out<1>(v, tw);
#pragma unroll
    for (int n1 = 0; n1 < kR; ++n1) {
      const int r = 32 * n1 + lane;
      if (r < out) col[r * cpitch] = v[n1];
    }
  }
  __syncthreads();

  // ---- 5. rows 2q and 2q+1 back to real numerators, scored, each lane's best kept.
  float bs = -INFINITY;
  int bi = 0x7fffffff;
  for (int q = warp; 2 * q < out; q += kWarps) {
    const float2* za = reinterpret_cast<const float2*>(plane + 2 * q * pitch);
    const float2* zb = za + cpitch;
    const bool has_b = 2 * q + 1 < out;
    float2 v[kR];
#pragma unroll
    for (int n1 = 0; n1 < kR; ++n1) {
      const int k = 32 * n1 + lane;
      float2 a, b = make_float2(0.0f, 0.0f);
      if (k <= m / 2) {
        a = za[k];
        if (has_b) b = zb[k];
      } else {
        a = cconj(za[m - k]);
        if (has_b) b = cconj(zb[m - k]);
      }
      v[n1] = make_float2(a.x - b.y, a.y + b.x);  // A + i B
    }
    fft_natural_in<1>(v, tw);  // v[k1] = num(2q, x) + i num(2q+1, x), x = k1 + 6 brev5(lane)
    const int base = kR * brev5(lane);
    float sc[2][kR];
#pragma unroll
    for (int k1 = 0; k1 < kR; ++k1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = base + k1, y = 2 * q + h;
        const bool valid = x < out && (h == 0 || has_b);
        const float d = valid ? rden[y * out + x] : 0.0f;
        float s = d != 0.0f ? (h ? v[k1].y : v[k1].x) * d : 0.0f;
        s = s < -1.0f ? -1.0f : (s > 1.0f ? 1.0f : s);  // keeps a NaN, as torch.clamp does
        sc[h][k1] = valid ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < kR; ++k1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (2 * q + h) * out + base + k1;
        if (sc[h][k1] != -INFINITY && beats(sc[h][k1], i, bs, bi)) {
          bs = sc[h][k1];
          bi = i;
        }
      }
    }
  }

  // ---- 6. the block's first maximum.
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, bs, d);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, d);
    if (beats(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_s[warp] = bs;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (beats(best_s[w], best_i[w], bs, bi)) {
        bs = best_s[w];
        bi = best_i[w];
      }
    }
    p.ly[blockIdx.x] = bi / out;
    p.lx[blockIdx.x] = bi % out;
    p.conf[blockIdx.x] = bs;
  }
}

size_t smem_bytes(int out) {
  return sizeof(double) * 2 * kRows * kM + sizeof(float) * kM * (kM + 2) +
         sizeof(float) * out * out + (sizeof(float) + sizeof(int)) * kWarps;
}

}  // namespace

extern "C" {

// Shared memory one block takes for out x out scores.
long long ncc_locate_smem_bytes(int out) { return (long long)smem_bytes(out); }

// windows (s, win, win) float32, mean and t_energy 0-d float32, spectrum
// (97, 6, 32) complex float32 (ops/ncc_locate.template_spectrum), all on the
// current device; ly, lx (s,) int32 and conf (s,) float32 out.  1 <= tpl <=
// win <= 192.  Launches one block per window on `stream`; does not
// synchronise; returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments out of range or scores that do not fit in a block's shared
// memory).
int ncc_locate_launch(const float* windows, int s, int win, int tpl, const float* mean,
                      const float* spectrum, const float* t_energy, int* ly, int* lx,
                      float* conf, cudaStream_t stream) {
  if (s < 1 || tpl < 1 || tpl > win || win > kM || win - tpl + 1 > kMaxOut)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.windows = windows;
  p.mean = mean;
  p.spectrum = reinterpret_cast<const float2*>(spectrum);
  p.t_energy = t_energy;
  p.ly = ly;
  p.lx = lx;
  p.conf = conf;
  p.win = win;
  p.tpl = tpl;
  p.out = win - tpl + 1;
  const size_t smem = smem_bytes(p.out);
  int device = 0, limit = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess)
    return (int)err;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(ncc_locate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  ncc_locate_kernel<<<s, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

const char* ncc_locate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
