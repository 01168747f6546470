// The inverse 128-point DFT along the A axis of a [128, 32] column strip,
// in registers with one exchange through shared memory: the transform of
// the reduce kernels 11 and 12 (fft_reduce.cu).
//
// What it replaces and why.  fft128.cuh's fft128_columns stages the strip
// in shared memory in bit-reversed order and runs seven radix-2 stages
// over it: each complex sample is stored once (8 B), passes through the
// seven stages (7 x 16 B) and is read back (8 B), 128 B of shared-memory
// traffic and 8 barriers a transform.  The reduce runs that transform K
// times a block (once a band), so at the 180 s batch's shapes (K = 4,
// R2 = 8, nfft = 2^23) it moved 34.4 GB through shared memory, ~1.0-1.2 ms
// at 128 B a clock an SM, more than the kernel's 0.82 ms device-memory
// bound.
//
// The factorisation here follows the loads a thread already makes.  Thread
// (g, t) of the 8 warps x 32 lanes holds rows a = g + 8 i (i < 16) of
// column t, so with k = k1 + 16 k2 (k1 < 16, k2 < 8)
//
//   z[k1 + 16 k2] = sum_g W_8^(g k2) W_128^(g k1) sum_i x[g + 8 i] W_16^(i k1)
//
// (W_N = exp(+2 pi i / N), the inverse):
//
//   1. areg_rows: the 16-point DFT over i in the thread's registers
//      (radix 4 x 4, constant twiddles), times W_128^(g k1) from a
//      128-entry table in shared memory (one address a warp: a broadcast),
//      into the exchange buffer ex[k1][g][t] (a warp writes 32 adjacent
//      float2: no bank conflict);
//   2. one barrier;
//   3. areg_cols: warp w takes k1 = w and w + 8, reads ex[k1][0..7][t] and
//      runs the 8-point DFT over g (radix 4 x 2) in registers.  Its output
//      k2 is row k1 + 16 k2 = w + 8 (2 k2 + h) for k1 = w + 8 h: the thread
//      ends with rows w + 8 j (j < 16) of its column, the rows it loaded,
//      so a warp stores whole 128-byte rows.
//
// Shared memory: 16 B a sample (one float2 stored, one read) instead of
// 128, one barrier instead of 8.  All arithmetic f32; the W_16 twiddles
// are literals, the W_128 table sincospif of exact arguments.
#pragma once

#include <cuda_runtime.h>

namespace amw_fft {

constexpr int kAregRows = 128;                   // A: the transform length
constexpr int kAregCols = 32;                    // strip width, one warp
constexpr int kAregG = 8;                        // warps: rows g + 8 i
constexpr int kAregI = 16;                       // rows a thread holds
constexpr int kAregThreads = kAregG * kAregCols;  // 256
static_assert(kAregG * kAregI == kAregRows, "128 = 8 x 16");

// One exchange buffer: ex[k1][g][t], the 16-point outputs of warp g.
struct AregExchange {
  float2 v[kAregI][kAregG][kAregCols];  // 32 KB
};

// cos(2 pi m / 16) for any m; with m known at compile time (every call
// here, after unrolling) it folds to a constant.
__device__ __forceinline__ float areg_cos16(int m) {
  m &= 15;
  if (m > 8) m = 16 - m;  // even
  const int q = m <= 4 ? m : 8 - m;
  const float c = q == 0   ? 1.0f
                  : q == 1 ? 0.92387953251128675613f
                  : q == 2 ? 0.70710678118654752440f
                  : q == 3 ? 0.38268343236508977173f
                           : 0.0f;
  return m <= 4 ? c : -c;
}

// (re, im) times exp(+2 pi i m / 16); exact at the multiples of 4.
__device__ __forceinline__ void areg_rot16(float& re, float& im, int m) {
  m &= 15;
  if (m == 0) return;
  if (m == 4) {  // times i
    const float t = re;
    re = -im;
    im = t;
  } else if (m == 8) {
    re = -re;
    im = -im;
  } else if (m == 12) {  // times -i
    const float t = re;
    re = im;
    im = -t;
  } else {
    const float c = areg_cos16(m), s = areg_cos16(m - 4);
    const float t = re * c - im * s;
    im = re * s + im * c;
    re = t;
  }
}

// In place over N registers, N in {2, 4, 8, 16}: x[k] <- sum_n x[n]
// exp(+2 pi i n k / N), natural order in and out.  N = P Q with
// n = n1 + P n2, k = k1 + Q k2: a Q-point DFT over n2 for each n1, times
// W_N^(n1 k1), a P-point DFT over n1 for each k1 (16 = 4 x 4, 8 = 2 x 4).
template <int N>
__device__ __forceinline__ void areg_idft(float (&re)[N], float (&im)[N]) {
  if constexpr (N == 2) {
    const float ar = re[0], ai = im[0];
    re[0] = ar + re[1];
    im[0] = ai + im[1];
    re[1] = ar - re[1];
    im[1] = ai - im[1];
  } else if constexpr (N == 4) {
    const float t0r = re[0] + re[2], t0i = im[0] + im[2];
    const float t1r = re[0] - re[2], t1i = im[0] - im[2];
    const float t2r = re[1] + re[3], t2i = im[1] + im[3];
    const float t3r = re[1] - re[3], t3i = im[1] - im[3];
    re[0] = t0r + t2r;
    im[0] = t0i + t2i;
    re[2] = t0r - t2r;
    im[2] = t0i - t2i;
    re[1] = t1r - t3i;  // t1 + i t3
    im[1] = t1i + t3r;
    re[3] = t1r + t3i;  // t1 - i t3
    im[3] = t1i - t3r;
  } else {
    constexpr int P = N == 8 ? 2 : 4;
    constexpr int Q = N / P;
    float br[P][Q], bi[P][Q];
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) {
      float ar[Q], ai[Q];
#pragma unroll
      for (int n2 = 0; n2 < Q; ++n2) {
        ar[n2] = re[n1 + P * n2];
        ai[n2] = im[n1 + P * n2];
      }
      areg_idft<Q>(ar, ai);
#pragma unroll
      for (int k1 = 0; k1 < Q; ++k1) {
        areg_rot16(ar[k1], ai[k1], n1 * k1 * (16 / N));
        br[n1][k1] = ar[k1];
        bi[n1][k1] = ai[k1];
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < Q; ++k1) {
      float cr[P], ci[P];
#pragma unroll
      for (int n1 = 0; n1 < P; ++n1) {
        cr[n1] = br[n1][k1];
        ci[n1] = bi[n1][k1];
      }
      areg_idft<P>(cr, ci);
#pragma unroll
      for (int k2 = 0; k2 < P; ++k2) {
        re[k1 + Q * k2] = cr[k2];
        im[k1 + Q * k2] = ci[k2];
      }
    }
  }
}

// W_128^j = exp(+2 pi i j / 128), j < 128, into `w` (all threads call it;
// the caller synchronises before the first use).
__device__ __forceinline__ void areg_init_w128(float2* w) {
  for (int j = threadIdx.x; j < kAregRows; j += blockDim.x) {
    float s, c;
    sincospif(static_cast<float>(j) / (kAregRows / 2), &s, &c);
    w[j] = make_float2(c, s);
  }
}

// Step 1: thread (g, t) holds x[g + 8 i] in (re, im)[i]; the 16-point DFT
// over i, times W_128^(g k1), into ex[k1][g][t].
__device__ __forceinline__ void areg_rows(float (&re)[kAregI],
                                          float (&im)[kAregI],
                                          AregExchange& ex, const float2* w,
                                          int g, int t) {
  areg_idft<kAregI>(re, im);
#pragma unroll
  for (int k1 = 0; k1 < kAregI; ++k1) {
    float vr = re[k1], vi = im[k1];
    if (k1 != 0) {
      const float2 c = w[g * k1];
      const float u = vr * c.x - vi * c.y;
      vi = vr * c.y + vi * c.x;
      vr = u;
    }
    ex.v[k1][g][t] = make_float2(vr, vi);
  }
}

// Step 3 (after a barrier): for k1 = w + 8 h, the 8-point DFT over g of
// ex[k1][.][t]; (re, im)[k2] is then row k1 + 16 k2 = w + 8 (2 k2 + h).
__device__ __forceinline__ void areg_cols(const AregExchange& ex, int w,
                                          int h, int t, float (&re)[kAregG],
                                          float (&im)[kAregG]) {
#pragma unroll
  for (int g = 0; g < kAregG; ++g) {
    const float2 v = ex.v[w + kAregG * h][g][t];
    re[g] = v.x;
    im[g] = v.y;
  }
  areg_idft<kAregG>(re, im);
}

}  // namespace amw_fft
