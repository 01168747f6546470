// 128-point DFTs along the columns of a [128, 32] tile in shared memory:
// stage A of kernels 4 and 5 (fft_stage_a.cu; the Python side is
// amw_tpu_torch/ops/fft_staged.py), its last user.  The B passes of the
// B/C kernels 6-10 (fft_split.cu, fft_bccb.cu) run on fft_breg.cuh and the
// reduce kernels 11 and 12 (fft_reduce.cu) their inverse stage A on
// fft_areg.cuh: both the register transform, 16 B of shared memory a
// sample and one barrier where this one takes 128 B and 8.
//
// The JAX package contracts its A and B axes with a 128 x 128 DFT matrix on
// the TPU's matrix unit (amw_tpu/ops/fft_pallas.py `_dot_l`).  On an H100 a
// direct 128-point DFT in f32 costs 1024 flops a point, about 3x the byte
// bound of a pass; a radix-2 transform costs ~35.  So a block stages a
// [128, 32] complex column strip (32 KB) in shared memory in bit-reversed
// row order and runs 7 radix-2 decimation-in-time stages over it, 8
// butterflies a thread a stage; the result is in natural row order.  All
// arithmetic is f32 on the CUDA cores (no TF32, no bf16 split); the 64
// twiddles are sincospif of exact arguments.
//
// col_dft128_kernel is one such strip transform over a batch of [128, S]
// matrices: stage A (S = B*C, twiddle t1 [128, S]).  Forward: DFT, then times the
// twiddle of the output row.  Inverse: times the twiddle of the input row,
// then the conjugate DFT, then `scale`.
#pragma once

#include <cuda_runtime.h>

namespace amw_fft {

constexpr int kN = 128;                         // A = B = 128
constexpr int kCols = 32;                       // tile width, one warp
constexpr int kThreads = 256;                   // 8 warps
constexpr int kRowsPerPass = kThreads / kCols;  // 8
constexpr int kRowsPerThread = kN / kRowsPerPass;  // 16

struct Tile {
  float re[kN][kCols];
  float im[kN][kCols];
};

struct Twiddles128 {
  float re[kN / 2];
  float im[kN / 2];
};

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// W_128^j = exp(sign * 2 pi i j / 128), j < 64 (sign -1 forward, +1 inverse).
__device__ __forceinline__ void init_twiddles(Twiddles128& w, float sign) {
  for (int j = threadIdx.x; j < kN / 2; j += blockDim.x) {
    float s, c;
    sincospif(sign * static_cast<float>(j) / (kN / 2), &s, &c);
    w.re[j] = c;
    w.im[j] = s;
  }
}

// In place over every column of `t`: bit-reversed rows in, DFT rows out in
// natural order.  All kThreads threads call it; it synchronises before each
// stage and once at the end.  A warp works on one row pair of 32 adjacent
// columns at a time, so shared-memory accesses are free of bank conflicts.
__device__ __forceinline__ void fft128_columns(Tile& t, const Twiddles128& w) {
  const int col = threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;
#pragma unroll
  for (int half = 1; half < kN; half <<= 1) {
    __syncthreads();
    const int tw_step = kN / (2 * half);
#pragma unroll
    for (int b = grp; b < kN / 2; b += kRowsPerPass) {
      const int j = b & (half - 1);
      const int i0 = ((b - j) << 1) + j;
      const int i1 = i0 + half;
      const float wr = w.re[j * tw_step];
      const float wi = w.im[j * tw_step];
      const float vr = t.re[i1][col];
      const float vi = t.im[i1][col];
      const float xr = vr * wr - vi * wi;
      const float xi = vr * wi + vi * wr;
      const float ur = t.re[i0][col];
      const float ui = t.im[i0][col];
      t.re[i0][col] = ur + xr;
      t.im[i0][col] = ui + xi;
      t.re[i1][col] = ur - xr;
      t.im[i1][col] = ui - xi;
    }
  }
  __syncthreads();
}

// Output layouts of col_dft128_kernel.
constexpr int kOutPlanes = 0;  // out_re / out_im, row q each
constexpr int kOutReal = 1;    // out_re only (real part)
constexpr int kOutJoin = 2;    // one array [K, 2, join_r2, 128*S]

// One block: matrix q = blockIdx.x % Q, columns [col0, col0 + 32) with
// col0 = 32 * (blockIdx.x / Q), so consecutive blocks share a twiddle strip
// (it stays in L2 across the batch).  Matrix q's element (a, col) is read at
// in + q * in_stride + a * S + col, as zero from in_len on (the unpadded
// rows of a signal shorter than the plan); it is written at row q of the
// output (length 128 * S).  `in` and `out` may be the same array (each block
// reads its whole strip before it writes).
template <bool kInverse, bool kRealIn, int kOut>
__global__ void __launch_bounds__(kThreads)
col_dft128_kernel(const float* in_re, const float* in_im, long long in_stride,
                  long long in_len, int Q, int S,
                  const float* __restrict__ tw_re,
                  const float* __restrict__ tw_im, float* out_re,
                  float* out_im, int join_r2, float scale) {
  __shared__ Tile t;
  __shared__ Twiddles128 w;
  const int q = blockIdx.x % Q;
  const int col0 = (blockIdx.x / Q) * kCols;
  const int col = threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;
  init_twiddles(w, kInverse ? 1.0f : -1.0f);

  const float* xr = in_re + q * in_stride;
  const float* xi = kRealIn ? nullptr : in_im + q * in_stride;
#pragma unroll 4
  for (int a = grp; a < kN; a += kRowsPerPass) {
    const long long pos = static_cast<long long>(a) * S + col0 + col;
    float vr = 0.0f, vi = 0.0f;
    if (pos < in_len) {
      vr = xr[pos];
      if (!kRealIn) vi = xi[pos];
    }
    if (kInverse) {
      const float cr = __ldg(tw_re + pos), ci = __ldg(tw_im + pos);
      const float ur = vr * cr - vi * ci;
      vi = vr * ci + vi * cr;
      vr = ur;
    }
    const int rb = bitrev(a, 7);
    t.re[rb][col] = vr;
    t.im[rb][col] = vi;
  }

  fft128_columns(t, w);

  const long long N = static_cast<long long>(kN) * S;
  long long row_re = q, row_im = q;
  if (kOut == kOutJoin) {
    const int k = q / join_r2;
    row_re = static_cast<long long>(k) * 2 * join_r2 + (q - k * join_r2);
    row_im = row_re + join_r2;
  }
  float* yr = out_re + row_re * N;
  float* yi = (kOut == kOutJoin ? out_re : out_im) + row_im * N;
#pragma unroll 4
  for (int a = grp; a < kN; a += kRowsPerPass) {
    const long long pos = static_cast<long long>(a) * S + col0 + col;
    float vr = t.re[a][col], vi = t.im[a][col];
    if (!kInverse) {
      const float cr = __ldg(tw_re + pos), ci = __ldg(tw_im + pos);
      const float ur = vr * cr - vi * ci;
      vi = vr * ci + vi * cr;
      vr = ur;
    }
    yr[pos] = vr * scale;
    if (kOut != kOutReal) yi[pos] = vi * scale;
  }
}

}  // namespace amw_fft
