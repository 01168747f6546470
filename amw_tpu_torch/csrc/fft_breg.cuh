// The B passes of the fused round trips (kernels 8 and 9, fft_bccb.cu) and
// of the split stages (kernels 7 and 10 inverse, launch_b_pass; kernel 6
// forward, breg_load and breg_strip inside its one pass, fft_split.cu): the
// 128-point DFT along b of each [128, 32] column strip of the [128, C]
// matrix of one (row, a'), with the twiddle T2[b', c] applied in registers,
// on fft_areg.cuh's register transform in both signs.
//
//   forward (pass 1):  z[b', c] = T2[b', c] sum_b x[b, c] W_128^(-b b');
//   inverse (pass 3):  y[b, c]  = sum_b' conj T2[b', c] z[b', c] W_128^(b b')
//                      (scale 1), in place.
//
// What it replaces and why.  Both passes ran fft128.cuh's
// col_dft128_kernel: the strip staged in shared memory in bit-reversed
// order, seven radix-2 stages over it, 128 B of shared-memory traffic and 8
// barriers a transform.  Here the transform is fft_areg.cuh's (16 x 8 along
// the loads a thread already makes, one exchange through shared memory):
// 16 B a sample, one barrier a block.
//
// The forward sign.  fft_areg.cuh computes the inverse (W = exp(+2 pi i /
// 128)).  With swap(a + i b) = b + i a, DFT(x) = swap(IDFT(swap(x))), and
// a swap is a renaming of registers: the forward pass hands areg_rows its
// (im, re) registers and reads areg_cols' outputs the same way round.  The
// arithmetic is the inverse's, mirrored, so the rounding is too; no
// forward-sign instance of the transform is compiled, and kernels 11 and
// 12 keep fft_areg.cuh as it was.
//
// Layout.  Block b of a pass takes matrix m = b / (C / 32) and its strip of
// columns c0 = 32 (b % (C / 32)) + [0, 32): the strips of one matrix are
// consecutive blocks, so the blocks resident at once read whole matrices
// (256 KB each at C = 512) and not one strip of many.  Thread (g, t) of 8
// warps x 32 lanes loads rows g + 8 i (i < 16) of column c0 + t, so a warp
// moves whole 128-byte rows; after the exchange warp g holds output rows
// g + 8 j (j < 16), the rows it loaded, and stores them whole.  So in place
// is safe: every load of the block comes before its one barrier, every
// store after it, and each warp writes only the rows it read.
//
// T2 is read from the plan's [128, C] tables (t2 forward, it2 = conj t2
// inverse; 1 MB for both at C = 512, L2-resident across the pass), so each
// product rounds as the plain version's table does; it is not recomputed.
// The inverse reads it2 on the input rows with the samples (rows g + 8 i),
// the forward t2 on the output rows g + 8 j, issued into the registers the
// samples left free once areg_rows has written the exchange, so the L2
// reads are in flight across the barrier.
//
// Bound on an H100: device-memory bytes.  Each pass reads its two planes
// once and writes them once: at the 180 s slice's shapes (R = 8 packed
// rows, nfft = 2^23) 1.074 GB, 0.3205 ms at 3.35 TB/s, forward and each of
// the K inverse passes alike.
//
// Geometry.  A block holds the exchange (32 KB) and a W_128 table a warp
// (8 KB: each warp fills the 16 entries it reads, so the block's one
// barrier is the exchange's) in static shared memory, so 5 blocks fit an SM
// by shared memory; its loads put 32 KB in flight (16 complex a thread).
// Little's law at 3.35 TB/s and ~1 us of latency wants ~25 KB in flight an
// SM, and a block spends part of its time in its transform and its stores,
// not loading, so kBregBlocks = 3 blocks an SM (96 KB of loads at most)
// keeps the memory busy while the others compute; __launch_bounds__(256, 3)
// caps a thread at 80 registers, room for the 32 samples, the 32 twiddles
// of T2 and the transform's temporaries (ptxas for sm_90a: 80, no spill).
// Built with kBregBlocks at 2 and 4 (80 and 64 registers, no spill) and
// timed by amw_tpu_torch/scripts/ab_bccb.py, the pass ran on an H100
// within 0.3 % of the time at 3, at 88-89 % of the bytes bound: the
// memory, not the occupancy, sets its time.
#pragma once

#include "fft_areg.cuh"

namespace amw_fft {

constexpr int kBregBlocks = 3;  // blocks an SM (launch bound)

// (re, im) *= (cr, ci).
__device__ __forceinline__ void breg_cmul(float& re, float& im, float cr,
                                          float ci) {
  const float u = re * cr - im * ci;
  im = re * ci + im * cr;
  re = u;
}

// W_128^(g k1), k1 < 16, at w[g k1]: the entries areg_rows reads for warp
// g.  Lane k1 of warp g writes its own, so the warp needs no block barrier
// for it (its caller's __syncwarp suffices).
__device__ __forceinline__ void breg_w128(float2* w, int g, int t) {
  if (t < kAregI) {
    float s, c;
    sincospif(static_cast<float>(g * t) / (kAregRows / 2), &s, &c);
    w[g * t] = make_float2(c, s);
  }
}

// Thread (g, t)'s loads of a strip: rows g + 8 i (i < 16) at in_* + pos +
// i * step.
__device__ __forceinline__ void breg_load(const float* in_re,
                                          const float* in_im, int pos,
                                          int step, float (&re)[kAregI],
                                          float (&im)[kAregI]) {
#pragma unroll
  for (int i = 0; i < kAregI; ++i) {
    re[i] = in_re[pos + i * step];
    im[i] = in_im[pos + i * step];
  }
}

// The rest of a strip after breg_load: (inverse) conj T2 on the input rows,
// the transform through `ex` (one block barrier inside), (forward) T2 on
// the output rows; then store(j, zr, zi) for each of the thread's output
// rows g + 8 j.  tw_* + pos + j * step is T2 (or conj T2) of row g + 8 j.
// Every thread of the block calls it; `ex` may be reused only after a
// further barrier.
template <bool kInverse, typename Store>
__device__ __forceinline__ void breg_strip(float (&re)[kAregI],
                                           float (&im)[kAregI],
                                           const float* __restrict__ tw_re,
                                           const float* __restrict__ tw_im,
                                           int pos, int step, AregExchange& ex,
                                           const float2* w, int g, int t,
                                           Store&& store) {
  if (kInverse) {
#pragma unroll
    for (int i = 0; i < kAregI; ++i)
      breg_cmul(re[i], im[i], __ldg(tw_re + pos + i * step),
                __ldg(tw_im + pos + i * step));
    areg_rows(re, im, ex, w, g, t);
  } else {
    areg_rows(im, re, ex, w, g, t);  // swap: the forward sign
    // T2 of the output rows g + 8 j, into the registers just freed
#pragma unroll
    for (int j = 0; j < kAregI; ++j) {
      re[j] = __ldg(tw_re + pos + j * step);
      im[j] = __ldg(tw_im + pos + j * step);
    }
  }
  __syncthreads();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float zr[kAregG], zi[kAregG];
    if (kInverse)
      areg_cols(ex, g, h, t, zr, zi);
    else
      areg_cols(ex, g, h, t, zi, zr);  // swap back
#pragma unroll
    for (int k2 = 0; k2 < kAregG; ++k2) {
      const int j = 2 * k2 + h;  // row k1 + 16 k2 = g + 8 j, k1 = g + 8 h
      if (!kInverse) breg_cmul(zr[k2], zi[k2], re[j], im[j]);
      store(j, zr[k2], zi[k2]);
    }
  }
}

// One block of a pass over Q matrices [128, C] (C a multiple of 32): in_*
// -> out_*, which may be the same planes.  tw_*: T2 [128, C] (forward) or
// conj T2 (kInverse).  Grid: Q * (C / 32) blocks of kAregThreads.
template <bool kInverse>
__device__ __forceinline__ void breg_pass(const float* in_re,
                                          const float* in_im,
                                          const float* __restrict__ tw_re,
                                          const float* __restrict__ tw_im,
                                          float* out_re, float* out_im,
                                          int C) {
  __shared__ AregExchange ex;
  __shared__ float2 w128[kAregG][kAregRows];  // warp g's W_128^(g k1)
  const int strips = C / kAregCols;
  const int m = static_cast<int>(blockIdx.x) / strips;
  const int col0 = (static_cast<int>(blockIdx.x) - m * strips) * kAregCols;
  const int t = threadIdx.x % kAregCols;
  const int g = threadIdx.x / kAregCols;
  const long long base = static_cast<long long>(m) * kAregRows * C;
  const int pos = g * C + col0 + t;  // row g; row g + 8 i at pos + i * step
  const int step = kAregG * C;

  float re[kAregI], im[kAregI];
  breg_load(in_re + base, in_im + base, pos, step, re, im);
  breg_w128(w128[g], g, t);
  __syncwarp();
  float* yr = out_re + base;
  float* yi = out_im + base;
  breg_strip<kInverse>(re, im, tw_re, tw_im, pos, step, ex, w128[g], g, t,
                       [&](int j, float zr, float zi) {
                         yr[pos + j * step] = zr;
                         yi[pos + j * step] = zi;
                       });
}

// The passes as kernels of their own names (a profiler tells them apart).
__global__ void __launch_bounds__(kAregThreads, kBregBlocks)
breg_fwd_kernel(const float* in_re, const float* in_im,
                const float* __restrict__ tw_re,
                const float* __restrict__ tw_im, float* out_re,
                float* out_im, int C) {
  breg_pass<false>(in_re, in_im, tw_re, tw_im, out_re, out_im, C);
}

__global__ void __launch_bounds__(kAregThreads, kBregBlocks)
breg_inv_kernel(const float* in_re, const float* in_im,
                const float* __restrict__ tw_re,
                const float* __restrict__ tw_im, float* out_re,
                float* out_im, int C) {
  breg_pass<true>(in_re, in_im, tw_re, tw_im, out_re, out_im, C);
}

// Q matrices [128, C]: forward (t2) or inverse (it2) B pass on `st`.
inline cudaError_t launch_b_pass(bool inverse, const float* in_re,
                                 const float* in_im, const float* tw_re,
                                 const float* tw_im, float* out_re,
                                 float* out_im, long long Q, int C,
                                 cudaStream_t st) {
  if (C <= 0 || C % kAregCols) return cudaErrorInvalidValue;
  const long long blocks = Q * (C / kAregCols);
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto kernel = inverse ? breg_inv_kernel : breg_fwd_kernel;
  kernel<<<static_cast<unsigned>(blocks), kAregThreads, 0, st>>>(
      in_re, in_im, tw_re, tw_im, out_re, out_im, C);
  return cudaGetLastError();
}

}  // namespace amw_fft
