// Stage A of the staged FFT, and its packed inverse with the join epilogue.
//
// Replaces two Pallas TPU kernels of amw_tpu/ops/fft_pallas.py:
//
// - `_stage_a` (kernel bodies `_stage_a_kernel`, `_stage_a_real_in_kernel`,
//   `_stage_a_real_out_kernel`): for each row x [R, nfft] viewed [128, S]
//   (S = B*C), the 128-point DFT along the first axis and the stage-1
//   twiddle t1[a', col] = exp(-+2 pi i a' col / nfft): forward
//   y = (W x) * t1, inverse y = W^H (x * conj-table) / nfft.  Modes: complex
//   (the packed forward: two real rows as one complex row), real-in forward
//   (imaginary part zero), real-out inverse (only the real plane written);
// - `_stage_a_inv_join` (`_stage_a_inv_join_kernel`): the complex inverse
//   over K*R2 packed spectra, both planes written into one array
//   [K, 2, R2, nfft], so the caller reads it as [K, 2*R2, nfft] (real rows,
//   then imaginary rows) with no concatenate pass.
//
// Design (fft128.cuh): one block per (row, 32-column strip), a radix-2
// transform over the 128 rows of the strip in shared memory; the forward
// reads the caller's unpadded rows [R, n] in place and takes zeros past n,
// so no padded copy of the signal is made.
//
// Bound on an H100: device-memory bytes.  A forward call at the 180 s
// slice's shapes (8 complex rows of 2^23 from a [16, n] signal) reads the
// signal once (0.51 GB), writes two planes (0.54 GB) and reads the 64 MB
// twiddle table once (the blocks of one strip run back to back, so the
// strip is in L2 for the other rows): ~0.34 ms at 3.35 TB/s, against
// ~0.04 ms of f32 arithmetic (~41 flops a point).  What the design does
// about the bytes: every thread loads and stores whole 128-byte rows of its
// warp's strip, and nothing but the strip goes through shared memory.
#include "fft128.cuh"

using namespace amw_fft;

extern "C" int amw_fft_stage_a(const float* xr, const float* xi,
                               const float* t1r, const float* t1i,
                               float* out_r, float* out_i, int rows,
                               int in_stride, int n, int S, int inverse,
                               int real_in, int real_out, float scale,
                               void* stream) {
  if (rows <= 0) return 0;
  if (S <= 0 || S % kCols || n < 0 || n > kN * S ||
      (real_in && inverse) || (real_out && !inverse))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows * (S / kCols));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!inverse && real_in) {
    col_dft128_kernel<false, true, kOutPlanes><<<grid, kThreads, 0, st>>>(
        xr, xi, in_stride, n, rows, S, t1r, t1i, out_r, out_i, 0, scale);
  } else if (!inverse) {
    col_dft128_kernel<false, false, kOutPlanes><<<grid, kThreads, 0, st>>>(
        xr, xi, in_stride, n, rows, S, t1r, t1i, out_r, out_i, 0, scale);
  } else if (real_out) {
    col_dft128_kernel<true, false, kOutReal><<<grid, kThreads, 0, st>>>(
        xr, xi, in_stride, n, rows, S, t1r, t1i, out_r, out_i, 0, scale);
  } else {
    col_dft128_kernel<true, false, kOutPlanes><<<grid, kThreads, 0, st>>>(
        xr, xi, in_stride, n, rows, S, t1r, t1i, out_r, out_i, 0, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// yr, yi: [K*R2, 128*S] spectra (`rows` = K*R2); out: [K, 2*R2, 128*S].
extern "C" int amw_fft_inv_join(const float* yr, const float* yi,
                                const float* t1r, const float* t1i,
                                float* out, int rows, int r2, int S,
                                float scale, void* stream) {
  if (rows <= 0) return 0;
  if (S <= 0 || S % kCols || r2 <= 0 || rows % r2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long N = static_cast<long long>(kN) * S;
  col_dft128_kernel<true, false, kOutJoin>
      <<<rows * (S / kCols), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          yr, yi, N, N, rows, S, t1r, t1i, out, out, r2, scale);
  return static_cast<int>(cudaGetLastError());
}
