// Inverse stage A with the multiband maps and the band sum fused in.
//
// Replaces two Pallas TPU kernels of amw_tpu/ops/fft_pallas.py:
//
// - `_reduce_stage_a_packed` (body `_stage_a_reduce_packed_kernel`), entry
//   amw_fft_reduce_packed.  Input: K spectra of R2 packed rows, two planes
//   [K*R2, nfft] (the output of the B/C stages for K band responses); a
//   [K, 8] table of per-band maps.  For each packed row r and band k it runs
//   the complex inverse stage A (conj twiddle t1, inverse 128-point DFT,
//   1/nfft), applies band k's map to the real plane and to the imaginary
//   plane (each holds a real signal: row r and row R2 + r of the original
//   batch), and sums the bands.  Output: [2*R2, nfft], the real-plane rows
//   then the imaginary-plane rows, in natural time order.
// - `_reduce_stage_a` (body `_stage_a_reduce_kernel`), entry
//   amw_fft_reduce: the unpacked rows of an odd row count (one mono track).
//   Input: K spectra of R rows, [K*R, nfft] planes; the same inverse, band
//   k's map on the real part only (the imaginary plane is discarded), the
//   band sum.  Output: [R, nfft].

// The maps are the multiband dynamics' soft-knee compressor, limiter and
// gain (amw_tpu_torch/ops/basic.py compress_soft_knee, limiter), as a
// table row [mode, p1..p5, limit, gain] built on the host by
// amw_tpu_torch/ops/bands.py BandMap.table_row:
//   mode 0: bypass (ratio 1 or <= 0);
//   mode 1: upward boost, p1 threshold dB, p2 1 - ratio, p3 max boost dB;
//   mode 2: hard knee, p1 threshold, p2 ratio;
//   mode 3: soft knee, p1 threshold, p2 ratio, p3 lower, p4 upper,
//           p5 knee slope;
// then clip to [-limit, limit] and times gain.
//
// Design (fft128.cuh): one block per (row, 32-column strip); for each band
// the strip of that band's spectrum goes through shared memory and the
// radix-2 transform, and each thread keeps its 16 samples of the band sums
// (both planes' when packed) in registers, so the K band signals never
// reach device memory and each output plane is stored once.
//
// Bound on an H100: device-memory bytes.  At the 180 s slice's shapes
// (K = 4, R2 = 8, nfft = 2^23) the call reads 2.15 GB of spectra and the
// 64 MB twiddle table (L2-resident across the blocks of a strip) and writes
// 0.54 GB: ~0.82 ms at 3.35 TB/s, against ~0.2 ms of f32 arithmetic.  The
// unpacked reduce of one mono 180 s track (K = 4, R = 1) reads 268 MB of
// spectra and the 67 MB table and writes 34 MB: ~0.11 ms.
#include "fft128.cuh"

using namespace amw_fft;

namespace {

constexpr int kMaxBands = 8;
constexpr int kBandCols = 8;

__device__ __forceinline__ float band_map(float x, const float* b) {
  const int mode = static_cast<int>(b[0]);
  float y = x;
  if (mode != 0) {
    const float ax = fabsf(x);
    float oa;
    if (mode == 1) {
      const float level =
          ax > 1e-12f ? 20.0f * log10f(fmaxf(ax, 1e-12f)) : -100.0f;
      const float boost = fminf(fmaxf((b[1] - level) * b[2], 0.0f), b[3]);
      oa = fminf(fmaxf(ax * exp10f(boost / 20.0f), 0.0f), 1.0f);
    } else if (mode == 2) {
      const float excess = fmaxf(ax - b[1], 0.0f);
      oa = fminf(ax, b[1] + excess / b[2]);
    } else {
      const float thresh = b[1], ratio = b[2], lower = b[3], upper = b[4];
      oa = ax <= lower ? ax
           : ax >= upper ? thresh + (ax - thresh) / ratio
                         : lower + (ax - lower) * b[5];
      oa = fmaxf(oa, 0.0f);
    }
    y = x > 0.0f ? oa : (x < 0.0f ? -oa : 0.0f);
  }
  y = fminf(fmaxf(y, -b[6]), b[6]);
  return y * b[7];
}

// kPacked: rows are packed pairs (both planes mapped and stored, output
// [2*R, N]); else plain rows (the real plane only, output [R, N]).
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
              const float* __restrict__ t1r, const float* __restrict__ t1i,
              const float* __restrict__ bands, float* __restrict__ out, int R,
              int K, int S, float scale) {
  __shared__ Tile t;
  __shared__ Twiddles128 w;
  __shared__ float bp[kMaxBands * kBandCols];
  const int r = blockIdx.x % R;
  const int col0 = (blockIdx.x / R) * kCols;
  const int col = threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;
  init_twiddles(w, 1.0f);
  for (int i = threadIdx.x; i < K * kBandCols; i += kThreads) bp[i] = bands[i];

  const long long N = static_cast<long long>(kN) * S;
  float acc_r[kRowsPerThread], acc_i[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc_r[i] = acc_i[i] = 0.0f;

  for (int k = 0; k < K; ++k) {
    const float* xr = yr + (static_cast<long long>(k) * R + r) * N;
    const float* xi = yi + (static_cast<long long>(k) * R + r) * N;
#pragma unroll 4
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int a = grp + i * kRowsPerPass;
      const long long pos = static_cast<long long>(a) * S + col0 + col;
      const float vr = xr[pos], vi = xi[pos];
      const float cr = __ldg(t1r + pos), ci = __ldg(t1i + pos);
      const int rb = bitrev(a, 7);
      t.re[rb][col] = vr * cr - vi * ci;
      t.im[rb][col] = vr * ci + vi * cr;
    }
    fft128_columns(t, w);
    const float* b = bp + k * kBandCols;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int a = grp + i * kRowsPerPass;
      acc_r[i] += band_map(t.re[a][col] * scale, b);
      if (kPacked) acc_i[i] += band_map(t.im[a][col] * scale, b);
    }
    __syncthreads();  // the tile is reloaded for the next band
  }

  float* o_re = out + static_cast<long long>(r) * N;
  float* o_im = out + static_cast<long long>(R + r) * N;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long pos =
        static_cast<long long>(grp + i * kRowsPerPass) * S + col0 + col;
    o_re[pos] = acc_r[i];
    if (kPacked) o_im[pos] = acc_i[i];
  }
}

int check_args(int K, int S) {
  if (K <= 0 || K > kMaxBands || S <= 0 || S % kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// yr, yi: [K*R2, 128*S]; bands: [K, 8]; out: [2*R2, 128*S].
extern "C" int amw_fft_reduce_packed(const float* yr, const float* yi,
                                     const float* t1r, const float* t1i,
                                     const float* bands, float* out, int R2,
                                     int K, int S, float scale,
                                     void* stream) {
  if (R2 <= 0) return 0;
  if (const int err = check_args(K, S)) return err;
  reduce_kernel<true><<<R2 * (S / kCols), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      yr, yi, t1r, t1i, bands, out, R2, K, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// yr, yi: [K*R, 128*S]; bands: [K, 8]; out: [R, 128*S].
extern "C" int amw_fft_reduce(const float* yr, const float* yi,
                              const float* t1r, const float* t1i,
                              const float* bands, float* out, int R, int K,
                              int S, float scale, void* stream) {
  if (R <= 0) return 0;
  if (const int err = check_args(K, S)) return err;
  reduce_kernel<false><<<R * (S / kCols), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      yr, yi, t1r, t1i, bands, out, R, K, S, scale);
  return static_cast<int>(cudaGetLastError());
}
