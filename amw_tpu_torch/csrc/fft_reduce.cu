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
//
// The maps are the multiband dynamics' soft-knee compressor, limiter and
// gain (amw_tpu_torch/ops/basic.py compress_soft_knee, limiter), as a
// table row [mode, p1..p5, limit, gain] built on the host by
// amw_tpu_torch/ops/bands.py BandMap.table_row:
//   mode 0: bypass (ratio 1 or <= 0);
//   mode 1: upward boost, p1 threshold dB, p2 1 - ratio, p3 max boost dB;
//   mode 2: hard knee, p1 threshold, p2 ratio;
//   mode 3: soft knee, p1 threshold, p2 ratio, p3 lower, p4 upper,
//           p5 knee slope;
// then clip to [-limit, limit] and times gain.  The operations are those of
// compress_soft_knee but one: modes 2 and 3 multiply by 1 / ratio,
// computed once a block (IEEE), where the plain version divides by the
// ratio, which saves a division subroutine a sample and plane (within a
// few ulps of the quotient; tests/test_torch_reduce_factored.py bounds
// what it costs against the plain version).
//
// Bound on an H100: device-memory bytes.  At the 180 s slice's shapes
// (K = 4, R2 = 8, nfft = 2^23) the call reads 2.15 GB of spectra and the
// 64 MB twiddle table and writes 0.54 GB: ~0.82 ms at 3.35 TB/s.  The
// unpacked reduce of one mono 180 s track (K = 4, R = 1) reads 268 MB of
// spectra and the 67 MB table and writes 34 MB: ~0.11 ms.
//
// Design.  One block of 256 threads a (row, 32-column strip), the blocks
// of one strip consecutive (they share its t1 in L2); thread (g, t) owns
// rows g + 8 i (i < 16) of column t.  For
// each band in turn the 128-point inverse DFT runs in registers with one
// exchange through shared memory (fft_areg.cuh), and each thread keeps its
// 16 samples of the band sums (both planes' when packed) in registers, so
// the K band signals never reach device memory and each output plane is
// stored once, whole 128-byte rows a warp.  Around the transform:
//
// - t1 is read once a block, not once a band: each thread reads its 16
//   complex twiddles, folds in the exact power-of-two scale 1/nfft (which
//   changes no rounding), and keeps them in its own 16 slots of shared
//   memory (32 KB a block), which leaves the registers for the loads;
// - bytes in flight: as soon as a thread has written band k's 16 values to
//   the exchange, the registers that held band k's loads are free, and it
//   issues band k + 1's 32 loads into them before the barrier, so they are
//   in flight while the block runs band k's 8-point DFTs and maps.  Two
//   exchange buffers (band k & 1) make one barrier a band enough;
// - a band's mode is uniform over the block, so the mode is chosen once a
//   band (one switch over 8 samples and both planes), not once a sample.
//
// Resources: __launch_bounds__(256, 2), so at most 128 registers a thread
// (ptxas for sm_90a: 128 in both instances, the packed one spilling 4
// bytes); kSmem = 97.3 KB of dynamic shared memory a block (two exchanges
// of 32 KB, the 32 KB twiddle slots, the W_128 table, the band rows); so 2
// blocks (16 warps) an SM.  At one block an SM (141 registers, no spill)
// the packed kernel took a third longer on an H100
// (amw_tpu_torch/scripts/reduce_variants.cu).
#include "fft_areg.cuh"

using namespace amw_fft;

namespace {

constexpr int kMaxBands = 8;
constexpr int kBandCols = 8;

// A band's row of the table, with the reciprocal of the ratio.
struct Band {
  float p[kBandCols];
  float inv_ratio;
  int mode;
};

struct Smem {
  AregExchange ex[2];                  // band k & 1
  float2 t1[kAregI][kAregThreads];     // thread's t1 * scale, row g + 8 i
  float2 w128[kAregRows];
  Band band[kMaxBands];
};
constexpr int kSmem = static_cast<int>(sizeof(Smem));

// Band map of one sample, the mode fixed at compile time.
template <int kMode>
__device__ __forceinline__ float band_map(float x, const Band& b) {
  float y = x;
  if (kMode != 0) {
    const float ax = fabsf(x);
    float oa;
    if (kMode == 1) {
      const float level =
          ax > 1e-12f ? 20.0f * log10f(fmaxf(ax, 1e-12f)) : -100.0f;
      const float boost = fminf(fmaxf((b.p[1] - level) * b.p[2], 0.0f),
                                b.p[3]);
      oa = fminf(fmaxf(ax * exp10f(boost / 20.0f), 0.0f), 1.0f);
    } else if (kMode == 2) {
      const float excess = fmaxf(ax - b.p[1], 0.0f);
      oa = fminf(ax, b.p[1] + excess * b.inv_ratio);
    } else {
      const float thresh = b.p[1], lower = b.p[3], upper = b.p[4];
      oa = ax <= lower ? ax
           : ax >= upper ? thresh + (ax - thresh) * b.inv_ratio
                         : lower + (ax - lower) * b.p[5];
      oa = fmaxf(oa, 0.0f);
    }
    y = x > 0.0f ? oa : (x < 0.0f ? -oa : 0.0f);
  }
  y = fminf(fmaxf(y, -b.p[6]), b.p[6]);
  return y * b.p[7];
}

// acc[2 k2 + h] += map(z[k2]) over the 8 outputs of one areg_cols call.
template <int kMode, bool kPacked, int h>
__device__ __forceinline__ void map_add(const Band& b,
                                        const float (&zr)[kAregG],
                                        const float (&zi)[kAregG],
                                        float (&acc_r)[kAregI],
                                        float (&acc_i)[kAregI]) {
#pragma unroll
  for (int k2 = 0; k2 < kAregG; ++k2) {
    acc_r[2 * k2 + h] += band_map<kMode>(zr[k2], b);
    if (kPacked) acc_i[2 * k2 + h] += band_map<kMode>(zi[k2], b);
  }
}

template <bool kPacked, int h>
__device__ __forceinline__ void map_add_band(const Band& b,
                                             const float (&zr)[kAregG],
                                             const float (&zi)[kAregG],
                                             float (&acc_r)[kAregI],
                                             float (&acc_i)[kAregI]) {
  switch (b.mode) {
    case 0: map_add<0, kPacked, h>(b, zr, zi, acc_r, acc_i); break;
    case 1: map_add<1, kPacked, h>(b, zr, zi, acc_r, acc_i); break;
    case 2: map_add<2, kPacked, h>(b, zr, zi, acc_r, acc_i); break;
    default: map_add<3, kPacked, h>(b, zr, zi, acc_r, acc_i); break;
  }
}

// Band k's 16 samples of this thread: rows g + 8 i of its column.
__device__ __forceinline__ void load_band(const float* __restrict__ xr,
                                          const float* __restrict__ xi,
                                          int pos, int step,
                                          float (&re)[kAregI],
                                          float (&im)[kAregI]) {
#pragma unroll
  for (int i = 0; i < kAregI; ++i) {
    re[i] = xr[pos + i * step];
    im[i] = xi[pos + i * step];
  }
}

// kPacked: rows are packed pairs (both planes mapped and stored, output
// [2*R, N]); else plain rows (the real plane only, output [R, N]).
template <bool kPacked>
__global__ void __launch_bounds__(kAregThreads, 2)
reduce_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
              const float* __restrict__ t1r, const float* __restrict__ t1i,
              const float* __restrict__ bands, float* __restrict__ out, int R,
              int K, int S, float scale) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int r = blockIdx.x % R;
  const int col0 = (blockIdx.x / R) * kAregCols;
  const int t = threadIdx.x % kAregCols;
  const int g = threadIdx.x / kAregCols;
  const long long N = static_cast<long long>(kAregRows) * S;
  const int pos = g * S + col0 + t;  // row g; row g + 8 i at pos + i * step
  const int step = kAregG * S;

  float xr[kAregI], xi[kAregI];
  load_band(yr + static_cast<long long>(r) * N,
            yi + static_cast<long long>(r) * N, pos, step, xr, xi);
#pragma unroll
  for (int i = 0; i < kAregI; ++i) {
    const int p = pos + i * step;
    sm.t1[i][threadIdx.x] =
        make_float2(__ldg(t1r + p) * scale, __ldg(t1i + p) * scale);
  }
  areg_init_w128(sm.w128);
  if (threadIdx.x < K) {
    Band& b = sm.band[threadIdx.x];
    for (int c = 0; c < kBandCols; ++c)
      b.p[c] = bands[threadIdx.x * kBandCols + c];
    b.mode = static_cast<int>(b.p[0]);
    b.inv_ratio = 1.0f / b.p[2];
  }
  __syncthreads();

  float acc_r[kAregI], acc_i[kAregI];
#pragma unroll
  for (int i = 0; i < kAregI; ++i) acc_r[i] = acc_i[i] = 0.0f;

  for (int k = 0; k < K; ++k) {
    AregExchange& ex = sm.ex[k & 1];
#pragma unroll
    for (int i = 0; i < kAregI; ++i) {
      const float2 c = sm.t1[i][threadIdx.x];
      const float u = xr[i] * c.x - xi[i] * c.y;
      xi[i] = xr[i] * c.y + xi[i] * c.x;
      xr[i] = u;
    }
    areg_rows(xr, xi, ex, sm.w128, g, t);
    if (k + 1 < K) {
      const long long row = static_cast<long long>(k + 1) * R + r;
      load_band(yr + row * N, yi + row * N, pos, step, xr, xi);
    }
    __syncthreads();
    const Band& b = sm.band[k];
    float zr[kAregG], zi[kAregG];
    areg_cols(ex, g, 0, t, zr, zi);
    map_add_band<kPacked, 0>(b, zr, zi, acc_r, acc_i);
    areg_cols(ex, g, 1, t, zr, zi);
    map_add_band<kPacked, 1>(b, zr, zi, acc_r, acc_i);
  }

  float* o_re = out + static_cast<long long>(r) * N;
  float* o_im = out + static_cast<long long>(R + r) * N;
#pragma unroll
  for (int j = 0; j < kAregI; ++j) {
    o_re[pos + j * step] = acc_r[j];
    if (kPacked) o_im[pos + j * step] = acc_i[j];
  }
}

int launch(bool packed, const float* yr, const float* yi, const float* t1r,
           const float* t1i, const float* bands, float* out, int R, int K,
           int S, float scale, void* stream) {
  if (R <= 0) return 0;
  if (K <= 0 || K > kMaxBands || S <= 0 || S % kAregCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = packed ? reduce_kernel<true> : reduce_kernel<false>;
  // above the 48 KB a block gets without asking
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R * (S / kAregCols), kAregThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(yr, yi, t1r, t1i, bands, out,
                                                R, K, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yr, yi: [K*R2, 128*S]; bands: [K, 8]; out: [2*R2, 128*S].
extern "C" int amw_fft_reduce_packed(const float* yr, const float* yi,
                                     const float* t1r, const float* t1i,
                                     const float* bands, float* out, int R2,
                                     int K, int S, float scale,
                                     void* stream) {
  return launch(true, yr, yi, t1r, t1i, bands, out, R2, K, S, scale, stream);
}

// yr, yi: [K*R, 128*S]; bands: [K, 8]; out: [R, 128*S].
extern "C" int amw_fft_reduce(const float* yr, const float* yi,
                              const float* t1r, const float* t1i,
                              const float* bands, float* out, int R, int K,
                              int S, float scale, void* stream) {
  return launch(false, yr, yi, t1r, t1i, bands, out, R, K, S, scale, stream);
}
