// The split B/C stages of the staged FFT: forward B+C into the stored
// (permuted) spectrum, and inverse C+B from it under zero, one or K
// responses.
//
// Replaces three Pallas TPU kernels of amw_tpu/ops/fft_pallas.py, the
// stages of its split route (AMW_FFT_FUSED_RT=0) and of its split public
// API (fft_permuted, ifft_permuted, fwd_real, inv_multi, inv_multi_reduce):
//
// - `_stage_bc` (body `_stage_bc_kernel`), entry amw_fft_bc: per (row, a'),
//   y = W_B x, y = y * T2, Y = DFT_C(y) stored in the permuted order;
// - `_stage_cb` (body `_stage_cb_kernel`), entry amw_fft_cb: per (row, a'),
//   z = W_B^H (DFT_C^H(Y [* H]) * conj T2), with or without one response
//   H [2, nfft] (a template flag, not a plane of ones);
// - `_stage_cb_multi` (body `_stage_cb_multi_kernel`), entry
//   amw_fft_cb_multi: the same for K responses [K, 2, nfft] from one stored
//   spectrum, out [K*R, nfft].
//
// Planes are [R, nfft] viewed [R, 128, 128, C] (a', b, c); the stored
// spectrum holds natural bin k3 = p / c1 + C2 * (p % c1) at position p of a
// C-row (fft_pallas._perm), responses the same order.
//
// Design: the passes of the fused kernels' design (b) (fft_bccb.cu), with
// the spectrum stored between them:
//
//   amw_fft_bc:        col_dft128_kernel (forward B, T2) x -> out, then
//                      cstage_fwd_kernel in place on out (fft_cstage.cuh:
//                      c_forward, c_store_permuted);
//   amw_fft_cb(_multi): cstage_inv_kernel X -> out[k] (c_load_permuted
//                      reads each block of the spectrum once, then
//                      c_inverse_responses loops over the K responses, as
//                      the Pallas kernel does), then col_dft128_kernel
//                      (conj T2, inverse B) in place on out.
//
// Neither needs a scratch buffer: the C pass of amw_fft_bc reads its whole
// block before its first barrier and writes back over it.
//
// Bound on an H100: device-memory bytes (~90 f32 flops a point against
// 16-24 bytes).  At the split v1 batch's shapes (R = 8 packed rows,
// nfft = 2^23): kernel 6 reads and writes two planes, 1.07 GB (0.32 ms at
// 3.35 TB/s); kernel 10 at K = 2 reads two planes and two responses and
// writes 2K planes, 1.74 GB (0.52 ms); kernel 7 on one packed row reads two
// planes and a response and writes two planes, 0.20 GB (0.06 ms).  Design
// (b) moves each plane through device memory once more (the in-place
// second pass of each entry), so it sits above these bounds, as kernels 8
// and 9 do.
#include "fft_cstage.cuh"

using namespace amw_fft;

namespace {

// Block: kCElems points of y from blockIdx.x * kCElems; y may be z.
__global__ void __launch_bounds__(kThreads)
cstage_fwd_kernel(const float* zr, const float* zi, float* yr, float* yi,
                  int C, int logC) {
  __shared__ CTile t;
  const long long base = static_cast<long long>(blockIdx.x) * kCElems;
  c_twiddles(t, C);
  c_forward(zr, zi, base, t, C, logC);
  c_store_permuted(t, yr, yi, base, C);
}

template <bool kResp>
__global__ void __launch_bounds__(kThreads)
cstage_inv_kernel(const float* __restrict__ Xr, const float* __restrict__ Xi,
                  const float* __restrict__ resps, float* __restrict__ out_r,
                  float* __restrict__ out_i, long long plane, long long nfft,
                  int C, int logC, int K) {
  __shared__ CTile t;
  const long long base = static_cast<long long>(blockIdx.x) * kCElems;
  c_twiddles(t, C);
  c_load_permuted(Xr, Xi, base, t, C);
  c_inverse_responses<kResp>(t, resps, out_r, out_i, base, plane, nfft, C,
                             logC, K);
}

// x*: [R, nfft] stage-A output; t2*: forward T2 [128, C]; out*: [R, nfft].
int run_bc(const float* xr, const float* xi, const float* t2r,
           const float* t2i, float* out_r, float* out_i, int R, int C,
           cudaStream_t st) {
  if (R <= 0) return 0;
  const int logC = c_log2(C);
  if (logC < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long bc = static_cast<long long>(kN) * C;
  const long long nfft = kN * bc;
  const int strips = C / kCols;

  col_dft128_kernel<false, false, kOutPlanes>
      <<<R * kN * strips, kThreads, 0, st>>>(xr, xi, bc, bc, R * kN, C, t2r,
                                             t2i, out_r, out_i, 0, 1.0f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cstage_fwd_kernel<<<static_cast<unsigned>(R * nfft / kCElems), kThreads, 0,
                      st>>>(out_r, out_i, out_r, out_i, C, logC);
  return static_cast<int>(cudaGetLastError());
}

// X*: [R, nfft] stored spectrum; resps: [K, 2, nfft] (unread without
// with_resp); it2*: inverse T2 [128, C]; out*: [K*R, nfft].
int run_cb(const float* Xr, const float* Xi, const float* resps,
           const float* it2r, const float* it2i, float* out_r, float* out_i,
           int R, int C, int K, bool with_resp, cudaStream_t st) {
  if (R <= 0 || K <= 0) return 0;
  const int logC = c_log2(C);
  if (logC < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long bc = static_cast<long long>(kN) * C;
  const long long nfft = kN * bc;
  const int strips = C / kCols;
  const unsigned blocks = static_cast<unsigned>(R * nfft / kCElems);

  if (with_resp) {
    cstage_inv_kernel<true><<<blocks, kThreads, 0, st>>>(
        Xr, Xi, resps, out_r, out_i, R * nfft, nfft, C, logC, K);
  } else {
    cstage_inv_kernel<false><<<blocks, kThreads, 0, st>>>(
        Xr, Xi, resps, out_r, out_i, R * nfft, nfft, C, logC, K);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  col_dft128_kernel<true, false, kOutPlanes>
      <<<K * R * kN * strips, kThreads, 0, st>>>(
          out_r, out_i, bc, bc, K * R * kN, C, it2r, it2i, out_r, out_i, 0,
          1.0f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int amw_fft_bc(const float* xr, const float* xi, const float* t2r,
                          const float* t2i, float* out_r, float* out_i, int R,
                          int C, void* stream) {
  return run_bc(xr, xi, t2r, t2i, out_r, out_i, R, C,
                static_cast<cudaStream_t>(stream));
}

// One response resp [2, nfft] when with_resp, none otherwise (the inverse
// of amw_fft_bc); out*: [R, nfft].
extern "C" int amw_fft_cb(const float* Xr, const float* Xi, const float* resp,
                          const float* it2r, const float* it2i, float* out_r,
                          float* out_i, int R, int C, int with_resp,
                          void* stream) {
  return run_cb(Xr, Xi, resp, it2r, it2i, out_r, out_i, R, C, 1,
                with_resp != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int amw_fft_cb_multi(const float* Xr, const float* Xi,
                                const float* resps, const float* it2r,
                                const float* it2i, float* out_r, float* out_i,
                                int R, int C, int K, void* stream) {
  return run_cb(Xr, Xi, resps, it2r, it2i, out_r, out_i, R, C, K, true,
                static_cast<cudaStream_t>(stream));
}
