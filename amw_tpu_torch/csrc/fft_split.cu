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
// the spectrum stored between them, on the same register C pass
// (fft_creg.cuh: one warp a C-row, one instance per log2 C in 5..10,
// dispatch_log_c and launch_c_pass as kernels 8 and 9 have them):
//
//   amw_fft_bc:         col_dft128_kernel (forward B, T2) x -> out, then
//                       cstage_fwd_kernel in place on out (creg_forward,
//                       store_stored: the registers leave the forward in
//                       the stored order, written back as vectors);
//   amw_fft_cb(_multi): cstage_inv_kernel X -> out[k] (load_stored reads
//                       each stored C-row once into registers, then
//                       creg_responses loops over the K responses, as the
//                       Pallas kernel does; the C-rows walked
//                       position-major, creg_inv_rows), then
//                       col_dft128_kernel (conj T2, inverse B) in place on
//                       out.
//
// Neither needs a scratch buffer: a warp of cstage_fwd_kernel holds its
// whole C-row in registers before it writes, and the stored order permutes
// only within the C-row.
//
// Bound on an H100: device-memory bytes (~90 f32 flops a point against
// 16-24 bytes).  At the split v1 batch's shapes (R = 8 packed rows,
// nfft = 2^23, C = 512): kernel 6 reads and writes two planes, 1.07 GB
// (0.32 ms at 3.35 TB/s); kernel 7 reads two planes and a response and
// writes two planes, 1.14 GB (0.34 ms; one unpacked row 0.20 GB, 0.06
// ms); kernel 10 reads two planes and K responses and writes 2K planes,
// 1.75 GB (0.52 ms) at K = 2 and 2.95 GB (0.88 ms) at K = 4.  Each C pass
// alone moves the same bytes as its kernel, so its bound is the same; it
// reaches them only if the R rows share each response read, hence the
// position-major walk (row-major, each row streamed the responses again:
// 0.54 GB more a response at these shapes).
// Design (b) moves each plane through device memory once more (the
// in-place second pass of each entry), so it sits above these bounds, as
// kernels 8 and 9 do.
#include "fft128.cuh"
#include "fft_creg.cuh"

using namespace amw_fft;

namespace {

template <int kLogC>
__global__ void __launch_bounds__(kCRegThreads)
cstage_fwd_kernel(float* yr, float* yi, long long rows) {
  __shared__ float2 tw[1 << kLogC];
  creg_table<kLogC>(tw);
  __syncthreads();
  creg_fwd_rows<kLogC>(yr, yi, rows, tw);
}

template <int kLogC, bool kResp>
__global__ void __launch_bounds__(kCRegThreads)
cstage_inv_kernel(const float* __restrict__ Xr, const float* __restrict__ Xi,
                  const float* __restrict__ resps, float* __restrict__ out_r,
                  float* __restrict__ out_i, long long rows, long long plane,
                  long long nfft, int K) {
  __shared__ float2 tw[1 << kLogC];
  creg_table<kLogC>(tw);
  __syncthreads();
  creg_inv_rows<kLogC, kResp>(Xr, Xi, resps, out_r, out_i, rows, plane, nfft,
                              K, tw);
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

  const long long rows = R * (nfft >> logC);
  return static_cast<int>(dispatch_log_c(logC, [&](auto lc) {
    return launch_c_pass(cstage_fwd_kernel<decltype(lc)::value>, rows, st,
                         out_r, out_i, rows);
  }));
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

  const long long rows = R * (nfft >> logC);
  const cudaError_t err = dispatch_log_c(logC, [&](auto lc) {
    constexpr int kLogC = decltype(lc)::value;
    return with_resp
               ? launch_c_pass(cstage_inv_kernel<kLogC, true>, rows, st, Xr,
                               Xi, resps, out_r, out_i, rows, R * nfft, nfft,
                               K)
               : launch_c_pass(cstage_inv_kernel<kLogC, false>, rows, st, Xr,
                               Xi, resps, out_r, out_i, rows, R * nfft, nfft,
                               K);
  });
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
