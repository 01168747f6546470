// Forward B+C, K responses, inverse C+B of the staged FFT.
//
// Replaces two Pallas TPU kernels of amw_tpu/ops/fft_pallas.py:
// `_stage_bccb_multi` (:684, body `_stage_bccb_multi_kernel` :441, C stage
// `_cstage_fwd` / `_cstage_inv` :334 / :361), entry amw_fft_bccb, and
// `_stage_bc_cb` (:658, body `_stage_bc_cb_kernel` :418, the same round
// trip under one response [2, nfft], the `apply_response` of every
// zero-phase pass), entry amw_fft_bc_cb: the K = 1 instance of the same
// three passes.  Input: stage
// A's output, two planes
// [R, nfft] viewed [R, 128, 128, C] (a', b, c); responses [K, 2, nfft] in
// the permuted storage order (k3 = p / c1 + C2 * (p % c1) at position p of a
// C-row, c1 = min(C, 128), C2 = C / c1).  Output: two planes [K*R, nfft]
// (= [K, R, 128, 128, C]) ready for the inverse stage A.  Per (row, a'):
//
//   y = W_B x          (128-point DFT along b)
//   y = y * T2         (T2[b', c] = W_(128 C)^(b' c))
//   Y = DFT_C(y)       (along c, per b')
//   z_k = W_B^H (DFT_C^H(Y * H_k) * conj T2)    for k < K.
//
// On the TPU the whole [128, C] complex tile of one (row, a') sits in VMEM
// (512 KB at C = 512) and never leaves it.  An SM has 227 KB of shared
// memory, so the tile fits one block only for C <= 128.  This port takes
// the split through device memory that works for every C in 32..1024
// (design (b)), three kernels launched by amw_fft_bccb:
//
//   1. breg_fwd_kernel (fft_breg.cuh): forward B and T2, x -> scratch z;
//   2. cstage_multi_kernel: per C-row of z, the forward C-DFT, then for
//      each response the product and the inverse C-DFT, into out[k]
//      (fft_creg.cuh: creg_table, creg_rows);
//   3. breg_inv_kernel: conj T2 and inverse B, in place on out.
//
// The B passes (fft_breg.cuh) run the 128-point DFT along b in registers on
// fft_areg.cuh's transform, the forward by swapping real and imaginary
// parts, one exchange through shared memory and one barrier a block, T2 on
// the registers from the plan's tables.  The split stages (kernels 6, 7, 10
// in fft_split.cu) run the same transforms with the spectrum stored in
// between: 7 and 10 as passes 2-3 of this design, 6 as passes 1-2 fused
// into one pass whose tile stays on chip in a thread-block cluster's
// shared memory.
//
// Bound on an H100: device-memory bytes.  The fused bound (x read once, K
// responses read once, K outputs written once) at the 180 s slice's shapes
// (R = 8, nfft = 2^23) is 1.14 GB (0.34 ms at 3.35 TB/s) at K = 1, 1.75 GB
// (0.52 ms) at K = 2 and 2.95 GB (0.88 ms) at K = 4.  The three passes move
// more, each reading and writing its planes once:
//
//   pass 1: x read, z written: 4 planes of R rows, 1.07 GB (0.32 ms);
//   pass 2: z read, K responses read, K outputs written: the fused bytes,
//           so its bound is the same 0.34 / 0.52 / 0.88 ms;
//   pass 3: the K outputs read and written again: 4K planes, K x 1.07 GB
//           (K x 0.32 ms).
//
// So three passes cannot go under 0.98 / 1.48 / 2.48 ms at K = 1 / 2 / 4.
// A cluster-fused round trip that keeps the tile on chip, as kernel 6 does
// (fft_split.cu), is later work.
//
// The C pass (fft_creg.cuh) keeps a C-row's points in registers, one warp
// a row, in the JAX kernel's own factorisation, so the spectrum comes out
// in the stored order: each response is read where the bin already is,
// with no gather, no runtime division and no block-wide barrier per stage
// (one barrier a block, after its twiddle table).  C is a template
// parameter (one instance per log2 C in 5..10, dispatch_log_c); blocks of
// 4 warps walk the C-rows grid-stride, as many as fit on the card at once
// (launch_c_pass).
#include "fft_breg.cuh"
#include "fft_creg.cuh"

using namespace amw_fft;

namespace {

template <int kLogC>
__global__ void __launch_bounds__(kCRegThreads)
cstage_multi_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                    const float* __restrict__ resps,
                    float* __restrict__ out_r, float* __restrict__ out_i,
                    long long rows, long long plane, long long nfft, int K) {
  __shared__ float2 tw[1 << kLogC];
  creg_table<kLogC>(tw);
  __syncthreads();
  creg_rows<kLogC>(zr, zi, resps, out_r, out_i, rows, plane, nfft, K, tw);
}

// x*: [R, nfft] stage-A output; resps: [K, 2, nfft]; t2*/it2*: [128, C]
// forward / inverse T2; z*: [R, nfft] scratch; out*: [K*R, nfft].
int run_bccb(const float* xr, const float* xi, const float* resps,
             const float* t2r, const float* t2i, const float* it2r,
             const float* it2i, float* zr, float* zi, float* out_r,
             float* out_i, int R, int C, int K, cudaStream_t st) {
  if (R <= 0 || K <= 0) return 0;
  const int logC = c_log2(C);
  if (logC < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nfft = static_cast<long long>(kAregRows) * kAregRows * C;
  const long long mats = static_cast<long long>(R) * kAregRows;

  cudaError_t err =
      launch_b_pass(false, xr, xi, t2r, t2i, zr, zi, mats, C, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows = R * (nfft >> logC);
  err = dispatch_log_c(logC, [&](auto lc) {
    return launch_c_pass(cstage_multi_kernel<decltype(lc)::value>, rows, st,
                         zr, zi, resps, out_r, out_i, rows, R * nfft, nfft, K);
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  return static_cast<int>(launch_b_pass(true, out_r, out_i, it2r, it2i, out_r,
                                        out_i, K * mats, C, st));
}

}  // namespace

extern "C" int amw_fft_bccb(const float* xr, const float* xi,
                            const float* resps, const float* t2r,
                            const float* t2i, const float* it2r,
                            const float* it2i, float* zr, float* zi,
                            float* out_r, float* out_i, int R, int C, int K,
                            void* stream) {
  return run_bccb(xr, xi, resps, t2r, t2i, it2r, it2i, zr, zi, out_r, out_i,
                  R, C, K, static_cast<cudaStream_t>(stream));
}

// As amw_fft_bccb with one response resp [2, nfft]; out*: [R, nfft].
extern "C" int amw_fft_bc_cb(const float* xr, const float* xi,
                             const float* resp, const float* t2r,
                             const float* t2i, const float* it2r,
                             const float* it2i, float* zr, float* zi,
                             float* out_r, float* out_i, int R, int C,
                             void* stream) {
  return run_bccb(xr, xi, resp, t2r, t2i, it2r, it2i, zr, zi, out_r, out_i,
                  R, C, 1, static_cast<cudaStream_t>(stream));
}
