// The C pass of the staged FFT's B/C kernels, shared by fft_bccb.cu
// (kernels 8 and 9: the fused round trips) and fft_split.cu (kernels 6, 7
// and 10: the split stages); the Python side is
// amw_tpu_torch/ops/fft_staged.py.
//
// Planes [R, nfft] are viewed [R, 128, 128, C]; a "C-row" is the C points
// of one (row, a', b').  A block of a C pass owns the kCElems consecutive
// points from blockIdx.x * kCElems, i.e. kCElems / C whole C-rows of one
// signal row (kCElems divides every nfft of a plan).  In shared memory it
// runs C-point radix-2 transforms (bit-reversed in, natural order out) on
// all of its C-rows at once.
//
// The spectrum of a C-row is stored in the JAX package's permuted order
// (fft_pallas._perm): storage position p holds natural bin
// k3 = p / c1 + C2 * (p % c1), c1 = min(C, 128), C2 = C / c1.  The pieces:
//
//   c_forward           natural-order time rows -> natural-order spectrum
//   c_load_permuted     stored spectrum -> natural-order spectrum
//   c_store_permuted    natural-order spectrum -> stored spectrum
//   c_inverse_responses for k < K: (x response k at each storage position),
//                       inverse C-DFT, store time rows into out[k]
//
// Shared memory: two pairs of kCElems floats (spectrum, work) and the C/2
// twiddles, 36 KB a block.
#pragma once

#include "fft128.cuh"

namespace amw_fft {

constexpr int kCElems = 2048;  // complex points of a plane per block
constexpr int kMaxC = 1024;

struct CTile {
  float sr[kCElems], si[kCElems];  // spectrum, natural order
  float wr[kCElems], wi[kCElems];  // one inverse transform's work
  float twr[kMaxC / 2], twi[kMaxC / 2];
};

// In place over each C-point row of re/im [kCElems]: bit-reversed in,
// natural order out; `conj_tw` runs the inverse (conjugate) transform.
__device__ __forceinline__ void fft_rows(float* re, float* im,
                                         const float* twr, const float* twi,
                                         int C, int logC, bool conj_tw) {
  for (int s = 0; s < logC; ++s) {
    __syncthreads();
    const int half = 1 << s;
    const int step = C >> (s + 1);
    for (int b = threadIdx.x; b < kCElems / 2; b += kThreads) {
      const int row = b >> (logC - 1);
      const int bb = b & ((C >> 1) - 1);
      const int j = bb & (half - 1);
      const int i0 = (row << logC) + ((bb - j) << 1) + j;
      const int i1 = i0 + half;
      const float wr = twr[j * step];
      const float wi = conj_tw ? -twi[j * step] : twi[j * step];
      const float vr = re[i1], vi = im[i1];
      const float xr = vr * wr - vi * wi;
      const float xi = vr * wi + vi * wr;
      const float ur = re[i0], ui = im[i0];
      re[i0] = ur + xr;
      im[i0] = ui + xi;
      re[i1] = ur - xr;
      im[i1] = ui - xi;
    }
  }
  __syncthreads();
}

// W_C^j = exp(-2 pi i j / C), j < C/2.  fft_rows synchronises before it
// reads them.
__device__ __forceinline__ void c_twiddles(CTile& t, int C) {
  for (int j = threadIdx.x; j < C / 2; j += kThreads) {
    float s, c;
    sincospif(-static_cast<float>(j) / (C / 2), &s, &c);
    t.twr[j] = c;
    t.twi[j] = s;
  }
}

// Natural bin of storage position p of a C-row.
__device__ __forceinline__ int c_natural(int p, int c1, int C2) {
  return p / c1 + C2 * (p % c1);
}

// z[base, base + kCElems): natural time order -> t.sr/si, the C-DFT of
// each C-row in natural order.  Every read of the block precedes its first
// barrier, so a caller may write the result back over z.
__device__ __forceinline__ void c_forward(const float* zr, const float* zi,
                                          long long base, CTile& t, int C,
                                          int logC) {
  for (int e = threadIdx.x; e < kCElems; e += kThreads) {
    const int dst = (e & ~(C - 1)) + bitrev(e & (C - 1), logC);
    t.sr[dst] = zr[base + e];
    t.si[dst] = zi[base + e];
  }
  fft_rows(t.sr, t.si, t.twr, t.twi, C, logC, false);
}

// X[base, base + kCElems) in storage order -> t.sr/si in natural order.
__device__ __forceinline__ void c_load_permuted(const float* Xr,
                                                const float* Xi,
                                                long long base, CTile& t,
                                                int C) {
  const int c1 = C < kN ? C : kN;
  const int C2 = C / c1;
  for (int e = threadIdx.x; e < kCElems; e += kThreads) {
    const int dst = (e & ~(C - 1)) + c_natural(e & (C - 1), c1, C2);
    t.sr[dst] = Xr[base + e];
    t.si[dst] = Xi[base + e];
  }
  __syncthreads();
}

// t.sr/si (natural order) -> Y[base, base + kCElems) in storage order.
__device__ __forceinline__ void c_store_permuted(const CTile& t, float* Yr,
                                                 float* Yi, long long base,
                                                 int C) {
  const int c1 = C < kN ? C : kN;
  const int C2 = C / c1;
  for (int e = threadIdx.x; e < kCElems; e += kThreads) {
    const int src = (e & ~(C - 1)) + c_natural(e & (C - 1), c1, C2);
    Yr[base + e] = t.sr[src];
    Yi[base + e] = t.si[src];
  }
}

// For k < K: the spectrum in t.sr/si (natural order) times response k
// (resps [K, 2, nfft], storage order; none with !kResp), the inverse C-DFT,
// stored in natural time order at out[k * plane + base, + kCElems).
// Unscaled (the 1/nfft is in the inverse stage A).
template <bool kResp>
__device__ __forceinline__ void c_inverse_responses(
    CTile& t, const float* __restrict__ resps, float* __restrict__ out_r,
    float* __restrict__ out_i, long long base, long long plane,
    long long nfft, int C, int logC, int K) {
  const int c1 = C < kN ? C : kN;
  const int C2 = C / c1;
  const long long roff = base % nfft;  // offset inside the signal row
  for (int k = 0; k < K; ++k) {
    const float* hr =
        kResp ? resps + static_cast<long long>(k) * 2 * nfft + roff : nullptr;
    const float* hi = kResp ? hr + nfft : nullptr;
    for (int e = threadIdx.x; e < kCElems; e += kThreads) {
      const int rbase = e & ~(C - 1);
      const int k3 = c_natural(e & (C - 1), c1, C2);
      const float a = t.sr[rbase + k3], b = t.si[rbase + k3];
      const int dst = rbase + bitrev(k3, logC);
      if (kResp) {
        const float h0 = hr[e], h1 = hi[e];
        t.wr[dst] = a * h0 - b * h1;
        t.wi[dst] = a * h1 + b * h0;
      } else {
        t.wr[dst] = a;
        t.wi[dst] = b;
      }
    }
    fft_rows(t.wr, t.wi, t.twr, t.twi, C, logC, true);
    float* orr = out_r + static_cast<long long>(k) * plane + base;
    float* ori = out_i + static_cast<long long>(k) * plane + base;
    for (int e = threadIdx.x; e < kCElems; e += kThreads) {
      orr[e] = t.wr[e];
      ori[e] = t.wi[e];
    }
    __syncthreads();  // wr/wi are rewritten for the next response
  }
}

// log2 of a C the B/C kernels take (a power of two in [32, 1024]), or -1.
inline int c_log2(int C) {
  if (C < kCols || C > kMaxC || (C & (C - 1))) return -1;
  int logC = 0;
  while ((1 << logC) < C) ++logC;
  return logC;
}

}  // namespace amw_fft
