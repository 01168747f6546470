// The C pass of the staged FFT's fused round trips (kernels 8 and 9,
// fft_bccb.cu): per C-row of the B pass's output, the forward C-DFT into
// the stored (permuted) order, then for each response the product and the
// inverse C-DFT back to natural time order.  C-points in registers, one
// warp per C-row, C a compile-time constant (kLogC 5..10: C = 32..1024).
//
// The JAX kernel's factorisation (amw_tpu/ops/fft_pallas.py `_cstage_fwd`,
// `_cstage_inv`): C = C2 * c1 with c1 = min(C, 128), a radix-C2 butterfly
// across the C2 chunks, the chunk twiddle W_C^(j k2'), then one c1-point
// DFT per chunk, which leaves output chunk k2' at positions k2' * c1 +
// [0, c1).  Here lane t of the warp holds points n = t + 32 j (j < P,
// P = C / 32: coalesced loads and stores), so n = c2 * c1 + (t + 32 m)
// with c2 the high log2(C2) bits of j and m its low two (C >= 128):
//
//   1. in registers, a P-point radix-2 DIF over j: its first log2(C2)
//      stages are the radix-C2 butterfly, their twiddles with the next
//      stages' the W_P^(m k2') part of the chunk twiddle, its last two
//      stages the radix-4 step of the c1-point DFT over m.  Register r then
//      holds q = bitrev(r) = k2' + C2 * ka;
//   2. times W_C^(t q): the rest of the chunk twiddle (W_C^(t k2')) and the
//      c1-point DFT's own twiddle (W_128^(t ka)), from a [P, 32] table in
//      shared memory (lane t reads row q at column t: no bank conflict);
//   3. across the lanes, a 32-point radix-2 DIF over t by __shfl_xor_sync:
//      lane l then holds kb = bitrev5(l) of bin k = q + P * kb.
//
// Bin k = k2' + C2 * k1 with k1 = ka + 4 kb is stored at p = k2' * c1 + k1
// (fft_pallas._perm): a compile-time offset per register plus (P / C2) * kb
// per lane, so the response is read where the bin already is (inside one
// c1-chunk, whose bytes the warp reads whole) and nothing is gathered or
// divided at run time.  The inverse runs the adjoint steps in reverse (DIT
// across the lanes from the bit-reversed lanes to natural t, the conjugate
// table, DIT in registers to natural j), so the output is stored as the
// input was loaded.  C < 128 is the case C2 = 1, c1 = C: the same code.
//
// Why shuffles and not a transpose through shared memory: with P points a
// lane the 32-point step is five exchanges of 2P floats and no barrier;
// the data never touch shared memory, and the order the DIF leaves them in
// (bit-reversed lanes) is exactly what the inverse DIT takes.
//
// Every loop over registers or stages has compile-time bounds and is
// unrolled, so each register index and each W_P twiddle is a constant
// (cos(pi m / 16) literals); the per-lane twiddles of step 3 are computed
// once per thread, the [P, 32] table once per block (sincospif of exact
// arguments).  f32 throughout.
#pragma once

#include <cuda_runtime.h>

namespace amw_fft {

constexpr int kCRegWarps = 4;                  // warps (C-row workers) a block
constexpr int kCRegThreads = 32 * kCRegWarps;  // 128
constexpr unsigned kFullMask = 0xffffffffu;

// cos(pi m / 16), 0 <= m <= 8.
__device__ __forceinline__ float cos_pi16(int m) {
  switch (m) {
    case 0: return 1.0f;
    case 1: return 0.98078528040323044913f;
    case 2: return 0.92387953251128675613f;
    case 3: return 0.83146961230254523708f;
    case 4: return 0.70710678118654752440f;
    case 5: return 0.55557023301960222474f;
    case 6: return 0.38268343236508977173f;
    case 7: return 0.19509032201612826785f;
    default: return 0.0f;
  }
}

// W_32^i = exp(-2 pi i i / 32), 0 <= i < 16 (compile-time i after
// unrolling, so this folds to two constants).
__device__ __forceinline__ void w32(int i, float& wr, float& wi) {
  if (i <= 8) {
    wr = cos_pi16(i);
    wi = -cos_pi16(8 - i);
  } else {
    wr = -cos_pi16(16 - i);
    wi = -cos_pi16(i - 8);
  }
}

template <int kBits>
__device__ __forceinline__ constexpr int rev_bits(int v) {
  int r = 0;
  for (int b = 0; b < kBits; ++b) r |= ((v >> b) & 1) << (kBits - 1 - b);
  return r;
}

template <int kLogC>
struct CReg {
  static constexpr int C = 1 << kLogC;
  static constexpr int P = C / 32;          // points a lane
  static constexpr int kLogP = kLogC - 5;
  static constexpr int c1 = C < 128 ? C : 128;
  static constexpr int C2 = C / c1;
  static constexpr int kLaneStride = P / C2;  // stored stride of kb

  // Stored position of register r's bin, less kLaneStride * kb.
  static __device__ __forceinline__ constexpr int pos(int r) {
    return (rev_bits<kLogP>(r) % C2) * c1 + rev_bits<kLogP>(r) / C2;
  }
};

// Radix-2 DIF over P registers: natural in, register r holds bin
// bitrev(r) out.  Twiddles W_(2h)^o = W_32^(o * 16 / h), constants.
template <int kLogP>
__device__ __forceinline__ void dif_regs(float* xr, float* xi) {
  constexpr int P = 1 << kLogP;
#pragma unroll
  for (int s = kLogP - 1; s >= 0; --s) {
    const int h = 1 << s;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i & h) continue;
      const int o = i & (h - 1);
      const float ar = xr[i], ai = xi[i], br = xr[i + h], bi = xi[i + h];
      xr[i] = ar + br;
      xi[i] = ai + bi;
      const float dr = ar - br, di = ai - bi;
      if (o == 0) {
        xr[i + h] = dr;
        xi[i + h] = di;
      } else {
        float wr, wi;
        w32(o * (16 / h), wr, wi);
        xr[i + h] = dr * wr - di * wi;
        xi[i + h] = dr * wi + di * wr;
      }
    }
  }
}

// Radix-2 DIT over P registers with conjugate twiddles (the adjoint of
// dif_regs): register r holds bin bitrev(r) in, natural order out.
template <int kLogP>
__device__ __forceinline__ void dit_regs_conj(float* xr, float* xi) {
  constexpr int P = 1 << kLogP;
#pragma unroll
  for (int s = 0; s < kLogP; ++s) {
    const int h = 1 << s;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i & h) continue;
      const int o = i & (h - 1);
      float br = xr[i + h], bi = xi[i + h];
      if (o != 0) {
        float wr, wi;
        w32(o * (16 / h), wr, wi);
        const float tr = br * wr + bi * wi;  // times conj(W)
        bi = bi * wr - br * wi;
        br = tr;
      }
      const float ar = xr[i], ai = xi[i];
      xr[i] = ar + br;
      xi[i] = ai + bi;
      xr[i + h] = ar - br;
      xi[i + h] = ai - bi;
    }
  }
}

// Per-lane twiddles of the 32-point step: stage s (h = 2^s, s = 1..4)
// pairs lane l with l ^ h; the upper lane's factor is W_(2h)^(l & (h-1)),
// the lower lane's 1.  wxr/wxi[s - 1].
__device__ __forceinline__ void lane_twiddles(int lane, float* wxr,
                                              float* wxi) {
#pragma unroll
  for (int s = 1; s < 5; ++s) {
    const int h = 1 << s;
    float sn = 0.0f, cs = 1.0f;
    if (lane & h)
      sincospif(-static_cast<float>(lane & (h - 1)) / h, &sn, &cs);
    wxr[s - 1] = cs;
    wxi[s - 1] = sn;
  }
}

// 32-point radix-2 DIF across the lanes, per register: lane t holds point
// t in, lane l holds bin bitrev5(l) out.
template <int P>
__device__ __forceinline__ void dif_lanes(float* xr, float* xi, int lane,
                                          const float* wxr,
                                          const float* wxi) {
#pragma unroll
  for (int s = 4; s >= 0; --s) {
    const int h = 1 << s;
    const float sg = (lane & h) ? -1.0f : 1.0f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float pr = __shfl_xor_sync(kFullMask, xr[r], h);
      const float pi = __shfl_xor_sync(kFullMask, xi[r], h);
      // lower lane: mine + partner's; upper: (partner's - mine) * W
      const float dr = fmaf(sg, xr[r], pr), di = fmaf(sg, xi[r], pi);
      if (s == 0) {
        xr[r] = dr;
        xi[r] = di;
      } else {
        xr[r] = dr * wxr[s - 1] - di * wxi[s - 1];
        xi[r] = dr * wxi[s - 1] + di * wxr[s - 1];
      }
    }
  }
}

// The adjoint of dif_lanes (DIT, conjugate twiddles): lane l holds bin
// bitrev5(l) in, lane t holds point t out.
template <int P>
__device__ __forceinline__ void dit_lanes_conj(float* xr, float* xi,
                                               int lane, const float* wxr,
                                               const float* wxi) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 1 << s;
    const float sg = (lane & h) ? -1.0f : 1.0f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      float vr = xr[r], vi = xi[r];
      if (s != 0) {  // the upper lane's value times conj(W); the lower's 1
        const float tr = vr * wxr[s - 1] + vi * wxi[s - 1];
        vi = vi * wxr[s - 1] - vr * wxi[s - 1];
        vr = tr;
      }
      const float pr = __shfl_xor_sync(kFullMask, vr, h);
      const float pi = __shfl_xor_sync(kFullMask, vi, h);
      // lower lane: mine + partner's; upper: partner's - mine
      xr[r] = fmaf(sg, vr, pr);
      xi[r] = fmaf(sg, vi, pi);
    }
  }
}

// tw[q * 32 + t] = W_C^(t q), q < P, t < 32: the block's step-2 table.
// All threads of the block call it; the caller synchronises after it.
template <int kLogC>
__device__ __forceinline__ void creg_table(float2* tw) {
  constexpr int C = 1 << kLogC;
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    const int m = ((e >> 5) * (e & 31)) & (C - 1);
    float sn, cs;
    sincospif(-static_cast<float>(2 * m) / C, &sn, &cs);
    tw[e] = make_float2(cs, sn);
  }
}

// The C pass over `rows` C-rows of z* (row g at g * C): the forward C-DFT,
// then for k < K the product with resps[k] (resps [K, 2, nfft], storage
// order; row g's stored positions at (g * C) mod nfft) and the inverse
// C-DFT, stored unscaled at out*[k * plane + g * C].  Warp w of the grid
// takes rows w, w + (warps of the grid), ...; `tw` is creg_table's, built
// and synchronised by the caller.
template <int kLogC>
__device__ __forceinline__ void creg_rows(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ resps, float* __restrict__ out_r,
    float* __restrict__ out_i, long long rows, long long plane,
    long long nfft, int K, const float2* tw) {
  using G = CReg<kLogC>;
  constexpr int P = G::P;
  const int lane = threadIdx.x & 31;
  float wxr[4], wxi[4];
  lane_twiddles(lane, wxr, wxi);
  const int lane_pos = G::kLaneStride * rev_bits<5>(lane);
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long g = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       g < rows; g += warps) {
    const long long base = g * G::C;
    float xr[P], xi[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      xr[j] = zr[base + lane + 32 * j];
      xi[j] = zi[base + lane + 32 * j];
    }
    dif_regs<G::kLogP>(xr, xi);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float2 w = tw[rev_bits<G::kLogP>(r) * 32 + lane];
      const float tr = xr[r] * w.x - xi[r] * w.y;
      xi[r] = xr[r] * w.y + xi[r] * w.x;
      xr[r] = tr;
    }
    dif_lanes<P>(xr, xi, lane, wxr, wxi);

    const float* hr = resps + (base & (nfft - 1)) + lane_pos;
    for (int k = 0; k < K; ++k, hr += 2 * nfft) {
      float yr[P], yi[P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const float h0 = __ldg(hr + G::pos(r));
        const float h1 = __ldg(hr + nfft + G::pos(r));
        yr[r] = xr[r] * h0 - xi[r] * h1;
        yi[r] = xr[r] * h1 + xi[r] * h0;
      }
      dit_lanes_conj<P>(yr, yi, lane, wxr, wxi);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const float2 w = tw[rev_bits<G::kLogP>(r) * 32 + lane];
        const float tr = yr[r] * w.x + yi[r] * w.y;  // times conj(W)
        yi[r] = yi[r] * w.x - yr[r] * w.y;
        yr[r] = tr;
      }
      dit_regs_conj<G::kLogP>(yr, yi);
      float* orr = out_r + k * plane + base + lane;
      float* ori = out_i + k * plane + base + lane;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        orr[32 * j] = yr[j];
        ori[32 * j] = yi[j];
      }
    }
  }
}

}  // namespace amw_fft
