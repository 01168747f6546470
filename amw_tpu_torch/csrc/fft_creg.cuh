// The C pass of the staged FFT's five B/C kernels: the fused round trips
// (kernels 8 and 9, fft_bccb.cu: forward C-DFT, K responses, inverse) and
// the split stages (kernels 6, 7 and 10, fft_split.cu: the forward C-DFT
// into the stored spectrum; the inverse from it under zero, one or K
// responses).  Per C-row of the B pass's output, C-points in registers,
// one warp per C-row, C a compile-time constant (kLogC 5..10: C =
// 32..1024).
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
// Bin k = k2' + C2 * k1 with k1 = ka + V kb (V = P / C2 = min(C, 128) / 32)
// is stored at p = k2' * c1 + k1 (fft_pallas._perm): the V registers of
// one k2' hold V consecutive stored positions, k2' * c1 + V kb + [0, V).
// So a lane moves them as one aligned vector (float4 at C >= 128, float2
// at 64, a float at 32), a warp covers each c1-chunk's bytes whole, and
// nothing is gathered or divided at run time.  The inverse runs the
// adjoint steps in reverse (DIT across the lanes from the bit-reversed
// lanes to natural t, the conjugate table, DIT in registers to natural
// j), so its output is stored as the forward's input was loaded.  C < 128
// is the case C2 = 1, c1 = C: the same code.
//
// The pieces, one register layout: creg_forward (natural C-row ->
// registers), store_stored / load_stored (registers <-> the stored
// order), creg_responses (for k < K: the product with response k, the
// inverse, the natural C-row into output k).  Two row walks compose them:
// creg_rows (8, 9) and creg_inv_rows (7, 10); their kernels are instances
// per log2 C launched by launch_c_pass, a grid of the blocks resident on
// the card walking the C-rows.  Kernel 6 (fft_split.cu) runs creg_forward
// on the C-rows of a tile in shared memory and store_stored to the stored
// spectrum, inside its one pass.
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

#include <type_traits>

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
  static constexpr int V = P / C2;  // stored stride of kb: 1, 2 or 4

  // The register that holds bin k2' + C2 * (ka + V kb), stored at
  // k2' * c1 + V kb + ka.
  static __device__ __forceinline__ constexpr int reg(int k2, int ka) {
    return rev_bits<kLogP>(k2 + C2 * ka);
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

// V consecutive floats at p, aligned to V floats, as one access; the
// loads through the read-only path (what they read is not written by the
// kernel).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The warp's per-lane constants: its lane, the stored offset of its bins
// (V * bitrev5(lane)) and the twiddles of the 32-point step.
struct CRegLane {
  int lane, pos;
  float wxr[4], wxi[4];
};

template <int kLogC>
__device__ __forceinline__ CRegLane creg_lane() {
  CRegLane L;
  L.lane = threadIdx.x & 31;
  L.pos = CReg<kLogC>::V * rev_bits<5>(L.lane);
  lane_twiddles(L.lane, L.wxr, L.wxi);
  return L;
}

// (a) The C-row at z* (natural order) -> the forward C-DFT in x*: register
// r of lane l holds the bin stored at k2' * c1 + ka + V * bitrev5(l) for
// r = CReg::reg(k2', ka).  `tw` is creg_table's.
template <int kLogC>
__device__ __forceinline__ void creg_forward(const float* zr, const float* zi,
                                             const CRegLane& L,
                                             const float2* tw, float* xr,
                                             float* xi) {
  using G = CReg<kLogC>;
  constexpr int P = G::P;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    xr[j] = zr[L.lane + 32 * j];
    xi[j] = zi[L.lane + 32 * j];
  }
  dif_regs<G::kLogP>(xr, xi);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const float2 w = tw[rev_bits<G::kLogP>(r) * 32 + L.lane];
    const float tr = xr[r] * w.x - xi[r] * w.y;
    xi[r] = xr[r] * w.y + xi[r] * w.x;
    xr[r] = tr;
  }
  dif_lanes<P>(xr, xi, L.lane, L.wxr, L.wxi);
}

// (b) x* -> the stored order of the C-row at y*: per chunk k2' one vector
// of V floats a lane and plane at k2' * c1 + L.pos.
template <int kLogC>
__device__ __forceinline__ void store_stored(const float* xr,
                                             const float* xi,
                                             const CRegLane& L, float* yr,
                                             float* yi) {
  using G = CReg<kLogC>;
#pragma unroll
  for (int k2 = 0; k2 < G::C2; ++k2) {
    float vr[G::V], vi[G::V];
#pragma unroll
    for (int ka = 0; ka < G::V; ++ka) {
      vr[ka] = xr[G::reg(k2, ka)];
      vi[ka] = xi[G::reg(k2, ka)];
    }
    store_vec<G::V>(yr + k2 * G::c1 + L.pos, vr);
    store_vec<G::V>(yi + k2 * G::c1 + L.pos, vi);
  }
}

// The inverse of store_stored: the stored C-row at y* -> x*, as
// creg_forward leaves them.
template <int kLogC>
__device__ __forceinline__ void load_stored(const float* yr, const float* yi,
                                            const CRegLane& L, float* xr,
                                            float* xi) {
  using G = CReg<kLogC>;
#pragma unroll
  for (int k2 = 0; k2 < G::C2; ++k2) {
    float vr[G::V], vi[G::V];
    load_vec<G::V>(yr + k2 * G::c1 + L.pos, vr);
    load_vec<G::V>(yi + k2 * G::c1 + L.pos, vi);
#pragma unroll
    for (int ka = 0; ka < G::V; ++ka) {
      xr[G::reg(k2, ka)] = vr[ka];
      xi[G::reg(k2, ka)] = vi[ka];
    }
  }
}

// (c) For k < K: y = x times response k (with kResp; resps [K, 2, nfft] in
// the stored order, hr = resps + the C-row's offset in its signal row),
// or x itself (without: K = 1, hr unread), then the inverse C-DFT, stored
// unscaled in natural order at out*[k * plane].
template <int kLogC, bool kResp>
__device__ __forceinline__ void creg_responses(
    const float* xr, const float* xi, const float* hr, long long nfft, int K,
    const CRegLane& L, const float2* tw, float* out_r, float* out_i,
    long long plane) {
  using G = CReg<kLogC>;
  constexpr int P = G::P;
  hr += L.pos;
  for (int k = 0; k < (kResp ? K : 1); ++k, hr += 2 * nfft) {
    float yr[P], yi[P];
    if constexpr (kResp) {
#pragma unroll
      for (int k2 = 0; k2 < G::C2; ++k2) {
        float h0[G::V], h1[G::V];
        load_vec<G::V>(hr + k2 * G::c1, h0);
        load_vec<G::V>(hr + nfft + k2 * G::c1, h1);
#pragma unroll
        for (int ka = 0; ka < G::V; ++ka) {
          const int r = G::reg(k2, ka);
          yr[r] = xr[r] * h0[ka] - xi[r] * h1[ka];
          yi[r] = xr[r] * h1[ka] + xi[r] * h0[ka];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        yr[r] = xr[r];
        yi[r] = xi[r];
      }
    }
    dit_lanes_conj<P>(yr, yi, L.lane, L.wxr, L.wxi);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float2 w = tw[rev_bits<G::kLogP>(r) * 32 + L.lane];
      const float tr = yr[r] * w.x + yi[r] * w.y;  // times conj(W)
      yi[r] = yi[r] * w.x - yr[r] * w.y;
      yr[r] = tr;
    }
    dit_regs_conj<G::kLogP>(yr, yi);
    float* orr = out_r + k * plane + L.lane;
    float* ori = out_i + k * plane + L.lane;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      orr[32 * j] = yr[j];
      ori[32 * j] = yi[j];
    }
  }
}

// The grid's walk over C-rows: warp w of the grid takes rows w, w + (warps
// of the grid), ...
__device__ __forceinline__ long long creg_first_row() {
  return static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
         (threadIdx.x >> 5);
}

__device__ __forceinline__ long long creg_row_step() {
  return static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
}

// Kernels 8 and 9: over `rows` C-rows of z* (row g at g * C), the forward
// C-DFT, then for k < K the product with resps[k] (resps [K, 2, nfft],
// stored order; row g's stored positions at (g * C) mod nfft) and the
// inverse C-DFT, stored unscaled at out*[k * plane + g * C].  `tw` is
// creg_table's, built and synchronised by the caller.
template <int kLogC>
__device__ __forceinline__ void creg_rows(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ resps, float* __restrict__ out_r,
    float* __restrict__ out_i, long long rows, long long plane,
    long long nfft, int K, const float2* tw) {
  using G = CReg<kLogC>;
  const CRegLane L = creg_lane<kLogC>();
  for (long long g = creg_first_row(); g < rows; g += creg_row_step()) {
    const long long base = g * G::C;
    float xr[G::P], xi[G::P];
    creg_forward<kLogC>(zr + base, zi + base, L, tw, xr, xi);
    creg_responses<kLogC, true>(xr, xi, resps + (base & (nfft - 1)), nfft,
                                K, L, tw, out_r + base, out_i + base, plane);
  }
}

// Kernels 7 and 10: each stored C-row of X* (read once) under K responses
// (kResp; none and K = 1 without), the inverse C-DFT, stored unscaled at
// out*[k * plane + g * C].  The walk is position-major: the grid's
// consecutive warps take one C-row position in each of the R signal rows,
// so the response segment they share comes from device memory once and
// from L2 for the others (a response plane, 32 MB at nfft = 2^23, does
// not stay in L2 while a signal row streams by).
template <int kLogC, bool kResp>
__device__ __forceinline__ void creg_inv_rows(
    const float* __restrict__ Xr, const float* __restrict__ Xi,
    const float* __restrict__ resps, float* __restrict__ out_r,
    float* __restrict__ out_i, long long rows, long long plane,
    long long nfft, int K, const float2* tw) {
  using G = CReg<kLogC>;
  const CRegLane L = creg_lane<kLogC>();
  const long long per_row = nfft >> kLogC;  // C-rows a signal row
  const long long R = rows / per_row;
  for (long long w = creg_first_row(); w < rows; w += creg_row_step()) {
    const long long base = ((w % R) * per_row + w / R) * G::C;
    float xr[G::P], xi[G::P];
    load_stored<kLogC>(Xr + base, Xi + base, L, xr, xi);
    creg_responses<kLogC, kResp>(xr, xi, resps + (base & (nfft - 1)), nfft,
                                 K, L, tw, out_r + base, out_i + base,
                                 plane);
  }
}

// log2 of a C the B/C kernels take (a power of two in [32, 1024]), or -1.
inline int c_log2(int C) {
  if (C < 32 || C > 1024 || (C & (C - 1))) return -1;
  int logC = 0;
  while ((1 << logC) < C) ++logC;
  return logC;
}

// f(std::integral_constant<int, logC>{}) for the C-pass instance of logC
// (c_log2's): every index of an instance is a shift or a mask.
template <typename F>
cudaError_t dispatch_log_c(int logC, F&& f) {
  switch (logC) {
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    default: return cudaErrorInvalidValue;
  }
}

// Launches a C-pass kernel over `rows` C-rows: blocks of kCRegWarps warps,
// at most as many as are resident on the card together, walk the rows
// grid-stride.
template <typename... Params, typename... Args>
cudaError_t launch_c_pass(void (*kernel)(Params...), long long rows,
                          cudaStream_t st, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kCRegThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (rows + kCRegWarps - 1) / kCRegWarps;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), kCRegThreads, 0, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace amw_fft
