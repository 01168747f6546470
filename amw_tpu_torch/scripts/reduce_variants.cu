// Variants of the packed reduce kernel (csrc/fft_reduce.cu reduce_kernel
// <true>, kernel 11), for amw_tpu_torch/scripts/ab_reduce.py --variants:
// the same blocks, loads and stores with parts of the work switched off,
// to see which part holds the kernel back.
//   kPart 0 (loads): every band's loads and t1 once, their product summed
//     over the bands and stored, no transform and no maps;
//   kPart 1 (transform): the loads and the 128-point DFT with its exchange
//     (csrc/fft_areg.cuh), the bands summed without maps;
//   kPart 2 (whole): the package kernel's work, the maps included;
//   kPart 3 (no prefetch): the whole kernel with band k's loads issued at
//     the top of band k, not before band k - 1's barrier;
//   kPart 4 (copysign): the whole kernel with the map's sign restored by
//     copysignf(oa, x) instead of two compares and two selects (the same
//     result but for a NaN sample in mode 2).
// kMinBlocks is __launch_bounds__' blocks an SM (2: at most 128 registers,
// the package's; 1: at most 255).  Only the soft-knee and bypass maps (the
// standard config's modes 3 and 0) are compiled.  Built by the script with
// nvcc into amw_tpu_torch/_build/; not part of the package.
#include "../csrc/fft_areg.cuh"

using namespace amw_fft;

namespace {

struct Band {
  float p[8];
  float inv_ratio;
  int mode;
};

struct Smem {
  AregExchange ex[2];
  float2 t1[kAregI][kAregThreads];
  float2 w128[kAregRows];
  Band band[8];
};
constexpr int kSmem = static_cast<int>(sizeof(Smem));

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

template <bool kCopysign>
__device__ __forceinline__ float soft_knee(float x, const Band& b) {
  float y = x;
  if (b.mode != 0) {
    const float ax = fabsf(x);
    float oa = ax <= b.p[3]   ? ax
               : ax >= b.p[4] ? b.p[1] + (ax - b.p[1]) * b.inv_ratio
                              : b.p[3] + (ax - b.p[3]) * b.p[5];
    oa = fmaxf(oa, 0.0f);
    y = kCopysign ? copysignf(oa, x)
                  : (x > 0.0f ? oa : (x < 0.0f ? -oa : 0.0f));
  }
  y = fminf(fmaxf(y, -b.p[6]), b.p[6]);
  return y * b.p[7];
}

template <int kPart, int kMinBlocks>
__global__ void __launch_bounds__(kAregThreads, kMinBlocks)
var_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
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
  const int pos = g * S + col0 + t;
  const int step = kAregG * S;

  float xr[kAregI], xi[kAregI];
#define LOAD(k)                                                  \
  load_band(yr + (static_cast<long long>(k) * R + r) * N,        \
            yi + (static_cast<long long>(k) * R + r) * N, pos, step, xr, xi)
  if (kPart != 3) LOAD(0);
#pragma unroll
  for (int i = 0; i < kAregI; ++i) {
    const int p = pos + i * step;
    sm.t1[i][threadIdx.x] =
        make_float2(__ldg(t1r + p) * scale, __ldg(t1i + p) * scale);
  }
  areg_init_w128(sm.w128);
  if (threadIdx.x < K) {
    Band& b = sm.band[threadIdx.x];
    for (int c = 0; c < 8; ++c) b.p[c] = bands[threadIdx.x * 8 + c];
    b.mode = static_cast<int>(b.p[0]);
    b.inv_ratio = 1.0f / b.p[2];
  }
  __syncthreads();

  float acc_r[kAregI], acc_i[kAregI];
#pragma unroll
  for (int i = 0; i < kAregI; ++i) acc_r[i] = acc_i[i] = 0.0f;

  for (int k = 0; k < K; ++k) {
    if (kPart == 3) LOAD(k);
#pragma unroll
    for (int i = 0; i < kAregI; ++i) {
      const float2 c = sm.t1[i][threadIdx.x];
      const float u = xr[i] * c.x - xi[i] * c.y;
      xi[i] = xr[i] * c.y + xi[i] * c.x;
      xr[i] = u;
    }
    if (kPart == 0) {
#pragma unroll
      for (int i = 0; i < kAregI; ++i) {
        acc_r[i] += xr[i];
        acc_i[i] += xi[i];
      }
      if (k + 1 < K) LOAD(k + 1);
      continue;
    }
    AregExchange& ex = sm.ex[k & 1];
    areg_rows(xr, xi, ex, sm.w128, g, t);
    if (kPart != 3 && k + 1 < K) LOAD(k + 1);
    __syncthreads();
    const Band& b = sm.band[k];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float zr[kAregG], zi[kAregG];
      areg_cols(ex, g, h, t, zr, zi);
#pragma unroll
      for (int k2 = 0; k2 < kAregG; ++k2) {
        if (kPart == 1) {
          acc_r[2 * k2 + h] += zr[k2];
          acc_i[2 * k2 + h] += zi[k2];
        } else {
          acc_r[2 * k2 + h] += soft_knee<kPart == 4>(zr[k2], b);
          acc_i[2 * k2 + h] += soft_knee<kPart == 4>(zi[k2], b);
        }
      }
    }
  }

  float* o_re = out + static_cast<long long>(r) * N;
  float* o_im = out + static_cast<long long>(R + r) * N;
#pragma unroll
  for (int j = 0; j < kAregI; ++j) {
    o_re[pos + j * step] = acc_r[j];
    o_im[pos + j * step] = acc_i[j];
  }
#undef LOAD
}

template <int kPart, int kMinBlocks>
int launch(const float* yr, const float* yi, const float* t1r,
           const float* t1i, const float* bands, float* out, int R, int K,
           int S, float scale, void* stream, int* per_sm) {
  const auto kernel = var_kernel<kPart, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kAregThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R * (S / kAregCols), kAregThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(yr, yi, t1r, t1i, bands, out,
                                                R, K, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 loads, 1 transform, 2 whole, 3 whole without the prefetch,
// 5 whole with copysignf (each at 2 blocks an SM), 4 whole at
// __launch_bounds__(256, 1); writes
// the blocks an SM the occupancy API gives to *per_sm.
extern "C" int var_reduce(int variant, const float* yr, const float* yi,
                          const float* t1r, const float* t1i,
                          const float* bands, float* out, int R2, int K,
                          int S, float scale, void* stream, int* per_sm) {
  switch (variant) {
    case 0: return launch<0, 2>(yr, yi, t1r, t1i, bands, out, R2, K, S,
                                scale, stream, per_sm);
    case 1: return launch<1, 2>(yr, yi, t1r, t1i, bands, out, R2, K, S,
                                scale, stream, per_sm);
    case 2: return launch<2, 2>(yr, yi, t1r, t1i, bands, out, R2, K, S,
                                scale, stream, per_sm);
    case 3: return launch<3, 2>(yr, yi, t1r, t1i, bands, out, R2, K, S,
                                scale, stream, per_sm);
    case 4: return launch<2, 1>(yr, yi, t1r, t1i, bands, out, R2, K, S,
                                scale, stream, per_sm);
    case 5: return launch<4, 2>(yr, yi, t1r, t1i, bands, out, R2, K, S,
                                scale, stream, per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
