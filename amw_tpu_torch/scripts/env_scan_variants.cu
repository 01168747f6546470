// Design variants of the envelope kernels' staged walk
// (csrc/env_staged.cuh env_staged_kernel), for amw_tpu_torch/scripts/tune_env_scan.py: the same
// walk with the tile's steps T, the ring's slots S, the scanning lane's
// register batch B (1: a scalar loop over shared memory; else float4
// batches, the next read before the current runs), the row padding P
// (float4 batches need 4), SPLIT loader threads a step column and the
// loads and stores on or off (MOVE).  Variant 4 is csrc/env_staged.cuh's.
// Built by the script with nvcc into amw_tpu_torch/_build/; not part of
// the package.
#include "../csrc/env_core.cuh"

using namespace amw_env;

namespace {

constexpr int kChunks = 32;

template <bool kClobber>
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kClobber)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int T, int S, int B, int P, int SPLIT, bool MOVE>
__global__ void __launch_bounds__(32 + T * SPLIT)
var_kernel(const float* __restrict__ v, float* __restrict__ out, int rows,
           int n, int W, int C, int K, float attack, float release) {
  constexpr int kRow = T + P;
  constexpr int kTileFloats = kChunks * kRow;
  extern __shared__ __align__(16) float ring[];
  __shared__ long long row_base[kChunks];
  __shared__ int win0[kChunks];
  const int m0 = blockIdx.x * kChunks;
  const int nc = min(kChunks, rows * K - m0);
  const int L = W + C;
  const int tiles = (L + T - 1) / T;
  const bool scans = threadIdx.x < 32;
  const int l = static_cast<int>(threadIdx.x) - 32;
  const int q = l % T;
  const int j0 = l / T;
  if (threadIdx.x < nc) {
    const int m = m0 + threadIdx.x;
    const int row = m / K;
    row_base[threadIdx.x] = static_cast<long long>(row) * n;
    win0[threadIdx.x] = (m - row * K) * C - W;
  }
  __syncthreads();
  auto load_tile = [&](int i) {
    const int t = i * T + q;
    if (MOVE && i < tiles && t < L) {
      float* dst = ring + (i % S) * kTileFloats + q;
#pragma unroll 4
      for (int j = j0; j < nc; j += SPLIT) {
        const int pos = win0[j] + t;
        const float* src = v + row_base[j] + min(max(pos, 0), n - 1);
        cp_async4<B == 1>(dst + j * kRow, src, pos < n);
      }
    }
    cp_async_commit();
  };
  auto store_tile = [&](int i) {
    const int t = i * T + q;
    if (!MOVE || t < W || t >= L) return;
    const float* src = ring + (i % S) * kTileFloats + q;
#pragma unroll 4
    for (int j = j0; j < nc; j += SPLIT) {
      const int pos = win0[j] + t;
      if (pos < n) out[row_base[j] + pos] = src[j * kRow];
    }
  };
  if (!scans) {
    for (int i = 0; i < S - 1; ++i) load_tile(i);
  }
  const int j = threadIdx.x;
  float e = 0.0f;
  for (int i = 0; i <= tiles; ++i) {
    if (!scans) cp_async_wait<S - 2>();
    __syncthreads();
    if (scans) {
      if (i == tiles || j >= nc) continue;
      float* tr = ring + (i % S) * kTileFloats + j * kRow;
      if (i == 0) e = tr[0];
      const int tl = min(T, L - i * T);
      if (tl == T && B > 1) {
        float4* t4 = reinterpret_cast<float4*>(tr);
        float x[B];
#pragma unroll
        for (int k = 0; k < B / 4; ++k) {
          const float4 a = t4[k];
          x[4 * k] = a.x;
          x[4 * k + 1] = a.y;
          x[4 * k + 2] = a.z;
          x[4 * k + 3] = a.w;
        }
#pragma unroll
        for (int s0 = 0; s0 < T; s0 += B) {
          float y[B];
          if (s0 + B < T) {
#pragma unroll
            for (int k = 0; k < B / 4; ++k) {
              const float4 a = t4[(s0 + B) / 4 + k];
              y[4 * k] = a.x;
              y[4 * k + 1] = a.y;
              y[4 * k + 2] = a.z;
              y[4 * k + 3] = a.w;
            }
          }
#pragma unroll
          for (int k = 0; k < B; ++k) {
            e = env_step(e, x[k], attack, release);
            x[k] = e;
          }
#pragma unroll
          for (int k = 0; k < B / 4; ++k)
            t4[s0 / 4 + k] = make_float4(x[4 * k], x[4 * k + 1],
                                         x[4 * k + 2], x[4 * k + 3]);
          if (s0 + B < T) {
#pragma unroll
            for (int k = 0; k < B; ++k) x[k] = y[k];
          }
        }
      } else if (tl == T) {
#pragma unroll
        for (int s = 0; s < T; ++s) {
          e = env_step(e, tr[s], attack, release);
          tr[s] = e;
        }
      } else {
        for (int s = 0; s < tl; ++s) {
          e = env_step(e, tr[s], attack, release);
          tr[s] = e;
        }
      }
    } else {
      if (i > 0) store_tile(i - 1);
      load_tile(i + S - 1);
    }
  }
  if (!scans) cp_async_wait<0>();
}

template <int T, int S, int B, int P, int SPLIT, bool MOVE = true>
int launch(const float* v, float* out, int rows, int n, int W, int C, int K,
           float a, float r) {
  const int smem = S * kChunks * (T + P) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      var_kernel<T, S, B, P, SPLIT, MOVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m = static_cast<long long>(rows) * K;
  var_kernel<T, S, B, P, SPLIT, MOVE>
      <<<static_cast<int>((m + kChunks - 1) / kChunks), 32 + T * SPLIT,
         smem>>>(v, out, rows, n, W, C, K, a, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int var_scan(int variant, const float* v, float* out, int rows,
                        int n, int W, int C, int K, float a, float r) {
  switch (variant) {
    case 0:  // the first design: a scalar scan, one loader a column
      return launch<128, 3, 1, 1, 1>(v, out, rows, n, W, C, K, a, r);
    case 1:
      return launch<128, 3, 16, 4, 1>(v, out, rows, n, W, C, K, a, r);
    case 2:
      return launch<128, 3, 32, 4, 1>(v, out, rows, n, W, C, K, a, r);
    case 3:
      return launch<128, 4, 16, 4, 1>(v, out, rows, n, W, C, K, a, r);
    case 4:  // csrc/env_staged.cuh's
      return launch<128, 3, 16, 4, 2>(v, out, rows, n, W, C, K, a, r);
    case 5:  // 4's scan alone: no loads, no stores
      return launch<128, 3, 16, 4, 2, false>(v, out, rows, n, W, C, K, a, r);
    case 6:
      return launch<256, 3, 16, 4, 1>(v, out, rows, n, W, C, K, a, r);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
