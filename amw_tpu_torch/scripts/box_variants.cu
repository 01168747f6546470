// Variants of the box smoother (csrc/box_smooth.cu, kernel 1) at the
// de-esser's k = 67, for amw_tpu_torch/scripts/ab_box.py --variants: the
// same tiles and staging with parts of the work switched off, other strip
// widths, the generic path, and the design it replaced.
//   0 (loads_stores): each block copies its tile, 16-byte loads straight to
//     16-byte stores, nothing through shared memory;
//   1 (staging): the package's staging into shared memory and its store of
//     the tile from there, no sums;
//   2 (whole): the package kernel, box_walk_kernel<67, 32>;
//   3 (strip_16), 4 (strip_64): the walk over strips of 16 / 64 outputs;
//   5 (generic): box_generic_kernel at k = 67 (the tile's s8 sums in shared
//     memory, then one output a thread);
//   6 (before): the kernel this design replaced: blocks of 1024 outputs,
//     4 a thread, all k taps summed from shared memory for the first and
//     slid over three more (acc += x[t + k] - x[t]; another order: not
//     exactly the plain version).
// Every variant but 0 and 1 writes the box average.  Built by the script
// with nvcc into amw_tpu_torch/_build/; not part of the package.
#include "../csrc/box_smooth.cu"

namespace {

constexpr int kK = 67;

__global__ void __launch_bounds__(kBoxThreads)
    copy_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const int t0 = blockIdx.x * kBoxTile;
  for (int o = 4 * threadIdx.x; o < kBoxTile; o += 4 * kBoxThreads) {
    const int t = t0 + o;
    if (t >= n) break;
    *reinterpret_cast<float4*>(y + base + t) =
        __ldg(reinterpret_cast<const float4*>(x + base + t));
  }
}

__global__ void __launch_bounds__(kBoxThreads)
    staging_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int n) {
  using W = BoxWalk<kK, kBoxStrip>;
  __shared__ float s[W::kSmem];
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const int t0 = blockIdx.x * kBoxTile;
  stage<kBoxStrip>(x + base, n, t0 - W::kLead, W::kLen, true, s);
  __syncthreads();
  store_tile<kBoxStrip>(s, y + base, n, t0, true);
}

constexpr int kOldThreads = 256;
constexpr int kOldPerThread = 4;
constexpr int kOldTB = kOldThreads * kOldPerThread;

__global__ void before_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int n, int k,
                              float inv_k) {
  extern __shared__ float win[];
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const int t0 = blockIdx.x * kOldTB;
  const int half = k / 2;
  const int len = kOldTB + k - 1;
  for (int i = threadIdx.x; i < len; i += kOldThreads) {
    const int g = t0 - half + i;
    win[i] = (g >= 0 && g < n) ? x[base + g] : 0.0f;
  }
  __syncthreads();
  const int j = threadIdx.x * kOldPerThread;
  float acc = 0.0f;
  for (int s = 0; s < k; ++s) acc += win[j + s];
#pragma unroll
  for (int u = 0; u < kOldPerThread; ++u) {
    const int t = t0 + j + u;
    if (t < n) y[base + t] = acc * inv_k;
    if (u + 1 < kOldPerThread) acc += win[j + u + k] - win[j + u];
  }
}

template <class Kern>
int per_sm(Kern kern, int threads, size_t smem) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                smem);
  return blocks;
}

}  // namespace

// rows 16-byte aligned and n % 4 == 0 (the 180 s batch's shape).
extern "C" int var_box(int variant, const float* x, float* y, int rows,
                       int n, void* stream, int* blocks_per_sm) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float inv_k = static_cast<float>(1.0 / kK);
  const dim3 grid((n + kBoxTile - 1) / kBoxTile, rows);
  switch (variant) {
    case 0:
      *blocks_per_sm = per_sm(copy_kernel, kBoxThreads, 0);
      copy_kernel<<<grid, kBoxThreads, 0, st>>>(x, y, n);
      break;
    case 1:
      *blocks_per_sm = per_sm(staging_kernel, kBoxThreads, 0);
      staging_kernel<<<grid, kBoxThreads, 0, st>>>(x, y, n);
      break;
    case 2:
      *blocks_per_sm = per_sm(box_walk_kernel<kK, 32>, kBoxThreads, 0);
      return static_cast<int>(launch_walk<kK>(x, y, rows, n, inv_k, 1, st));
    case 3: {
      const dim3 g16((n + 128 * 16 - 1) / (128 * 16), rows);
      *blocks_per_sm = per_sm(box_walk_kernel<kK, 16>, kBoxThreads, 0);
      box_walk_kernel<kK, 16><<<g16, kBoxThreads, 0, st>>>(x, y, n, inv_k,
                                                            1);
      break;
    }
    case 4: {
      const dim3 g64((n + 128 * 64 - 1) / (128 * 64), rows);
      *blocks_per_sm = per_sm(box_walk_kernel<kK, 64>, kBoxThreads, 0);
      box_walk_kernel<kK, 64><<<g64, kBoxThreads, 0, st>>>(x, y, n, inv_k,
                                                            1);
      break;
    }
    case 5:
      *blocks_per_sm =
          per_sm(box_generic_kernel, kBoxThreads, box_generic_smem(kK));
      return static_cast<int>(
          launch_generic(x, y, rows, n, kK, inv_k, 1, st));
    case 6: {
      const dim3 gold((n + kOldTB - 1) / kOldTB, rows);
      const size_t smem = static_cast<size_t>(kOldTB + kK - 1) * 4;
      *blocks_per_sm = per_sm(before_kernel, kOldThreads, smem);
      before_kernel<<<gold, kOldThreads, smem, st>>>(x, y, n, kK,
                                                     1.0f / kK);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
