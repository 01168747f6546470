// Centred moving average of width k over the rows of x [R, n], zero
// outside [0, n): y[r, t] = (1/k) * sum_{s<k} x[r, t - k/2 + s], with the
// taps added in the order of the plain version (amw_tpu_torch/ops/
// fdfilter.py box_smooth_plain), so the result equals it exactly:
//   k >= 16: s8[i] = ((x[i] + x[i+1]) + ...) + x[i+7]   (b = k / 8, r = k % 8)
//            out[t] = ((s8[t] + s8[t+8]) + ... + s8[t+8(b-1)])
//                     + x[t+8b] + ... + x[t+k-1]
//   k < 16:  out[t] = ((x[t] + x[t+1]) + ...) + x[t+k-1]
// then times (float)(1.0 / k).  x[i] here is the zero-padded row at i - k/2.
//
// Replaces the Pallas TPU kernel amw_tpu/ops/fdfilter.py `_box_pallas`
// (the de-esser's gain smoother, k = 67 at 44.1 kHz, 73 at 48 kHz), which
// loads a 2048-sample block and both neighbour blocks into VMEM and sums
// them with the same two-level decomposition.
//
// Bound on an H100 (3.35 TB/s): one read and one write of R*n*4 bytes,
// 1.016 GB at the 8 x 180 s batch's [16, 7938000] -> 0.303 ms; the ~18
// adds an output (2.3 GFLOP) take 35 us at the 67 TFLOP/s f32 rate, so the
// kernel is bound by bytes.  What stands between it and that bound is the
// shared memory: summing k taps from shared memory for every output reads
// ~18 words an output, about what the SMs' banks deliver in 0.3 ms.
//
// Design.  A block of kBoxThreads threads takes kBoxTile outputs of one
// row; it stages the tile's samples and halo in shared memory with 16-byte
// loads (4-byte ones when the row is not 16-byte aligned), zero outside
// the row.  For the de-esser's widths (k a template parameter,
// box_walk_kernel) each thread walks a strip of kBoxStrip consecutive
// outputs in registers: it reads the strip's kBoxStrip + k - 1 samples
// once, keeps the last eight in a rolling window, forms each s8 afresh
// (7 adds in the plain order) and adds it to every output of the strip it
// belongs to; the remainder taps follow as their samples arrive, so each
// output receives its terms in the plain order.  That is (32 + 66) / 32
// ~ 3 shared reads an output at k = 67.  One pad word after every
// kBoxStrip staged samples puts lane i's strip in bank i (no conflicts).
// The outputs go back through shared memory and out as coalesced 16-byte
// stores.  Any other width runs box_generic_kernel: the same staging, the
// tile's s8 sums once into shared memory, then one output a thread with
// b + r reads, still in the plain order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBoxThreads = 128;                   // threads a block
constexpr int kBoxStrip = 32;                      // outputs a thread (walk)
constexpr int kBoxTile = kBoxThreads * kBoxStrip;  // outputs a block
constexpr int kBoxA = 8;                           // first level's width

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Samples staged before a tile's first output: k / 2 rounded up to a
// multiple of 4, so that the staged range starts 16-byte aligned.
__host__ __device__ constexpr int box_lead(int k) { return round4(k / 2); }

// Shared index of staged sample m when one pad word follows every
// P samples (P = kNoPad: none).
constexpr int kNoPad = 1 << 30;

template <int P>
__device__ __forceinline__ int padded(int m) {
  return P == kNoPad ? m : m + m / P;
}

// Stage xr[g0 + m], m in [0, len), zero outside [0, n), into s[padded(m)].
// With vec (n % 4 == 0, rows 16-byte aligned, g0 % 4 == 0) each vector
// lies wholly inside or wholly outside the row; len is then rounded up to 4
// and s must hold padded(round4(len)) floats.
template <int P>
__device__ __forceinline__ void stage(const float* __restrict__ xr, int n,
                                      int g0, int len, bool vec,
                                      float* __restrict__ s) {
  if (vec) {
    for (int m = 4 * threadIdx.x; m < len; m += 4 * kBoxThreads) {
      const int g = g0 + m;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g >= 0 && g < n) v = __ldg(reinterpret_cast<const float4*>(xr + g));
      const int a = padded<P>(m);  // m % 4 == 0: a .. a + 3 are consecutive
      s[a] = v.x;
      s[a + 1] = v.y;
      s[a + 2] = v.z;
      s[a + 3] = v.w;
    }
  } else {
    for (int m = threadIdx.x; m < len; m += kBoxThreads) {
      const int g = g0 + m;
      s[padded<P>(m)] = (g >= 0 && g < n) ? xr[g] : 0.0f;
    }
  }
}

// Store a walk tile's outputs s[padded(o)], o in [0, kBoxThreads * P), to
// yr[t0 + o] for t0 + o < n, four consecutive outputs a thread and step.
template <int P>
__device__ __forceinline__ void store_tile(const float* __restrict__ s,
                                           float* __restrict__ yr, int n,
                                           int t0, bool vec) {
  for (int o = 4 * threadIdx.x; o < kBoxThreads * P;
       o += 4 * kBoxThreads) {
    const int t = t0 + o;
    if (t >= n) break;
    const int a = padded<P>(o);
    if (vec) {
      *reinterpret_cast<float4*>(yr + t) =
          make_float4(s[a], s[a + 1], s[a + 2], s[a + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (t + c < n) yr[t + c] = s[a + c];
    }
  }
}

// The register walk for width K over strips of P outputs (the package's
// P is kBoxStrip; scripts/box_variants.cu builds others).
template <int K, int P>
struct BoxWalk {
  static constexpr int kTile = kBoxThreads * P;
  static constexpr int kB = K / kBoxA;
  static constexpr int kR = K - kBoxA * kB;
  static constexpr int kLead = box_lead(K);
  static constexpr int kOff = kLead - K / 2;  // a strip's first staged sample
  static constexpr int kSpan = P + K - 1;     // samples a strip reads
  static constexpr int kLen = round4(kTile + kOff + K - 1);  // staged
  static constexpr int kSmem =
      (kLen + kLen / P > kTile + kTile / P ? kLen + kLen / P
                                           : kTile + kTile / P) + 1;
  static_assert(kB >= 2, "the walk is the two-level sum (k >= 16)");
  static_assert(P % kBoxA == 0, "strips of whole groups of eight: the "
                "pitch P + 1 is odd, so the lanes' strips start in 32 banks");
};

template <int K, int P>
__global__ void __launch_bounds__(kBoxThreads)
    box_walk_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int n, float inv_k, int vec) {
  using W = BoxWalk<K, P>;
  __shared__ float s[W::kSmem];
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const int t0 = blockIdx.x * W::kTile;
  stage<P>(x + base, n, t0 - W::kLead, W::kLen, vec, s);
  __syncthreads();

  // padded(threadIdx.x * P + m) = threadIdx.x * (P + 1) + m + m / P
  const float* st = s + threadIdx.x * (P + 1);
  float acc[P];
  float v[kBoxA];  // v[i % 8]: the strip's sample i, the last eight kept
#pragma unroll
  for (int i = 0; i < W::kSpan; ++i) {
    const int m = W::kOff + i;
    v[i % kBoxA] = st[m + m / P];
    if (i >= kBoxA - 1) {
      const int q = i - (kBoxA - 1);  // s8 at strip position q
      float s8 = v[q % kBoxA];
#pragma unroll
      for (int c = 1; c < kBoxA; ++c) s8 += v[(q + c) % kBoxA];
#pragma unroll
      for (int j = 0; j < W::kB; ++j) {
        const int p = q - kBoxA * j;  // output p's j-th term
        if (p >= 0 && p < P) acc[p] = j == 0 ? s8 : acc[p] + s8;
      }
    }
#pragma unroll
    for (int rho = 0; rho < W::kR; ++rho) {
      const int p = i - kBoxA * W::kB - rho;  // output p's tap 8b + rho
      if (p >= 0 && p < P) acc[p] += v[i % kBoxA];
    }
  }
  __syncthreads();  // every strip has read its samples: s takes the outputs
#pragma unroll
  for (int p = 0; p < P; ++p) s[threadIdx.x * (P + 1) + p] = acc[p] * inv_k;
  __syncthreads();
  store_tile<P>(s, y + base, n, t0, vec);
}

// Any width: the tile's s8 sums once into shared memory, then each thread
// sums outputs o = threadIdx.x + j * kBoxThreads in the plain order.
// Dynamic shared memory: box_generic_smem(k) bytes.
__host__ __device__ inline int box_generic_len(int k) {
  return round4(kBoxTile + box_lead(k) - k / 2 + k - 1);
}

inline size_t box_generic_smem(int k) {
  const int b = k / kBoxA;
  const int sums = b >= 2 ? kBoxTile + kBoxA * (b - 1) : 0;
  return static_cast<size_t>(box_generic_len(k) + sums) * sizeof(float);
}

__global__ void __launch_bounds__(kBoxThreads)
    box_generic_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int n, int k, float inv_k, int vec) {
  extern __shared__ float smem[];
  const int b = k / kBoxA;
  const int lead = box_lead(k);
  const int len = box_generic_len(k);
  float* w = smem;
  float* s8 = smem + len;
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const int t0 = blockIdx.x * kBoxTile;
  stage<kNoPad>(x + base, n, t0 - lead, len, vec, w);
  __syncthreads();
  const float* wo = w + (lead - k / 2);  // wo[o + s]: output o's tap s
  if (b >= 2) {
    const int ns = kBoxTile + kBoxA * (b - 1);
    for (int i = threadIdx.x; i < ns; i += kBoxThreads) {
      float a = wo[i];
#pragma unroll
      for (int c = 1; c < kBoxA; ++c) a += wo[i + c];
      s8[i] = a;
    }
    __syncthreads();
  }
  float* yr = y + base;
  for (int o = threadIdx.x; o < kBoxTile; o += kBoxThreads) {
    const int t = t0 + o;
    if (t >= n) break;
    float acc;
    int tap;
    if (b >= 2) {
      acc = s8[o];
      for (int j = 1; j < b; ++j) acc += s8[o + kBoxA * j];
      tap = kBoxA * b;
    } else {
      acc = wo[o];
      tap = 1;
    }
    for (; tap < k; ++tap) acc += wo[o + tap];
    yr[t] = acc * inv_k;
  }
}

template <int K>
cudaError_t launch_walk(const float* x, float* y, int rows, int n,
                        float inv_k, int vec, cudaStream_t stream) {
  using W = BoxWalk<K, kBoxStrip>;
  const dim3 grid((n + W::kTile - 1) / W::kTile, rows);
  box_walk_kernel<K, kBoxStrip><<<grid, kBoxThreads, 0, stream>>>(
      x, y, n, inv_k, vec);
  return cudaGetLastError();
}

cudaError_t launch_generic(const float* x, float* y, int rows, int n, int k,
                           float inv_k, int vec, cudaStream_t stream) {
  const size_t smem = box_generic_smem(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        box_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kBoxTile - 1) / kBoxTile, rows);
  box_generic_kernel<<<grid, kBoxThreads, smem, stream>>>(x, y, n, k, inv_k,
                                                          vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int amw_box_smooth(const float* x, float* y, int rows, int n,
                              int k, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(y);
  // the plain version's factor: the Python float 1.0 / k, as float
  const float inv_k = static_cast<float>(1.0 / k);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 67:  // the de-esser at 44.1 kHz (ops/dynamics.py build_deesser)
      err = launch_walk<67>(x, y, rows, n, inv_k, vec, st);
      break;
    case 73:  // ... at 48 kHz
      err = launch_walk<73>(x, y, rows, n, inv_k, vec, st);
      break;
    default:
      err = launch_generic(x, y, rows, n, k, inv_k, vec, st);
  }
  return static_cast<int>(err);
}
