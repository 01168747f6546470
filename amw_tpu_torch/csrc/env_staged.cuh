// The staged walk of the chunked attack/release envelope, shared by the
// three envelope kernels (env_scan.cu: amw_env_scan and amw_env_rows;
// env_gain.cu: amw_env_gain).  One template over an epilogue:
//
//   env_staged_kernel<Epi>  /  launch_staged<Epi>
//
// Row `row` of v [rows, n] is cut into K chunks of C samples; chunk
// m = row * K + kk runs W warm-up steps and then its C body steps of the
// recurrence in env_core.cuh: step t reads position kk * C - W + t (below
// 0 v[row, 0], the recurrence's fixed point; from n on 0), the state
// starts at the first warm-up value, and the body positions below n are
// written.  W is chosen on the host so that the warm-up forgets the start
// state to 1e-8; at (W, C, K) = (0, n, 1) the walk is the exact recurrence
// along each row, env[0] = v[0].
//
// A block takes 32 consecutive chunks and walks their W + C steps in
// staged tiles of [32 chunks x 128 steps]: eight loader warps (two a step
// column) copy each tile into a ring of three in shared memory with
// cp.async (a warp reads 32 consecutive positions of one chunk's window),
// two tiles ahead of the scan, and store the body columns of the tile
// scanned before, coalesced; the scanning warp (one chunk a lane) runs
// the 128 steps of the current tile in batches of 16 on registers,
// reading the next batch as float4s before it runs the current one, and
// writes the envelope back into the tile.  One barrier a tile.
//
// The epilogue `Epi` says what the walk reads and what it stores, off the
// serial chain:
//
//   Epi::kAbs                   the scanning lane takes |v| as it unpacks
//                               a batch (the de-esser's sidechain);
//   epi.limit(row, n)           a per-row bound, kept in shared memory
//                               beside the row's base;
//   epi.store(env, pos, limit)  the value the loaders store at body
//                               position pos < n.
//
// Bound on an H100: the serial depth, W + C dependent steps a chunk, each
// a compare, a select, a subtract and a fused multiply-add (tau ~14
// cycles); and the bytes, v once, the overlapping warm-up windows (W / C
// of v again: they come back from device memory, since a [16, 7938000]
// signal far exceeds the 50 MB L2) and the output once.  A second block
// on an SM shares its loads, and the kernel waits for the busiest SM: the
// host picks C for one block of full chunks on every SM where it can
// (`scan.scan_geometry`); the walk takes any W, C, K.
#pragma once

#include <cuda_runtime.h>

#include "env_core.cuh"

namespace amw_env {

constexpr int kChunks = 32;     // chunks a block: one scanning warp
constexpr int kStepTile = 128;  // steps a staged tile
constexpr int kStages = 3;      // tiles in the ring: loads run two ahead
constexpr int kRowPad = 4;      // a chunk's tile row: 16-byte aligned
constexpr int kRow = kStepTile + kRowPad;
constexpr int kLoaderSplit = 2;  // loader threads a step column
constexpr int kScanThreads = 32 + kLoaderSplit * kStepTile;
constexpr int kBatch = 16;  // steps the scanning lane holds in registers
constexpr int kTileFloats = kChunks * kRow;
constexpr int kScanSmem = kStages * kTileFloats * 4;  // 50,688 bytes

// 4 bytes from global memory into shared memory, asynchronously; with
// `valid` false the destination is zero-filled and nothing is read.  (No
// memory clobber: the wait below orders the copies.)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

template <bool kAbs>
__device__ __forceinline__ float scan_input(float v) {
  return kAbs ? fabsf(v) : v;
}

template <class Epi>
__global__ void __launch_bounds__(kScanThreads)
env_staged_kernel(const float* __restrict__ v, float* __restrict__ out,
                  int rows, int n, int W, int C, int K, float attack,
                  float release, Epi epi) {
  // ring[slot][chunk][step]: a row of kRow floats keeps the scanning
  // warp's float4 accesses (a quarter warp covers the 32 banks once) and
  // the loaders' column accesses free of bank conflicts
  extern __shared__ __align__(16) float ring[];
  __shared__ long long row_base[kChunks];  // row * n
  __shared__ int win0[kChunks];            // kk * C - W: position of step 0
  __shared__ int limit[kChunks];           // epi.limit(row, n)
  const int m0 = blockIdx.x * kChunks;
  const int nc = min(kChunks, rows * K - m0);
  const int L = W + C;  // steps a chunk
  const int tiles = (L + kStepTile - 1) / kStepTile;
  const bool scans = threadIdx.x < 32;
  // loader l moves step column q of the chunks j0, j0 + kLoaderSplit, ...
  const int l = static_cast<int>(threadIdx.x) - 32;
  const int q = l % kStepTile;
  const int j0 = l / kStepTile;

  if (threadIdx.x < nc) {
    const int m = m0 + threadIdx.x;
    const int row = m / K;
    row_base[threadIdx.x] = static_cast<long long>(row) * n;
    win0[threadIdx.x] = (m - row * K) * C - W;
    limit[threadIdx.x] = epi.limit(row, n);
  }
  __syncthreads();

  // tile i: steps [i * kStepTile, + kStepTile) of every chunk
  auto load_tile = [&](int i) {
    const int t = i * kStepTile + q;
    if (i < tiles && t < L) {
      float* dst = ring + (i % kStages) * kTileFloats + q;
#pragma unroll 4
      for (int j = j0; j < nc; j += kLoaderSplit) {
        const int pos = win0[j] + t;
        const float* src = v + row_base[j] + min(max(pos, 0), n - 1);
        cp_async4(dst + j * kRow, src, pos < n);
      }
    }
    cp_async_commit();  // empty groups keep the count of groups per tile
  };
  auto store_tile = [&](int i) {
    const int t = i * kStepTile + q;
    if (t < W || t >= L) return;
    const float* src = ring + (i % kStages) * kTileFloats + q;
#pragma unroll 4
    for (int j = j0; j < nc; j += kLoaderSplit) {
      const int pos = win0[j] + t;
      if (pos < n) out[row_base[j] + pos] = epi.store(src[j * kRow], pos,
                                                      limit[j]);
    }
  };

  if (!scans) {
    for (int i = 0; i < kStages - 1; ++i) load_tile(i);
  }
  const int j = threadIdx.x;  // the scanning lane's chunk
  float e = 0.0f;
  for (int i = 0; i <= tiles; ++i) {
    // tile i has landed (each loader waits for its own copies, the barrier
    // for everyone's); tile i - 1 is scanned
    if (!scans) cp_async_wait<kStages - 2>();
    __syncthreads();
    if (scans) {
      if (i == tiles || j >= nc) continue;
      float* tr = ring + (i % kStages) * kTileFloats + j * kRow;
      // the state starts at the first warm-up value
      if (i == 0) e = scan_input<Epi::kAbs>(tr[0]);
      const int tl = min(kStepTile, L - i * kStepTile);
      if (tl == kStepTile) {
        // batches of kBatch steps on registers, the next batch's inputs
        // read before the current batch runs: no step waits on shared
        // memory
        float4* t4 = reinterpret_cast<float4*>(tr);
        float x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch / 4; ++k) {
          const float4 a = t4[k];
          x[4 * k] = scan_input<Epi::kAbs>(a.x);
          x[4 * k + 1] = scan_input<Epi::kAbs>(a.y);
          x[4 * k + 2] = scan_input<Epi::kAbs>(a.z);
          x[4 * k + 3] = scan_input<Epi::kAbs>(a.w);
        }
#pragma unroll
        for (int s0 = 0; s0 < kStepTile; s0 += kBatch) {
          float y[kBatch];
          if (s0 + kBatch < kStepTile) {
#pragma unroll
            for (int k = 0; k < kBatch / 4; ++k) {
              const float4 a = t4[(s0 + kBatch) / 4 + k];
              y[4 * k] = scan_input<Epi::kAbs>(a.x);
              y[4 * k + 1] = scan_input<Epi::kAbs>(a.y);
              y[4 * k + 2] = scan_input<Epi::kAbs>(a.z);
              y[4 * k + 3] = scan_input<Epi::kAbs>(a.w);
            }
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            e = env_step(e, x[k], attack, release);
            x[k] = e;
          }
#pragma unroll
          for (int k = 0; k < kBatch / 4; ++k)
            t4[s0 / 4 + k] = make_float4(x[4 * k], x[4 * k + 1],
                                         x[4 * k + 2], x[4 * k + 3]);
          if (s0 + kBatch < kStepTile) {
#pragma unroll
            for (int k = 0; k < kBatch; ++k) x[k] = y[k];
          }
        }
      } else {
        for (int s = 0; s < tl; ++s) {
          e = env_step(e, scan_input<Epi::kAbs>(tr[s]), attack, release);
          tr[s] = e;
        }
      }
    } else {
      // the slot of tile i - 1 takes tile i + kStages - 1 once its body
      // is stored; each loader reloads only the elements it stored
      if (i > 0) store_tile(i - 1);
      load_tile(i + kStages - 1);
    }
  }
  if (!scans) cp_async_wait<0>();
}

// Launch the walk over v, out [rows, n] at chunk geometry W, C, K
// (K * C >= n > (K - 1) * C) on `stream`; returns a cudaError_t.
template <class Epi>
int launch_staged(const float* v, float* out, int rows, int n, int W, int C,
                  int K, float attack, float release, Epi epi,
                  void* stream) {
  const long long m = static_cast<long long>(rows) * K;
  if (m <= 0 || n <= 0) return 0;
  if (W < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the ring exceeds the 48 KB a block gets without asking
  const cudaError_t err = cudaFuncSetAttribute(
      env_staged_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kScanSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  env_staged_kernel<Epi><<<static_cast<int>((m + kChunks - 1) / kChunks),
                           kScanThreads, kScanSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      v, out, rows, n, W, C, K, attack, release, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace amw_env
