// Attack/release envelopes of a nonnegative v [rows, n]: the chunked scan
// and the one-sequence-per-row scan.
//
// Replaces two Pallas TPU kernels of amw_tpu/ops/scan.py, the two routes
// of its `envelope_follower`:
//
// - `_win_scan_pallas` in envelope mode (no gain map, no aux mask; reached
//   from scan.py:297 for signals longer than twice the warm-up):
//   amw_env_scan.  Row `row` is cut into K chunks of C samples; chunk
//   m = row * K + kk runs W warm-up steps and then its C body steps of the
//   recurrence in env_core.cuh (the same core as env_gain.cu): step t reads
//   position kk * C - W + t (below 0 v[row, 0], from n on 0), the state
//   starts at the first warm-up value, and the body positions below n are
//   written.  A block takes 32 consecutive chunks and walks their W + C
//   steps in staged tiles of [32 chunks x 128 steps]: eight loader warps
//   (two a step column) copy each tile into a ring of three in shared
//   memory with cp.async (a warp reads 32 consecutive positions of one
//   chunk's window), two tiles ahead of the scan, and store the body
//   columns of the tile scanned before, coalesced; the scanning warp (one
//   chunk a lane) runs the 128 steps of the current tile in batches of 16
//   on registers, reading the next batch as float4s before it runs the
//   current one, and writes the envelope back into the tile.  One barrier
//   a tile.
// - `_env_pallas` (scan.py:122, via `_env_blocks` for short signals): the
//   exact recurrence along each whole row, env[0] = v[0]: amw_env_rows.
//   Only a few rows are in flight (16 in an 8 x stereo batch), so one
//   thread walks one row.  A block takes 32 rows; its 256 threads stage a
//   [32 rows x 128 steps] tile through shared memory with coalesced loads
//   (a warp reads 32 consecutive steps of one row), the first warp runs the
//   128 steps of its rows from shared memory and writes the envelope back
//   into the tile, and the block stores the tile coalesced.
//
// Bound on an H100: the serial depth, W + C dependent steps a chunk (W =
// 81236 for the transient designer's 5 ms / 100 ms follower at 44.1 kHz),
// each a compare, a select, a subtract and a fused multiply-add (~14
// cycles); and the bytes, v once, the overlapping warm-up windows (W / C
// of v again: they come back from device memory, since a [16, 7938000]
// signal far exceeds the 50 MB L2) and the envelope once.  A second block
// on an SM shares its loads, and the kernel waits for the busiest SM: the
// host picks C for one block of full chunks on every SM where it can
// (`scan.scan_geometry`); amw_env_scan takes any W, C, K.  amw_env_rows
// runs n dependent steps, plus the tile loads and stores between them.
//
// amw_env_step_clock measures the dependent step alone: one warp runs
// env_step on register values between two clock64 reads.
#include "env_core.cuh"

using namespace amw_env;

namespace {

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

__global__ void __launch_bounds__(kScanThreads)
env_scan_kernel(const float* __restrict__ v, float* __restrict__ out,
                int rows, int n, int W, int C, int K, float attack,
                float release) {
  // ring[slot][chunk][step]: a row of kRow floats keeps the scanning
  // warp's float4 accesses (a quarter warp covers the 32 banks once) and
  // the loaders' column accesses free of bank conflicts
  extern __shared__ __align__(16) float ring[];
  __shared__ long long row_base[kChunks];  // row * n
  __shared__ int win0[kChunks];            // kk * C - W: position of step 0
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
      if (pos < n) out[row_base[j] + pos] = src[j * kRow];
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
      if (i == 0) e = tr[0];  // the state starts at the first warm-up value
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
          x[4 * k] = a.x;
          x[4 * k + 1] = a.y;
          x[4 * k + 2] = a.z;
          x[4 * k + 3] = a.w;
        }
#pragma unroll
        for (int s0 = 0; s0 < kStepTile; s0 += kBatch) {
          float y[kBatch];
          if (s0 + kBatch < kStepTile) {
#pragma unroll
            for (int k = 0; k < kBatch / 4; ++k) {
              const float4 a = t4[(s0 + kBatch) / 4 + k];
              y[4 * k] = a.x;
              y[4 * k + 1] = a.y;
              y[4 * k + 2] = a.z;
              y[4 * k + 3] = a.w;
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
          e = env_step(e, tr[s], attack, release);
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

constexpr int kClockSteps = 8;  // register inputs cycled by the clock kernel

__global__ void env_step_clock_kernel(long long* __restrict__ cycles,
                                      float* __restrict__ sink, int steps,
                                      float attack, float release) {
  const int lane = threadIdx.x;
  float x[kClockSteps];
#pragma unroll
  for (int k = 0; k < kClockSteps; ++k)
    x[k] = 0.125f * static_cast<float>((lane + 3 * k) % 7);
  float e = x[0];
  const long long t0 = clock64();
  for (int s = 0; s < steps; s += kClockSteps) {
#pragma unroll
    for (int k = 0; k < kClockSteps; ++k)
      e = env_step(e, x[k], attack, release);
  }
  const long long t1 = clock64();
  sink[lane] = e;
  if (lane == 0) cycles[0] = t1 - t0;
}

constexpr int kRowsPerBlock = 32;  // one warp scans, one row a thread
constexpr int kTile = 128;         // steps per staged tile
constexpr int kRowsThreads = 256;  // threads that load and store the tile

__global__ void __launch_bounds__(kRowsThreads)
env_rows_kernel(const float* __restrict__ v, float* __restrict__ out,
                int rows, int n, float attack, float release) {
  // +1: thread r walks row r of the tile, so consecutive rows sit in
  // consecutive banks
  __shared__ float tile[kRowsPerBlock][kTile + 1];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nr = min(kRowsPerBlock, rows - row0);
  const int r = threadIdx.x;
  const bool scans = r < nr;
  float e = 0.0f;
  if (scans) e = v[static_cast<long long>(row0 + r) * n];  // env[0] = v[0]

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tl = min(kTile, n - t0);
    for (int i = threadIdx.x; i < nr * kTile; i += kRowsThreads) {
      const int rr = i / kTile, s = i - rr * kTile;
      if (s < tl)
        tile[rr][s] = v[static_cast<long long>(row0 + rr) * n + t0 + s];
    }
    __syncthreads();
    if (scans) {
#pragma unroll 8
      for (int s = 0; s < tl; ++s) {
        e = env_step(e, tile[r][s], attack, release);
        tile[r][s] = e;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * kTile; i += kRowsThreads) {
      const int rr = i / kTile, s = i - rr * kTile;
      if (s < tl)
        out[static_cast<long long>(row0 + rr) * n + t0 + s] = tile[rr][s];
    }
    __syncthreads();  // the tile is reloaded for the next steps
  }
}

}  // namespace

// v, out: [rows, n]; chunk geometry W, C, K (K * C >= n > (K - 1) * C).
extern "C" int amw_env_scan(const float* v, float* out, int rows, int n,
                            int W, int C, int K, float attack, float release,
                            void* stream) {
  const long long m = static_cast<long long>(rows) * K;
  if (m <= 0 || n <= 0) return 0;
  if (W < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the ring exceeds the 48 KB a block gets without asking
  const cudaError_t err = cudaFuncSetAttribute(
      env_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kScanSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  env_scan_kernel<<<static_cast<int>((m + kChunks - 1) / kChunks),
                    kScanThreads, kScanSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      v, out, rows, n, W, C, K, attack, release);
  return static_cast<int>(cudaGetLastError());
}

// cycles: [1] int64, the clock64 cycles of one warp's `steps` dependent
// env_step calls (a multiple of 8); sink: [32], the lanes' last states.
extern "C" int amw_env_step_clock(long long* cycles, float* sink, int steps,
                                  float attack, float release,
                                  void* stream) {
  if (steps <= 0 || steps % kClockSteps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  env_step_clock_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, sink, steps, attack, release);
  return static_cast<int>(cudaGetLastError());
}

// v, out: [rows, n].
extern "C" int amw_env_rows(const float* v, float* out, int rows, int n,
                            float attack, float release, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  env_rows_kernel<<<blocks, kRowsThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(v, out, rows, n,
                                                          attack, release);
  return static_cast<int>(cudaGetLastError());
}
