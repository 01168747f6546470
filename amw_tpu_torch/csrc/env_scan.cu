// Attack/release envelopes of a nonnegative v [rows, n]: the chunked scan
// and the one-sequence-per-row scan.
//
// Replaces two Pallas TPU kernels of amw_tpu/ops/scan.py, the two routes
// of its `envelope_follower`:
//
// - `_win_scan_pallas` in envelope mode (no gain map, no aux mask; reached
//   from scan.py:297 for signals longer than twice the warm-up):
//   amw_env_scan.  Row `row` is cut into K chunks of C samples; thread
//   m = row * K + kk runs W warm-up steps and then its C body steps of the
//   recurrence in env_core.cuh (the same core as env_gain.cu), reading v in
//   place, and writes the envelope of its body.
// - `_env_pallas` (scan.py:122, via `_env_blocks` for short signals): the
//   exact recurrence along each whole row, env[0] = v[0]: amw_env_rows.
//   Only a few rows are in flight (16 in an 8 x stereo batch), so one
//   thread walks one row.  A block takes 32 rows; its 256 threads stage a
//   [32 rows x 128 steps] tile through shared memory with coalesced loads
//   (a warp reads 32 consecutive steps of one row), the first warp runs the
//   128 steps of its rows from shared memory and writes the envelope back
//   into the tile, and the block stores the tile coalesced.
//
// Bound on an H100: the serial depth.  amw_env_scan runs W + C dependent
// steps a thread (W = 81225 for the transient designer's 5 ms / 100 ms
// follower at 44.1 kHz); the bytes (v once, the envelope once: 1.02 GB at
// [16, 7938000], 0.30 ms at 3.35 TB/s) matter less.  amw_env_rows runs n
// dependent steps, plus the tile loads and stores between them.
#include "env_core.cuh"

using namespace amw_env;

namespace {

constexpr int kScanThreads = 128;

__global__ void env_scan_kernel(const float* __restrict__ v,
                                float* __restrict__ out, int rows, int n,
                                int W, int C, int K, float attack,
                                float release) {
  const int m = blockIdx.x * kScanThreads + threadIdx.x;
  if (m >= rows * K) return;
  const int row = m / K;
  const int kk = m - row * K;
  const float* vr = v + static_cast<long long>(row) * n;
  float* yr = out + static_cast<long long>(row) * n;
  const int off = kk * C;

  float e = env_warmup<false>(vr, off, W, attack, release);
  const int end = min(off + C, n);
#pragma unroll 4
  for (int g = off; g < end; ++g) {
    e = env_step(e, env_input<false>(vr + g), attack, release);
    yr[g] = e;
  }
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
  const int m = rows * K;
  if (m <= 0 || n <= 0) return 0;
  if (W < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  env_scan_kernel<<<(m + kScanThreads - 1) / kScanThreads, kScanThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      v, out, rows, n, W, C, K, attack, release);
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
