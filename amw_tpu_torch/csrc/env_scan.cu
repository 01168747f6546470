// Attack/release envelopes of a nonnegative v [rows, n]: the chunked scan
// and the one-sequence-per-row scan, both the staged walk of
// env_staged.cuh with the envelope itself as its epilogue.
//
// Replaces two Pallas TPU kernels of amw_tpu/ops/scan.py, the two routes
// of its `envelope_follower`:
//
// - `_win_scan_pallas` in envelope mode (no gain map, no aux mask; reached
//   from scan.py:297 for signals longer than twice the warm-up):
//   amw_env_scan, at any chunk geometry W, C, K (the host takes
//   `scan.scan_geometry`'s: one block of 32 full chunks on every SM where
//   it can).
// - `_env_pallas` (scan.py:122, via `_env_blocks` for short signals): the
//   exact recurrence along each whole row, env[0] = v[0]: amw_env_rows,
//   the same walk at (W, C, K) = (0, n, 1): step t reads position t, the
//   state starts at v[row, 0], every position is stored.  Only a few rows
//   are in flight (16 in an 8 x stereo batch, 2 for one clip), so one
//   block on one SM walks them: bound by the n dependent steps and the
//   per-tile barrier, not by bytes.
//
// amw_env_step_clock measures the dependent step alone: one warp runs
// env_step on register values between two clock64 reads.
#include "env_staged.cuh"

using namespace amw_env;

namespace {

struct Envelope {
  static constexpr bool kAbs = false;

  __device__ __forceinline__ int limit(int, int n) const { return n; }

  __device__ __forceinline__ float store(float e, int, int) const {
    return e;
  }
};

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

}  // namespace

// v, out: [rows, n]; chunk geometry W, C, K (K * C >= n > (K - 1) * C).
extern "C" int amw_env_scan(const float* v, float* out, int rows, int n,
                            int W, int C, int K, float attack, float release,
                            void* stream) {
  return launch_staged(v, out, rows, n, W, C, K, attack, release,
                       Envelope{}, stream);
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
  return launch_staged(v, out, rows, n, 0, n, 1, attack, release,
                       Envelope{}, stream);
}
