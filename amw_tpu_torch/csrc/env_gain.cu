// De-esser envelope -> gain over chunked windows of x [rows, n].
//
// Replaces the Pallas TPU kernel amw_tpu/ops/scan.py `_win_scan_pallas` in
// gain mode (take_abs, aux).  Row `row` of x is cut into K chunks of C
// samples; thread m = row * K + kk runs the attack/release recurrence of
// env_core.cuh over v = |x| at global positions kk*C - W .. kk*C + C - 1:
// W warm-up steps (positions below 0 read x[0], the recurrence's fixed
// point, which reproduces env[0] = |x[0]| for chunk 0) then C body steps.
// W is chosen so that the warm-up forgets the start state to 1e-8, so every
// chunk equals the exact recurrence.  Each body step writes
//
//   out[row, g] = clip(red(env) / env, floor, 1)   for 0 <= g < n_valid[row]
//               = 0                                 otherwise,
//   red(env)    = thresh + (env - thresh) / ratio if env > thresh else env,
//
// (gain 1 where env <= 1e-10, as in the JAX kernel).  The TPU kernel reads
// materialised warm-up/body views [M, W] and [M, C]; this one reads both
// in place from x by index.
//
// Bound on an H100: each thread runs W + C dependent steps, and the whole
// call takes at least that depth times one step's latency (W is about
// 69000 for the de-esser's 85 ms release at 44.1 kHz).  The bytes the
// function must move, x once and the gain once (2 * 16 * 220500 * 4 =
// 28.2 MB at the de-esser's [16, 220500], 8.4 us at 3.35 TB/s), matter far
// less.  One thread walks one row here, so loads are not coalesced (each
// thread streams its own cache lines through L1); staging tiles through
// shared memory is later work.
#include "env_core.cuh"

using namespace amw_env;

namespace {

constexpr int kThreads = 128;

__global__ void env_gain_kernel(const float* __restrict__ x,
                                const int* __restrict__ n_valid,
                                float* __restrict__ out, int rows, int n,
                                int W, int C, int K, float attack,
                                float release, float thresh, float ratio,
                                float floor_) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= rows * K) return;
  const int row = m / K;
  const int kk = m - row * K;
  const float* xr = x + static_cast<long long>(row) * n;
  float* yr = out + static_cast<long long>(row) * n;
  const int off = kk * C;
  const int nv = n_valid[row];

  float e = env_warmup<true>(xr, off, W, attack, release);
  const int end = min(off + C, n);
#pragma unroll 4
  for (int g = off; g < end; ++g) {
    e = env_step(e, env_input<true>(xr + g), attack, release);
    const float red = e > thresh ? thresh + (e - thresh) / ratio : e;
    float gain = e > 1e-10f ? red / (e + 1e-12f) : 1.0f;
    gain = fminf(fmaxf(gain, floor_), 1.0f);
    yr[g] = g < nv ? gain : 0.0f;
  }
}

}  // namespace

extern "C" int amw_env_gain(const float* x, const int* n_valid, float* out,
                            int rows, int n, int W, int C, int K,
                            float attack, float release, float thresh,
                            float ratio, float floor_, void* stream) {
  const int m = rows * K;
  if (m <= 0 || n <= 0) return 0;
  env_gain_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, n_valid, out, rows, n, W, C, K, attack, release, thresh, ratio,
      floor_);
  return static_cast<int>(cudaGetLastError());
}
