// De-esser envelope -> gain over chunked windows of x [rows, n].
//
// Replaces the Pallas TPU kernel amw_tpu/ops/scan.py `_win_scan_pallas` in
// gain mode (take_abs, aux).  The staged walk of env_staged.cuh over
// v = |x| (the scanning lane takes |x| as it unpacks a batch, off the
// dependent chain; positions below 0 read x[row, 0], whose |.| is the
// recurrence's fixed point, from n on 0), with the gain map as its
// epilogue, run by the loader threads as they store a tile's body:
//
//   out[row, g] = clip(red(env) / env, floor, 1)   for 0 <= g < n_valid[row]
//               = 0                                 otherwise,
//   red(env)    = thresh + (env - thresh) / ratio if env > thresh else env,
//
// (gain 1 where env <= 1e-10, as in the JAX kernel; the same operations in
// the same order as scan._gain_map, IEEE division).  The TPU kernel reads
// materialised warm-up/body views [M, W] and [M, C]; this one reads both
// in place from x by index.
//
// Bound on an H100: the serial depth W + C (W = 69050 for the de-esser's
// 4 ms / 85 ms at 44.1 kHz) times one step's latency, against the bytes
// of x once, the overlapping warm-up windows and the gain once; the host
// takes `scan.scan_geometry`'s chunks, one block of full chunks on every
// SM where it can (at the 180 s batch's [16, 7938000]: C 30080, K 264,
// exactly 132 blocks).
#include "env_staged.cuh"

using namespace amw_env;

namespace {

struct DeesserGain {
  const int* n_valid;
  float thresh, ratio, floor_;

  static constexpr bool kAbs = true;

  __device__ __forceinline__ int limit(int row, int) const {
    return n_valid[row];
  }

  __device__ __forceinline__ float store(float e, int pos, int nv) const {
    const float red = e > thresh ? thresh + (e - thresh) / ratio : e;
    float gain = e > 1e-10f ? red / (e + 1e-12f) : 1.0f;
    gain = fminf(fmaxf(gain, floor_), 1.0f);
    return pos < nv ? gain : 0.0f;
  }
};

}  // namespace

// x, out: [rows, n]; n_valid: [rows]; chunk geometry W, C, K
// (K * C >= n > (K - 1) * C).
extern "C" int amw_env_gain(const float* x, const int* n_valid, float* out,
                            int rows, int n, int W, int C, int K,
                            float attack, float release, float thresh,
                            float ratio, float floor_, void* stream) {
  return launch_staged(x, out, rows, n, W, C, K, attack, release,
                       DeesserGain{n_valid, thresh, ratio, floor_}, stream);
}
