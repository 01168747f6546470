// The attack/release envelope recurrence, shared by the envelope kernels
// (env_gain.cu: the de-esser's envelope -> gain; env_scan.cu: the chunked
// envelope and the one-sequence-per-row envelope; the Python side is
// amw_tpu_torch/ops/scan.py):
//
//   env = c * env + (1 - c) * v = v + c * (env - v),
//   c   = attack if v > env else release,
//
// evaluated in the second form (one fused multiply-add after the
// subtraction; the plain PyTorch versions take the same form).
//
// The recurrence is a contraction with factor max(attack, release) < 1, so
// a chunk of a row that starts W steps early (its warm-up, W chosen on the
// host so that the start state is forgotten to 1e-8) equals the exact
// sequential envelope from its first kept step on.  Position 0 of a row is
// the recurrence's fixed point for v[0]: a warm-up that reaches back
// before the row reads v[0] there, which reproduces env[0] = v[0].
#pragma once

#include <cuda_runtime.h>

namespace amw_env {

__device__ __forceinline__ float env_step(float e, float v, float attack,
                                          float release) {
  const float c = v > e ? attack : release;
  return fmaf(c, e - v, v);
}

template <bool kAbs>
__device__ __forceinline__ float env_input(const float* p) {
  const float v = __ldg(p);
  return kAbs ? fabsf(v) : v;
}

// The state after the W warm-up steps of the chunk whose first kept
// position is `off` in row `xr` (positions below 0 read xr[0]); the state
// starts at the first warm-up value.  kAbs: the input is |xr|.
template <bool kAbs>
__device__ __forceinline__ float env_warmup(const float* xr, int off, int W,
                                            float attack, float release) {
  const int start = off - W;
  float e = env_input<kAbs>(xr + max(start, 0));
#pragma unroll 4
  for (int g = start; g < off; ++g) {
    e = env_step(e, env_input<kAbs>(xr + max(g, 0)), attack, release);
  }
  return e;
}

}  // namespace amw_env
