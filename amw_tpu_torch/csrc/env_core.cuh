// The attack/release envelope recurrence, shared by the envelope kernels
// (env_staged.cuh, the staged walk of env_scan.cu and env_gain.cu; the
// Python side is amw_tpu_torch/ops/scan.py):
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

}  // namespace amw_env
