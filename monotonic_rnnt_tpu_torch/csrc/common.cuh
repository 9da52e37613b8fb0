// Device helpers shared by the monotonic RNN-T kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define MRNNT_NEG_INF (-INFINITY)

namespace mrnnt {

constexpr int kWarp = 32;
// Values each lane loads before it reduces them: four independent loads in
// flight per lane keep enough bytes moving to approach the HBM rate.
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// log(exp(a) + exp(b)) = max + log1p(exp(min - max)); exactly -inf when both
// are -inf, and NaN when either is NaN (monotonic_rnnt_tpu/ops/helpers.py:19).
__device__ __forceinline__ float log_sum_exp(float a, float b) {
  const float mx = a > b ? a : b;
  const float mn = a > b ? b : a;
  if (mx == MRNNT_NEG_INF) return MRNNT_NEG_INF;
  return mx + log1pf(expf(mn - mx));
}

}  // namespace mrnnt

// The C entry points return the launch's cudaError_t as an int (0 = ok).
// Each library is built from one source file, so this definition is linked
// once per library.
extern "C" const char* mrnnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
