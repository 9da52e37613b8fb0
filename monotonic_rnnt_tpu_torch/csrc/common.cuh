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

// 0 where lo <= w <= hi, else -inf: a window folded into a log-space value
// by addition, as the Pallas kernels fold their reachability masks.
__device__ __forceinline__ float window_mask(int w, int lo, int hi) {
  return (w >= lo && w <= hi) ? 0.f : MRNNT_NEG_INF;
}

// Online log-sum-exp of one row of v values, read by one warp: on return
// every lane holds the row's max m and s = sum exp(x - m), combined across
// the warp by shuffles. kUnroll loads are in flight per lane; an all -inf
// chunk (or the masked tail) contributes nothing, and an all -inf row gives
// m = -inf, s = 0. Loads are scalar, so any v and row alignment works.
template <typename T>
__device__ __forceinline__ void warp_row_lse(const T* __restrict__ x, int v,
                                             int lane, float& m_out,
                                             float& s_out) {
  float m = MRNNT_NEG_INF, s = 0.f;
  for (int v0 = lane; v0 < v; v0 += kWarp * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int vi = v0 + k * kWarp;
      xs[k] = vi < v ? to_f32(x[vi]) : MRNNT_NEG_INF;
    }
    float cm = xs[0];
#pragma unroll
    for (int k = 1; k < kUnroll; ++k) cm = fmaxf(cm, xs[k]);
    const float mn = fmaxf(m, cm);
    if (mn == MRNNT_NEG_INF) continue;
    float acc = s * expf(m - mn);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc += expf(xs[k] - mn);
    s = acc;
    m = mn;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, m2);
    if (mn != MRNNT_NEG_INF) {
      s = s * expf(m - mn) + s2 * expf(m2 - mn);
      m = mn;
    }
  }
  m_out = m;
  s_out = s;
}

// Blocks of kRowThreads threads, one warp per row, for the row-parallel
// passes over the big tensor. Returns 0 or the launch's cudaError_t.
constexpr int kRowThreads = 256;  // 8 rows per block

inline int row_blocks(long long rows, unsigned* blocks) {
  const long long per_block = kRowThreads / kWarp;
  const long long n = (rows + per_block - 1) / per_block;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

}  // namespace mrnnt

// The C entry points return the launch's cudaError_t as an int (0 = ok).
// Each library is built from one source file, so this definition is linked
// once per library.
extern "C" const char* mrnnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
