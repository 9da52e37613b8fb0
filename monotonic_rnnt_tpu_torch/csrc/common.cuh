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

// 16 bytes of T as one load: float4 (4 floats) or uint4 (8 bf16), unpacked
// to and packed from f32. bf16 packs round to nearest even, as astype.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const float4& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static float4 pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// True when rows of v values of `itemsize` bytes at both pointers can be
// read and written 16 bytes a lane: every row starts on a 16-byte boundary.
inline bool rows_are_16b(const void* a, const void* b, long long v,
                         int itemsize) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15ull) != 0;
  };
  return (v * itemsize) % 16 == 0 && !misaligned(a) && !misaligned(b);
}

// Vectors a lane keeps in flight on the 16-byte gradient path: 32 values
// (8 float4 or 4 x 8 bf16), so that a row of V = 1000 is one round of loads.
template <typename T>
constexpr int kVecUnroll = 32 / Vec16<T>::n;

// Values of one 16-byte stage of a row in shared memory: 2 KB of T.
template <typename T>
constexpr int kStageValues = 2048 / static_cast<int>(sizeof(T));

// A stage's 16-byte vectors a lane holds: 4 (float4, or 8 bf16 each).
template <typename T>
constexpr int kStageVecs = kStageValues<T> / Vec16<T>::n / kWarp;

// n values (n <= kStageValues<T>, n * sizeof(T) a multiple of 16, src
// 16-byte aligned) read 16 bytes a lane into registers, lane i taking
// vectors i, i + 32, ...: a streaming (evict-first) read, in flight until
// store_stage puts them into the warp's shared stage.
template <typename T>
__device__ __forceinline__ void load_stage(
    typename Vec16<T>::type (&raw)[kStageVecs<T>], const T* src, int n,
    int lane) {
  const typename Vec16<T>::type* v =
      reinterpret_cast<const typename Vec16<T>::type*>(src);
#pragma unroll
  for (int k = 0; k < kStageVecs<T>; ++k)
    if ((lane + k * kWarp) * Vec16<T>::n < n) raw[k] = __ldcs(v + lane + k * kWarp);
}

template <typename T>
__device__ __forceinline__ void store_stage(
    const typename Vec16<T>::type (&raw)[kStageVecs<T>], T* stage, int n,
    int lane) {
  typename Vec16<T>::type* v = reinterpret_cast<typename Vec16<T>::type*>(stage);
#pragma unroll
  for (int k = 0; k < kStageVecs<T>; ++k)
    if ((lane + k * kWarp) * Vec16<T>::n < n) v[lane + k * kWarp] = raw[k];
}

// warp_row_lse's rounds over n values at x (global or shared memory),
// continuing the lane's running (m, s): the same values a lane, in the
// same order, with the same arithmetic and -inf rules. A row read in
// pieces of whole rounds (multiples of kWarp * kUnroll values), then
// combined by warp_lse_combine, gives warp_row_lse's result bit for bit.
template <typename T>
__device__ __forceinline__ void lse_rounds(const T* x, int n, int lane,
                                           float& m, float& s) {
  for (int v0 = lane; v0 < n; v0 += kWarp * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int vi = v0 + k * kWarp;
      xs[k] = vi < n ? to_f32(x[vi]) : MRNNT_NEG_INF;
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
}

// warp_row_lse's shuffle tree: every lane ends with the row's (m, s).
__device__ __forceinline__ void warp_lse_combine(float& m, float& s) {
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
}

// Flags between the CTAs of one persistent launch. A producer's threads
// write their data, meet at __syncthreads, and one thread publishes with
// publish_flag (a device-scope fence, then a release store); a consumer
// reads the flag with an acquire load and reads the data through L2
// (__ldcg), never through a possibly stale L1 line.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish_flag(int* p, int v) {
  __threadfence();
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// 4-byte asynchronous copies global -> shared (sm_80+), for rings that a
// thread fills and reads itself: cp_async_wait<N> leaves N groups pending.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The CTAs of `kernel` (threads a CTA, smem dynamic bytes) resident at once
// on the current device, after raising its dynamic shared memory limit when
// smem passes the default 48 KB. Returns 0 or a cudaError_t. The answer is
// kept for the last (kernel, smem, device) asked, the launch's usual case.
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads, size_t smem, int* ctas) {
  static thread_local struct { Kernel kernel; size_t smem; int dev, ctas; }
      last = {nullptr, 0, -1, 0};
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (last.kernel == kernel && last.smem == smem && last.dev == dev) {
    *ctas = last.ctas;
    return 0;
  }
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *ctas = sms * per_sm;
  last = {kernel, smem, dev, *ctas};
  return 0;
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
