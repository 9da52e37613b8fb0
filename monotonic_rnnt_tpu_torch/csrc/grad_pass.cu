// Logit gradient of the monotonic RNN-T loss from per-cell coefficients.
//
// Replaces the TPU kernel monotonic_rnnt_tpu/ops/pallas/kernels.py:
// grad_pass (body _grad_kernel). Same operands and outputs: logits
// [B,T,S1,V] f32 or bf16 (S1 is the band width W on the packed band
// layout), denom, occ, cb, cl [B,T,S1] f32, labels [B,S1] (one id per
// lattice row) or [B,T,S1] (the band layout's per-(t,w) ids) int32 ->
// grads [B,T,S1,V] in f32 or bf16:
//   dz = p * (occ - [v==blank] cb - [v==label] cl),  p = exp(x + denom),
// and 0 by a select (never p*0) where that coefficient is 0, so +-inf
// padding cannot give NaN (kernels.py:1317-1319). It is also the second half
// of beta_grad_fused (csrc/beta_grad.cu), which launches it with [B,S1]
// labels.
//
// What bounds it on an H100: HBM bytes, one read of the logits and one
// write of the gradient (0.42 GB f32 at the banded acceptance case B=2,
// T=1600, W=16, V=1024: ~0.125 ms at 3.35 TB/s); the [B,T,S1] streams add
// about 2%.
//
// Design. One warp per (b,t,s) row over V, kUnroll loads in flight per lane.
// A row whose three coefficients are all 0 (padding, unreachable cells) has
// a zero gradient whatever its logits hold: it is written without being
// read. The labels are addressed with a b-stride and a t-stride (0 for
// [B,S1] labels), so both layouts run the same code. bf16 output rounds to
// nearest even, as astype. Row offsets are 64-bit; loads are scalar, so any
// V works.

#include "common.cuh"

namespace mrnnt {

template <typename TIn, typename TOut>
__global__ void mrnnt_grad_kernel(const TIn* __restrict__ logits,
                                  const float* __restrict__ denom,
                                  const float* __restrict__ occ,
                                  const float* __restrict__ cb,
                                  const float* __restrict__ cl,
                                  const int* __restrict__ labels,
                                  long long lab_b_stride,
                                  long long lab_t_stride, long long rows,
                                  int t_max, int s1, int v, int blank,
                                  TOut* __restrict__ grads) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  if (row >= rows) return;
  const long long off = row * static_cast<long long>(v);
  TOut* g = grads + off;
  const float o = occ[row], c_b = cb[row], c_l = cl[row];
  if (o == 0.f && c_b == 0.f && c_l == 0.f) {
    const TOut zero = from_f32<TOut>(0.f);
    for (int vi = lane; vi < v; vi += kWarp) g[vi] = zero;
    return;
  }
  const TIn* x = logits + off;
  const float d = denom[row];
  const long long bt = row / s1;
  const int lab = labels[(bt / t_max) * lab_b_stride +
                         (bt % t_max) * lab_t_stride +
                         static_cast<int>(row % s1)];
  for (int v0 = lane; v0 < v; v0 += kWarp * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int vi = v0 + k * kWarp;
      xs[k] = vi < v ? to_f32(x[vi]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int vi = v0 + k * kWarp;
      if (vi < v) {
        const float p = expf(xs[k] + d);
        const float coef =
            o - (vi == blank ? c_b : 0.f) - (vi == lab ? c_l : 0.f);
        g[vi] = from_f32<TOut>(coef == 0.f ? 0.f : p * coef);
      }
    }
  }
}

template <typename TIn, typename TOut>
int launch_grad(const void* logits, const float* denom, const float* occ,
                const float* cb, const float* cl, const int* labels,
                long long lab_b_stride, long long lab_t_stride, int batch,
                int t_max, int s1, int v, int blank, void* grads,
                cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * t_max * s1;
  unsigned blocks;
  if (const int err = row_blocks(rows, &blocks)) return err;
  mrnnt_grad_kernel<TIn, TOut><<<blocks, kRowThreads, 0, stream>>>(
      static_cast<const TIn*>(logits), denom, occ, cb, cl, labels,
      lab_b_stride, lab_t_stride, rows, t_max, s1, v, blank,
      static_cast<TOut*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mrnnt

// labels_per_t: 0 for [B,S1] labels, 1 for [B,T,S1].
extern "C" int mrnnt_grad(const void* logits, int in_bf16, const float* denom,
                          const float* occ, const float* cb, const float* cl,
                          const int* labels, int labels_per_t, int batch,
                          int t_max, int s1, int v, int blank, void* grads,
                          int out_bf16, void* stream) {
  using mrnnt::launch_grad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long t_stride = labels_per_t ? s1 : 0;
  const long long b_stride = labels_per_t ? static_cast<long long>(t_max) * s1
                                          : s1;
#define MRNNT_GRAD_ARGS                                                      \
  logits, denom, occ, cb, cl, labels, b_stride, t_stride, batch, t_max, s1, \
      v, blank, grads, st
  if (in_bf16 && out_bf16)
    return launch_grad<__nv_bfloat16, __nv_bfloat16>(MRNNT_GRAD_ARGS);
  if (in_bf16) return launch_grad<__nv_bfloat16, float>(MRNNT_GRAD_ARGS);
  if (out_bf16) return launch_grad<float, __nv_bfloat16>(MRNNT_GRAD_ARGS);
  return launch_grad<float, float>(MRNNT_GRAD_ARGS);
#undef MRNNT_GRAD_ARGS
}
