// Fused beta recurrence + occupancy coefficients + logit gradient of the
// monotonic RNN-T loss.
//
// Replaces the TPU kernel monotonic_rnnt_tpu/ops/pallas/kernels.py:
// beta_grad_fused (body _beta_grad_kernel). Same operands and outputs:
// logits [B,T,S1,V] f32 or bf16; denom, lp_blank and lp_label with the beta
// window folded in, aprev (alpha(t-1,s), -inf on invalid cells) [B,T,S1] f32;
// input_lengths [B] int32; ll_bounded and grad_scale [B] f32; beta_virtual
// and labels_ext [B,S1] -> grads [B,T,S1,V] in the logits' dtype and betas
// [B,T,S1] f32.
//
// What bounds it on an H100: HBM bytes. One read of the logits and one write
// of the gradient (2.61 GB f32 / 1.31 GB bf16 at B=32,T=200,S=50,V=1000,
// ~0.78 / 0.39 ms at 3.35 TB/s); the [B,T,S1] streams add under 1%.
//
// Design. As for stats_alpha.cu, the TPU's one sequential grid becomes two
// launches:
//  (c) mrnnt_beta_kernel: one block per sample, t walked downwards with the
//      beta row ping-ponged in shared memory; the "next" row is the virtual
//      boundary row while t+1 >= T_b. Besides betas it writes the three
//      occupancy coefficients occ/cb/cl [B,T,S1] f32, each
//      scale * exp(aprev + beta - ll) in the op order of kernels.py:688-691,
//      so the cost cotangent is folded in. They cost 3.9 MB at the benchmark
//      shape (0.3% of the big tensor) and let (d) stay elementwise.
//  (d) mrnnt_grad_kernel, the kernel of grad_pass (csrc/grad_pass.cu),
//      which the wrapper launches after (c) with [B,S1] labels.

#include "common.cuh"

namespace mrnnt {

__global__ void mrnnt_beta_kernel(
    const float* __restrict__ lpb_bmask, const float* __restrict__ lpl_bmask,
    const float* __restrict__ aprev, const int* __restrict__ input_lengths,
    const float* __restrict__ ll_bounded, const float* __restrict__ grad_scale,
    const float* __restrict__ beta_virtual, int t_max, int s1,
    float* __restrict__ betas, float* __restrict__ occ, float* __restrict__ cb,
    float* __restrict__ cl) {
  // Three rows of s1 + 1 floats (virtual row, two carries); slot s1 holds
  // -inf so that row[s + 1] needs no bounds test.
  extern __shared__ float rows_sh[];
  const int b = blockIdx.x;
  const int w = s1 + 1;
  float* virt = rows_sh;
  float* bufs[2] = {rows_sh + w, rows_sh + 2 * w};
  for (int s = threadIdx.x; s < w; s += blockDim.x) {
    virt[s] = s < s1 ? beta_virtual[b * s1 + s] : MRNNT_NEG_INF;
    bufs[0][s] = MRNNT_NEG_INF;
    bufs[1][s] = MRNNT_NEG_INF;
  }
  __syncthreads();

  const int t_b = input_lengths[b];
  const float ll = ll_bounded[b];
  const float sc = grad_scale[b];
  const long long base = static_cast<long long>(b) * t_max * s1;
  int cur = 0;
  for (int t = t_max - 1; t >= 0; --t) {
    const float* nxt = (t + 1 >= t_b) ? virt : bufs[cur];
    float* out = bufs[cur ^ 1];
    const long long off = base + static_cast<long long>(t) * s1;
    for (int s = threadIdx.x; s < s1; s += blockDim.x) {
      const float n0 = nxt[s];
      const float n1 = nxt[s + 1];
      const float nw =
          log_sum_exp(n0 + lpb_bmask[off + s], n1 + lpl_bmask[off + s]);
      out[s] = nw;
      betas[off + s] = nw;
      const float ap = aprev[off + s];
      occ[off + s] = sc * expf(ap + nw - ll);
      cb[off + s] = sc * expf(ap + n0 - ll);
      cl[off + s] = sc * expf(ap + n1 - ll);
    }
    __syncthreads();
    cur ^= 1;
  }
}

}  // namespace mrnnt

extern "C" int mrnnt_beta(const float* lpb_bmask, const float* lpl_bmask,
                          const float* aprev, const int* input_lengths,
                          const float* ll_bounded, const float* grad_scale,
                          const float* beta_virtual, int batch, int t_max,
                          int s1, float* betas, float* occ, float* cb,
                          float* cl, void* stream) {
  const size_t smem = 3 * (static_cast<size_t>(s1) + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mrnnt::mrnnt_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = s1 >= 1024 ? 1024 : ((s1 + 31) / 32) * 32;
  mrnnt::mrnnt_beta_kernel<<<batch, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      lpb_bmask, lpl_bmask, aprev, input_lengths, ll_bounded, grad_scale,
      beta_virtual, t_max, s1, betas, occ, cb, cl);
  return static_cast<int>(cudaGetLastError());
}
