// Fused log-softmax statistics + alpha recurrence of the monotonic RNN-T loss.
//
// Replaces the TPU kernel monotonic_rnnt_tpu/ops/pallas/kernels.py:
// stats_alpha_fused (body _stats_alpha_kernel). Same operands and outputs:
// logits [B,T,S1,V] f32 or bf16, labels_ext [B,S1] int32 (-1 on invalid
// slots), inclusive alpha windows a_lo/a_hi [B,T] int32 (hi < lo = empty)
// -> denom, lp_blank, lp_label, alphas, each [B,T,S1] f32.
//
// What bounds it on an H100: HBM bytes. The logits are read once
// (B*T*S1*V*itemsize: 1.31 GB f32 / 0.65 GB bf16 at B=32,T=200,S=50,V=1000,
// ~0.39 / 0.20 ms at 3.35 TB/s); the four [B,T,S1] outputs add 0.3%. The
// arithmetic (an exp per element) is far below the f32 rate.
//
// Design. On the TPU one sequential grid both streamed V and advanced the
// DP. Hopper blocks run unordered, so the wrapper launches two kernels:
//  (a) mrnnt_stats_kernel: one warp per (b,t,s) row, an online max/sum-exp
//      over V in f32 (common.cuh warp_row_lse, shared with the banded stats
//      kernel). Lane 0 loads x[blank] and x[label[s]] directly.
//      This is the only pass over the big tensor.
//  (b) mrnnt_alpha_kernel: one block per sample, a thread per s (strided
//      when S1 exceeds the block), t walked serially with the alpha row
//      ping-ponged in shared memory and one __syncthreads per step. It reads
//      only the [B,T,S1] stats that (a) just wrote (L2-resident at the
//      benchmark shape). Its ~T serial steps are exposed, not hidden behind
//      the stream as on the TPU; fusing them back is later work.
// Row offsets are 64-bit: B*T*S1*V passes 2^31 at shapes the loss runs.
// Loads are scalar, so any V (79, 1000, 5000) and any row alignment works.

#include "common.cuh"

namespace mrnnt {

template <typename T>
__global__ void mrnnt_stats_kernel(const T* __restrict__ logits,
                                   const int* __restrict__ labels_ext,
                                   long long rows, long long t_s1, int s1,
                                   int v, int blank,
                                   float* __restrict__ denom,
                                   float* __restrict__ lp_blank,
                                   float* __restrict__ lp_label) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  if (row >= rows) return;
  const T* x = logits + row * static_cast<long long>(v);

  float m, s;
  warp_row_lse(x, v, lane, m, s);
  if (lane != 0) return;

  // An all -inf row gives denom = +inf, as logsumexp's -inf.
  const float d = -(m + logf(s));
  const long long b = row / t_s1;
  const int si = static_cast<int>(row % s1);
  const int lab = labels_ext[b * s1 + si];
  // Ids outside [0, V) select nothing (0.0), as kernels.py's compare-select;
  // the -1 sentinel gives lp_label = -inf (kernels.py:573).
  const float xl = (lab >= 0 && lab < v) ? to_f32(x[lab]) : 0.f;
  denom[row] = d;
  lp_blank[row] = to_f32(x[blank]) + d;
  lp_label[row] = lab >= 0 ? xl + d : MRNNT_NEG_INF;
}

__global__ void mrnnt_alpha_kernel(const float* __restrict__ lp_blank,
                                   const float* __restrict__ lp_label,
                                   const int* __restrict__ a_lo,
                                   const int* __restrict__ a_hi, int t_max,
                                   int s1, float* __restrict__ alphas) {
  extern __shared__ float rows_sh[];  // two alpha rows of s1 floats
  const int b = blockIdx.x;
  float* bufs[2] = {rows_sh, rows_sh + s1};
  // Virtual row alpha(-1, s) = [s == 0] in log space.
  for (int s = threadIdx.x; s < s1; s += blockDim.x)
    bufs[0][s] = s == 0 ? 0.f : MRNNT_NEG_INF;
  __syncthreads();

  const long long base = static_cast<long long>(b) * t_max * s1;
  for (int t = 0; t < t_max; ++t) {
    const float* prev = bufs[t & 1];
    float* next = bufs[(t + 1) & 1];
    const int lo = a_lo[b * t_max + t];
    const int hi = a_hi[b * t_max + t];
    const long long off = base + static_cast<long long>(t) * s1;
    for (int s = threadIdx.x; s < s1; s += blockDim.x) {
      float out = MRNNT_NEG_INF;
      if (s >= lo && s <= hi) {
        const float no_emit = prev[s] + lp_blank[off + s];
        const float emit =
            s > 0 ? prev[s - 1] + lp_label[off + s - 1] : MRNNT_NEG_INF;
        out = log_sum_exp(no_emit, emit);
      }
      next[s] = out;
      alphas[off + s] = out;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_stats(const void* logits, const int* labels_ext, int batch,
                 int t_max, int s1, int v, int blank, float* denom,
                 float* lp_blank, float* lp_label, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * t_max * s1;
  unsigned blocks;
  if (const int err = row_blocks(rows, &blocks)) return err;
  mrnnt_stats_kernel<T><<<blocks, kRowThreads, 0, stream>>>(
      static_cast<const T*>(logits), labels_ext, rows,
      static_cast<long long>(t_max) * s1, s1, v, blank, denom, lp_blank,
      lp_label);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mrnnt

extern "C" int mrnnt_stats(const void* logits, int is_bf16,
                           const int* labels_ext, int batch, int t_max, int s1,
                           int v, int blank, float* denom, float* lp_blank,
                           float* lp_label, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return mrnnt::launch_stats<__nv_bfloat16>(logits, labels_ext, batch, t_max,
                                              s1, v, blank, denom, lp_blank,
                                              lp_label, st);
  return mrnnt::launch_stats<float>(logits, labels_ext, batch, t_max, s1, v,
                                    blank, denom, lp_blank, lp_label, st);
}

extern "C" int mrnnt_alpha(const float* lp_blank, const float* lp_label,
                           const int* a_lo, const int* a_hi, int batch,
                           int t_max, int s1, float* alphas, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(s1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mrnnt::mrnnt_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = s1 >= 1024 ? 1024 : ((s1 + 31) / 32) * 32;
  mrnnt::mrnnt_alpha_kernel<<<batch, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      lp_blank, lp_label, a_lo, a_hi, t_max, s1, alphas);
  return static_cast<int>(cudaGetLastError());
}
