// The split pipeline's kernels: log-softmax statistics with the raw label
// log-prob, and the V-free alpha and beta scans over the padded lattice.
//
// Replaces the TPU kernels of monotonic_rnnt_tpu/ops/pallas/kernels.py:
//  * softmax_stats (body _stats_kernel + _online_lse_step):
//      logits [B,T,S1,V] f32 or bf16, labels [B,S1] or [B,T,S1] int32 ->
//      denom, lp_blank, lp_label_raw, each [B,T,S1] f32. The label
//      log-prob is raw: an id outside [0, V) (the -1 sentinel) selects
//      nothing and gives 0 + denom; the callers mask those slots;
//  * alpha_scan (body _alpha_kernel):
//      lp_blank, lp_label, alpha_maskadd [B,T,S1] f32 -> alphas;
//  * beta_scan (body _beta_kernel):
//      lp_blank, lp_label, beta_maskadd [B,T,S1] f32, input_lengths [B]
//      int32, beta_virtual [B,S1] f32 -> betas;
//  * fwdbwd_scan (body _fwdbwd_kernel): both, one launch;
//  * softmax_stats_partial (body _stats_partial_kernel), the vocab-sharded
//    losses' pre-reduction statistics: logits [B,T,S1,V_local] f32 or bf16
//    (S1 is W on the band layout) -> m = max_v x and se = sum_v exp(x - m),
//    each [B,T,S1] f32, which the caller combines across the shards.
//
// What bounds them on an H100. The stats kernels: HBM bytes, one read of the
// logits (1.31 GB f32 / 0.65 GB bf16 at B=32, T=200, S=50, V=1000: ~0.39 /
// 0.20 ms at 3.35 TB/s; a rank's [16,200,51,500] shard on a 2x2 mesh: 0.097
// / 0.049 ms). The scans: latency, not bytes. Their traffic is O(B*T*S1)
// f32 (a few us of HBM time) but each walks T dependent steps.
//
// Design.
//  * Stats: one warp per (b,t,s) row, the online log-sum-exp of common.cuh
//    (as the other stats kernels). Lane 0 gathers x[blank] and x[label];
//    labels are addressed with a b- and a t-stride (t-stride 0 for [B,S1]).
//    The partial kernel writes the row's (m, se) and gathers nothing. An all
//    -inf row gives m = -inf and se = 0, where the TPU kernel's
//    exp(-inf - -inf) gives se = NaN: the shards' combine then needs no
//    guard against a shard whose row is all -inf.
//  * Scans: the TPU kernel packs alpha and t-reversed beta into one row of
//    2*S1 lanes so one roll pair advances both chains; that packing serves
//    the TPU's vector unit only. Here the chains run in two blocks per
//    sample (fwdbwd: blockIdx.y 0 = alpha, 1 = beta), a thread per slot s
//    (strided when S1 exceeds 1024), the carried row ping-ponged in shared
//    memory with a -inf sentinel slot at each end, so the s-1 and s+1 reads
//    need no tests, and one barrier per step. The operand rows do not depend
//    on the carry, so the block stages a chunk of up to kStageBytes of them
//    into shared memory with all its threads' loads in flight, then walks
//    the chunk: a step waits on shared memory, not on HBM latency
//    (csrc/banded.cu's scheme). beta_virtual is the same row for every t and
//    is staged once. The standalone beta kernel runs the same device code
//    as fwdbwd's beta block, so the two give identical betas.
//  * Masks: where the additive mask is -inf the output is exactly -inf, by
//    a select (the port's convention, ROADMAP.md section 3); elsewhere the
//    mask is added, as the TPU kernels add it. On finite inputs that is the
//    TPU kernels' result; a NaN statistic of a masked padding cell (from
//    +-inf padding logits) stays out of the recurrence.
// Row offsets are 64-bit.

#include "common.cuh"

namespace mrnnt {

template <typename T>
__global__ void mrnnt_softmax_stats_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    long long lab_b_stride, long long lab_t_stride, long long rows,
    int t_max, int s1, int v, int blank, float* __restrict__ denom,
    float* __restrict__ lp_blank, float* __restrict__ lp_label) {
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
  const long long bt = row / s1;
  const int lab = labels[(bt / t_max) * lab_b_stride +
                         (bt % t_max) * lab_t_stride +
                         static_cast<int>(row % s1)];
  // Ids outside [0, V) select nothing (0.0), as the compare-select sum.
  const float xl = (lab >= 0 && lab < v) ? to_f32(x[lab]) : 0.f;
  denom[row] = d;
  lp_blank[row] = to_f32(x[blank]) + d;
  lp_label[row] = xl + d;
}

template <typename T>
__global__ void mrnnt_softmax_stats_partial_kernel(
    const T* __restrict__ logits, long long rows, int v,
    float* __restrict__ m_out, float* __restrict__ se_out) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  if (row >= rows) return;
  float m, s;
  warp_row_lse(logits + row * static_cast<long long>(v), v, lane, m, s);
  if (lane != 0) return;
  m_out[row] = m;
  se_out[row] = s;
}

// Operand bytes one chunk stages in shared memory (three [tc, S1] streams).
constexpr int kStageBytes = 36 * 1024;

inline int stage_steps(int t_max, int s1) {
  int tc = kStageBytes / (3 * s1 * static_cast<int>(sizeof(float)));
  if (tc < 1) tc = 1;
  return tc < t_max ? tc : t_max;
}

// Shared memory of a scan block: three rows of s1 + 2 floats (two carries
// and the beta chain's virtual row) and the staged chunk.
inline size_t scan_smem_bytes(int s1, int tc) {
  return (3 * (static_cast<size_t>(s1) + 2) +
          3 * static_cast<size_t>(tc) * s1) * sizeof(float);
}

// Stages n consecutive floats from row0 of each of the three streams.
__device__ __forceinline__ void stage3(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       const float* __restrict__ c,
                                       long long row0, int n, float* st_a,
                                       float* st_b, float* st_c) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    st_a[i] = a[row0 + i];
    st_b[i] = b[row0 + i];
    st_c[i] = c[row0 + i];
  }
}

// -inf where the additive mask is -inf, x + mask elsewhere.
__device__ __forceinline__ float apply_mask(float x, float mask) {
  return mask == MRNNT_NEG_INF ? MRNNT_NEG_INF : x + mask;
}

// alpha(t, s) = mask(LSE(alpha(t-1, s) + lpb[t,s],
//                        alpha(t-1, s-1) + lpl[t,s-1])),
// alpha(-1, s) = [s == 0].
__device__ void alpha_chain(const float* __restrict__ lpb,
                            const float* __restrict__ lpl,
                            const float* __restrict__ amask, int b,
                            int t_max, int s1, int tc,
                            float* __restrict__ alphas, float* smem) {
  const int wp = s1 + 2;  // row[i + 1] holds slot i; row[0], row[s1+1] = -inf
  float* rows[2] = {smem, smem + wp};
  float* st_b = smem + 3 * wp;
  float* st_l = st_b + tc * s1;
  float* st_m = st_l + tc * s1;
  for (int i = threadIdx.x; i < wp; i += blockDim.x) {
    rows[0][i] = i == 1 ? 0.f : MRNNT_NEG_INF;
    rows[1][i] = MRNNT_NEG_INF;
  }
  const long long base = static_cast<long long>(b) * t_max * s1;
  int cur = 0;
  for (int t0 = 0; t0 < t_max; t0 += tc) {
    const int n = min(tc, t_max - t0);
    const long long row0 = base + static_cast<long long>(t0) * s1;
    __syncthreads();  // the previous chunk's steps are done with the stage
    stage3(lpb, lpl, amask, row0, n * s1, st_b, st_l, st_m);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* prev = rows[cur] + 1;
      float* next = rows[cur ^ 1];
      const float* sb = st_b + k * s1;
      const float* sl = st_l + k * s1;
      const float* sm = st_m + k * s1;
      for (int s = threadIdx.x; s < s1; s += blockDim.x) {
        const float emit = s > 0 ? prev[s - 1] + sl[s - 1] : MRNNT_NEG_INF;
        const float out =
            apply_mask(log_sum_exp(prev[s] + sb[s], emit), sm[s]);
        next[s + 1] = out;
        alphas[row0 + static_cast<long long>(k) * s1 + s] = out;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
}

// beta(t, s) = mask(LSE(nxt[s] + lpb[t,s], nxt[s+1] + lpl[t,s])),
// nxt = t+1 >= T_b ? beta_virtual : beta(t+1); the carry starts at -inf.
__device__ void beta_chain(const float* __restrict__ lpb,
                           const float* __restrict__ lpl,
                           const float* __restrict__ bmask,
                           const int* __restrict__ input_lengths,
                           const float* __restrict__ beta_virtual, int b,
                           int t_max, int s1, int tc,
                           float* __restrict__ betas, float* smem) {
  const int wp = s1 + 2;
  float* rows[2] = {smem, smem + wp};
  float* virt = smem + 2 * wp;
  float* st_b = smem + 3 * wp;
  float* st_l = st_b + tc * s1;
  float* st_m = st_l + tc * s1;
  for (int i = threadIdx.x; i < wp; i += blockDim.x) {
    rows[0][i] = MRNNT_NEG_INF;
    rows[1][i] = MRNNT_NEG_INF;
    virt[i] = (i == 0 || i == wp - 1)
                  ? MRNNT_NEG_INF
                  : beta_virtual[static_cast<long long>(b) * s1 + i - 1];
  }
  const int t_b = input_lengths[b];
  const long long base = static_cast<long long>(b) * t_max * s1;
  int cur = 0;
  for (int t_end = t_max; t_end > 0; t_end -= tc) {
    const int t0 = max(0, t_end - tc);
    const int n = t_end - t0;
    const long long row0 = base + static_cast<long long>(t0) * s1;
    __syncthreads();
    stage3(lpb, lpl, bmask, row0, n * s1, st_b, st_l, st_m);
    __syncthreads();
    for (int k = n - 1; k >= 0; --k) {
      // The same for the whole block.
      const float* nx = (t0 + k + 1 >= t_b ? virt : rows[cur]) + 1;
      float* out = rows[cur ^ 1];
      const float* sb = st_b + k * s1;
      const float* sl = st_l + k * s1;
      const float* sm = st_m + k * s1;
      for (int s = threadIdx.x; s < s1; s += blockDim.x) {
        const float nw = apply_mask(
            log_sum_exp(nx[s] + sb[s], nx[s + 1] + sl[s]), sm[s]);
        out[s + 1] = nw;
        betas[row0 + static_cast<long long>(k) * s1 + s] = nw;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
}

__global__ void mrnnt_alpha_scan_kernel(const float* __restrict__ lpb,
                                        const float* __restrict__ lpl,
                                        const float* __restrict__ amask,
                                        int t_max, int s1, int tc,
                                        float* __restrict__ alphas) {
  extern __shared__ float smem[];
  alpha_chain(lpb, lpl, amask, blockIdx.x, t_max, s1, tc, alphas, smem);
}

__global__ void mrnnt_beta_scan_kernel(const float* __restrict__ lpb,
                                       const float* __restrict__ lpl,
                                       const float* __restrict__ bmask,
                                       const int* __restrict__ input_lengths,
                                       const float* __restrict__ beta_virtual,
                                       int t_max, int s1, int tc,
                                       float* __restrict__ betas) {
  extern __shared__ float smem[];
  beta_chain(lpb, lpl, bmask, input_lengths, beta_virtual, blockIdx.x, t_max,
             s1, tc, betas, smem);
}

__global__ void mrnnt_fwdbwd_scan_kernel(
    const float* __restrict__ lpb, const float* __restrict__ lpl,
    const float* __restrict__ amask, const float* __restrict__ bmask,
    const int* __restrict__ input_lengths,
    const float* __restrict__ beta_virtual, int t_max, int s1, int tc,
    float* __restrict__ alphas, float* __restrict__ betas) {
  extern __shared__ float smem[];
  if (blockIdx.y == 0)
    alpha_chain(lpb, lpl, amask, blockIdx.x, t_max, s1, tc, alphas, smem);
  else
    beta_chain(lpb, lpl, bmask, input_lengths, beta_virtual, blockIdx.x,
               t_max, s1, tc, betas, smem);
}

// Stage depth, shared memory and block size of a scan launch; raises the
// kernel's shared-memory cap when a wide row needs more than 48 KB.
template <typename K>
int scan_config(K kernel, int t_max, int s1, int* tc, size_t* smem,
                int* threads) {
  *tc = stage_steps(t_max, s1);
  *smem = scan_smem_bytes(s1, *tc);
  *threads = s1 >= 1024 ? 1024 : ((s1 + 31) / 32) * 32;
  if (*smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

}  // namespace mrnnt

// labels_per_t: 0 for [B,S1] labels, 1 for [B,T,S1].
extern "C" int mrnnt_softmax_stats(const void* logits, int is_bf16,
                                   const int* labels, int labels_per_t,
                                   int batch, int t_max, int s1, int v,
                                   int blank, float* denom, float* lp_blank,
                                   float* lp_label, void* stream) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max * s1;
  unsigned blocks;
  if (const int err = row_blocks(rows, &blocks)) return err;
  const long long t_stride = labels_per_t ? s1 : 0;
  const long long b_stride =
      labels_per_t ? static_cast<long long>(t_max) * s1 : s1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    mrnnt_softmax_stats_kernel<__nv_bfloat16><<<blocks, kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, b_stride, t_stride,
        rows, t_max, s1, v, blank, denom, lp_blank, lp_label);
  else
    mrnnt_softmax_stats_kernel<float><<<blocks, kRowThreads, 0, st>>>(
        static_cast<const float*>(logits), labels, b_stride, t_stride, rows,
        t_max, s1, v, blank, denom, lp_blank, lp_label);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_softmax_stats_partial(const void* logits, int is_bf16,
                                           int batch, int t_max, int s1,
                                           int v, float* m, float* se,
                                           void* stream) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max * s1;
  unsigned blocks;
  if (const int err = row_blocks(rows, &blocks)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    mrnnt_softmax_stats_partial_kernel<__nv_bfloat16>
        <<<blocks, kRowThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(logits), rows, v, m, se);
  else
    mrnnt_softmax_stats_partial_kernel<float><<<blocks, kRowThreads, 0, st>>>(
        static_cast<const float*>(logits), rows, v, m, se);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_alpha_scan(const float* lpb, const float* lpl,
                                const float* amask, int batch, int t_max,
                                int s1, float* alphas, void* stream) {
  using namespace mrnnt;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_alpha_scan_kernel, t_max, s1, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_alpha_scan_kernel<<<batch, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, amask, t_max, s1, tc, alphas);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_beta_scan(const float* lpb, const float* lpl,
                               const float* bmask, const int* input_lengths,
                               const float* beta_virtual, int batch,
                               int t_max, int s1, float* betas,
                               void* stream) {
  using namespace mrnnt;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_beta_scan_kernel, t_max, s1, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_beta_scan_kernel<<<batch, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, bmask, input_lengths, beta_virtual, t_max, s1, tc, betas);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_fwdbwd_scan(const float* lpb, const float* lpl,
                                 const float* amask, const float* bmask,
                                 const int* input_lengths,
                                 const float* beta_virtual, int batch,
                                 int t_max, int s1, float* alphas,
                                 float* betas, void* stream) {
  using namespace mrnnt;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_fwdbwd_scan_kernel, t_max, s1, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_fwdbwd_scan_kernel<<<dim3(batch, 2), threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, amask, bmask, input_lengths, beta_virtual, t_max, s1, tc,
      alphas, betas);
  return static_cast<int>(cudaGetLastError());
}
