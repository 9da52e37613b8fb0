// The banded (packed [B,T,W,V]) monotonic RNN-T loss's forward kernels:
// log-softmax statistics with the reachability masks folded in, the
// cost-only alpha scan, and the alpha+beta scans of a training forward.
//
// Replaces the TPU kernels of monotonic_rnnt_tpu/ops/pallas/kernels.py:
//  * softmax_stats_banded (body _stats_banded_kernel):
//      logits_band [B,T,W,V] f32 or bf16, lab_band [B,T,W] int32 (-1
//      sentinel), slot windows ra_lo/ra_hi/rb_lo/rb_hi [B,T] int32 ->
//      denom, lpb+amask, lpl+amask shifted one slot down[, lpb+bmask,
//      lpl+bmask], each [B,T,W] f32;
//  * alpha_scan_banded (body _alpha_band_kernel):
//      lpb, lpl [B,T,W] f32 (masks folded in), d [B,T] int32 -> alphas;
//  * fwdbwd_scan_banded (body _fwdbwd_band_kernel):
//      the alpha operands, beta operands lpbb/lplb, d_next [B,T] int32,
//      input_lengths [B] int32, beta_virtual [B,T,W] f32 -> alphas, betas.
//
// What bounds them on an H100. The stats kernel: HBM bytes, one read of the
// band tensor (0.21 GB f32 at B=2, T=1600, W=16, V=1024: ~0.063 ms at
// 3.35 TB/s). The scans: latency, not bytes. Their traffic is O(B*T*W) f32
// (a few us of HBM time) but each walks T dependent steps for only B
// samples.
//
// Design.
//  * Stats: one warp per (b,t,w) row, the online log-sum-exp of
//    common.cuh (as mrnnt_stats_kernel); lane 0 gathers x[blank] and
//    x[lab_band[row]] and adds the 0/-inf window masks. The alpha emit mask
//    is the alpha window shifted by one slot (bounds minus 1): the emit into
//    w reads lp_label at w-1.
//  * Scans: one block per (sample, chain), a thread per slot w (strided when
//    W exceeds 1024), the carried row ping-ponged in shared memory with one
//    -inf sentinel slot at each end, so the +-1 slot reads need no tests,
//    and one barrier per step. The operand rows do not depend on the carry,
//    so the block stages a chunk of up to kStageBytes of them (and the d
//    shifts) into shared memory with all its threads' loads in flight, then
//    walks the chunk: a step waits on shared memory, not on HBM latency.
//    fwdbwd runs the alpha chain in blockIdx.y == 0 and the beta chain, t
//    walked downwards, in blockIdx.y == 1, side by side. The beta chain's
//    virtual boundary row (t+1 >= T_b) is loaded when a step needs it.
// Row offsets are 64-bit.

#include "common.cuh"

namespace mrnnt {

template <typename T>
__global__ void mrnnt_stats_banded_kernel(
    const T* __restrict__ logits, const int* __restrict__ lab_band,
    const int* __restrict__ ra_lo, const int* __restrict__ ra_hi,
    const int* __restrict__ rb_lo, const int* __restrict__ rb_hi,
    long long rows, int w, int v, int blank, float* __restrict__ denom,
    float* __restrict__ lpba, float* __restrict__ lpla,
    float* __restrict__ lpbb, float* __restrict__ lplb) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  if (row >= rows) return;
  const T* x = logits + row * static_cast<long long>(v);
  float m, s;
  warp_row_lse(x, v, lane, m, s);
  if (lane != 0) return;

  const float d = -(m + logf(s));
  const long long bt = row / w;
  const int wi = static_cast<int>(row % w);
  const int lab = lab_band[row];
  // Ids outside [0, V) select nothing (0.0), as the Pallas compare-select;
  // the -1 sentinel gives lp_label = -inf before the mask is added.
  const float xl = (lab >= 0 && lab < v) ? to_f32(x[lab]) : 0.f;
  const float lpb = to_f32(x[blank]) + d;
  const float lpl = lab >= 0 ? xl + d : MRNNT_NEG_INF;
  const int alo = ra_lo[bt], ahi = ra_hi[bt];
  denom[row] = d;
  lpba[row] = lpb + window_mask(wi, alo, ahi);
  lpla[row] = lpl + window_mask(wi, alo - 1, ahi - 1);
  if (lpbb != nullptr) {
    const float bm = window_mask(wi, rb_lo[bt], rb_hi[bt]);
    lpbb[row] = lpb + bm;
    lplb[row] = lpl + bm;
  }
}

// Operand bytes one chunk stages in shared memory (two [tc, W] f32 streams
// and tc shifts).
constexpr int kStageBytes = 32 * 1024;

inline int stage_steps(int t_max, int w) {
  int tc = kStageBytes / ((2 * w + 1) * static_cast<int>(sizeof(float)));
  if (tc < 1) tc = 1;
  return tc < t_max ? tc : t_max;
}

// Shared memory of a scan block: three rows of w + 2 floats (two carries
// and the beta chain's virtual row) and the staged chunk.
inline size_t scan_smem_bytes(int w, int tc) {
  return (3 * (static_cast<size_t>(w) + 2) +
          static_cast<size_t>(tc) * (2 * w + 1)) * sizeof(float);
}

// Stages rows [t0, t0 + n) of the two operand streams and of the shifts.
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ shift, long long row0, long long t_row0, int n,
    int w, float* st_a, float* st_b, int* st_s) {
  for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
    st_a[i] = a[row0 + i];
    st_b[i] = b[row0 + i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) st_s[i] = shift[t_row0 + i];
}

// alpha(t, w) = LSE(aligned[w] + lpb[t,w], aligned[w-1] + lpl[t,w-1]),
// aligned = d[t] ? alpha(t-1, w+1) : alpha(t-1, w); alpha(-1, w) = [w == 0].
__device__ void alpha_chain(const float* __restrict__ lpb,
                            const float* __restrict__ lpl,
                            const int* __restrict__ d, int b, int t_max,
                            int w, int tc, float* __restrict__ alphas,
                            float* smem) {
  const int wp = w + 2;  // row[i + 1] holds slot i; row[0], row[w+1] = -inf
  float* rows[2] = {smem, smem + wp};
  float* st_b = smem + 3 * wp;
  float* st_l = st_b + tc * w;
  int* st_d = reinterpret_cast<int*>(st_l + tc * w);
  for (int i = threadIdx.x; i < wp; i += blockDim.x) {
    rows[0][i] = i == 1 ? 0.f : MRNNT_NEG_INF;
    rows[1][i] = MRNNT_NEG_INF;
  }
  const long long base = static_cast<long long>(b) * t_max * w;
  int cur = 0;
  for (int t0 = 0; t0 < t_max; t0 += tc) {
    const int n = min(tc, t_max - t0);
    const long long row0 = base + static_cast<long long>(t0) * w;
    __syncthreads();  // the previous chunk's steps are done with the stage
    stage_chunk(lpb, lpl, d, row0, static_cast<long long>(b) * t_max + t0, n,
                w, st_b, st_l, st_d);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* al = rows[cur] + 1 + (st_d[k] == 1 ? 1 : 0);  // aligned
      float* next = rows[cur ^ 1];
      const float* sb = st_b + k * w;
      const float* sl = st_l + k * w;
      for (int wi = threadIdx.x; wi < w; wi += blockDim.x) {
        const float emit =
            wi > 0 ? al[wi - 1] + sl[wi - 1] : MRNNT_NEG_INF;
        const float out = log_sum_exp(al[wi] + sb[wi], emit);
        next[wi + 1] = out;
        alphas[row0 + static_cast<long long>(k) * w + wi] = out;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
}

// beta(t, w) = LSE(nxt[w - dn] + lpb[t,w], nxt[w - dn + 1] + lpl[t,w]),
// dn = d_next[t], nxt = t+1 >= T_b ? beta_virtual[t] : beta(t+1);
// beta(T_max, .) = -inf.
__device__ void beta_chain(const float* __restrict__ lpb,
                           const float* __restrict__ lpl,
                           const int* __restrict__ d_next,
                           const int* __restrict__ input_lengths,
                           const float* __restrict__ beta_virtual, int b,
                           int t_max, int w, int tc,
                           float* __restrict__ betas, float* smem) {
  const int wp = w + 2;
  float* rows[2] = {smem, smem + wp};
  float* virt = smem + 2 * wp;
  float* st_b = smem + 3 * wp;
  float* st_l = st_b + tc * w;
  int* st_d = reinterpret_cast<int*>(st_l + tc * w);
  for (int i = threadIdx.x; i < 3 * wp; i += blockDim.x)
    smem[i] = MRNNT_NEG_INF;
  const int t_b = input_lengths[b];
  const long long base = static_cast<long long>(b) * t_max * w;
  int cur = 0;
  for (int t_end = t_max; t_end > 0; t_end -= tc) {
    const int t0 = max(0, t_end - tc);
    const int n = t_end - t0;
    const long long row0 = base + static_cast<long long>(t0) * w;
    __syncthreads();
    stage_chunk(lpb, lpl, d_next, row0,
                static_cast<long long>(b) * t_max + t0, n, w, st_b, st_l,
                st_d);
    __syncthreads();
    for (int k = n - 1; k >= 0; --k) {
      const long long row = row0 + static_cast<long long>(k) * w;
      const float* nxt = rows[cur];
      if (t0 + k + 1 >= t_b) {  // the same for the whole block
        for (int wi = threadIdx.x; wi < w; wi += blockDim.x)
          virt[wi + 1] = beta_virtual[row + wi];
        __syncthreads();
        nxt = virt;
      }
      const float* nx = nxt + 1 - (st_d[k] == 1 ? 1 : 0);
      float* out = rows[cur ^ 1];
      const float* sb = st_b + k * w;
      const float* sl = st_l + k * w;
      for (int wi = threadIdx.x; wi < w; wi += blockDim.x) {
        const float nw = log_sum_exp(nx[wi] + sb[wi], nx[wi + 1] + sl[wi]);
        out[wi + 1] = nw;
        betas[row + wi] = nw;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
}

__global__ void mrnnt_alpha_banded_kernel(const float* __restrict__ lpb,
                                          const float* __restrict__ lpl,
                                          const int* __restrict__ d,
                                          int t_max, int w, int tc,
                                          float* __restrict__ alphas) {
  extern __shared__ float smem[];
  alpha_chain(lpb, lpl, d, blockIdx.x, t_max, w, tc, alphas, smem);
}

__global__ void mrnnt_fwdbwd_banded_kernel(
    const float* __restrict__ lpba, const float* __restrict__ lpla,
    const int* __restrict__ d, const float* __restrict__ lpbb,
    const float* __restrict__ lplb, const int* __restrict__ d_next,
    const int* __restrict__ input_lengths,
    const float* __restrict__ beta_virtual, int t_max, int w, int tc,
    float* __restrict__ alphas, float* __restrict__ betas) {
  extern __shared__ float smem[];
  if (blockIdx.y == 0)
    alpha_chain(lpba, lpla, d, blockIdx.x, t_max, w, tc, alphas, smem);
  else
    beta_chain(lpbb, lplb, d_next, input_lengths, beta_virtual, blockIdx.x,
               t_max, w, tc, betas, smem);
}

// Stage depth, shared memory and block size of a scan launch; raises the
// kernel's shared-memory cap when a wide band needs more than 48 KB.
template <typename K>
int scan_config(K kernel, int t_max, int w, int* tc, size_t* smem,
                int* threads) {
  *tc = stage_steps(t_max, w);
  *smem = scan_smem_bytes(w, *tc);
  *threads = w >= 1024 ? 1024 : ((w + 31) / 32) * 32;
  if (*smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

}  // namespace mrnnt

extern "C" int mrnnt_stats_banded(const void* logits, int is_bf16,
                                  const int* lab_band, const int* ra_lo,
                                  const int* ra_hi, const int* rb_lo,
                                  const int* rb_hi, int batch, int t_max,
                                  int w, int v, int blank, float* denom,
                                  float* lpba, float* lpla, float* lpbb,
                                  float* lplb, void* stream) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max * w;
  unsigned blocks;
  if (const int err = row_blocks(rows, &blocks)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    mrnnt_stats_banded_kernel<__nv_bfloat16><<<blocks, kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), lab_band, ra_lo, ra_hi,
        rb_lo, rb_hi, rows, w, v, blank, denom, lpba, lpla, lpbb, lplb);
  else
    mrnnt_stats_banded_kernel<float><<<blocks, kRowThreads, 0, st>>>(
        static_cast<const float*>(logits), lab_band, ra_lo, ra_hi, rb_lo,
        rb_hi, rows, w, v, blank, denom, lpba, lpla, lpbb, lplb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_alpha_banded(const float* lpb, const float* lpl,
                                  const int* d, int batch, int t_max, int w,
                                  float* alphas, void* stream) {
  using namespace mrnnt;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_alpha_banded_kernel, t_max, w, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_alpha_banded_kernel<<<batch, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      lpb, lpl, d, t_max, w, tc, alphas);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_fwdbwd_banded(const float* lpba, const float* lpla,
                                   const int* d, const float* lpbb,
                                   const float* lplb, const int* d_next,
                                   const int* input_lengths,
                                   const float* beta_virtual, int batch,
                                   int t_max, int w, float* alphas,
                                   float* betas, void* stream) {
  using namespace mrnnt;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_fwdbwd_banded_kernel, t_max, w, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_fwdbwd_banded_kernel<<<dim3(batch, 2), threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      lpba, lpla, d, lpbb, lplb, d_next, input_lengths, beta_virtual, t_max,
      w, tc, alphas, betas);
  return static_cast<int>(cudaGetLastError());
}
