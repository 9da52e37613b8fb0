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
//  * Stats: one warp per (b,t,w) row, reduced by common.cuh's walk_rows
//    (the stats reduction of every stats kernel, so a row's stats equal
//    the split and fused routes' bit for bit); lane 0 reads x[blank] and
//    x[lab_band[row]] and adds the 0/-inf window masks. The alpha emit mask
//    is the alpha window shifted by one slot (bounds minus 1): the emit into
//    w reads lp_label at w-1.
//  * Scans: a step is one log_sum_exp a slot on operands that do not depend
//    on the carry, and B chains give the card a few warps, so a step's
//    latency is the kernel's time. fwdbwd runs the alpha chain in
//    blockIdx.y == 0 and the beta chain, t walked downwards, in
//    blockIdx.y == 1, side by side.
//    - W <= 32: one warp a chain (alpha_warp, beta_warp). Lane w carries
//      slot w in a register (lanes >= W carry values no slot reads); the
//      +-1 slot neighbours come by __shfl_up_sync / __shfl_down_sync of
//      the previous carry, both at once (-inf past either edge). lpb, lpl shifted onto the
//      lane, the shift and the beta chain's virtual row are loaded
//      kScanRing steps ahead into a register ring, so no step waits on
//      memory and none on a barrier; stores are not waited on. A step is
//      then the latency of its shuffles, selects and one log_sum_exp.
//    - W > 32: a block a chain, a thread per slot (strided past 1024), the
//      carry ping-ponged in shared memory with one -inf sentinel slot at
//      each end and one barrier a step. The operand rows (and the virtual
//      rows their steps need) come in chunks of up to kStageBytes through
//      two stages: cp.async fills chunk c+1 while chunk c is walked.
//    Every slot takes log_sum_exp of the same two operands, in the same
//    order, on both paths and in the plain version's terms, so
//    alpha_scan_banded's alphas equal fwdbwd_scan_banded's bit for bit.
// Row offsets are 64-bit.

#include "common.cuh"

namespace mrnnt {

// softmax_stats_banded's rows: lane 0 reads x[blank] and x[lab_band[row]]
// and writes the stats with the window masks added.
template <typename T>
struct BandedStatsRows {
  DirectReads<T> d;
  const int* lab_band;
  const int *ra_lo, *ra_hi, *rb_lo, *rb_hi;
  int w;
  float *denom, *lpba, *lpla, *lpbb, *lplb;

  __device__ __forceinline__ void begin(long long, long long) {}
  __device__ __forceinline__ void pre(long long row) {
    d.load(row, lab_band[row]);
  }
  __device__ __forceinline__ void start(long long row) { d.take(row); }
  __device__ __forceinline__ void fin(long long row, float m, float s) {
    const float dn = -(m + logf(s));
    const long long bt = row / w;
    const int wi = static_cast<int>(row % w);
    // The -1 sentinel gives lp_label = -inf before the mask is added.
    const float lpb = d.xb + dn;
    const float lpl = d.lab >= 0 ? d.xl + dn : MRNNT_NEG_INF;
    const int alo = ra_lo[bt], ahi = ra_hi[bt];
    denom[row] = dn;
    lpba[row] = lpb + window_mask(wi, alo, ahi);
    lpla[row] = lpl + window_mask(wi, alo - 1, ahi - 1);
    if (lpbb != nullptr) {
      const float bm = window_mask(wi, rb_lo[bt], rb_hi[bt]);
      lpbb[row] = lpb + bm;
      lplb[row] = lpl + bm;
    }
  }
};

// A warp a row (blocks of 8 rows; a half-warp a row on short rows, when
// the upper half of the grid has none).
template <typename T, int kBytes, int kG>
__global__ void __launch_bounds__(kRowThreads) mrnnt_stats_banded_kernel(
    const T* __restrict__ logits, const int* __restrict__ lab_band,
    const int* __restrict__ ra_lo, const int* __restrict__ ra_hi,
    const int* __restrict__ rb_lo, const int* __restrict__ rb_hi,
    long long rows, int w, int v, int blank, float* __restrict__ denom,
    float* __restrict__ lpba, float* __restrict__ lpla,
    float* __restrict__ lpbb, float* __restrict__ lplb) {
  BandedStatsRows<T> r{{logits, v, blank}, lab_band, ra_lo, ra_hi, rb_lo,
                       rb_hi, w, denom, lpba, lpla, lpbb, lplb};
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  walk_rows<T, kBytes, kG>(logits, v, 0, warp,
                       static_cast<long long>(gridDim.x) * (blockDim.x / kWarp),
                       rows, r);
}

// --- W <= 32: a warp a chain -------------------------------------------------

// Steps whose operands a warp chain has in flight ahead of the step.
constexpr int kScanRing = 16;

// The warp chains walk T in groups of kScanRing steps, fully unrolled, so
// that ring slot k is a register. Loads read clamped, always valid
// addresses and are masked where they are used, so that no step waits on a
// load issued after the one it reads (a load whose value is selected right
// away, or one under a per-step branch, made each step wait on memory);
// only the last, partial group tests each step. A lane >= W carries
// garbage from its own operands, never read: every slot read across the
// band's top edge is replaced by -inf. No branch region may sit between
// one step's log_sum_exp and the next step's shuffles: the alpha chain's
// store compiles to a predicated store; the beta chain's, written the same
// way, became a branch around its address arithmetic, so it is written as
// one predicated PTX store (common.cuh's store_if).

// alpha(t, w) = LSE(aligned[w] + lpb[t,w], aligned[w-1] + lpl[t,w-1]),
// aligned = d[t] ? alpha(t-1, w+1) : alpha(t-1, w); alpha(-1, w) = [w == 0].
__device__ void alpha_warp(const float* __restrict__ lpb,
                           const float* __restrict__ lpl,
                           const int* __restrict__ d, int b, int t_max, int w,
                           float* __restrict__ alphas) {
  const int lane = threadIdx.x;
  const bool in_band = lane < w;
  const bool top = lane + 1 >= w;   // slot lane+1 lies past the band
  const int own = min(lane, w - 1), left = max(min(lane, w) - 1, 0);
  const long long base = static_cast<long long>(b) * t_max * w;
  const int* db = d + static_cast<long long>(b) * t_max;
  // Step t's operands sit in slot t % kScanRing: lpb[t, lane], lpl[t,
  // lane-1] (the emit into the lane) and d[t]; t clamped to T - 1.
  float rb[kScanRing], rl[kScanRing];
  int rd[kScanRing];
  const auto fetch = [&](int t, int k) {
    t = min(t, t_max - 1);
    const long long row = base + static_cast<long long>(t) * w;
    rb[k] = __ldg(lpb + row + own);
    rl[k] = __ldg(lpl + row + left);
    rd[k] = __ldg(db + t);
  };
  float prev = lane == 0 ? 0.f : MRNNT_NEG_INF;
  const auto step = [&](int t, int k) {
    const float up = __shfl_down_sync(kFull, prev, 1);  // slot w+1
    const float dn = __shfl_up_sync(kFull, prev, 1);    // slot w-1
    const bool shift = rd[k] == 1;
    const float al = shift ? (top ? MRNNT_NEG_INF : up) : prev;  // aligned[w]
    const float al_m1 = shift ? prev : dn;                       // aligned[w-1]
    const float emit = lane > 0 ? al_m1 + rl[k] : MRNNT_NEG_INF;
    prev = log_sum_exp(al + rb[k], emit);
    if (in_band) alphas[base + static_cast<long long>(t) * w + lane] = prev;
  };
#pragma unroll
  for (int k = 0; k < kScanRing; ++k) fetch(k, k);
  int t0 = 0;
  for (; t0 + kScanRing <= t_max; t0 += kScanRing) {
#pragma unroll
    for (int k = 0; k < kScanRing; ++k) {
      step(t0 + k, k);
      fetch(t0 + k + kScanRing, k);
    }
  }
#pragma unroll
  for (int k = 0; k < kScanRing; ++k)
    if (t0 + k < t_max) step(t0 + k, k);
}

// beta(t, w) = LSE(nxt[w - dn] + lpb[t,w], nxt[w - dn + 1] + lpl[t,w]),
// dn = d_next[t], nxt = t+1 >= T_b ? beta_virtual[t] : beta(t+1);
// beta(T_max, .) = -inf.
__device__ void beta_warp(const float* __restrict__ lpb,
                          const float* __restrict__ lpl,
                          const int* __restrict__ d_next,
                          const int* __restrict__ input_lengths,
                          const float* __restrict__ beta_virtual, int b,
                          int t_max, int w, float* __restrict__ betas) {
  const int lane = threadIdx.x;
  const bool in_band = lane < w;
  const bool top = lane + 1 >= w;
  const int own = min(lane, w - 1);
  const long long base = static_cast<long long>(b) * t_max * w;
  const int* db = d_next + static_cast<long long>(b) * t_max;
  const int t_b = input_lengths[b];
  // Step i (t = T-1-i) in slot i % kScanRing: lpb, lpl, d_next and the
  // virtual row, read whether or not the step takes it; t clamped to 0.
  float rb[kScanRing], rl[kScanRing], rv[kScanRing];
  int rd[kScanRing];
  const auto fetch = [&](int t, int k) {
    t = max(t, 0);
    const long long at = base + static_cast<long long>(t) * w + own;
    rb[k] = __ldg(lpb + at);
    rl[k] = __ldg(lpl + at);
    rv[k] = __ldg(beta_virtual + at);
    rd[k] = __ldg(db + t);
  };
  float carry = MRNNT_NEG_INF;
  const auto step = [&](int t, int k) {
    const float nxt = t + 1 >= t_b ? rv[k] : carry;
    const float up = __shfl_down_sync(kFull, nxt, 1);   // slot w+1
    const float dn = __shfl_up_sync(kFull, nxt, 1);     // slot w-1
    const bool shift = rd[k] == 1;
    const float n0 = shift ? (lane == 0 ? MRNNT_NEG_INF : dn) : nxt;
    const float n1 = shift ? nxt : (top ? MRNNT_NEG_INF : up);
    carry = log_sum_exp(n0 + rb[k], n1 + rl[k]);
    store_if(betas + base + static_cast<long long>(t) * w + lane, carry,
             in_band);
  };
#pragma unroll
  for (int k = 0; k < kScanRing; ++k) fetch(t_max - 1 - k, k);
  int i0 = 0;
  for (; i0 + kScanRing <= t_max; i0 += kScanRing) {
#pragma unroll
    for (int k = 0; k < kScanRing; ++k) {
      step(t_max - 1 - (i0 + k), k);
      fetch(t_max - 1 - (i0 + k + kScanRing), k);
    }
  }
#pragma unroll
  for (int k = 0; k < kScanRing; ++k)
    if (i0 + k < t_max) step(t_max - 1 - (i0 + k), k);
}

// --- W > 32: a block a chain -------------------------------------------------

// Operand bytes one stage holds: per step two [W] f32 rows, the virtual row
// with its two sentinels, and the shift.
constexpr int kStageBytes = 32 * 1024;

__host__ __device__ inline int step_words(int w) { return 3 * w + 3; }

inline int stage_steps(int t_max, int w) {
  int tc = kStageBytes / (step_words(w) * static_cast<int>(sizeof(float)));
  if (tc < 1) tc = 1;
  return tc < t_max ? tc : t_max;
}

// Shared memory of a block chain: the two carries of w + 2 floats, then two
// stages of tc steps.
inline size_t scan_smem_bytes(int w, int tc) {
  return (2 * (static_cast<size_t>(w) + 2) +
          2 * static_cast<size_t>(tc) * step_words(w)) * sizeof(float);
}

// One stage: lpb [tc][w], lpl [tc][w], virt [tc][w+2], shift [tc].
struct Stage {
  float *b, *l, *v;
  int* s;
  __device__ Stage(float* base, int tc, int w)
      : b(base), l(base + tc * w), v(base + 2 * tc * w),
        s(reinterpret_cast<int*>(base + tc * (3 * w + 2))) {}
};

// Issues chunk [t0, t0 + n)'s copies into `st` as one cp.async group: both
// operand rows and the shift of every step, and the virtual row of each
// step with t+1 >= t_b (t_b = 0 for the alpha chain: none).
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ shift, const float* __restrict__ virt, int t_b,
    long long row0, long long t_row0, int t0, int n, int w, const Stage& st) {
  for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
    cp_async4(st.b + i, a + row0 + i);
    cp_async4(st.l + i, b + row0 + i);
    const int k = i / w;
    if (virt != nullptr && t0 + k + 1 >= t_b)
      cp_async4(st.v + k * (w + 2) + 1 + (i - k * w), virt + row0 + i);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async4(reinterpret_cast<float*>(st.s + i),
              reinterpret_cast<const float*>(shift + t_row0 + i));
  cp_async_commit();
}

// Lays out a block chain's shared memory: the two carries (slot i at
// row[i + 1]), all -inf but slot 0 of rows[0], which is `first`, then the
// two stages (returns the first; the second follows it), every virtual
// row's two sentinels -inf.
__device__ float* block_init(float* smem, int w, int tc, float first,
                             float* rows[2]) {
  const int wp = w + 2;
  rows[0] = smem;
  rows[1] = smem + wp;
  for (int i = threadIdx.x; i < 2 * wp; i += blockDim.x)
    smem[i] = i == 1 ? first : MRNNT_NEG_INF;
  float* stages = smem + 2 * wp;
  for (int i = threadIdx.x; i < 2 * tc; i += blockDim.x) {
    float* v = Stage(stages + (i / tc) * tc * step_words(w), tc, w).v +
               (i % tc) * wp;
    v[0] = MRNNT_NEG_INF;
    v[w + 1] = MRNNT_NEG_INF;
  }
  return stages;
}

// Stage c % 2 of the two that follow the carries.
__device__ __forceinline__ Stage stage_of(float* stages, int c, int tc,
                                          int w) {
  return Stage(stages + (c & 1) * tc * step_words(w), tc, w);
}

__device__ void alpha_block(const float* __restrict__ lpb,
                            const float* __restrict__ lpl,
                            const int* __restrict__ d, int b, int t_max,
                            int w, int tc, float* __restrict__ alphas,
                            float* smem) {
  float* rows[2];
  float* stages = block_init(smem, w, tc, 0.f, rows);   // alpha(-1, 0) = 0
  const long long base = static_cast<long long>(b) * t_max * w;
  const long long t_base = static_cast<long long>(b) * t_max;
  const int chunks = (t_max + tc - 1) / tc;
  stage_chunk(lpb, lpl, d, nullptr, 0, base, t_base, 0, min(tc, t_max), w,
              stage_of(stages, 0, tc, w));
  int cur = 0;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * tc, n = min(tc, t_max - t0);
    if (c + 1 < chunks) {   // chunk c+1 into the stage chunk c-1 used
      const int t1 = t0 + tc;
      stage_chunk(lpb, lpl, d, nullptr, 0,
                  base + static_cast<long long>(t1) * w, t_base + t1, t1,
                  min(tc, t_max - t1), w, stage_of(stages, c + 1, tc, w));
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();   // this thread's copies of chunk c have landed
    __syncthreads();      // and every thread's
    const Stage s = stage_of(stages, c, tc, w);
    const long long row0 = base + static_cast<long long>(t0) * w;
    for (int k = 0; k < n; ++k) {
      const float* al = rows[cur] + 1 + (s.s[k] == 1 ? 1 : 0);  // aligned
      float* next = rows[cur ^ 1];
      const float* sb = s.b + k * w;
      const float* sl = s.l + k * w;
      for (int wi = threadIdx.x; wi < w; wi += blockDim.x) {
        const float emit =
            wi > 0 ? al[wi - 1] + sl[wi - 1] : MRNNT_NEG_INF;
        const float out = log_sum_exp(al[wi] + sb[wi], emit);
        next[wi + 1] = out;
        alphas[row0 + static_cast<long long>(k) * w + wi] = out;
      }
      __syncthreads();   // also: chunk c's stage is free after its last step
      cur ^= 1;
    }
  }
}

__device__ void beta_block(const float* __restrict__ lpb,
                           const float* __restrict__ lpl,
                           const int* __restrict__ d_next,
                           const int* __restrict__ input_lengths,
                           const float* __restrict__ beta_virtual, int b,
                           int t_max, int w, int tc,
                           float* __restrict__ betas, float* smem) {
  float* rows[2];
  float* stages =
      block_init(smem, w, tc, MRNNT_NEG_INF, rows);   // beta(T_max) = -inf
  const int t_b = input_lengths[b];
  const long long base = static_cast<long long>(b) * t_max * w;
  const long long t_base = static_cast<long long>(b) * t_max;
  const int chunks = (t_max + tc - 1) / tc;
  // Chunk c covers [max(0, t_max - (c+1) tc), t_max - c tc), walked down.
  const auto issue = [&](int c) {
    const int t_end = t_max - c * tc, t0 = max(0, t_end - tc);
    stage_chunk(lpb, lpl, d_next, beta_virtual, t_b,
                base + static_cast<long long>(t0) * w, t_base + t0, t0,
                t_end - t0, w, stage_of(stages, c, tc, w));
  };
  issue(0);
  int cur = 0;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) issue(c + 1); else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Stage s = stage_of(stages, c, tc, w);
    const int t_end = t_max - c * tc, t0 = max(0, t_end - tc);
    const long long row0 = base + static_cast<long long>(t0) * w;
    for (int k = t_end - t0 - 1; k >= 0; --k) {
      const float* nxt = t0 + k + 1 >= t_b ? s.v + k * (w + 2) : rows[cur];
      const float* nx = nxt + 1 - (s.s[k] == 1 ? 1 : 0);
      float* out = rows[cur ^ 1];
      const float* sb = s.b + k * w;
      const float* sl = s.l + k * w;
      for (int wi = threadIdx.x; wi < w; wi += blockDim.x) {
        const float nw = log_sum_exp(nx[wi] + sb[wi], nx[wi + 1] + sl[wi]);
        out[wi + 1] = nw;
        betas[row0 + static_cast<long long>(k) * w + wi] = nw;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
}

// --- the scan kernels --------------------------------------------------------

template <bool kOneWarp>
__global__ void mrnnt_alpha_banded_kernel(const float* __restrict__ lpb,
                                          const float* __restrict__ lpl,
                                          const int* __restrict__ d,
                                          int t_max, int w, int tc,
                                          float* __restrict__ alphas) {
  extern __shared__ float smem[];
  if constexpr (kOneWarp)
    alpha_warp(lpb, lpl, d, blockIdx.x, t_max, w, alphas);
  else
    alpha_block(lpb, lpl, d, blockIdx.x, t_max, w, tc, alphas, smem);
}

template <bool kOneWarp>
__global__ void mrnnt_fwdbwd_banded_kernel(
    const float* __restrict__ lpba, const float* __restrict__ lpla,
    const int* __restrict__ d, const float* __restrict__ lpbb,
    const float* __restrict__ lplb, const int* __restrict__ d_next,
    const int* __restrict__ input_lengths,
    const float* __restrict__ beta_virtual, int t_max, int w, int tc,
    float* __restrict__ alphas, float* __restrict__ betas) {
  extern __shared__ float smem[];
  if constexpr (kOneWarp) {
    if (blockIdx.y == 0)
      alpha_warp(lpba, lpla, d, blockIdx.x, t_max, w, alphas);
    else
      beta_warp(lpbb, lplb, d_next, input_lengths, beta_virtual, blockIdx.x,
                t_max, w, betas);
  } else {
    if (blockIdx.y == 0)
      alpha_block(lpba, lpla, d, blockIdx.x, t_max, w, tc, alphas, smem);
    else
      beta_block(lpbb, lplb, d_next, input_lengths, beta_virtual, blockIdx.x,
                 t_max, w, tc, betas, smem);
  }
}

// A scan launch's shape: one warp and no shared memory where W <= 32, else
// a thread a slot (at most 1024) and two stages of tc steps; raises the
// block kernel's shared-memory cap when a wide band needs more than 48 KB.
template <typename K>
int scan_config(K block_kernel, int t_max, int w, int* tc, size_t* smem,
                int* threads) {
  if (w <= kWarp) {
    *tc = 0;
    *smem = 0;
    *threads = kWarp;
    return 0;
  }
  *tc = stage_steps(t_max, w);
  *smem = scan_smem_bytes(w, *tc);
  *threads = w >= 1024 ? 1024 : ((w + 31) / 32) * 32;
  if (*smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  if (blocks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_row_type(is_bf16, logits, v, [&](auto rt) {
    using R = decltype(rt);
    using T = typename R::type;
    mrnnt_stats_banded_kernel<T, R::bytes, R::lanes>
        <<<blocks, kRowThreads, 0, st>>>(
            static_cast<const T*>(logits), lab_band, ra_lo, ra_hi, rb_lo,
            rb_hi, rows, w, v, blank, denom, lpba, lpla, lpbb, lplb);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int mrnnt_alpha_banded(const float* lpb, const float* lpl,
                                  const int* d, int batch, int t_max, int w,
                                  float* alphas, void* stream) {
  using namespace mrnnt;
  // Nothing to scan; the warp chains read clamped rows, so T, W >= 1.
  if (batch == 0 || t_max == 0 || w == 0) return 0;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_alpha_banded_kernel<false>, t_max, w,
                                  &tc, &smem, &threads))
    return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w <= kWarp)
    mrnnt_alpha_banded_kernel<true><<<batch, threads, 0, st>>>(
        lpb, lpl, d, t_max, w, tc, alphas);
  else
    mrnnt_alpha_banded_kernel<false><<<batch, threads, smem, st>>>(
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
  if (batch == 0 || t_max == 0 || w == 0) return 0;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_fwdbwd_banded_kernel<false>, t_max,
                                  w, &tc, &smem, &threads))
    return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch, 2);
  if (w <= kWarp)
    mrnnt_fwdbwd_banded_kernel<true><<<grid, threads, 0, st>>>(
        lpba, lpla, d, lpbb, lplb, d_next, input_lengths, beta_virtual, t_max,
        w, tc, alphas, betas);
  else
    mrnnt_fwdbwd_banded_kernel<false><<<grid, threads, smem, st>>>(
        lpba, lpla, d, lpbb, lplb, d_next, input_lengths, beta_virtual, t_max,
        w, tc, alphas, betas);
  return static_cast<int>(cudaGetLastError());
}
