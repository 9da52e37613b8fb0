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
// / 0.049 ms), as long as a value costs few enough instructions: at the
// bf16 byte rate the card issues ~20 lane-instructions a value. The online
// log-sum-exp these kernels had (5 expf for 4 values and 10 more a lane in
// the shuffle tree, ~25-30 instructions a value) was bound by its
// arithmetic at ~2x the bytes' time; the stats reduction now takes ~10 (one
// expf, its argument, the accumulating FFMA, the bf16 unpack, half a max).
// The scans: latency, not bytes. Their traffic is O(B*T*S1) f32 (a few us
// of HBM time) but each walks T dependent steps.
//
// Design.
//  * Stats: a persistent grid (the CTAs resident at once) whose warps walk
//    the (b,t,s) rows in order, a warp a row (a half-warp on short rows),
//    reduced by common.cuh's walk_rows (the stats reduction of every stats
//    kernel): loads as wide as the rows' alignment allows, the warp's next
//    2 KB round (its next row's, at V = 1000 bf16) in flight while one is
//    reduced in registers. Lane 0 reads x[blank] and x[label] directly,
//    through the lines the round brought in;
//    labels are addressed with a b- and a t-stride (t-stride 0 for [B,S1]).
//    The partial kernel writes the row's (m, se) and reads nothing else. An
//    all -inf row gives m = -inf and se = 0, where the TPU kernel's
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
//    is staged once. That block chain runs above S1 = 256 (the chain's cut).
//    At S1 <= 256 every scan runs the register chain: a warp for every 32
//    slots (alpha_warps, beta_warps), the carry in registers, the
//    neighbours by shuffle and, across warps, through shared memory behind
//    one barrier a step (none in one warp), the operands a register ring
//    ahead; each slot's arithmetic is alpha_chain's or beta_chain's, so both
//    designs give identical alphas and betas, and alpha_scan and beta_scan
//    equal fwdbwd_scan's halves.
//  * Masks: where the additive mask is -inf the output is exactly -inf, by
//    a select (the port's convention, ROADMAP.md section 3); elsewhere the
//    mask is added, as the TPU kernels add it. On finite inputs that is the
//    TPU kernels' result; a NaN statistic of a masked padding cell (from
//    +-inf padding logits) stays out of the recurrence.
// Row offsets are 64-bit.

#include <type_traits>

#include "common.cuh"

namespace mrnnt {

// softmax_stats' rows: lane 0 reads x[blank] and x[label] and writes denom,
// lp_blank and lp_label_raw. A label's (b, t, s) is carried from row to row
// of the warp's walk by adding the stride's, so no row pays a division.
template <typename T>
struct SplitStatsRows {
  DirectReads<T> d;
  const int* labels;
  long long lab_b_stride, lab_t_stride;
  int t_max, s1;
  float* denom;
  float* lp_blank;
  float* lp_label;
  long long b = 0, db = 0;  // (b, t, s) of the row pre() takes next,
  int t = 0, s = 0;         // and (db, dt, ds) of the walk's stride
  int dt = 0, ds = 0;

  __device__ __forceinline__ void split(long long r, long long& rb, int& rt,
                                        int& rs) const {
    const long long bt = r / s1;
    rs = static_cast<int>(r - bt * s1);
    rb = bt / t_max;
    rt = static_cast<int>(bt - rb * t_max);
  }
  __device__ __forceinline__ void begin(long long row, long long stride) {
    split(row, b, t, s);
    split(stride, db, dt, ds);
  }
  __device__ __forceinline__ void pre(long long row) {
    d.load(row, labels[b * lab_b_stride + t * lab_t_stride + s]);
    s += ds;
    const int carry = s >= s1;
    if (carry) s -= s1;
    t += dt + carry;  // < 2 * t_max
    if (t >= t_max) {
      t -= t_max;
      ++b;
    }
    b += db;
  }
  __device__ __forceinline__ void start(long long row) { d.take(row); }
  __device__ __forceinline__ void fin(long long row, float m, float s_) {
    // An all -inf row gives denom = +inf, as logsumexp's -inf.
    const float dn = -(m + logf(s_));
    denom[row] = dn;
    lp_blank[row] = d.xb + dn;
    lp_label[row] = d.xl + dn;
  }
};

// softmax_stats_partial's rows: (m, s) as they are.
struct PartialRows {
  float* m_out;
  float* se_out;

  __device__ __forceinline__ void begin(long long, long long) {}
  __device__ __forceinline__ void pre(long long) {}
  __device__ __forceinline__ void start(long long) {}
  __device__ __forceinline__ void fin(long long row, float m, float s) {
    m_out[row] = m;
    se_out[row] = s;
  }
};

// The grid's warps walk the rows in order: warp w takes rows w, w + warps,
// ... (or, on short rows, a half-warp each of rows 2w and 2w + 1, ...),
// each with its next round in flight (common.cuh's walk_rows).
struct GridWalk {
  long long warp, warps;  // this warp, and the grid's warps (the stride)
};

__device__ __forceinline__ GridWalk grid_walk() {
  return {static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
              threadIdx.x / kWarp,
          static_cast<long long>(gridDim.x) * (blockDim.x / kWarp)};
}

template <typename T, int kBytes, int kG>
__global__ void __launch_bounds__(kRowThreads) mrnnt_softmax_stats_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    long long lab_b_stride, long long lab_t_stride, long long rows,
    int t_max, int s1, int v, int blank, float* __restrict__ denom,
    float* __restrict__ lp_blank, float* __restrict__ lp_label) {
  SplitStatsRows<T> r{{logits, v, blank}, labels, lab_b_stride,
                      lab_t_stride, t_max, s1, denom, lp_blank, lp_label};
  const GridWalk g = grid_walk();
  walk_rows<T, kBytes, kG>(logits, v, 0, g.warp, g.warps, rows, r);
}

template <typename T, int kBytes, int kG>
__global__ void __launch_bounds__(kRowThreads)
    mrnnt_softmax_stats_partial_kernel(const T* __restrict__ logits,
                                       long long rows, int v,
                                       float* __restrict__ m_out,
                                       float* __restrict__ se_out) {
  PartialRows r{m_out, se_out};
  const GridWalk g = grid_walk();
  walk_rows<T, kBytes, kG>(logits, v, 0, g.warp, g.warps, rows, r);
}

// A persistent grid for `kernel`: the CTAs resident at once, or fewer when
// the rows need fewer blocks of kRowThreads.
template <typename K>
int stats_grid(K kernel, long long rows, unsigned* blocks) {
  if (const int err = row_blocks(rows, blocks)) return err;
  int ctas = 0;
  if (const int err = resident_ctas(kernel, kRowThreads, 0, &ctas))
    return err;
  if (static_cast<long long>(ctas) < *blocks)
    *blocks = static_cast<unsigned>(ctas);
  return 0;
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

// --- The register chain at S1 <= 256: a warp for every 32 slots -------------
//
// A chain is one block of W = ceil(S1/32) <= kChainWarpsMax warps, thread s
// carrying slot s in a register, so that each operand row loads coalesced. The
// neighbour term comes over one lane by shuffle; across a warp edge it goes
// through shared memory, written by the edge lane before the step's one
// barrier (double-buffered by step parity; no barrier and no shared memory
// for W = 1). The slots past S1 carry values from clamped operand columns
// that no live slot reads. Operands are loaded kChainRing steps ahead into
// a register ring, from clamped, always valid addresses (banded.cu's warp
// chains), the steps unrolled a ring at a time so that a ring slot is a
// register; stores are predicated (store_if), so no step waits on memory.
// Each slot computes alpha_chain's or beta_chain's apply_mask(log_sum_exp(a,
// b), mask) on the same operands in the same order, log_sum_exp with a
// select in place of its early return (lse_select): the values equal the
// block chain's.
//  * Alpha: slot s offers alpha(t-1, s) + lpl[t, s], the emit term of slot
//    s+1, which takes it by __shfl_up_sync (lane 0 of warp w from lane 31
//    of warp w-1); slot 0 takes -inf.
//  * Beta: the neighbour nx[s+1] is the carry (or the virtual row, a
//    register, where t+1 >= T_b: uniform across the block) shuffled down
//    one lane (lane 31 of warp w from lane 0 of warp w+1); a slot whose
//    neighbour lies past S1 takes -inf.
// One warp carrying ceil(S1/32) slots a lane in registers instead, with no
// barrier, took about ceil(S1/32) one-slot steps a step, its slots' log1pf
// not overlapping, and lost to this chain at every S1 > 32 (PERF.md
// section 6).

// Steps whose operands a chain has in flight ahead of the step.
constexpr int kChainRing = 16;
// The largest W that runs the register chain; above W * 32 slots the
// block chain runs. Eight warps beat the block chain at every S1 timed past
// 128 (129-256, T = 200 and 1600, B = 2 and 32: PERF.md section 6).
constexpr int kChainWarpsMax = 8;

// log_sum_exp(a, b) with a select in place of its early return: the same
// bits, no branch between one step's shuffles and the next's.
__device__ __forceinline__ float lse_select(float a, float b) {
  const float mx = a > b ? a : b;
  const float e = expf((a > b ? b : a) - mx);
  return mx == MRNNT_NEG_INF ? MRNNT_NEG_INF : mx + log1pf(e);
}

template <int W>
__device__ __forceinline__ void alpha_warps(const float* __restrict__ lpb,
                                            const float* __restrict__ lpl,
                                            const float* __restrict__ amask,
                                            int b, int t_max, int s1,
                                            float* __restrict__ alphas) {
  constexpr int R = kChainRing;
  __shared__ float edge[2][W];  // lane 31's emit term of each warp, by parity
  const int s = threadIdx.x, lane = s % kWarp, w = s / kWarp;
  const bool live = s < s1;
  const int col = min(s, s1 - 1);
  const long long base = static_cast<long long>(b) * t_max * s1;
  float carry = s == 0 ? 0.f : MRNNT_NEG_INF;
  // Step t in ring slot t % R; t clamped to T-1.
  float rb[R], rl[R], rm[R];
  const auto fetch = [&](int t, int k) {
    const long long at =
        base + static_cast<long long>(min(t, t_max - 1)) * s1 + col;
    rb[k] = __ldg(lpb + at);
    rl[k] = __ldg(lpl + at);
    rm[k] = __ldg(amask + at);
  };
  const auto step = [&](int t, int k) {  // R is even: k & 1 is t's parity
    const float offer = carry + rl[k];    // alpha(t-1, s) + lpl[t, s]
    float emit = __shfl_up_sync(kFull, offer, 1);
    if constexpr (W > 1) {
      if (lane == kWarp - 1) edge[k & 1][w] = offer;
      __syncthreads();
      if (w > 0) {  // uniform across the warp
        const float last = edge[k & 1][w - 1];
        emit = lane == 0 ? last : emit;
      }
    }
    emit = s == 0 ? MRNNT_NEG_INF : emit;
    carry = apply_mask(lse_select(carry + rb[k], emit), rm[k]);
    store_if(alphas + base + static_cast<long long>(t) * s1 + s, carry, live);
  };
#pragma unroll
  for (int k = 0; k < R; ++k) fetch(k, k);
  int t0 = 0;
  for (; t0 + R <= t_max; t0 += R) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      step(t0 + k, k);
      fetch(t0 + k + R, k);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (t0 + k < t_max) step(t0 + k, k);
}

template <int W>
__device__ __forceinline__ void beta_warps(
    const float* __restrict__ lpb, const float* __restrict__ lpl,
    const float* __restrict__ bmask, const int* __restrict__ input_lengths,
    const float* __restrict__ beta_virtual, int b, int t_max, int s1,
    float* __restrict__ betas) {
  constexpr int R = kChainRing;
  __shared__ float edge[2][W];  // lane 0's nx of each warp, by step parity
  const int s = threadIdx.x, lane = s % kWarp, w = s / kWarp;
  const bool live = s < s1;
  const bool past = s + 1 >= s1;  // nx[s+1] lies past S1
  const int col = min(s, s1 - 1);
  const long long base = static_cast<long long>(b) * t_max * s1;
  const float virt =
      live ? beta_virtual[static_cast<long long>(b) * s1 + s] : MRNNT_NEG_INF;
  float carry = MRNNT_NEG_INF;
  const int t_b = input_lengths[b];
  // Step i (t = T-1-i) in ring slot i % R; t clamped to 0.
  float rb[R], rl[R], rm[R];
  const auto fetch = [&](int t, int k) {
    const long long at = base + static_cast<long long>(max(t, 0)) * s1 + col;
    rb[k] = __ldg(lpb + at);
    rl[k] = __ldg(lpl + at);
    rm[k] = __ldg(bmask + at);
  };
  const auto step = [&](int t, int k) {  // R is even: k & 1 is i's parity
    const float nx = t + 1 >= t_b ? virt : carry;  // uniform
    float up = __shfl_down_sync(kFull, nx, 1);
    if constexpr (W > 1) {
      if (lane == 0) edge[k & 1][w] = nx;
      __syncthreads();
      if (w + 1 < W) {  // uniform across the warp
        const float first = edge[k & 1][w + 1];
        up = lane == kWarp - 1 ? first : up;
      }
    }
    carry = apply_mask(
        lse_select(nx + rb[k], (past ? MRNNT_NEG_INF : up) + rl[k]), rm[k]);
    store_if(betas + base + static_cast<long long>(t) * s1 + s, carry, live);
  };
#pragma unroll
  for (int k = 0; k < R; ++k) fetch(t_max - 1 - k, k);
  int i0 = 0;
  for (; i0 + R <= t_max; i0 += R) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      step(t_max - 1 - (i0 + k), k);
      fetch(t_max - 1 - (i0 + k + R), k);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (i0 + k < t_max) step(t_max - 1 - (i0 + k), k);
}

template <int W>
__global__ void __launch_bounds__(W * kWarp) mrnnt_alpha_warps_kernel(
    const float* __restrict__ lpb, const float* __restrict__ lpl,
    const float* __restrict__ amask, int t_max, int s1,
    float* __restrict__ alphas) {
  alpha_warps<W>(lpb, lpl, amask, blockIdx.x, t_max, s1, alphas);
}

template <int W>
__global__ void __launch_bounds__(W * kWarp) mrnnt_beta_warps_kernel(
    const float* __restrict__ lpb, const float* __restrict__ lpl,
    const float* __restrict__ bmask, const int* __restrict__ input_lengths,
    const float* __restrict__ beta_virtual, int t_max, int s1,
    float* __restrict__ betas) {
  beta_warps<W>(lpb, lpl, bmask, input_lengths, beta_virtual, blockIdx.x,
                t_max, s1, betas);
}

// fwdbwd_scan's register chains: blockIdx.y 0 the alpha chain, 1 the beta
// chain of sample blockIdx.x.
template <int W>
__global__ void __launch_bounds__(W * kWarp) mrnnt_fwdbwd_warps_kernel(
    const float* __restrict__ lpb, const float* __restrict__ lpl,
    const float* __restrict__ amask, const float* __restrict__ bmask,
    const int* __restrict__ input_lengths,
    const float* __restrict__ beta_virtual, int t_max, int s1,
    float* __restrict__ alphas, float* __restrict__ betas) {
  if (blockIdx.y == 0)
    alpha_warps<W>(lpb, lpl, amask, blockIdx.x, t_max, s1, alphas);
  else
    beta_warps<W>(lpb, lpl, bmask, input_lengths, beta_virtual, blockIdx.x,
                  t_max, s1, betas);
}

// Calls f(std::integral_constant<int, W>) for the chain's W = ceil(S1/32)
// and returns its result; -1 past the cut (the block chain runs).
template <int W = 1, typename F>
int with_chain_warps(int s1, F&& f) {
  if (s1 <= W * kWarp) return f(std::integral_constant<int, W>{});
  if constexpr (W < kChainWarpsMax)
    return with_chain_warps<W + 1>(s1, f);
  else
    return -1;
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
  if (rows == 0) return 0;
  const long long t_stride = labels_per_t ? s1 : 0;
  const long long b_stride =
      labels_per_t ? static_cast<long long>(t_max) * s1 : s1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_row_type(is_bf16, logits, v, [&](auto rt) {
    using R = decltype(rt);
    using T = typename R::type;
    const auto kernel =
        mrnnt_softmax_stats_kernel<T, R::bytes, R::lanes>;
    unsigned blocks;
    if (const int err = stats_grid(kernel, rows, &blocks)) return err;
    kernel<<<blocks, kRowThreads, 0, st>>>(
        static_cast<const T*>(logits), labels, b_stride, t_stride, rows,
        t_max, s1, v, blank, denom, lp_blank, lp_label);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int mrnnt_softmax_stats_partial(const void* logits, int is_bf16,
                                           int batch, int t_max, int s1,
                                           int v, float* m, float* se,
                                           void* stream) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max * s1;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_row_type(is_bf16, logits, v, [&](auto rt) {
    using R = decltype(rt);
    using T = typename R::type;
    const auto kernel =
        mrnnt_softmax_stats_partial_kernel<T, R::bytes, R::lanes>;
    unsigned blocks;
    if (const int err = stats_grid(kernel, rows, &blocks)) return err;
    kernel<<<blocks, kRowThreads, 0, st>>>(static_cast<const T*>(logits),
                                           rows, v, m, se);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int mrnnt_alpha_scan(const float* lpb, const float* lpl,
                                const float* amask, int batch, int t_max,
                                int s1, float* alphas, void* stream) {
  using namespace mrnnt;
  if (batch == 0 || t_max == 0 || s1 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chain = with_chain_warps(s1, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    mrnnt_alpha_warps_kernel<W><<<batch, W * kWarp, 0, st>>>(
        lpb, lpl, amask, t_max, s1, alphas);
    return static_cast<int>(cudaGetLastError());
  });
  if (chain >= 0) return chain;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_alpha_scan_kernel, t_max, s1, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_alpha_scan_kernel<<<batch, threads, smem, st>>>(lpb, lpl, amask,
                                                        t_max, s1, tc, alphas);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrnnt_beta_scan(const float* lpb, const float* lpl,
                               const float* bmask, const int* input_lengths,
                               const float* beta_virtual, int batch,
                               int t_max, int s1, float* betas,
                               void* stream) {
  using namespace mrnnt;
  if (batch == 0 || t_max == 0 || s1 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chain = with_chain_warps(s1, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    mrnnt_beta_warps_kernel<W><<<batch, W * kWarp, 0, st>>>(
        lpb, lpl, bmask, input_lengths, beta_virtual, t_max, s1, betas);
    return static_cast<int>(cudaGetLastError());
  });
  if (chain >= 0) return chain;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_beta_scan_kernel, t_max, s1, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_beta_scan_kernel<<<batch, threads, smem, st>>>(
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
  if (batch == 0 || t_max == 0 || s1 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chain = with_chain_warps(s1, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    mrnnt_fwdbwd_warps_kernel<W><<<dim3(batch, 2), W * kWarp, 0, st>>>(
        lpb, lpl, amask, bmask, input_lengths, beta_virtual, t_max, s1,
        alphas, betas);
    return static_cast<int>(cudaGetLastError());
  });
  if (chain >= 0) return chain;
  int tc, threads;
  size_t smem;
  if (const int err = scan_config(mrnnt_fwdbwd_scan_kernel, t_max, s1, &tc,
                                  &smem, &threads))
    return err;
  mrnnt_fwdbwd_scan_kernel<<<dim3(batch, 2), threads, smem, st>>>(
      lpb, lpl, amask, bmask, input_lengths, beta_virtual, t_max, s1, tc,
      alphas, betas);
  return static_cast<int>(cudaGetLastError());
}
