// Fused log-softmax statistics + alpha recurrence of the monotonic RNN-T
// loss, in one persistent launch.
//
// Replaces the TPU kernel monotonic_rnnt_tpu/ops/pallas/kernels.py:
// stats_alpha_fused (body _stats_alpha_kernel). Operands and outputs:
// logits [B,T,S1,V] f32 or bf16, labels_ext [B,S1] int32 (-1 on invalid
// slots), inclusive alpha windows a_lo/a_hi [B,T] int32 (hi < lo = empty),
// input_lengths T'_b and label_lengths S_b [B] int32 -> denom, lp_blank,
// lp_label, alphas, each [B,T,S1] f32.
//
// Only the live lattice is read: the cells t < T'_b, s <= S_b. Every other
// cell, which no caller reads, gets the fill of a row of probability zero
// (denom 0, lp_blank = lp_label = alphas = -inf) without a read of its
// logits. There this kernel departs from the Pallas one, which computes
// the stats of every cell of the padded lattice.
//
// What bounds it on an H100: HBM bytes. The live logits are read once
// (sum_b T'_b*(S_b+1)*V*itemsize; at full lengths B=32,T=200,S=50,V=1000
// that is 1.31 GB f32 / 0.65 GB bf16, ~0.39 / 0.20 ms at 3.35 TB/s); the
// four [B,T,S1] outputs add 0.3%. The arithmetic (an exp per element) is
// far below the f32 rate.
//
// Design. On the TPU one sequential grid streamed V and advanced the DP, so
// the DP hid behind the block DMAs. Here one launch of as many CTAs as are
// resident at once (the occupancy API) takes work by tickets from two
// global counters, which the wrapper zeroes with B*T ready flags in one
// int32 scratch:
//  * stats tiles (counter 1, tickets 0..B*T-1): one (b,t) lattice row block
//    of S1 rows, in ascending t, t-major across samples. A tile with
//    t >= T'_b writes the fill to its S1 slots; a live tile reduces its
//    min(S_b+1, S1) live rows and writes the fill to the rest. A warp a row,
//    reduced by common.cuh's walk_rows (the stats reduction that the split
//    and banded routes' stats kernels share, so their stats are equal bit
//    for bit): loads as wide as the rows' alignment allows (16 bytes a lane
//    at V = 1000), one 2 KB round a warp in registers (the next round's
//    loads go out before the row's shuffle trees), one expf a value. Lane 0 reads x[blank]
//    and x[label[s]] directly, through the cache lines the round just
//    brought in (an id outside [0, V) selects 0.0, and -1 gives
//    lp_label = -inf, kernels.py:573). Once its S1 rows are written the
//    tile sets ready[b,t] (release). Tiles never wait.
//  * alpha chains (counter 0, tickets 0..B-1), taken first: one CTA walks
//    sample b's alpha row up t in shared memory. Warp 0 acquires the ready
//    flags of the next `win` rows at once; the CTA reads the rows that are
//    ready through L2 into shared memory in one go and advances over them
//    with one __syncthreads a step, so the chain pays one global latency
//    per window and trails the stats frontier. It waits on rows t < T'_b
//    only, keeps its window to s <= S_b, and writes -inf rows from T'_b.
//
// Why it cannot deadlock, at any B and any occupancy, with no cooperative
// launch: a chain whose next row is not ready checks the stats counter; if
// that row's tile is still unclaimed the chain takes the next stats ticket
// itself and processes it, else it spins on a tile that a running CTA
// holds, and tiles never wait. So no CTA waits on a ticket that no running
// CTA holds, whatever the card's scheduling order.
// Row offsets are 64-bit: B*T*S1*V passes 2^31 at shapes the loss runs.

#include "common.cuh"

namespace mrnnt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;

struct StatsAlphaArgs {
  const void* logits;
  const int* labels;
  const int* a_lo;
  const int* a_hi;
  const int* ilen;  // T'_b
  const int* slen;  // S_b
  int batch, t_max, s1, v, blank, win;
  float* denom;
  float* lp_blank;
  float* lp_label;
  float* alphas;
  int* sync;  // ready[B*T], then the two ticket counters
};

// Floats of a chain's shared memory (two alpha rows, a window of win rows
// of lp_blank and lp_label, win lo/hi pairs), rounded up to 16 bytes.
inline __host__ __device__ int chain_floats(int s1, int win) {
  return ((2 + 2 * win) * s1 + 2 * win + 3) / 4 * 4;
}

// A stats tile's rows: lane 0 reads x[blank] and x[label[s]] and writes
// denom, lp_blank and lp_label. An all -inf row gives denom = +inf, as
// logsumexp's -inf; the -1 sentinel gives lp_label = -inf (kernels.py:573).
template <typename T>
struct TileRows {
  DirectReads<T> d;
  const StatsAlphaArgs* a;
  const int* labels;  // sample b's [S1] ids
  long long row0;

  __device__ __forceinline__ void begin(long long, long long) {}
  __device__ __forceinline__ void pre(long long row) {
    d.load(row, labels[row - row0]);
  }
  __device__ __forceinline__ void start(long long row) { d.take(row); }
  __device__ __forceinline__ void fin(long long row, float m, float sm) {
    const float dn = -(m + logf(sm));
    a->denom[row] = dn;
    a->lp_blank[row] = d.xb + dn;
    a->lp_label[row] = d.lab >= 0 ? d.xl + dn : MRNNT_NEG_INF;
  }
};

// The live slots of lattice row (b, t): min(S_b + 1, S1), none where
// t >= T'_b or S_b < 0. The loss launches this kernel before it has
// checked the lengths, so any int32 S_b stays inside the row: S_b is
// compared before the + 1, which would overflow at INT_MAX.
__device__ __forceinline__ int live_slots(const StatsAlphaArgs& a, int b,
                                          int t) {
  if (t >= a.ilen[b]) return 0;
  const int sl = a.slen[b];
  return sl < 0 ? 0 : (sl >= a.s1 ? a.s1 : sl + 1);
}

// Stats of the live rows of lattice row (b, t) = ticket k, warp w taking
// rows w, w + 8, ... (half-warps rows 2w + h, 2w + 16 + h, ... on short
// rows) with common.cuh's walk_rows, the fill on the other slots, then
// ready[b,t].
template <typename T, int kBytes, int kG>
__device__ void stats_tile(const StatsAlphaArgs& a, int k) {
  const int t = k / a.batch, b = k % a.batch;
  const long long row0 = (static_cast<long long>(b) * a.t_max + t) * a.s1;
  const int live = live_slots(a, b, t);
  const T* logits = static_cast<const T*>(a.logits);
  TileRows<T> rows{{logits, a.v, a.blank}, &a, a.labels + b * a.s1, row0};
  // One round buffer: two spill under the kernel's 64 registers.
  walk_rows<T, kBytes, kG, false>(logits, a.v, row0, threadIdx.x / kWarp,
                                  kWarps, row0 + live, rows);
  for (int s = live + threadIdx.x; s < a.s1; s += kThreads) {
    a.denom[row0 + s] = 0.f;
    a.lp_blank[row0 + s] = MRNNT_NEG_INF;
    a.lp_label[row0 + s] = MRNNT_NEG_INF;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    publish_flag(a.sync + static_cast<long long>(b) * a.t_max + t, 1);
}

// Sample b's alpha chain, run by the whole CTA. ctrl: one shared int.
template <typename T, int kBytes, int kG>
__device__ void alpha_chain(const StatsAlphaArgs& a, int b, float* sh,
                            int* ctrl) {
  const int tid = threadIdx.x, s1 = a.s1, t_max = a.t_max, win = a.win;
  const int tiles = a.batch * t_max;
  // Rows t < t_live are waited on and advanced; from there the rows are -inf.
  const int t_live = max(0, min(a.ilen[b], t_max)), s_top = a.slen[b];
  const int* ready = a.sync + static_cast<long long>(b) * t_max;
  int* stats_counter = a.sync + tiles + 1;
  float* bufs[2] = {sh, sh + s1};
  float* w_blank = sh + 2 * s1;        // win x s1
  float* w_label = w_blank + win * s1;  // win x s1
  int* w_lo = reinterpret_cast<int*>(w_label + win * s1);
  int* w_hi = w_lo + win;
  // Virtual row alpha(-1, s) = [s == 0] in log space.
  for (int s = tid; s < s1; s += kThreads)
    bufs[0][s] = s == 0 ? 0.f : MRNNT_NEG_INF;

  int cur = 0;
  for (int t = 0; t < t_live;) {
    if (tid < kWarp) {
      // Rows t.. that are ready, at most win; or a stats ticket to take.
      int r = t, help = -1;
      for (;;) {
        const bool ok = tid < win && t + tid < t_live &&
                        load_acquire(ready + t + tid) != 0;
        const unsigned mask = __ballot_sync(0xffffffffu, ok);
        r = t + __ffs(~mask) - 1;  // win < 32, so ~mask has a set bit
        if (r > t) break;
        if (tid == 0 && load_acquire(stats_counter) <= t * a.batch + b) {
          // Row t's tile is unclaimed: claim the next stats ticket.
          const int k = atomicAdd(stats_counter, 1);
          help = k < tiles ? k : -1;
        }
        help = __shfl_sync(0xffffffffu, help, 0);
        if (help >= 0) break;
        __nanosleep(64);
      }
      if (tid == 0) *ctrl = help >= 0 ? -1 - help : r;
    }
    __syncthreads();
    const int c = *ctrl;
    if (c < 0) {
      stats_tile<T, kBytes, kG>(a, -1 - c);
      continue;
    }
    const int rows = c - t;
    const long long off0 = (static_cast<long long>(b) * t_max + t) * s1;
    // Written by other CTAs in this launch: read through L2.
    for (int j = tid; j < rows * s1; j += kThreads) {
      w_blank[j] = __ldcg(a.lp_blank + off0 + j);
      w_label[j] = __ldcg(a.lp_label + off0 + j);
    }
    if (tid < rows) {
      w_lo[tid] = a.a_lo[b * t_max + t + tid];
      w_hi[tid] = min(a.a_hi[b * t_max + t + tid], s_top);
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float* prev = bufs[cur];
      float* next = bufs[cur ^ 1];
      const int lo = w_lo[j], hi = w_hi[j];
      const float* lpb = w_blank + j * s1;
      const float* lpl = w_label + j * s1;
      for (int s = tid; s < s1; s += kThreads) {
        float out = MRNNT_NEG_INF;
        if (s >= lo && s <= hi) {
          const float no_emit = prev[s] + lpb[s];
          const float emit = s > 0 ? prev[s - 1] + lpl[s - 1] : MRNNT_NEG_INF;
          out = log_sum_exp(no_emit, emit);
        }
        next[s] = out;
        a.alphas[off0 + static_cast<long long>(j) * s1 + s] = out;
      }
      __syncthreads();
      cur ^= 1;
    }
    t = c;
  }
  const long long end = static_cast<long long>(b + 1) * t_max * s1;
  for (long long i = (static_cast<long long>(b) * t_max + t_live) * s1 + tid;
       i < end; i += kThreads)
    a.alphas[i] = MRNNT_NEG_INF;
}

// At most 64 registers a thread: four CTAs an SM.
template <typename T, int kBytes, int kG>
__global__ void __launch_bounds__(kThreads, 4)
    mrnnt_stats_alpha_kernel(StatsAlphaArgs a) {
  extern __shared__ float sh[];
  __shared__ int ticket, ctrl;
  const int tiles = a.batch * a.t_max;
  int* counters = a.sync + tiles;
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(counters, 1);
    __syncthreads();
    const int c = ticket;
    __syncthreads();
    if (c >= a.batch) break;
    alpha_chain<T, kBytes, kG>(a, c, sh, &ctrl);
  }
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(counters + 1, 1);
    __syncthreads();
    const int k = ticket;
    __syncthreads();
    if (k >= tiles) break;
    stats_tile<T, kBytes, kG>(a, k);
  }
}

template <typename T, int kBytes, int kG>
int launch_stats_alpha(const StatsAlphaArgs& a, cudaStream_t stream) {
  const auto kernel = mrnnt_stats_alpha_kernel<T, kBytes, kG>;
  const size_t smem = chain_floats(a.s1, a.win) * sizeof(float);
  int ctas = 0;
  if (const int err = resident_ctas(kernel, kThreads, smem, &ctas)) return err;
  const long long tickets = static_cast<long long>(a.batch) * (a.t_max + 1);
  if (tickets < ctas) ctas = static_cast<int>(tickets);
  kernel<<<ctas, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mrnnt

// sync: B*T + 2 int32 zeros.
extern "C" int mrnnt_stats_alpha(const void* logits, int is_bf16,
                                 const int* labels_ext, const int* a_lo,
                                 const int* a_hi, const int* input_lengths,
                                 const int* label_lengths, int batch,
                                 int t_max, int s1, int v, int blank,
                                 float* denom, float* lp_blank,
                                 float* lp_label, float* alphas, int* sync,
                                 void* stream) {
  using namespace mrnnt;
  if (batch == 0 || t_max == 0 || s1 == 0) return 0;
  // Tickets are int: B*T, plus one overshoot a CTA, must fit.
  if (static_cast<long long>(batch) * t_max > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // Rows a chain takes at once: up to 8, while the window stays ~16 KB.
  int win = 2048 / s1;
  win = win < 1 ? 1 : (win > 8 ? 8 : win);
  const StatsAlphaArgs a{logits, labels_ext, a_lo, a_hi, input_lengths,
                         label_lengths, batch, t_max, s1, v, blank, win,
                         denom, lp_blank, lp_label, alphas, sync};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_row_type(is_bf16, logits, v, [&](auto rt) {
    using R = decltype(rt);
    return launch_stats_alpha<typename R::type, R::bytes, R::lanes>(a, st);
  });
}
