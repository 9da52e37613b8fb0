// Fused log-softmax statistics + alpha recurrence of the monotonic RNN-T
// loss, in one persistent launch.
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
// Design. On the TPU one sequential grid streamed V and advanced the DP, so
// the DP hid behind the block DMAs. Here one launch of as many CTAs as are
// resident at once (the occupancy API) takes work by tickets from two
// global counters, which the wrapper zeroes with B*T ready flags in one
// int32 scratch:
//  * stats tiles (counter 1, tickets 0..B*T-1): one (b,t) lattice row block
//    of S1 rows, in ascending t, t-major across samples. A warp a row: an
//    online max/sum-exp over V in f32. Where rows_are_16b holds, the warp
//    reads its rows 16 bytes a lane into registers, one 2 KB piece ahead,
//    and reduces each piece from a 2 KB shared stage with warp_row_lse's
//    own rounds (lse_rounds, warp_lse_combine), so the
//    stats equal bit for bit those of warp_row_lse, which the split and
//    banded routes' stats kernels use; otherwise warp_row_lse reads one
//    scalar a lane. Lane 0 takes x[blank] and x[label[s]] directly (an id
//    outside [0, V) selects 0.0, and -1 gives lp_label = -inf,
//    kernels.py:573). Once its S1 rows are written the tile sets
//    ready[b,t] (release). Tiles never wait.
//  * alpha chains (counter 0, tickets 0..B-1), taken first: one CTA walks
//    sample b's alpha row up t in shared memory. Warp 0 acquires the ready
//    flags of the next `win` rows at once; the CTA reads the rows that are
//    ready through L2 into shared memory in one go and advances over them
//    with one __syncthreads a step, so the chain pays one global latency
//    per window and trails the stats frontier.
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
  int batch, t_max, s1, v, blank, win;
  float* denom;
  float* lp_blank;
  float* lp_label;
  float* alphas;
  int* sync;  // ready[B*T], then the two ticket counters
};

// Floats of a chain's shared memory (two alpha rows, a window of win rows
// of lp_blank and lp_label, win lo/hi pairs), rounded up to 16 bytes; the
// warps' row stages follow it on the 16-byte path.
inline __host__ __device__ int chain_floats(int s1, int win) {
  return ((2 + 2 * win) * s1 + 2 * win + 3) / 4 * 4;
}

// Lane 0's outputs of one row from its (m, s) and its two direct reads.
__device__ __forceinline__ void write_stats(const StatsAlphaArgs& a,
                                            long long row, float m, float sm,
                                            float xb, float xl, int lab) {
  // An all -inf row gives denom = +inf, as logsumexp's -inf; the -1
  // sentinel gives lp_label = -inf (kernels.py:573).
  const float d = -(m + logf(sm));
  a.denom[row] = d;
  a.lp_blank[row] = xb + d;
  a.lp_label[row] = lab >= 0 ? xl + d : MRNNT_NEG_INF;
}

// Stats of the S1 rows of lattice row (b, t) = ticket k, a warp a row, then
// ready[b,t]. sh: the kernel's dynamic shared memory.
template <typename T, bool kVec>
__device__ void stats_tile(const StatsAlphaArgs& a, int k, float* sh) {
  const int t = k / a.batch, b = k % a.batch;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long row0 = (static_cast<long long>(b) * a.t_max + t) * a.s1;
  const T* logits = static_cast<const T*>(a.logits);
  if constexpr (kVec) {
    // The warp's rows in pieces of kStageValues<T> (V = 1000: one piece
    // bf16, two f32), read 16 bytes a lane into registers one piece ahead:
    // piece q + 1 is in flight while piece q, stored to the warp's shared
    // stage, is reduced in warp_row_lse's order.
    constexpr int kS = kStageValues<T>;
    T* stage = reinterpret_cast<T*>(sh + chain_floats(a.s1, a.win)) +
               warp * kS;
    const int pieces = (a.v + kS - 1) / kS;
    const int items = (a.s1 - warp + kWarps - 1) / kWarps * pieces;
    const auto src = [&](int q) {
      return logits + (row0 + warp + q / pieces * kWarps) * a.v +
             q % pieces * kS;
    };
    const auto count = [&](int q) { return min(kS, a.v - q % pieces * kS); };
    typename Vec16<T>::type raw[kStageVecs<T>];
    if (items > 0) load_stage<T>(raw, src(0), count(0), lane);
    float m = MRNNT_NEG_INF, sm = 0.f, xb = 0.f, xl = 0.f;
    for (int q = 0; q < items; ++q) {
      const int s = warp + q / pieces * kWarps, b0 = q % pieces * kS;
      const int n = count(q);
      store_stage<T>(raw, stage, n, lane);
      __syncwarp();
      if (q + 1 < items) load_stage<T>(raw, src(q + 1), count(q + 1), lane);
      const int lab = a.labels[b * a.s1 + s];
      lse_rounds(stage, n, lane, m, sm);
      if (lane == 0) {
        // The direct reads, from the piece that holds them; an id outside
        // [0, V) selects nothing (0.0), as kernels.py's select.
        if (a.blank >= b0 && a.blank < b0 + n) xb = to_f32(stage[a.blank - b0]);
        if (lab >= b0 && lab < b0 + n) xl = to_f32(stage[lab - b0]);
      }
      __syncwarp();  // the stage is read before the next piece lands in it
      if (q % pieces == pieces - 1) {
        warp_lse_combine(m, sm);
        if (lane == 0) write_stats(a, row0 + s, m, sm, xb, xl, lab);
        m = MRNNT_NEG_INF;
        sm = xb = xl = 0.f;
      }
    }
  } else {
    for (int s = warp; s < a.s1; s += kWarps) {
      const long long row = row0 + s;
      const T* x = logits + row * a.v;
      float m, sm;
      warp_row_lse(x, a.v, lane, m, sm);
      if (lane == 0) {
        const int lab = a.labels[b * a.s1 + s];
        // An id outside [0, V) selects nothing (0.0), as kernels.py's select.
        const float xl = (lab >= 0 && lab < a.v) ? to_f32(x[lab]) : 0.f;
        write_stats(a, row, m, sm, to_f32(x[a.blank]), xl, lab);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    publish_flag(a.sync + static_cast<long long>(b) * a.t_max + t, 1);
}

// Sample b's alpha chain, run by the whole CTA. ctrl: one shared int.
template <typename T, bool kVec>
__device__ void alpha_chain(const StatsAlphaArgs& a, int b, float* sh,
                            int* ctrl) {
  const int tid = threadIdx.x, s1 = a.s1, t_max = a.t_max, win = a.win;
  const int tiles = a.batch * t_max;
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
  for (int t = 0; t < t_max;) {
    if (tid < kWarp) {
      // Rows t.. that are ready, at most win; or a stats ticket to take.
      int r = t, help = -1;
      for (;;) {
        const bool ok = tid < win && t + tid < t_max &&
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
      stats_tile<T, kVec>(a, -1 - c, sh);
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
      w_hi[tid] = a.a_hi[b * t_max + t + tid];
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
}

// At most 64 registers a thread: four CTAs an SM.
template <typename T, bool kVec>
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
    alpha_chain<T, kVec>(a, c, sh, &ctrl);
  }
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(counters + 1, 1);
    __syncthreads();
    const int k = ticket;
    __syncthreads();
    if (k >= tiles) break;
    stats_tile<T, kVec>(a, k, sh);
  }
}

template <typename T, bool kVec>
int launch_stats_alpha(const StatsAlphaArgs& a, cudaStream_t stream) {
  const auto kernel = mrnnt_stats_alpha_kernel<T, kVec>;
  const size_t smem =
      chain_floats(a.s1, a.win) * sizeof(float) +
      (kVec ? static_cast<size_t>(kWarps) * kStageValues<T> * sizeof(T) : 0);
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
                                 const int* a_hi, int batch, int t_max, int s1,
                                 int v, int blank, float* denom,
                                 float* lp_blank, float* lp_label,
                                 float* alphas, int* sync, void* stream) {
  using namespace mrnnt;
  if (batch == 0 || t_max == 0 || s1 == 0) return 0;
  // Tickets are int: B*T, plus one overshoot a CTA, must fit.
  if (static_cast<long long>(batch) * t_max > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // Rows a chain takes at once: up to 8, while the window stays ~16 KB.
  int win = 2048 / s1;
  win = win < 1 ? 1 : (win > 8 ? 8 : win);
  const StatsAlphaArgs a{logits, labels_ext, a_lo, a_hi, batch, t_max, s1, v,
                         blank, win, denom, lp_blank, lp_label, alphas, sync};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = rows_are_16b(logits, logits, v, is_bf16 ? 2 : 4);
  if (is_bf16)
    return vec ? launch_stats_alpha<__nv_bfloat16, true>(a, st)
               : launch_stats_alpha<__nv_bfloat16, false>(a, st);
  return vec ? launch_stats_alpha<float, true>(a, st)
             : launch_stats_alpha<float, false>(a, st);
}
