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
// 3.35 TB/s), with one precise expf a value behind them (~1 for every 4
// bytes f32, 2 bf16). On the card the read runs at ~2.8 TB/s f32 whether
// or not the exponentials run (a band of -inf takes none; PERF.md section
// 6): they hide behind the bytes. The scans: latency, not bytes. Their
// traffic is O(B*T*W) f32 (a few us of HBM time) but each walks T
// dependent steps for only B samples.
//
// Design.
//  * Stats: a persistent grid (resident_ctas CTAs, kStatsCtasPerSm a SM),
//    each CTA a ring of kStatsStages stages in shared memory. The flat
//    [B*T*W, V] rows are cut into units of whole rows (a stage's worth);
//    one producer thread a CTA draws units in order from the launch's
//    ticket counter (zeroed on the stream before the launch) and fills
//    the stages with cp.async.bulk copies that complete on a "full"
//    mbarrier a stage; the kStatsConsumers consumer warps release a stage
//    on its "empty" mbarrier (after a fence.proxy.async), so HBM keeps a
//    CTA's next stages in flight while the warps spend their exponentials
//    on the stage that landed. Units drawn in order keep the bytes in
//    flight one front that sweeps the band: contiguous spans a CTA (the
//    front as wide as the band) read 5-8% slower on the card, a static
//    interleave up to 3% (PERF.md section 6).
//    A stage holds whole rows (32 KB of logits at most) where the ring
//    holds a row for every consumer group, else one row a group and a
//    round of each, the rows streaming through the ring a round at a time
//    (V = 50,000 f32). A copy moves the 16-byte-aligned span that
//    covers its bytes, and the readers offset into it, so any V and any
//    storage offset take the one kernel. Each stage also stages its rows'
//    labels and the window bounds of their (b,t) tiles, and a head in
//    which the producer says where the stage's rows start, so that no
//    consumer repeats the walk's 64-bit arithmetic. The consumers reduce a
//    row with common.cuh's load_round (its shared-memory loads), lse_round
//    and group_max_sumexp in walk_rows' order and groups, so a row's stats
//    equal rows 1, 3 and 10's bit for bit. One lane of the group reads the
//    row's x[blank], x[label], label and bounds from the staged tile and
//    keeps its stats; each lane writes the row it keeps once the group has
//    kG of them (the epilogue, a logf, the 0/-inf window masks and five
//    stores, then costs one pass for kG rows: lane 0 writing each row as
//    it finished cost 3-5 us of the call). The alpha emit mask is the alpha
//    window shifted by one slot (bounds minus 1): the emit into w reads
//    lp_label at w-1.
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

// --- softmax_stats_banded: a persistent grid fed by a bulk-copy ring ---------

constexpr int kStatsConsumers = 16;  // consumer warps a CTA
constexpr int kStatsThreads = (kStatsConsumers + 1) * kWarp;  // + producer
constexpr int kStatsStages = 3;
constexpr int kStatsStageBytes = 32 * 1024;  // logits a stage holds
// CTAs a SM that the registers are capped for (56 a thread); two rings of
// three 32 KB stages fit a SM's shared memory.
constexpr int kStatsCtasPerSm = 2;
constexpr int kStatsMaxRows = 256;   // rows a stage at most (its metadata)
constexpr int kRoundBytes = kRoundSlots * kWarp * 16;  // 2 KB, any dtype
// Bytes a staged span may grow by when it is widened to 16-byte bounds.
constexpr int kSpanSlack = 32;

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// A launch's ring, fixed by the shape on the host. The flat [rows, V]
// band is cut into units of unit_rows consecutive rows, which the CTAs
// draw in order. A unit fills `chunks` stages in turn, each
// holding rounds [c * chunk_rounds, ...) of every row of the unit: all of
// them (chunks = 1, whole rows, one copy of the unit's contiguous bytes)
// where the ring holds a row for every consumer group, else one row a
// group (unit_rows = the groups) and chunk_rounds rounds of each, one copy
// a row, into slots slot_bytes apart. Each stage also holds the unit's
// labels, the [B,T] window bounds of the (b,t) tiles its rows span, and a
// head that the producer writes: where the stage's rows start.
struct StatsRing {
  long long rows, units;
  int v, w, blank, row_bytes;
  int unit_rows, unit_q;  // unit_q: unit_rows % the consumer groups
  int rounds, chunk_rounds, chunks, slot_bytes;
  int lab_off, bnd_off, bnd_bytes, head_off, stage_bytes;
  int beta;
};

template <typename T, int kG>
StatsRing stats_ring(long long rows, int w, int v, int blank, int beta) {
  constexpr int groups = kStatsConsumers * (kWarp / kG);
  StatsRing g{};
  g.rows = rows;
  g.v = v;
  g.w = w;
  g.blank = blank;
  g.beta = beta;
  g.row_bytes = v * static_cast<int>(sizeof(T));
  g.rounds = (v + kRoundValues<T> - 1) / kRoundValues<T>;
  int fit = kStatsStageBytes / g.row_bytes;
  if (fit > kStatsMaxRows) fit = kStatsMaxRows;
  long long data;
  if (fit * kStatsStages >= groups) {   // whole rows
    g.unit_rows = fit;
    g.chunk_rounds = g.rounds;
    g.chunks = 1;
    g.slot_bytes = 0;
    data = align16(static_cast<long long>(fit) * g.row_bytes) + kSpanSlack;
  } else {                              // one row a group, a chunk a stage
    g.unit_rows = groups;
    g.chunk_rounds = kStatsStageBytes / groups / kRoundBytes;
    if (g.chunk_rounds < 1) g.chunk_rounds = 1;
    g.chunks = (g.rounds + g.chunk_rounds - 1) / g.chunk_rounds;
    g.slot_bytes = g.chunk_rounds * kRoundBytes + kSpanSlack;
    data = static_cast<long long>(groups) * g.slot_bytes;
  }
  g.units = (rows + g.unit_rows - 1) / g.unit_rows;
  g.unit_q = g.unit_rows % groups;
  // A unit's rows span at most (unit_rows - 1) / w + 2 (b,t) tiles.
  g.lab_off = static_cast<int>(data);
  g.bnd_off = g.lab_off + static_cast<int>(align16(4LL * g.unit_rows + kSpanSlack));
  g.bnd_bytes = static_cast<int>(align16(4LL * ((g.unit_rows - 1) / w + 2) + kSpanSlack));
  g.head_off = g.bnd_off + 4 * g.bnd_bytes;
  g.stage_bytes = (g.head_off + 64 + 127) & ~127;
  return g;
}

// Where a stage's rows start: the producer's walk, written into the stage
// beside its copies, so that no consumer repeats its 64-bit arithmetic.
// The stage holds rows [r0, r0 + n), rounds [k0, k0 + nk) of each; row r0
// is w-slot `rem` of (b,t) tile bt0 and the CTA's row q (mod the groups:
// the rows of the units the CTA drew before it); n = 0 ends the walk;
// the bytes of each copy start `*_mis` bytes into their region.
struct StageHead {
  long long r0, bt0;
  int n, k0, nk, rem, q, x_mis, lab_mis, bnd_mis[4];
};

__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<unsigned long long>(p) & 15ull);
}

// Copies bytes [src, src + len) as the 16-byte-aligned span that covers
// them into dst (16-aligned), adding its bytes to bar's phase; src's
// misalignment is then the bytes' offset from dst.
__device__ __forceinline__ void stage_bytes_of(unsigned dst, const void* src,
                                               long long len, unsigned bar) {
  const char* lo = static_cast<const char*>(src) - misalign(src);
  const unsigned bytes = static_cast<unsigned>(
      align16(misalign(src) + len));
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, lo, bytes, bar);
}

// The producer: one thread draws the CTA's units from *tickets (one ahead)
// and keeps the ring's stages filled, each once every consumer warp has
// released it; a head of no rows, once the units run out, stops the
// consumers.
template <typename T, int kG>
__device__ __forceinline__ void stats_produce(
    const StatsRing& g, unsigned long long* tickets, unsigned char* ring,
    unsigned long long* full, unsigned long long* empty, const T* logits,
    const int* lab_band, const int* const (&bounds)[4]) {
  constexpr int kGroups = kStatsConsumers * (kWarp / kG);
  constexpr int kR = kRoundValues<T>;
  StageHead h{};
  int c = 0;
  long long u = static_cast<long long>(atomicAdd(tickets, 1ULL));
  long long next = static_cast<long long>(atomicAdd(tickets, 1ULL));
  for (long long i = 0;; ++i) {
    const int st = static_cast<int>(i % kStatsStages);
    if (i >= kStatsStages)
      mbar_wait(smem_u32(&empty[st]),
                static_cast<unsigned>((i / kStatsStages - 1) & 1));
    unsigned char* stage = ring + static_cast<long long>(st) * g.stage_bytes;
    if (u >= g.units) {   // no unit left: a head of no rows stops the ring
      h.n = 0;
      *reinterpret_cast<StageHead*>(stage + g.head_off) = h;
      mbar_arrive(smem_u32(&full[st]));
      return;
    }
    if (c == 0) {   // a unit's first stage
      h.r0 = u * g.unit_rows;
      h.bt0 = h.r0 / g.w;
      h.rem = static_cast<int>(h.r0 - h.bt0 * g.w);
    }
    const unsigned base = smem_u32(stage);
    const unsigned bar = smem_u32(&full[st]);
    h.n = static_cast<int>(min(static_cast<long long>(g.unit_rows), g.rows - h.r0));
    h.k0 = c * g.chunk_rounds;
    h.nk = min(g.chunk_rounds, g.rounds - h.k0);
    const T* first = logits + h.r0 * g.v + static_cast<long long>(h.k0) * kR;
    h.x_mis = misalign(first);
    if (g.chunks == 1) {
      stage_bytes_of(base, first, static_cast<long long>(h.n) * g.row_bytes,
                     bar);
    } else {
      const int len = (min(g.v, (h.k0 + h.nk) * kR) - h.k0 * kR) *
                      static_cast<int>(sizeof(T));
      for (int j = 0; j < h.n; ++j)
        stage_bytes_of(base + j * g.slot_bytes,
                       first + static_cast<long long>(j) * g.v, len, bar);
    }
    h.lab_mis = misalign(lab_band + h.r0);
    stage_bytes_of(base + g.lab_off, lab_band + h.r0, 4LL * h.n, bar);
    const int nbt = (h.rem + h.n - 1) / g.w + 1;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      h.bnd_mis[a] = misalign(bounds[a] + h.bt0);
      if (a < 2 || g.beta)
        stage_bytes_of(base + g.bnd_off + a * g.bnd_bytes, bounds[a] + h.bt0,
                       4LL * nbt, bar);
    }
    *reinterpret_cast<StageHead*>(stage + g.head_off) = h;
    mbar_arrive(bar);   // releases the head's writes to the consumers
    if (++c == g.chunks) {
      c = 0;
      u = next;
      if (u < g.units) next = static_cast<long long>(atomicAdd(tickets, 1ULL));
      h.q = (h.q + g.unit_q) % kGroups;
    }
  }
}

// A finished row's stats, held by one lane of its group until the group
// writes kG of them at once: the row, its (m, s), x[blank], x[label] and
// the flags of its label (not the -1 sentinel) and of its three windows.
struct PendingRow {
  long long row = -1;
  float m = 0.f, s = 0.f, xb = 0.f, xl = 0.f;
  unsigned flags = 0;
  static constexpr unsigned kLab = 1, kAlpha = 2, kEmit = 4, kBeta = 8;

  // The stats with the window masks added, as the plain version adds them;
  // an id outside [0, V) selected 0.0 (xl), as DirectReads.
  __device__ __forceinline__ void write(float* denom, float* lpba,
                                        float* lpla, float* lpbb,
                                        float* lplb) const {
    const float dn = -(m + logf(s));
    const float lpb = xb + dn;
    const float lpl = flags & kLab ? xl + dn : MRNNT_NEG_INF;
    const auto mask = [&](unsigned f) {
      return flags & f ? 0.f : MRNNT_NEG_INF;
    };
    denom[row] = dn;
    lpba[row] = lpb + mask(kAlpha);
    lpla[row] = lpl + mask(kEmit);
    if (lpbb != nullptr) {
      lpbb[row] = lpb + mask(kBeta);
      lplb[row] = lpl + mask(kBeta);
    }
  }
};

// A warp of consumers: kG-lane groups, group q of the CTA takes the rows
// whose index in the CTA's walk is q modulo the groups, and reduces each
// with the shared reduction (common.cuh's load_round, lse_round and
// group_max_sumexp, the order of walk_rows), its rounds read from the
// staged tile. A row split over stages (chunks > 1) carries its (m, s)
// from one to the next. Lane `slot` of the group reads the row's
// x[blank], x[label], label and window bounds from the tile while the
// tile is staged, and keeps the row's stats (PendingRow); every kG rows
// (and at the end) each lane writes the row it keeps, so that the
// epilogue (a logf, the masks, five stores) costs the group one pass for
// kG rows rather than one a row.
template <typename T, int kBytes, int kG>
__device__ __forceinline__ void stats_consume(
    const StatsRing& g, const unsigned char* ring,
    unsigned long long* full, unsigned long long* empty, float* denom,
    float* lpba, float* lpla, float* lpbb, float* lplb) {
  constexpr int kR = kRoundValues<T>;
  constexpr int kGroups = kStatsConsumers * (kWarp / kG);
  const int lane = threadIdx.x % kWarp, half = lane / kG, gl = lane % kG;
  const int group = (threadIdx.x / kWarp) * (kWarp / kG) + half;
  const unsigned mask = kG == kWarp ? kFull : 0xffffu << (half * kG);
  float m = MRNNT_NEG_INF, s = 0.f;
  PendingRow mine;
  int slot = 0;   // the lane of the group that keeps the next row
  for (long long i = 0;; ++i) {
    const int st = static_cast<int>(i % kStatsStages);
    mbar_wait(smem_u32(&full[st]),
              static_cast<unsigned>((i / kStatsStages) & 1));
    const unsigned char* stage =
        ring + static_cast<long long>(st) * g.stage_bytes;
    const StageHead& h = *reinterpret_cast<const StageHead*>(stage + g.head_off);
    const int n = h.n;
    if (n == 0) break;
    const int k0 = h.k0, nk = h.nk, lo = k0 * kR;
    const bool last = k0 + nk == g.rounds;
    for (int j = (group - h.q + kGroups) % kGroups; j < n; j += kGroups) {
      const T* x = reinterpret_cast<const T*>(
          g.chunks == 1 ? stage + h.x_mis + j * g.row_bytes
                        : stage + j * g.slot_bytes +
                              ((h.x_mis + j * g.row_bytes) & 15));
      if (gl == slot) {
        const int lab = reinterpret_cast<const int*>(
            stage + g.lab_off + h.lab_mis)[j];
        if (k0 == 0) mine.xb = mine.xl = 0.f;
        if (g.blank >= lo && g.blank - lo < nk * kR)
          mine.xb = to_f32(x[g.blank - lo]);
        if (lab >= lo && lab < g.v && lab - lo < nk * kR)
          mine.xl = to_f32(x[lab - lo]);
        if (last) {
          const int b = (h.rem + j) / g.w, wi = h.rem + j - b * g.w;
          const auto bound = [&](int a) {
            return reinterpret_cast<const int*>(
                stage + g.bnd_off + a * g.bnd_bytes + h.bnd_mis[a])[b];
          };
          const int alo = bound(0), ahi = bound(1);
          unsigned f = lab >= 0 ? PendingRow::kLab : 0u;
          if (wi >= alo && wi <= ahi) f |= PendingRow::kAlpha;
          if (wi >= alo - 1 && wi <= ahi - 1) f |= PendingRow::kEmit;
          if (g.beta && wi >= bound(2) && wi <= bound(3))
            f |= PendingRow::kBeta;
          mine.flags = f;
          mine.row = h.r0 + j;
        }
      }
      for (int k = 0; k < nk; ++k) {
        const int nv = min(kR, g.v - lo - k * kR);
        uint4 r[kRoundSlots];
        load_round<T, kBytes, kG, SharedLoads>(r, x + k * kR, nv, gl);
        lse_round<T, kG>(r, nv, m, s);
      }
      if (!last) continue;
      group_max_sumexp<kG>(m, s, mask);
      if (gl == slot) {
        mine.m = m;
        mine.s = s;
      }
      m = MRNNT_NEG_INF;
      s = 0.f;
      if (++slot == kG) {
        mine.write(denom, lpba, lpla, lpbb, lplb);
        slot = 0;
      }
    }
    // This warp's reads of the stage come before the bulk copy that
    // refills it (another proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
  }
  if (gl < slot) mine.write(denom, lpba, lpla, lpbb, lplb);
}

// kStatsConsumers consumer warps and one producer warp, whose lane 0
// drives the ring; the grid is at most g.units CTAs, which draw the units
// from *tickets (0 at launch).
template <typename T, int kBytes, int kG>
__global__ void __launch_bounds__(kStatsThreads, kStatsCtasPerSm)
mrnnt_stats_banded_kernel(
    const T* __restrict__ logits, const int* __restrict__ lab_band,
    const int* __restrict__ ra_lo, const int* __restrict__ ra_hi,
    const int* __restrict__ rb_lo, const int* __restrict__ rb_hi,
    const StatsRing g, float* __restrict__ denom, float* __restrict__ lpba,
    float* __restrict__ lpla, float* __restrict__ lpbb,
    float* __restrict__ lplb, unsigned long long* __restrict__ tickets) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kStatsStages];
  __shared__ __align__(8) unsigned long long empty[kStatsStages];
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStatsStages; ++st) {
      mbar_init(smem_u32(&full[st]), 1);
      mbar_init(smem_u32(&empty[st]), kStatsConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / kWarp == kStatsConsumers) {
    const int* const bounds[4] = {ra_lo, ra_hi, rb_lo, rb_hi};
    if (threadIdx.x % kWarp == 0)
      stats_produce<T, kG>(g, tickets, ring, full, empty, logits, lab_band,
                           bounds);
    return;
  }
  stats_consume<T, kBytes, kG>(g, ring, full, empty, denom, lpba,
                               lpla, lpbb, lplb);
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

// The ring of a launch at this shape, and its grid (at most the CTAs
// resident at once, and at most one a unit); raises the kernel's dynamic
// shared-memory cap first, which fails where the device cannot give it.
// A stage holds at most ~39 KB (32 KB of logits, its labels and bounds at
// W = 1), so the three take under 120 KB at any shape.
template <typename T, int kBytes, int kG>
int stats_launch(long long rows, int w, int v, int blank, int beta,
                 StatsRing* g, size_t* smem, unsigned* grid) {
  *g = stats_ring<T, kG>(rows, w, v, blank, beta);
  *smem = static_cast<size_t>(kStatsStages) * g->stage_bytes;
  int ctas = 0;
  if (const int err = resident_ctas(mrnnt_stats_banded_kernel<T, kBytes, kG>,
                                    kStatsThreads, *smem, &ctas))
    return err;
  *grid = static_cast<unsigned>(ctas < g->units ? ctas : g->units);
  return 0;
}

}  // namespace mrnnt

extern "C" int mrnnt_stats_banded(const void* logits, int is_bf16,
                                  const int* lab_band, const int* ra_lo,
                                  const int* ra_hi, const int* rb_lo,
                                  const int* rb_hi, int batch, int t_max,
                                  int w, int v, int blank, float* denom,
                                  float* lpba, float* lpla, float* lpbb,
                                  float* lplb, void* tickets, void* stream) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max * w;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_row_type(is_bf16, logits, v, [&](auto rt) {
    using R = decltype(rt);
    using T = typename R::type;
    StatsRing g;
    size_t smem;
    unsigned grid;
    if (const int err = stats_launch<T, R::bytes, R::lanes>(
            rows, w, v, blank, lpbb != nullptr, &g, &smem, &grid))
      return err;
    cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(unsigned long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    mrnnt_stats_banded_kernel<T, R::bytes, R::lanes>
        <<<grid, kStatsThreads, smem, st>>>(
            static_cast<const T*>(logits), lab_band, ra_lo, ra_hi, rb_lo,
            rb_hi, g, denom, lpba, lpla, lpbb, lplb,
            static_cast<unsigned long long*>(tickets));
    return static_cast<int>(cudaGetLastError());
  });
}

// What mrnnt_stats_banded would launch at this shape, without launching:
// out = {grid, threads, stages, stage bytes, dynamic shared memory, rows a
// unit, stages a unit, load bytes, lanes a row}.
extern "C" int mrnnt_stats_banded_shape(const void* logits, int is_bf16,
                                        int batch, int t_max, int w, int v,
                                        int beta, long long* out) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max * w;
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_row_type(is_bf16, logits, v, [&](auto rt) {
    using R = decltype(rt);
    StatsRing g;
    size_t smem;
    unsigned grid;
    if (const int err = stats_launch<typename R::type, R::bytes, R::lanes>(
            rows, w, v, 0, beta, &g, &smem, &grid))
      return err;
    const long long shape[9] = {grid, kStatsThreads, kStatsStages,
                                g.stage_bytes, static_cast<long long>(smem),
                                g.unit_rows, g.chunks, R::bytes, R::lanes};
    for (int i = 0; i < 9; ++i) out[i] = shape[i];
    return 0;
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
