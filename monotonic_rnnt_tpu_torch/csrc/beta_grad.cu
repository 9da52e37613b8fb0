// Fused beta recurrence + occupancy coefficients + logit gradient of the
// monotonic RNN-T loss, in one persistent launch.
//
// Replaces the TPU kernel monotonic_rnnt_tpu/ops/pallas/kernels.py:
// beta_grad_fused (body _beta_grad_kernel). Same operands and outputs:
// logits [B,T,S1,V] f32 or bf16; denom, lp_blank and lp_label with the beta
// window folded in, aprev (alpha(t-1,s), -inf on invalid cells) [B,T,S1] f32;
// input_lengths [B] int32; ll_bounded and grad_scale [B] f32 (grad_scale may
// be null: 1); beta_virtual and labels_ext [B,S1] -> grads [B,T,S1,V] in the
// logits' dtype and betas [B,T,S1] f32.
//
// What bounds it on an H100: HBM bytes. One read of the logits and one write
// of the gradient (2.61 GB f32 / 1.31 GB bf16 at B=32,T=200,S=50,V=1000,
// ~0.78 / 0.39 ms at 3.35 TB/s; rows whose coefficients are all 0 are not
// read); the [B,T,S1] streams add under 1%.
//
// Design. On the TPU one sequential grid advanced the beta DP on a block's
// first V step and hid it behind the block DMAs. Here one launch of as many
// CTAs as are resident at once (the occupancy API) takes work by tickets
// from two global counters, which the wrapper zeroes with the B progress
// words in one int32 scratch:
//  * chains (counter 0, tickets 0..B-1): one CTA walks sample b's beta row
//    down t in shared memory (the virtual row while t+1 >= T_b; slot S1
//    holds -inf), writes betas and the three occupancy coefficients
//    occ/cb/cl = sc * exp(aprev + . - ll) (op order of kernels.py:688-691)
//    to a [3,B,T,S1] f32 scratch that stays in L2, and publishes the count
//    of rows done in done[b] (release). Its operand rows arrive through a
//    ring of cp.async copies issued ring_depth(S1) rows ahead (8 at S1 <=
//    170), so no step waits on a global load. For S1 <= 32 one warp runs the chain with __syncwarp.
//  * gradient tiles (counter 1, tickets 0..B*T-1): one (b,t) lattice row
//    block of S1 x V, in descending t, t-major across samples, so that every
//    chain's frontier is consumed evenly. A tile acquire-spins until
//    done[b] covers t, then writes its S1 rows, a warp a row, with
//    common.cuh's grad_row, the gradient row that grad_pass (csrc/
//    grad_pass.cu) runs too: dz = p*(occ - [v==blank] cb - [v==label] cl),
//    p = exp(x + denom), 0 by a select where that coefficient is 0; a row
//    whose three coefficients are 0 is written without being read
//    (zero_row). Loads and stores are 16 bytes a lane (float4, or 8 bf16)
//    where rows_are_16b holds, scalar otherwise.
//
// Why it cannot deadlock, at any B and any occupancy, with no cooperative
// launch: a CTA takes tile tickets only after counter 0 has passed B, so
// every chain was claimed before any tile, by a CTA that is running; a
// chain never waits on anything; so every chain ends, and a tile waits only
// on a chain that runs.

#include "common.cuh"

namespace mrnnt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
// Rows a chain publishes at once: a release costs a device-scope fence.
constexpr int kPublishEvery = 4;

struct BetaGradArgs {
  const void* logits;
  const float* denom;
  const float* lpb;    // lp_blank, beta window folded in
  const float* lpl;    // lp_label, beta window folded in
  const float* aprev;
  const int* ilen;
  const float* llb;
  const float* scale;  // null: 1
  const float* bvirt;
  const int* labels;
  int batch, t_max, s1, v, blank, ring;
  void* grads;
  float* betas;
  float* coef;  // occ, cb, cl: [3, B*T*S1]
  int* sync;    // done[B], then the two ticket counters
};

// Waits for the oldest of `ring` rows in flight: cp.async.wait_group takes
// an immediate, so one case per ring depth.
__device__ __forceinline__ void ring_wait(int ring) {
  switch (ring) {
    case 8: cp_async_wait<7>(); break;
    case 4: cp_async_wait<3>(); break;
    case 2: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void chain_sync(bool one_warp) {
  if (one_warp) __syncwarp(); else __syncthreads();
}

// Sample b's beta chain, run by `nthreads` threads (a warp, or the CTA).
__device__ void beta_chain(const BetaGradArgs& a, int b, float* sh,
                           int nthreads, bool one_warp) {
  const int tid = threadIdx.x, s1 = a.s1, t_max = a.t_max, ring = a.ring;
  const int w = s1 + 1;
  float* virt = sh;
  float* bufs[2] = {sh + w, sh + 2 * w};
  float* slots = sh + 3 * w;  // ring x [lpb, lpl, aprev] x s1
  const long long n = static_cast<long long>(a.batch) * t_max * s1;
  const long long base = static_cast<long long>(b) * t_max * s1;

  for (int s = tid; s < w; s += nthreads) {
    virt[s] = s < s1 ? a.bvirt[b * s1 + s] : MRNNT_NEG_INF;
    bufs[0][s] = MRNNT_NEG_INF;
    bufs[1][s] = MRNNT_NEG_INF;
  }
  const auto fill = [&](int t, int slot) {
    if (t >= 0) {
      float* dst = slots + slot * 3 * s1;
      const long long off = base + static_cast<long long>(t) * s1;
      for (int s = tid; s < s1; s += nthreads) {
        cp_async4(dst + s, a.lpb + off + s);
        cp_async4(dst + s1 + s, a.lpl + off + s);
        cp_async4(dst + 2 * s1 + s, a.aprev + off + s);
      }
    }
    cp_async_commit();  // one group per row, empty past t = 0
  };
  for (int i = 0; i < ring; ++i) fill(t_max - 1 - i, i);
  chain_sync(one_warp);

  const int t_b = a.ilen[b];
  const float ll = a.llb[b];
  const float sc = a.scale != nullptr ? a.scale[b] : 1.f;
  int cur = 0;
  for (int i = 0; i < t_max; ++i) {
    const int t = t_max - 1 - i;
    const int slot = i % ring;
    ring_wait(ring);
    const float* row = slots + slot * 3 * s1;
    const float* nxt = (t + 1 >= t_b) ? virt : bufs[cur];
    float* out = bufs[cur ^ 1];
    const long long off = base + static_cast<long long>(t) * s1;
    for (int s = tid; s < s1; s += nthreads) {
      const float n0 = nxt[s];
      const float n1 = nxt[s + 1];
      const float nw = log_sum_exp(n0 + row[s], n1 + row[s1 + s]);
      const float ap = row[2 * s1 + s];
      out[s] = nw;
      a.betas[off + s] = nw;
      a.coef[off + s] = sc * expf(ap + nw - ll);
      a.coef[n + off + s] = sc * expf(ap + n0 - ll);
      a.coef[2 * n + off + s] = sc * expf(ap + n1 - ll);
    }
    // This thread has used its values of the slot: refill it `ring` rows on.
    fill(t - ring, slot);
    chain_sync(one_warp);
    if (tid == 0 && ((i + 1) % kPublishEvery == 0 || i + 1 == t_max))
      publish_flag(a.sync + b, i + 1);
    cur ^= 1;
  }
  cp_async_wait<0>();
}

// The S1 gradient rows of lattice row (b, t), a warp a row.
template <typename T, bool kVec>
__device__ void grad_tile(const BetaGradArgs& a, int b, int t) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long n = static_cast<long long>(a.batch) * a.t_max * a.s1;
  const long long row0 = (static_cast<long long>(b) * a.t_max + t) * a.s1;
  const T* logits = static_cast<const T*>(a.logits);
  T* grads = static_cast<T*>(a.grads);
  for (int s = warp; s < a.s1; s += kWarps) {
    const long long row = row0 + s;
    // The coefficients were written by another CTA in this launch: read
    // them through L2.
    const float o = __ldcg(a.coef + row);
    const float c_b = __ldcg(a.coef + n + row);
    const float c_l = __ldcg(a.coef + 2 * n + row);
    T* g = grads + row * a.v;
    if (o == 0.f && c_b == 0.f && c_l == 0.f) {
      zero_row<T, kVec>(g, a.v, lane);
      continue;
    }
    grad_row<T, T, kVec>(logits + row * a.v, g, a.v, lane, a.denom[row], o,
                         c_b, c_l, a.blank, a.labels[b * a.s1 + s]);
  }
}

// At most 64 registers a thread: four CTAs an SM.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    mrnnt_beta_grad_kernel(BetaGradArgs a) {
  extern __shared__ float sh[];
  __shared__ int ticket;
  int* counters = a.sync + a.batch;
  const bool one_warp = a.s1 <= kWarp;
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(counters, 1);
    __syncthreads();
    const int c = ticket;
    __syncthreads();
    if (c >= a.batch) break;
    if (!one_warp || threadIdx.x < kWarp)
      beta_chain(a, c, sh, one_warp ? kWarp : kThreads, one_warp);
    __syncthreads();  // the shared rows are free for the next ticket
  }
  const int tiles = a.batch * a.t_max;
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(counters + 1, 1);
    __syncthreads();
    const int k = ticket;
    __syncthreads();
    if (k >= tiles) break;
    const int t = a.t_max - 1 - k / a.batch;
    const int b = k % a.batch;
    if (threadIdx.x == 0) {
      const int need = a.t_max - t;
      while (load_acquire(a.sync + b) < need) __nanosleep(128);
    }
    __syncthreads();
    grad_tile<T, kVec>(a, b, t);
  }
}

// Ring rows a chain keeps in flight: deep while the ring stays small.
inline int ring_depth(int s1) {
  const long long row_bytes = 3LL * s1 * sizeof(float);
  int r = 8;
  while (r > 1 && r * row_bytes > 16 * 1024) r /= 2;
  return r;
}

template <typename T, bool kVec>
int launch_beta_grad(BetaGradArgs a, cudaStream_t stream) {
  const auto kernel = mrnnt_beta_grad_kernel<T, kVec>;
  const size_t smem =
      (3 * (static_cast<size_t>(a.s1) + 1) + 3 * static_cast<size_t>(a.ring) *
                                                 a.s1) * sizeof(float);
  int ctas = 0;
  if (const int err = resident_ctas(kernel, kThreads, smem, &ctas)) return err;
  const long long tickets = static_cast<long long>(a.batch) * (a.t_max + 1);
  if (tickets < ctas) ctas = static_cast<int>(tickets);
  kernel<<<ctas, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mrnnt

// sync: B + 2 int32 zeros; coef: 3*B*T*S1 f32 scratch; grad_scale may be
// null. The output has the logits' dtype.
extern "C" int mrnnt_beta_grad(const void* logits, int is_bf16,
                               const float* denom, const float* lpb_bmask,
                               const float* lpl_bmask, const float* aprev,
                               const int* input_lengths,
                               const float* ll_bounded,
                               const float* grad_scale,
                               const float* beta_virtual, const int* labels,
                               int batch, int t_max, int s1, int v, int blank,
                               void* grads, float* betas, float* coef,
                               int* sync, void* stream) {
  using namespace mrnnt;
  if (batch == 0 || t_max == 0 || s1 == 0) return 0;
  // Tickets are int: B*T, plus one overshoot a CTA, must fit.
  if (static_cast<long long>(batch) * t_max > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const BetaGradArgs a{logits, denom, lpb_bmask, lpl_bmask, aprev,
                       input_lengths, ll_bounded, grad_scale, beta_virtual,
                       labels, batch, t_max, s1, v, blank, ring_depth(s1),
                       grads, betas, coef, sync};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int itemsize = is_bf16 ? 2 : 4;
  const bool vec = rows_are_16b(logits, grads, v, itemsize);
  if (is_bf16)
    return vec ? launch_beta_grad<__nv_bfloat16, true>(a, st)
               : launch_beta_grad<__nv_bfloat16, false>(a, st);
  return vec ? launch_beta_grad<float, true>(a, st)
             : launch_beta_grad<float, false>(a, st);
}
