// The padded loss's small-array glue around rows 1 and 2 (stats_alpha_fused,
// beta_grad_fused), in three launches.
//
// Replaces no TPU kernel. On the TPU this glue is XLA's: the window bounds,
// the ll gather and the small folds between the kernels of
// monotonic_rnnt_tpu/ops/pallas/fused.py (_dp_fused_alpha_half,
// _dp_fused_grad_half) fuse into a few XLA loops. In eager PyTorch the same
// glue was ~120 ATen kernels a loss step, each one host dispatch of 10-27 us,
// so the card idled while the host issued them. Each kernel here is its
// plain version in ops/cuda/kernels.py bit for bit: integer window
// arithmetic (int32, wrapping as torch's does), selects, a shift and a pick.
//
//  * mrnnt_loss_prologue_kernel (before row 1): a thread per (b, t) gives
//    the alpha and beta windows of bands.py's _window_bounds, t < T_b
//    conjoined into both hi bounds (hi = -1), stacked [4, B, T]; the
//    threads past B*T give extend_labels' labels_ext [B, S1].
//  * mrnnt_loss_costs_kernel (after row 1): a thread per sample picks
//    ll = alphas[b, T_b - 1, S_b] by JAX's take_along_axis rule (NaN for an
//    index out of range, reference.py's _gather_ll) and writes -ll.
//  * mrnnt_beta_operands_kernel (before row 2): a warp per (b, t) row gives
//    the beta window folded into lp_blank and lp_label by a select (a NaN
//    statistic outside the window stays out), alpha(t-1, s) where t < T_b
//    and ll is finite, else -inf; the warp of row (b, 0) also writes
//    beta_virtual[b] and ll_bounded[b].
//
// What bounds them on an H100: launch latency. The largest, the operands,
// reads three and writes three [B, T, S1] f32 arrays: 24 MB at the loss
// cell's largest bucket, ~7 us at 3.35 TB/s.

#include "common.cuh"

namespace mrnnt {

constexpr int kGlueThreads = 256;
constexpr int kGlueWarps = kGlueThreads / kWarp;

// int32 arithmetic that wraps on overflow, as torch's int32 tensors do (a
// length an exported artifact never checked may be anything, and the padded
// loss launches the prologue and the costs before it checks the lengths).
// No length indexes memory unclamped: the prologue's only index is its
// (b, t) or (b, s) slot, and the costs pick in range or write NaN.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void mrnnt_loss_prologue_kernel(
    const void* labels, int labels_int64, int label_cols, const int* ilen,
    const int* slen, const int* band_min, const int* band_max, int batch,
    int t_max, int s1, int* labels_ext, int* windows) {
  const long long bt = static_cast<long long>(batch) * t_max;
  const long long n = bt + static_cast<long long>(batch) * s1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (i < bt) {
      const int b = static_cast<int>(i / t_max);
      const int t = static_cast<int>(i - static_cast<long long>(b) * t_max);
      const int il = ilen[b], sl = slen[b];
      // alpha window at t (cpu_workspace_manager.h:67-71).
      const int a_lo = max(band_min[i], wrap_sub(t, wrap_sub(wrap_sub(il, 1),
                                                              sl)));
      const int a_hi = min(min(band_max[i], wrap_add(t, 1)), sl);
      // beta window at t: the band of t-1, [0, S1] before t = 0.
      const int p_min = t == 0 ? 0 : band_min[i - 1];
      const int p_max = t == 0 ? s1 : band_max[i - 1];
      const int b_lo = max(p_min, wrap_sub(t, wrap_sub(il, sl)));
      const int b_hi = min(min(p_max, t), sl);
      const bool valid = t < il;
      windows[i] = a_lo;
      windows[bt + i] = valid ? a_hi : -1;
      windows[2 * bt + i] = b_lo;
      windows[3 * bt + i] = valid ? b_hi : -1;
    } else {
      const long long j = i - bt;
      const int b = static_cast<int>(j / s1);
      const int s = static_cast<int>(j - static_cast<long long>(b) * s1);
      int id = -1;
      if (s < slen[b] && s < label_cols) {
        const long long at = static_cast<long long>(b) * label_cols + s;
        id = labels_int64
                 ? static_cast<int>(static_cast<const long long*>(labels)[at])
                 : static_cast<const int*>(labels)[at];
      }
      labels_ext[j] = id;
    }
  }
}

__global__ void mrnnt_loss_costs_kernel(const float* alphas, const int* ilen,
                                        const int* slen, int batch, int t_max,
                                        int s1, float* ll_fwd, float* costs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const long long t = max(static_cast<long long>(ilen[b]) - 1, 0LL);
  long long s = slen[b];
  if (s < 0) s += s1;
  const bool ok = t < t_max && s >= 0 && s < s1;
  const float ll =
      ok ? alphas[(static_cast<long long>(b) * t_max + t) * s1 + s]
         : __int_as_float(0x7fc00000);
  ll_fwd[b] = ll;
  costs[b] = __int_as_float(__float_as_int(ll) ^ (1 << 31));  // -ll, exact
}

__global__ void mrnnt_beta_operands_kernel(
    const float* lp_blank, const float* lp_label, const float* alphas,
    const float* ll_fwd, const int* ilen, const int* slen, const int* b_lo,
    const int* b_hi, int batch, int t_max, int s1, float* masked,
    float* ll_bounded, float* beta_virtual) {
  const long long rows = static_cast<long long>(batch) * t_max;
  const long long bts = rows * s1;
  const int lane = threadIdx.x % kWarp;
  for (long long row = static_cast<long long>(blockIdx.x) * kGlueWarps +
                       threadIdx.x / kWarp;
       row < rows; row += static_cast<long long>(gridDim.x) * kGlueWarps) {
    const int b = static_cast<int>(row / t_max);
    const int t = static_cast<int>(row - static_cast<long long>(b) * t_max);
    const int lo = b_lo[row], hi = b_hi[row];
    const float ll = ll_fwd[b];
    const bool ll_ok = fabsf(ll) < INFINITY;  // isfinite: false for NaN
    const bool valid = t < ilen[b] && ll_ok;
    const long long base = row * s1;
    for (int s = lane; s < s1; s += kWarp) {
      const long long i = base + s;
      const bool in_band = s >= lo && s <= hi;
      masked[i] = in_band ? lp_blank[i] : MRNNT_NEG_INF;
      masked[bts + i] = in_band ? lp_label[i] : MRNNT_NEG_INF;
      // alpha(t-1, s); the virtual row alpha(-1, s) = [s == 0] at t = 0.
      const float prev = t == 0 ? (s == 0 ? 0.f : MRNNT_NEG_INF)
                                : alphas[i - s1];
      masked[2 * bts + i] = valid ? prev : MRNNT_NEG_INF;
    }
    if (t == 0) {
      const int sl = slen[b];
      for (int s = lane; s < s1; s += kWarp)
        beta_virtual[static_cast<long long>(b) * s1 + s] =
            s == sl ? 0.f : MRNNT_NEG_INF;
      if (lane == 0) ll_bounded[b] = ll_ok ? ll : 0.f;
    }
  }
}

// Blocks of kGlueThreads for `work` items, at most 64 a SM's worth: the
// kernels stride over the rest.
inline int glue_blocks(long long work) {
  const long long most = 132LL * 64;
  const long long need = (work + kGlueThreads - 1) / kGlueThreads;
  return static_cast<int>(need < most ? (need < 1 ? 1 : need) : most);
}

}  // namespace mrnnt

// labels [B, label_cols] int32 (labels_int64 = 0) or int64, contiguous;
// input_lengths, label_lengths [B], band_min, band_max [B, T] int32 ->
// labels_ext [B, S1] and windows [4, B, T] int32 (a_lo, a_hi, b_lo, b_hi).
extern "C" int mrnnt_loss_prologue(const void* labels, int labels_int64,
                                   int label_cols, const int* input_lengths,
                                   const int* label_lengths,
                                   const int* band_min, const int* band_max,
                                   int batch, int t_max, int s1,
                                   int* labels_ext, int* windows,
                                   void* stream) {
  using namespace mrnnt;
  const long long work = static_cast<long long>(batch) * (t_max + s1);
  if (work == 0) return 0;
  mrnnt_loss_prologue_kernel<<<glue_blocks(work), kGlueThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      labels, labels_int64, label_cols, input_lengths, label_lengths,
      band_min, band_max, batch, t_max, s1, labels_ext, windows);
  return static_cast<int>(cudaGetLastError());
}

// alphas [B, T, S1] f32, input_lengths, label_lengths [B] int32 -> ll_fwd
// and costs [B] f32.
extern "C" int mrnnt_loss_costs(const float* alphas, const int* input_lengths,
                                const int* label_lengths, int batch, int t_max,
                                int s1, float* ll_fwd, float* costs,
                                void* stream) {
  using namespace mrnnt;
  if (batch == 0) return 0;
  mrnnt_loss_costs_kernel<<<(batch + kGlueThreads - 1) / kGlueThreads,
                            kGlueThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      alphas, input_lengths, label_lengths, batch, t_max, s1, ll_fwd, costs);
  return static_cast<int>(cudaGetLastError());
}

// lp_blank, lp_label, alphas [B, T, S1] f32; ll_fwd [B] f32; input_lengths,
// label_lengths [B] and the beta window b_lo, b_hi [B, T] int32 -> masked
// [3, B, T, S1] f32 (lpb_bmask, lpl_bmask, aprev_masked), ll_bounded [B] and
// beta_virtual [B, S1] f32.
extern "C" int mrnnt_beta_operands(
    const float* lp_blank, const float* lp_label, const float* alphas,
    const float* ll_fwd, const int* input_lengths, const int* label_lengths,
    const int* b_lo, const int* b_hi, int batch, int t_max, int s1,
    float* masked, float* ll_bounded, float* beta_virtual, void* stream) {
  using namespace mrnnt;
  const long long rows = static_cast<long long>(batch) * t_max;
  if (rows == 0 || s1 == 0) return 0;
  mrnnt_beta_operands_kernel<<<glue_blocks(rows * kWarp), kGlueThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      lp_blank, lp_label, alphas, ll_fwd, input_lengths, label_lengths, b_lo,
      b_hi, batch, t_max, s1, masked, ll_bounded, beta_virtual);
  return static_cast<int>(cudaGetLastError());
}
