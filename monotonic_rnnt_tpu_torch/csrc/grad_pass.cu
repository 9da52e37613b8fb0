// Logit gradient of the monotonic RNN-T loss from per-cell coefficients.
//
// Replaces the TPU kernel monotonic_rnnt_tpu/ops/pallas/kernels.py:
// grad_pass (body _grad_kernel). Same operands and outputs: logits
// [B,T,S1,V] f32 or bf16 (S1 is the band width W on the packed band
// layout), denom, occ, cb, cl [B,T,S1] f32, labels [B,S1] (one id per
// lattice row) or [B,T,S1] (the band layout's per-(t,w) ids) int32 ->
// grads [B,T,S1,V] in f32 or bf16:
//   dz = p * (occ - [v==blank] cb - [v==label] cl),  p = exp(x + denom),
// and 0 by a select (never p*0) where that coefficient is 0, so +-inf
// padding cannot give NaN (kernels.py:1317-1319). The banded, split,
// fused-joint and sharded routes launch it; beta_grad_fused (csrc/
// beta_grad.cu) writes the padded route's gradient itself, with the same
// row code.
//
// What bounds it on an H100: HBM bytes, one read of the live rows' logits
// and one write of every gradient row (0.29 GB f32 at the banded case
// B=2, T=1600, W=16, V=1024, where 19,103 of 51,200 rows have a non-zero
// coefficient: ~0.086 ms at 3.35 TB/s); the [B,T,S1] streams add about 1%.
//
// Design. common.cuh owns the row: grad_row writes one (b,t,s) row, a warp
// a row, and zero_row writes a row whose three coefficients are 0 without
// reading it (131 MB of the banded case's 210 MB of writes). Lanes move
// 16 bytes a load and a store, 32 values in flight a lane, where
// rows_are_16b holds and the input and output types are equal (every
// caller passes out_dtype = logits.dtype); the mixed pairs and unaligned
// rows take the same arithmetic one value a load, so both paths give the
// same bits. The grid is dense: a block of 8 warps takes 8 consecutive
// rows, at most 64 registers a thread so that 4 blocks (32 warps, 128 KB
// of f32 loads) sit on an SM; the block scheduler hands the blocks out in
// order as they finish, so the rows of zero and live coefficients balance
// by themselves. A persistent grid drawing 8-row tickets from a counter
// was measured slower (PERF.md section 6). The labels are addressed with a
// b-stride and a t-stride (0 for [B,S1] labels), so both layouts run the
// same code; an id outside [0, V), a negative blank included, matches no
// column. Row offsets are 64-bit; any V.

#include "common.cuh"

namespace mrnnt {

struct GradArgs {
  const void* logits;
  const float* denom;
  const float* occ;
  const float* cb;
  const float* cl;
  const int* labels;
  long long lab_b_stride, lab_t_stride, rows;
  int t_max, s1, v, blank;
  void* grads;
};

// A warp a row, 8 rows a block. At most 64 registers a thread: four blocks
// an SM.
template <typename TIn, typename TOut, bool kVec>
__global__ void __launch_bounds__(kRowThreads, 4)
    mrnnt_grad_kernel(GradArgs a) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kRowThreads / kWarp) +
      threadIdx.x / kWarp;
  if (row >= a.rows) return;
  const long long off = row * static_cast<long long>(a.v);
  TOut* g = static_cast<TOut*>(a.grads) + off;
  const float o = a.occ[row], c_b = a.cb[row], c_l = a.cl[row];
  if (o == 0.f && c_b == 0.f && c_l == 0.f) {
    zero_row<TOut, kVec>(g, a.v, lane);
    return;
  }
  const long long bt = row / a.s1;
  const int lab = a.labels[(bt / a.t_max) * a.lab_b_stride +
                           (bt % a.t_max) * a.lab_t_stride +
                           static_cast<int>(row - bt * a.s1)];
  grad_row<TIn, TOut, kVec>(static_cast<const TIn*>(a.logits) + off, g, a.v,
                            lane, a.denom[row], o, c_b, c_l, a.blank, lab);
}

template <typename TIn, typename TOut, bool kVec>
int launch_grad(const GradArgs& a, cudaStream_t stream) {
  unsigned blocks;
  if (const int err = row_blocks(a.rows, &blocks)) return err;
  mrnnt_grad_kernel<TIn, TOut, kVec><<<blocks, kRowThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mrnnt

// labels_per_t: 0 for [B,S1] labels, 1 for [B,T,S1].
extern "C" int mrnnt_grad(const void* logits, int in_bf16, const float* denom,
                          const float* occ, const float* cb, const float* cl,
                          const int* labels, int labels_per_t, int batch,
                          int t_max, int s1, int v, int blank, void* grads,
                          int out_bf16, void* stream) {
  using namespace mrnnt;
  using BF = __nv_bfloat16;
  const long long rows = static_cast<long long>(batch) * t_max * s1;
  if (rows == 0) return 0;
  const GradArgs a{logits, denom, occ, cb, cl, labels,
                   labels_per_t ? static_cast<long long>(t_max) * s1 : s1,
                   labels_per_t ? s1 : 0, rows, t_max, s1, v, blank, grads};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 != out_bf16)
    return in_bf16 ? launch_grad<BF, float, false>(a, st)
                   : launch_grad<float, BF, false>(a, st);
  const bool vec = rows_are_16b(logits, grads, v, in_bf16 ? 2 : 4);
  if (in_bf16)
    return vec ? launch_grad<BF, BF, true>(a, st)
               : launch_grad<BF, BF, false>(a, st);
  return vec ? launch_grad<float, float, true>(a, st)
             : launch_grad<float, float, false>(a, st);
}
