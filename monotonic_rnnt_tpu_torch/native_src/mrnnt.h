// mrnnt.h — C ABI of the native monotonic RNN-T engine (libmrnnt).
//
// Counterpart of the reference's installable C entry point
// (rnnt_entrypoint.h:24-25 compute_rnnt_loss); see mrnnt.cpp for the
// implementation and the math contract. All functions are thread-safe.

#ifndef MRNNT_H_
#define MRNNT_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

enum MrnntStatus {
  MRNNT_OK = 0,
  MRNNT_BAD_ARGUMENT = 1,   /* null pointer or non-positive size */
  MRNNT_BAD_LENGTHS = 2,    /* need T_b >= 1 and 0 <= S_b <= T_b */
};

/* Human-readable description of a status code. */
const char* mrnnt_status_string(int status);

/* Scratch bytes mrnnt_loss_packed needs for this batch (3 f32 tables of
 * T_b*(S_b+1) cells per sample). Returns a status code. */
int mrnnt_workspace_bytes(int32_t batch, const int32_t* T, const int32_t* S,
                          int64_t* out_bytes);

/* Monotonic RNN-T loss (+ gradients) on a packed batch.
 *
 * acts:      [sum_b T_b*(S_b+1), V] f32 raw logits, row-major, sample-major
 *            packing with per-sample cell order (t * (S_b+1) + s) — the
 *            reference's packed layout. Softmax is applied internally.
 * labels:    [batch, s_stride] int32 (s_stride >= max S_b), no blanks.
 * T, S:      [batch] per-sample input/label lengths.
 * V:         vocabulary size; blank: blank index in [0, V).
 * num_threads: OpenMP thread count; 0 = library default.
 * alignment: optional [batch, t_stride] int32 per-frame reference alignment
 *            (t_stride >= max T_b) with max_shift as the band half-width;
 *            pass NULL when unrestricted.
 * costs:     [batch] out, negative log-likelihoods.
 * grads:     like acts, out; NULL selects the cost-only fast path.
 * workspace: buffer of mrnnt_workspace_bytes, or NULL to self-allocate.
 *
 * Returns a status code (MRNNT_OK on success). */
int mrnnt_loss_packed(const float* acts, const int32_t* labels, int32_t batch,
                      const int32_t* T, const int32_t* S, int32_t V,
                      int32_t s_stride, int32_t blank, int32_t num_threads,
                      const int32_t* alignment, int32_t t_stride,
                      int32_t max_shift, float* costs, float* grads,
                      void* workspace);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* MRNNT_H_ */
