// mrnnt.cpp — native CPU engine for the monotonic RNN-T loss.
//
// Role: the framework's C-ABI entry point for external embedders (the
// counterpart of the reference's extern "C" compute_rnnt_loss,
// rnnt_entrypoint.h:24-25) and an independent oracle for the JAX/Pallas
// kernels. Built from scratch for this framework: flat rectangular
// per-sample DP tables, one function per phase, OpenMP over the batch.
//
// Math contract (identical to the TPU path; see ops/reference.py):
//   logp(v|t,s)  = act[t,s,v] - logsumexp_v act[t,s,:]
//   fwd(t,s)     = LSE(fwd(t-1,s) + logp(blank|t,s),
//                      fwd(t-1,s-1) + logp(lab[s-1]|t,s-1))
//   bwd(t,s)     = LSE(bwd(t+1,s) + logp(blank|t,s),
//                      bwd(t+1,s+1) + logp(lab[s]|t,s))
//   dL/dz[t,s,v] = p(v|t,s) * (exp(fwd(t-1,s)+bwd(t,s)-ll)
//                  - [v==blank]   * exp(fwd(t-1,s)+bwd(t+1,s)-ll)
//                  - [v==lab[s]]  * exp(fwd(t-1,s)+bwd(t+1,s+1)-ll))
// with alignment-band clamping identical to the reference's
// restrict_to_alignment semantics (cpu_workspace_manager.h:207-224).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC mrnnt.cpp -o libmrnnt.so

#include "mrnnt.h"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

inline float log_add(float a, float b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const float hi = a > b ? a : b;
  const float lo = a > b ? b : a;
  return hi + std::log1p(std::exp(lo - hi));
}

// Per-sample view over the packed activation block.
struct SampleView {
  const float* acts;     // [T, S1, V]
  const int32_t* labels; // [S]
  int T, S, V;
  int S1() const { return S + 1; }
  const float* cell(int t, int s) const {
    return acts + (static_cast<int64_t>(t) * S1() + s) * V;
  }
};

// Allowed label-count window per frame (alignment restriction).
struct Band {
  std::vector<int32_t> lo, hi;  // size T
  bool active = false;
};

Band make_band(const SampleView& sv, const int32_t* alignment, int32_t shift,
               int32_t blank) {
  Band band;
  if (alignment == nullptr) return band;
  band.active = true;
  band.lo.resize(sv.T);
  band.hi.resize(sv.T);
  std::vector<int32_t> count(sv.T + 1, 0);  // nonblanks in alignment[0..k)
  for (int t = 0; t < sv.T; ++t)
    count[t + 1] = count[t] + (alignment[t] != blank ? 1 : 0);
  for (int t = 0; t < sv.T; ++t) {
    const int lo_idx = std::max(0, t + 1 - shift);
    const int hi_idx = std::min(sv.T, t + 1 + shift);
    band.lo[t] = std::min(count[lo_idx], sv.S);
    band.hi[t] = std::min(count[hi_idx], sv.S);
  }
  return band;
}

// log-softmax normalizers for every lattice cell: out[t*S1+s].
void cell_normalizers(const SampleView& sv, float* out) {
  const int cells = sv.T * sv.S1();
  for (int c = 0; c < cells; ++c) {
    const float* z = sv.acts + static_cast<int64_t>(c) * sv.V;
    float m = z[0];
    for (int v = 1; v < sv.V; ++v) m = std::max(m, z[v]);
    float acc = 0.f;
    for (int v = 0; v < sv.V; ++v) acc += std::exp(z[v] - m);
    out[c] = m + std::log(acc);  // logsumexp (note: positive form)
  }
}

struct FrameWindow {
  int lo, hi;  // inclusive s-range
};

FrameWindow fwd_window(const SampleView& sv, const Band& band, int t) {
  FrameWindow w;
  w.lo = std::max(0, t - (sv.T - 1 - sv.S));
  w.hi = std::min(sv.S, t + 1);
  if (band.active) {
    w.lo = std::max(w.lo, static_cast<int>(band.lo[t]));
    w.hi = std::min(w.hi, static_cast<int>(band.hi[t]));
  }
  return w;
}

FrameWindow bwd_window(const SampleView& sv, const Band& band, int t) {
  FrameWindow w;
  if (t == 0) { w.lo = 0; w.hi = 0; return w; }
  w.lo = std::max(0, t - (sv.T - sv.S));
  w.hi = std::min(sv.S, t);
  if (band.active) {
    w.lo = std::max(w.lo, static_cast<int>(band.lo[t - 1]));
    w.hi = std::min(w.hi, static_cast<int>(band.hi[t - 1]));
  }
  return w;
}

// fwd table is [T, S1]; row t holds fwd(t, s). Returns log-likelihood.
float run_forward(const SampleView& sv, const float* norm, const Band& band,
                  int blank, float* fwd) {
  const int s1 = sv.S1();
  std::fill(fwd, fwd + static_cast<int64_t>(sv.T) * s1, kNegInf);
  for (int t = 0; t < sv.T; ++t) {
    const FrameWindow w = fwd_window(sv, band, t);
    for (int s = w.lo; s <= w.hi; ++s) {
      const float prev_same =
          t == 0 ? (s == 0 ? 0.f : kNegInf) : fwd[(t - 1) * s1 + s];
      const float prev_diag =
          s == 0 ? kNegInf
                 : (t == 0 ? (s == 1 ? 0.f : kNegInf)
                           : fwd[(t - 1) * s1 + s - 1]);
      const float stay =
          prev_same + sv.cell(t, s)[blank] - norm[t * s1 + s];
      const float step =
          s == 0 ? kNegInf
                 : prev_diag + sv.cell(t, s - 1)[sv.labels[s - 1]] -
                       norm[t * s1 + s - 1];
      fwd[t * s1 + s] = log_add(stay, step);
    }
  }
  return fwd[(sv.T - 1) * s1 + sv.S];
}

// bwd table row t holds bwd(t, s) (the reference's code convention where the
// virtual terminal row is bwd(T, s) = [s == S]).
float run_backward(const SampleView& sv, const float* norm, const Band& band,
                   int blank, float* bwd) {
  const int s1 = sv.S1();
  std::fill(bwd, bwd + static_cast<int64_t>(sv.T) * s1, kNegInf);
  for (int t = sv.T - 1; t >= 0; --t) {
    const FrameWindow w = bwd_window(sv, band, t);
    for (int s = w.lo; s <= w.hi; ++s) {
      const bool terminal = (t == sv.T - 1);
      const float next_same =
          terminal ? (s == sv.S ? 0.f : kNegInf) : bwd[(t + 1) * s1 + s];
      const float next_diag =
          s == sv.S ? kNegInf
                    : (terminal ? (s + 1 == sv.S ? 0.f : kNegInf)
                                : bwd[(t + 1) * s1 + s + 1]);
      const float stay = next_same + sv.cell(t, s)[blank] - norm[t * s1 + s];
      const float step =
          s == sv.S ? kNegInf
                    : next_diag + sv.cell(t, s)[sv.labels[s]] -
                          norm[t * s1 + s];
      bwd[t * s1 + s] = log_add(stay, step);
    }
  }
  return bwd[0];
}

void emit_gradients(const SampleView& sv, const float* norm, const float* fwd,
                    const float* bwd, float ll, int blank, float* grad) {
  const int s1 = sv.S1();
  if (!std::isfinite(ll)) {  // infeasible lattice: cost inf, grads zero
    std::memset(grad, 0,
                sizeof(float) * static_cast<int64_t>(sv.T) * s1 * sv.V);
    return;
  }
  for (int t = 0; t < sv.T; ++t) {
    for (int s = 0; s <= sv.S; ++s) {
      const float prev =
          t == 0 ? (s == 0 ? 0.f : kNegInf) : fwd[(t - 1) * s1 + s];
      const float through = prev + bwd[t * s1 + s] - ll;
      const float via_blank =
          prev + (t == sv.T - 1 ? (s == sv.S ? 0.f : kNegInf)
                                : bwd[(t + 1) * s1 + s]) - ll;
      const float via_label =
          s == sv.S ? kNegInf
                    : prev + (t == sv.T - 1
                                  ? (s + 1 == sv.S ? 0.f : kNegInf)
                                  : bwd[(t + 1) * s1 + s + 1]) - ll;
      float* g = grad + (static_cast<int64_t>(t) * s1 + s) * sv.V;
      const float* z = sv.cell(t, s);
      const float n = norm[t * s1 + s];
      const float occ = std::exp(through);
      if (occ == 0.f && via_blank == kNegInf && via_label == kNegInf) {
        std::memset(g, 0, sizeof(float) * sv.V);
        continue;
      }
      for (int v = 0; v < sv.V; ++v) {
        const float p = std::exp(z[v] - n);
        float val = p * occ;
        if (v == blank) val -= std::exp(z[v] - n + via_blank);
        if (s < sv.S && v == sv.labels[s])
          val -= std::exp(z[v] - n + via_label);
        g[v] = val;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* mrnnt_status_string(int status) {
  switch (status) {
    case MRNNT_OK: return "ok";
    case MRNNT_BAD_ARGUMENT: return "bad argument (null pointer or size)";
    case MRNNT_BAD_LENGTHS: return "bad lengths (need T>=1, 0<=S<=T)";
    default: return "unknown status";
  }
}

// Scratch bytes needed by mrnnt_loss_packed for this batch.
int mrnnt_workspace_bytes(int32_t batch, const int32_t* T, const int32_t* S,
                          int64_t* out_bytes) {
  if (batch <= 0 || T == nullptr || S == nullptr || out_bytes == nullptr)
    return MRNNT_BAD_ARGUMENT;
  int64_t total = 0;
  for (int b = 0; b < batch; ++b) {
    if (T[b] < 1 || S[b] < 0 || S[b] > T[b]) return MRNNT_BAD_LENGTHS;
    total += 3LL * T[b] * (S[b] + 1);  // norm + fwd + bwd tables
  }
  *out_bytes = total * static_cast<int64_t>(sizeof(float));
  return MRNNT_OK;
}

// Monotonic RNN-T loss (+ gradients) on a packed batch.
//
// acts:   [sum_b T_b*(S_b+1), V] row-major, sample-major packing with
//         per-sample cell order (t * (S_b+1) + s) — the reference's layout.
// labels: [batch, s_stride] int32 (s_stride >= max S_b).
// alignment: optional [batch, t_stride] (t_stride >= max T_b), with
//         max_shift as the band half-width; pass NULL when unrestricted.
// costs:  [batch] out. grads: like acts, out; NULL -> cost-only fast path.
// workspace: buffer of mrnnt_workspace_bytes, or NULL to self-allocate.
int mrnnt_loss_packed(const float* acts, const int32_t* labels, int32_t batch,
                      const int32_t* T, const int32_t* S, int32_t V,
                      int32_t s_stride, int32_t blank, int32_t num_threads,
                      const int32_t* alignment, int32_t t_stride,
                      int32_t max_shift, float* costs, float* grads,
                      void* workspace) {
  if (!acts || !labels || !T || !S || !costs || batch <= 0 || V <= 0)
    return MRNNT_BAD_ARGUMENT;
  if (blank < 0 || blank >= V) return MRNNT_BAD_ARGUMENT;

  int64_t ws_bytes = 0;
  const int rc = mrnnt_workspace_bytes(batch, T, S, &ws_bytes);
  if (rc != MRNNT_OK) return rc;

  std::vector<float> owned;
  float* ws = static_cast<float*>(workspace);
  if (ws == nullptr) {
    owned.resize(ws_bytes / sizeof(float));
    ws = owned.data();
  }

  // Per-sample offsets into acts/grads and workspace.
  std::vector<int64_t> act_off(batch + 1, 0), ws_off(batch + 1, 0);
  for (int b = 0; b < batch; ++b) {
    const int64_t cells = static_cast<int64_t>(T[b]) * (S[b] + 1);
    act_off[b + 1] = act_off[b] + cells * V;
    ws_off[b + 1] = ws_off[b] + 3 * cells;
  }

#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic)
#endif
  for (int b = 0; b < batch; ++b) {
    SampleView sv{acts + act_off[b], labels + static_cast<int64_t>(b) * s_stride,
                  T[b], S[b], V};
    const int64_t cells = static_cast<int64_t>(sv.T) * sv.S1();
    float* norm = ws + ws_off[b];
    float* fwd = norm + cells;
    float* bwd = fwd + cells;

    const Band band = make_band(
        sv, alignment ? alignment + static_cast<int64_t>(b) * t_stride
                      : nullptr,
        max_shift, blank);
    cell_normalizers(sv, norm);
    const float ll = run_forward(sv, norm, band, blank, fwd);
    costs[b] = -ll;
    if (grads != nullptr) {
      run_backward(sv, norm, band, blank, bwd);
      emit_gradients(sv, norm, fwd, bwd, ll, blank, grads + act_off[b]);
    }
  }
  return MRNNT_OK;
}

}  // extern "C"
