// Device helpers shared by the monotonic RNN-T kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define MRNNT_NEG_INF (-INFINITY)

namespace mrnnt {

constexpr int kWarp = 32;
// Values each lane of the gradient kernels' scalar loops loads before it
// uses them: four independent loads in flight per lane.
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// log(exp(a) + exp(b)) = max + log1p(exp(min - max)); exactly -inf when both
// are -inf, and NaN when either is NaN (monotonic_rnnt_tpu/ops/helpers.py:19).
// A NaN a against b = -inf lands in mn (a > b is false), so the -inf return
// asks for both: mx == -inf alone gave -inf there, and lost the NaN.
__device__ __forceinline__ float log_sum_exp(float a, float b) {
  const float mx = a > b ? a : b;
  const float mn = a > b ? b : a;
  if (mx == MRNNT_NEG_INF && mn == MRNNT_NEG_INF) return MRNNT_NEG_INF;
  return mx + log1pf(expf(mn - mx));
}

// 0 where lo <= w <= hi, else -inf: a window folded into a log-space value
// by addition, as the Pallas kernels fold their reachability masks.
__device__ __forceinline__ float window_mask(int w, int lo, int hi) {
  return (w >= lo && w <= hi) ? 0.f : MRNNT_NEG_INF;
}

// The warp chains' shuffle mask: every lane of the warp.
constexpr unsigned kFull = 0xffffffffu;

// *p = v where pred holds, as one predicated store: the warp chains'
// stores, which a compiler-made branch around the address arithmetic would
// put between one step's log_sum_exp and the next step's shuffles.
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "@q st.global.f32 [%0], %1;\n"
      "}\n" ::"l"(p),
      "f"(v), "r"(static_cast<int>(pred)));
}

// 16 bytes of T as one load: float4 (4 floats) or uint4 (8 bf16), unpacked
// to and packed from f32. bf16 packs round to nearest even, as astype.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const float4& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static float4 pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// True when rows of v values of `itemsize` bytes at both pointers can be
// read and written 16 bytes a lane: every row starts on a 16-byte boundary.
inline bool rows_are_16b(const void* a, const void* b, long long v,
                         int itemsize) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15ull) != 0;
  };
  return (v * itemsize) % 16 == 0 && !misaligned(a) && !misaligned(b);
}

// Vectors a lane keeps in flight on the 16-byte gradient path: 32 values
// (8 float4 or 4 x 8 bf16), so that a row of V = 1000 is one round of loads.
template <typename T>
constexpr int kVecUnroll = 32 / Vec16<T>::n;

// --- The gradient row: one (b,t,s) row of dz over V ---------------------------
//
// Every gradient the port writes comes from grad_row below: beta_grad.cu's
// tiles (beta_grad_fused) and grad_pass.cu (grad_pass, for the banded,
// split, fused-joint and sharded routes). A warp writes one row:
//   dz = p * (occ - [v==blank] c_b - [v==lab] c_l),  p = exp(x + d),
// and 0 by a select (never p*0) where that coefficient is 0, so +-inf
// padding gives no NaN (kernels.py:1317-1319); bf16 output rounds to
// nearest even, as astype. An id outside [0, V) matches no column. With
// kVec the lanes move 16 bytes a load and a store (float4, or 8 bf16), 32
// values in flight a lane, streamed past L1 (__ldcs/__stcs); the caller
// takes kVec only where rows_are_16b holds and the two types are equal.
// Otherwise each lane moves one value a load, kUnroll in flight.
template <typename TIn, typename TOut, bool kVec>
__device__ __forceinline__ void grad_row(const TIn* __restrict__ x,
                                         TOut* __restrict__ g, int v,
                                         int lane, float d, float o,
                                         float c_b, float c_l, int blank,
                                         int lab) {
  const auto cell = [&](float xv, int vi) {
    const float p = expf(xv + d);
    const float coef = o - (vi == blank ? c_b : 0.f) - (vi == lab ? c_l : 0.f);
    return coef == 0.f ? 0.f : p * coef;
  };
  if constexpr (kVec) {
    static_assert(sizeof(TIn) == sizeof(TOut), "16-byte rows are one type");
    using V = Vec16<TIn>;
    constexpr int kN = V::n;
    const typename V::type* xv = reinterpret_cast<const typename V::type*>(x);
    typename V::type* gv = reinterpret_cast<typename V::type*>(g);
    constexpr int kU = kVecUnroll<TIn>;
    const int nv = v / kN;
    for (int i0 = lane; i0 < nv; i0 += kWarp * kU) {
      typename V::type raw[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k)
        if (i0 + k * kWarp < nv) raw[k] = __ldcs(xv + i0 + k * kWarp);
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int i = i0 + k * kWarp;
        if (i < nv) {
          float f[kN];
          V::unpack(raw[k], f);
#pragma unroll
          for (int j = 0; j < kN; ++j) f[j] = cell(f[j], i * kN + j);
          __stcs(gv + i, V::pack(f));
        }
      }
    }
  } else {
    for (int v0 = lane; v0 < v; v0 += kWarp * kUnroll) {
      float xs[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int vi = v0 + k * kWarp;
        xs[k] = vi < v ? to_f32(x[vi]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int vi = v0 + k * kWarp;
        if (vi < v) g[vi] = from_f32<TOut>(cell(xs[k], vi));
      }
    }
  }
}

// A row whose three coefficients are 0 (padding, unreachable cells): its
// gradient is 0 whatever its logits hold, so it is written without being
// read, 16 bytes a store with kVec.
template <typename T, bool kVec>
__device__ __forceinline__ void zero_row(T* __restrict__ g, int v, int lane) {
  if constexpr (kVec) {
    using V = Vec16<T>;
    float f[V::n] = {};
    const typename V::type z = V::pack(f);
    typename V::type* gv = reinterpret_cast<typename V::type*>(g);
    for (int i = lane; i < v / V::n; i += kWarp) __stcs(gv + i, z);
  } else {
    const T zero = from_f32<T>(0.f);
    for (int vi = lane; vi < v; vi += kWarp) g[vi] = zero;
  }
}

// --- The stats reduction: a row's max and sum-exp ----------------------------
//
// Every stats kernel (split.cu's softmax_stats and softmax_stats_partial,
// stats_alpha.cu's tiles) reduces its rows with walk_rows below, and
// banded.cu's softmax_stats_banded with its load_round (from shared memory),
// lse_round and group_max_sumexp in walk_rows' order: one order that
// depends on V and the dtype only, so a row gives the same bits in every
// kernel, at every load width and from either memory:
//  * A row is reduced by a group of G lanes: the whole warp, or a half-warp
//    (two rows a warp) where the row fits in half a round (V <= 256 f32,
//    512 bf16), so that short rows keep 2 KB a warp in flight and pay half
//    the trees. A round is 4 * G 16-byte vectors (2 KB for G = 32: 512 f32,
//    1024 bf16); lane i of the group takes the round's vectors i, i + G,
//    i + 2G and i + 3G (its slots 0-3); the values past the row's end count
//    as -inf. A row of V = 1000 is one round in bf16, two in f32.
//  * Per round a lane takes the max cm of its values, sets mn = max(m, cm),
//    rescales its sum once (s *= expf(m - mn), skipped when mn == m), then
//    adds expf(x - mn) for each of its values in index order: one precise
//    expf a value, against 5 for 4 values and 10 more a lane in the
//    shuffle tree before, and a bf16 max on pairs.
//  * Across the group's lanes: a max-only shuffle tree, one exp(m_lane - M)
//    a lane, then an add-only tree; every lane ends with the same bits.
// Rules: an all -inf row gives m = -inf, s = 0 (denom = +inf); a -inf value
// adds exactly 0; a NaN makes m and s NaN (the max propagates NaN, as
// torch.amax); a +inf makes s NaN (inf - inf). m is the exact row max.
// Why the precise expf: the f32 alpha and beta recursions at T = 1600
// (|alpha| ~ 1e4, an ulp ~ 9.8e-4) round differently wherever a row's
// stats differ from the oracle's by an ulp, and one such alpha ulp moves
// the occupancies behind it by 0.98 of the banded gradient check's 1e-3
// relative tolerance; the check holds while such flips stay few and do not
// compound on a path. A cheaper exponential (ex2.approx) shifts more rows,
// and that check then fails (chip_smoke.py prints the drift; PERF.md, PR 9).
// Loads are as wide as the rows' alignment allows (row_load_bytes: 16, 8, 4
// or 2 bytes) and fill the same slots, so the width never changes the order.

constexpr int kRoundSlots = 4;  // 16-byte vectors a lane holds of a round

template <typename T>
constexpr int kRoundValues = kRoundSlots * kWarp * 16 / static_cast<int>(sizeof(T));

// Lanes that reduce a row of v values of T: 16 where the row fits in half a
// round, else 32. The same for every stats kernel at the same V and dtype.
template <typename T>
__host__ __device__ constexpr int row_lanes(int v) {
  return v <= kRoundValues<T> / 2 ? kWarp / 2 : kWarp;
}

// max(a, b), NaN when either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(const unsigned& w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

// The widest load (16, 8 or 4 bytes, else itemsize) at which every row of
// v values of `itemsize` bytes at p starts aligned.
inline int row_load_bytes(const void* p, long long v, int itemsize) {
  const auto addr = reinterpret_cast<unsigned long long>(p);
  for (int w = 16; w > itemsize; w /= 2)
    if ((v * itemsize) % w == 0 && addr % w == 0) return w;
  return itemsize;
}

// Whether slot k of a round of n values holds a value for any of the
// group's kG lanes: the same for the whole group.
template <typename T, int kG>
__device__ __forceinline__ bool slot_live(int k, int n) {
  return k * kG * (16 / static_cast<int>(sizeof(T))) < n;
}

// Where a round's loads read from: device memory through the read-only
// path (GlobalLoads), or a tile that a bulk copy staged in shared memory
// (SharedLoads, banded.cu). Only the source differs: a round fills the same
// slots from either.
struct GlobalLoads {
  template <typename U>
  __device__ __forceinline__ static U ld(const U* p) { return __ldg(p); }
};
struct SharedLoads {
  template <typename U>
  __device__ __forceinline__ static U ld(const U* p) { return *p; }
};

// The 16 bytes of T at p (aligned to kBytes), loaded kBytes at a time, as
// four 32-bit words in index order. A load of 2 bytes reads one bf16.
template <typename T, int kBytes, typename Ld = GlobalLoads>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p) {
  if constexpr (kBytes == 16) {
    return Ld::ld(reinterpret_cast<const uint4*>(p));
  } else if constexpr (kBytes == 8) {
    const uint2 a = Ld::ld(reinterpret_cast<const uint2*>(p));
    const uint2 b = Ld::ld(reinterpret_cast<const uint2*>(p) + 1);
    return make_uint4(a.x, a.y, b.x, b.y);
  } else if constexpr (kBytes == 4) {
    const unsigned* w = reinterpret_cast<const unsigned*>(p);
    return make_uint4(Ld::ld(w), Ld::ld(w + 1), Ld::ld(w + 2), Ld::ld(w + 3));
  } else {
    static_assert(kBytes == 2 && sizeof(T) == 2, "2-byte loads are bf16");
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = Ld::ld(h + 2 * j) | (static_cast<unsigned>(Ld::ld(h + 2 * j + 1)) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Group lane gl's slots of the round of n values at src (a group of kG
// lanes), loaded kBytes at a time (src and n aligned to kBytes) through Ld;
// values past n are -inf. A slot inside the row for every lane loads
// unchecked. Slots that hold nothing for any lane of the group are left
// unset: lse_round skips them.
template <typename T, int kBytes, int kG, typename Ld = GlobalLoads>
__device__ __forceinline__ void load_round(uint4 (&r)[kRoundSlots],
                                           const T* __restrict__ src, int n,
                                           int gl) {
  constexpr int kVN = 16 / static_cast<int>(sizeof(T));  // values a vector
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));  // a load
  constexpr unsigned kNegInf = sizeof(T) == 4 ? 0xff800000u : 0xff80ff80u;
  const T* lane_src = src + gl * kVN;
#pragma unroll
  for (int k = 0; k < kRoundSlots; ++k) {
    if (!slot_live<T, kG>(k, n)) break;
    const T* p = lane_src + k * kG * kVN;
    if ((k + 1) * kG * kVN <= n) {  // the same for the whole group
      r[k] = load_vec<T, kBytes, Ld>(p);
      continue;
    }
    const int i0 = (gl + k * kG) * kVN;
    unsigned w[4];
    if constexpr (kBytes == 16) {
      const uint4 u = i0 < n ? Ld::ld(reinterpret_cast<const uint4*>(p))
                             : make_uint4(kNegInf, kNegInf, kNegInf, kNegInf);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else if constexpr (kBytes == 8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint2 u = i0 + j * kPer < n
                            ? Ld::ld(reinterpret_cast<const uint2*>(p) + j)
                            : make_uint2(kNegInf, kNegInf);
        w[2 * j] = u.x;
        w[2 * j + 1] = u.y;
      }
    } else if constexpr (kBytes == 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = i0 + j * kPer < n
                   ? Ld::ld(reinterpret_cast<const unsigned*>(p) + j)
                   : kNegInf;
    } else {  // bf16 one value a load
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned lo = i0 + 2 * j < n ? Ld::ld(h + 2 * j) : 0xff80u;
        const unsigned hi = i0 + 2 * j + 1 < n ? Ld::ld(h + 2 * j + 1) : 0xff80u;
        w[j] = lo | (hi << 16);
      }
    }
    r[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The values of one 32-bit word of a round, in index order, as f32.
template <typename T>
__device__ __forceinline__ float word_value(unsigned w, int half) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w);
  else
    return __uint_as_float(half ? (w & 0xffff0000u) : (w << 16));
}

// One round of n values (the lane's slots r, a group of kG lanes) folded
// into its running (m, s), in the order above.
template <typename T, int kG>
__device__ __forceinline__ void lse_round(const uint4 (&r)[kRoundSlots], int n,
                                          float& m, float& s) {
  constexpr int kHalves = sizeof(T) == 4 ? 1 : 2;
  if (!slot_live<T, kG>(0, n)) return;  // V = 0
  float cm;
  if constexpr (sizeof(T) == 4) {
    cm = max_nan(max_nan(__uint_as_float(r[0].x), __uint_as_float(r[0].y)),
                 max_nan(__uint_as_float(r[0].z), __uint_as_float(r[0].w)));
#pragma unroll
    for (int k = 1; k < kRoundSlots; ++k) {
      if (!slot_live<T, kG>(k, n)) break;
      cm = max_nan(cm, max_nan(max_nan(__uint_as_float(r[k].x),
                                       __uint_as_float(r[k].y)),
                               max_nan(__uint_as_float(r[k].z),
                                       __uint_as_float(r[k].w))));
    }
  } else {  // bf16 pairs: a max is exact in bf16
    __nv_bfloat162 c2 = __hmax2_nan(__hmax2_nan(as_bf162(r[0].x), as_bf162(r[0].y)),
                                    __hmax2_nan(as_bf162(r[0].z), as_bf162(r[0].w)));
#pragma unroll
    for (int k = 1; k < kRoundSlots; ++k) {
      if (!slot_live<T, kG>(k, n)) break;
      c2 = __hmax2_nan(c2, __hmax2_nan(__hmax2_nan(as_bf162(r[k].x), as_bf162(r[k].y)),
                                       __hmax2_nan(as_bf162(r[k].z), as_bf162(r[k].w))));
    }
    cm = max_nan(__low2float(c2), __high2float(c2));
  }
  const float mn = max_nan(m, cm);
  if (mn == MRNNT_NEG_INF) return;  // nothing but -inf yet: m = -inf, s = 0
  if (mn != m) s *= expf(m - mn);
#pragma unroll
  for (int k = 0; k < kRoundSlots; ++k) {
    if (!slot_live<T, kG>(k, n)) break;
    const unsigned w[4] = {r[k].x, r[k].y, r[k].z, r[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
        s += expf(word_value<T>(w[j], h) - mn);
  }
  m = mn;
}

// The (m, s) of a group's kG lanes (shuffle mask `mask`) combined: every
// lane of the group ends with the row's.
template <int kG>
__device__ __forceinline__ void group_max_sumexp(float& m, float& s,
                                                 unsigned mask) {
  float mx = m;
#pragma unroll
  for (int off = kG / 2; off > 0; off /= 2)
    mx = max_nan(mx, __shfl_xor_sync(mask, mx, off));
  if (mx != MRNNT_NEG_INF && m != mx)
    s *= expf(m - mx);
#pragma unroll
  for (int off = kG / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(mask, s, off);
  m = mx;
}

// A group's walk over rows of v values at x: the round it reduces next,
// (r_row, r_k), and the lanes' running (m, s). step<true>() reduces the
// round in `cur` while the next one loads into `nxt`; step<false>() loads
// the next round into `nxt` (which may be `cur`) once `cur` is reduced.
template <typename T, int kBytes, int kG, typename Rows>
struct RowWalk {
  static constexpr int kR = kRoundValues<T>;
  const T* __restrict__ x;
  int v, last, gl;  // gl: this lane's index in its group of kG
  unsigned mask;    // the group's lanes, for the shuffles
  long long stride, end;
  Rows& rows;
  long long r_row;
  int r_k = 0;
  float m = MRNNT_NEG_INF, s = 0.f;

  __device__ __forceinline__ int count(int k) const {
    return min(kR, v - k * kR);
  }

  __device__ __forceinline__ void load(uint4 (&r)[kRoundSlots], long long row,
                                       int k) {
    load_round<T, kBytes, kG>(r, x + row * v + k * kR, count(k), gl);
    if (k == 0 && gl == 0) rows.pre(row);
  }

  template <bool kAhead>
  __device__ __forceinline__ bool step(uint4 (&cur)[kRoundSlots],
                                       uint4 (&nxt)[kRoundSlots]) {
    long long n_row = r_row;
    int n_k = r_k + 1;
    if (n_k > last) {
      n_k = 0;
      n_row += stride;
    }
    if (r_k == 0 && gl == 0) rows.start(r_row);
    if (kAhead && n_row < end) load(nxt, n_row, n_k);
    lse_round<T, kG>(cur, count(r_k), m, s);
    if (!kAhead && n_row < end) load(nxt, n_row, n_k);
    if (r_k == last) {
      group_max_sumexp<kG>(m, s, mask);
      if (gl == 0) rows.fin(r_row, m, s);
      m = MRNNT_NEG_INF;
      s = 0.f;
    }
    r_row = n_row;
    r_k = n_k;
    return r_row < end;
  }
};

// Warp `warp` of `warps` reduces its rows of v values at x below `end`,
// each to its (m, s), in groups of kG = row_lanes<T>(v) lanes (the launch
// picks kG): rows base + warp, base + warp + warps, ... with a whole warp a
// row, or rows base + 2 * warp + h, base + 2 * (warp + warps) + h, ... for
// half-warp h. With kAhead the next round's loads are in flight while a
// round is reduced (two register buffers, used in turn); without, one
// buffer, its next loads issued before the row's shuffle trees (for a
// kernel whose register budget holds one round). The group's lane 0 makes
// the calls on `rows`: begin(first, stride) once, pre(r) as row r's first
// round is loaded, start(r) as that round is reduced, fin(r, m, s) when the
// row is done. Every lane of the warp calls walk_rows with the same
// arguments.
template <typename T, int kBytes, int kG, bool kAhead = true, typename Rows>
__device__ __forceinline__ void walk_rows(const T* __restrict__ x, int v,
                                          long long base, long long warp,
                                          long long warps, long long end,
                                          Rows& rows) {
  constexpr int kPerWarp = kWarp / kG;
  const int lane = threadIdx.x % kWarp, h = lane / kG;
  const long long first = base + warp * kPerWarp + h;
  const long long stride = warps * kPerWarp;
  if (first >= end) return;
  RowWalk<T, kBytes, kG, Rows> w{
      x, v, (v - 1) / kRoundValues<T>, lane % kG,
      kG == kWarp ? 0xffffffffu : 0xffffu << (h * kG), stride, end, rows,
      first};
  if (lane % kG == 0) rows.begin(first, stride);
  uint4 a[kRoundSlots];
  w.load(a, first, 0);
  if constexpr (kAhead) {
    uint4 b[kRoundSlots];
    while (w.template step<true>(a, b) && w.template step<true>(b, a)) {
    }
  } else {
    while (w.template step<false>(a, a)) {
    }
  }
}

// Lane 0's direct reads of a row for the stats kernels that take the blank
// and label log-probs: x[blank], read as the row's first round is loaded,
// and x[label], read as it is reduced (the id loaded a round before); an id
// outside [0, V) selects 0.0, as the compare-select of kernels.py.
template <typename T>
struct DirectReads {
  const T* x;
  int v, blank;
  int lab_next = 0, lab = 0;
  float xb_next = 0.f, xb = 0.f, xl = 0.f;

  __device__ __forceinline__ void load(long long row, int label) {
    lab_next = label;
    xb_next = to_f32(x[row * v + blank]);
  }
  __device__ __forceinline__ void take(long long row) {
    lab = lab_next;
    xb = xb_next;
    xl = (lab >= 0 && lab < v) ? to_f32(x[row * v + lab]) : 0.f;
  }
};

// Calls f(RowType<T, kBytes, kG>{}) for the logits' type, the rows' load
// width and row_lanes<T>(v): each (type, width, group) is its own kernel.
template <typename T, int kBytes, int kG>
struct RowType {
  using type = T;
  static constexpr int bytes = kBytes;
  static constexpr int lanes = kG;
};

template <typename T, int kBytes, typename F>
int with_lanes(int v, F&& f) {
  if (row_lanes<T>(v) == kWarp) return f(RowType<T, kBytes, kWarp>{});
  return f(RowType<T, kBytes, kWarp / 2>{});
}

template <typename F>
int with_row_type(int is_bf16, const void* logits, int v, F&& f) {
  using BF = __nv_bfloat16;
  const int width = row_load_bytes(logits, v, is_bf16 ? 2 : 4);
  if (is_bf16) {
    switch (width) {
      case 16: return with_lanes<BF, 16>(v, f);
      case 8: return with_lanes<BF, 8>(v, f);
      case 4: return with_lanes<BF, 4>(v, f);
      default: return with_lanes<BF, 2>(v, f);
    }
  }
  switch (width) {
    case 16: return with_lanes<float, 16>(v, f);
    case 8: return with_lanes<float, 8>(v, f);
    default: return with_lanes<float, 4>(v, f);
  }
}

// Flags between the CTAs of one persistent launch. A producer's threads
// write their data, meet at __syncthreads, and one thread publishes with
// publish_flag (a device-scope fence, then a release store); a consumer
// reads the flag with an acquire load and reads the data through L2
// (__ldcg), never through a possibly stale L1 line.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish_flag(int* p, int v) {
  __threadfence();
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// 4-byte asynchronous copies global -> shared (sm_80+), for rings that a
// thread fills and reads itself: cp_async_wait<N> leaves N groups pending.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bulk copies (TMA, sm_90) into shared memory that complete on an mbarrier:
// stream.cu's dma copy and banded.cu's stats ring. A barrier counts
// `count` arrivals a phase, plus the bytes its arrivals said to expect;
// waiters name the phase by its parity (0 for the first after init).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Tells the barrier's current phase to wait for `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Global -> shared, `bytes` (a multiple of 16, both addresses 16-aligned),
// completing on `bar`, whose phase must expect them.
__device__ __forceinline__ void bulk_copy(unsigned dst_smem, const char* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst_smem),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bulk_copy with an arrival on `bar` (a barrier of one arrival a phase)
// that expects its bytes.
__device__ __forceinline__ void bulk_load(unsigned dst_smem, const char* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  bulk_copy(dst_smem, src, bytes, bar);
}

// The CTAs of `kernel` (threads a CTA, smem dynamic bytes) resident at once
// on the current device, after raising its dynamic shared memory limit when
// smem passes the default 48 KB. Returns 0 or a cudaError_t. The answer is
// kept for the last (kernel, smem, device) asked, the launch's usual case.
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads, size_t smem, int* ctas) {
  static thread_local struct { Kernel kernel; size_t smem; int dev, ctas; }
      last = {nullptr, 0, -1, 0};
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (last.kernel == kernel && last.smem == smem && last.dev == dev) {
    *ctas = last.ctas;
    return 0;
  }
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *ctas = sms * per_sm;
  last = {kernel, smem, dev, *ctas};
  return 0;
}

// Blocks of kRowThreads threads, one warp per row, for the row-parallel
// passes over the big tensor. Returns 0 or the launch's cudaError_t.
constexpr int kRowThreads = 256;  // 8 rows per block

inline int row_blocks(long long rows, unsigned* blocks) {
  const long long per_block = kRowThreads / kWarp;
  const long long n = (rows + per_block - 1) / per_block;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

}  // namespace mrnnt

// The C entry points return the launch's cudaError_t as an int (0 = ok).
// Each library is built from one source file, so this definition is linked
// once per library.
extern "C" const char* mrnnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
