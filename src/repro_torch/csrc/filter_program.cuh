// DNF filter program of one query over one attribute row (the device side
// of repro_torch/core/filters.py, shared by the kernels in this directory).
//
// valid (W,) f32: disjunct is live when > 0
// imask (W, mi) int64: allowed-value bitmask (uint32 bits) per int column
// flo/fhi (W, mf) f32: closed interval per float column
// ri (mi,) int32 and rf (mf,) f32: the row's attributes
//
// A shift amount outside [0, 32) -- the -1 ints of pad rows -- gives bit 0,
// as the uint32 shift of the reference evaluators does.  A NaN float (pad
// rows) fails every interval test.  mi = 0 or mf = 0 skips that block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace favor {

constexpr float BIG = 3.0e38f;

__device__ __forceinline__ bool eval_row(const float* __restrict__ valid,
                                         const long long* __restrict__ imask,
                                         const float* __restrict__ flo,
                                         const float* __restrict__ fhi,
                                         int W, int mi, int mf,
                                         const int* ri, const float* rf) {
  for (int w = 0; w < W; ++w) {
    if (!(valid[w] > 0.f)) continue;
    bool ok = true;
    for (int c = 0; c < mi && ok; ++c) {
      const int v = ri[c];
      ok = v >= 0 && v < 32 && ((imask[w * mi + c] >> v) & 1LL);
    }
    for (int c = 0; c < mf && ok; ++c) {
      const float a = rf[c];
      ok = (a >= flo[w * mf + c]) && (a <= fhi[w * mf + c]);
    }
    if (ok) return true;
  }
  return false;
}

// A necessary condition of eval_row that reads only a row's first A
// attributes of each kind, for a screen that holds them in registers: the
// hull of a program is, per column c < A, the union over its live
// disjuncts of the int column's allowed values (the low 32 bits of imask,
// the only ones eval_row reads) and the smallest interval holding every
// live float interval.  If eval_row passes a row through disjunct w, then
// each int value lies in [0, 32) with its bit set in imask[w] and so in
// the union, and each float lies in [flo[w], fhi[w]] and so in the hull
// (fminf / fmaxf return one of their operands; a NaN bound, which no float
// passes, is skipped).  So may_pass(hull, row) is false only for rows that
// eval_row fails.  A program with no live disjunct has an empty hull.
template <int A>
struct Hull {
  uint32_t ints[A];
  float lo[A], hi[A];
};

template <int A>
__device__ inline void build_hull(const float* valid, const long long* imask,
                                  const float* flo, const float* fhi, int W,
                                  int mi, int mf, Hull<A>& h) {
  for (int c = 0; c < A; ++c) {
    uint32_t u = 0u;
    float lo = INFINITY, hi = -INFINITY;
    for (int w = 0; w < W; ++w) {
      if (!(valid[w] > 0.f)) continue;
      if (c < mi) u |= (uint32_t)imask[w * mi + c];
      if (c < mf) {
        lo = fminf(lo, flo[w * mf + c]);
        hi = fmaxf(hi, fhi[w * mf + c]);
      }
    }
    h.ints[c] = u;
    h.lo[c] = lo;
    h.hi[c] = hi;
  }
}

template <int A>
__device__ __forceinline__ bool may_pass(const Hull<A>& h, const int (&ri)[A],
                                         const float (&rf)[A], int mi,
                                         int mf) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < A; ++c) {
    if (c < mi)
      ok = ok && ri[c] >= 0 && ri[c] < 32 && (h.ints[c] >> ri[c] & 1u);
    if (c < mf) ok = ok && rf[c] >= h.lo[c] && rf[c] <= h.hi[c];
  }
  return ok;
}

// d2 = |v|^2 + |q|^2 - 2 q.v, rounded step by step as written: the explicit
// _rn intrinsics keep nvcc from contracting the expression into an FMA, so
// the formula rounds like the reference's.
__device__ __forceinline__ float l2_from_dot(float vn, float qn, float dot) {
  const float d2 = __fsub_rn(__fadd_rn(vn, qn), __fmul_rn(2.f, dot));
  return sqrtf(fmaxf(d2, 0.f));
}

}  // namespace favor
