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

// d2 = |v|^2 + |q|^2 - 2 q.v, rounded step by step as written: the explicit
// _rn intrinsics keep nvcc from contracting the expression into an FMA, so
// the formula rounds like the reference's.
__device__ __forceinline__ float l2_from_dot(float vn, float qn, float dot) {
  const float d2 = __fsub_rn(__fadd_rn(vn, qn), __fmul_rn(2.f, dot));
  return sqrtf(fmaxf(d2, 0.f));
}

}  // namespace favor
