// Graph-expansion distances: for each (query, neighbour id) pair, gather the
// DB row, take the L2 distance, evaluate the query's filter program on the
// row's attributes (TD bit) and compose the exclusion distance
// dbar = d + D * (1 - td) (Eq. 2).  An id < 0 gives BIG and td = 0.
//
// Replaces the TPU kernel src/repro/kernels/gather_distance/kernel.py:
// gather_distance_pallas (body _kernel, helper _eval_row).
//
// What bounds it on an H100: bytes.  Each pair reads one scattered d-float
// row (512 bytes at d = 128) for 2*d operations -- 0.5 operations per byte,
// far below the card's f32 ridge point -- so the gather's memory traffic is
// the whole cost.
//
// Design:
//  * one warp per pair; the lanes read the row as float4s (a 128-float row
//    is exactly one 16-byte load per lane, all 32 coalesced into one 512-byte
//    segment), so each gathered row is one full-width memory transaction;
//  * the TPU kernel's scalar prefetch of the ids has no counterpart: each
//    warp loads its own id;
//  * each lane's partial dot is an FMA chain in a fixed order, and the warp
//    reduces with xor shuffles in a fixed order, so a pair's distance does
//    not depend on the batch width (bucket padding and lane compaction rely
//    on that, src/repro/core/scoring.py:46-60);
//  * the squared norm comes from norms[id]; the filter program is evaluated
//    by lane 0 on the gathered row.
#include <cuda_runtime.h>
#include <math.h>

#include "filter_program.cuh"

namespace {

using favor::BIG;

constexpr int WARPS = 8;  // pairs per block

__global__ void __launch_bounds__(WARPS * 32) gd_kernel(
    const int* __restrict__ ids, const float* __restrict__ q,
    const float* __restrict__ vec, const float* __restrict__ norms,
    const int* __restrict__ ints, const float* __restrict__ floats,
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi,
    const float* __restrict__ dvec, int B, int M, int d, int mi, int mf,
    int W, float* __restrict__ out_d, int* __restrict__ out_td) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= (long long)B * M) return;
  const int b = (int)(pair / M);
  const int id = ids[pair];
  if (id < 0) {
    if (lane == 0) {
      out_d[pair] = BIG;
      out_td[pair] = 0;
    }
    return;
  }
  const float* qrow = q + (size_t)b * d;
  const float* vrow = vec + (size_t)id * d;
  float dot = 0.f, qq = 0.f;
  if ((d & 3) == 0) {
    const float4* q4 = reinterpret_cast<const float4*>(qrow);
    const float4* v4 = reinterpret_cast<const float4*>(vrow);
    for (int c = lane; c < (d >> 2); c += 32) {
      const float4 a = q4[c];
      const float4 v = __ldg(v4 + c);
      dot = fmaf(a.x, v.x, dot);
      dot = fmaf(a.y, v.y, dot);
      dot = fmaf(a.z, v.z, dot);
      dot = fmaf(a.w, v.w, dot);
      qq = fmaf(a.x, a.x, qq);
      qq = fmaf(a.y, a.y, qq);
      qq = fmaf(a.z, a.z, qq);
      qq = fmaf(a.w, a.w, qq);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float a = qrow[c];
      dot = fmaf(a, __ldg(vrow + c), dot);
      qq = fmaf(a, a, qq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    qq += __shfl_xor_sync(0xffffffffu, qq, off);
  }
  if (lane == 0) {
    const float dist = favor::l2_from_dot(norms[id], qq, dot);
    const bool td = favor::eval_row(
        valid + (size_t)b * W, imask + (size_t)b * W * mi,
        flo + (size_t)b * W * mf, fhi + (size_t)b * W * mf, W, mi, mf,
        ints + (size_t)id * mi, floats + (size_t)id * mf);
    out_d[pair] = td ? dist : dist + dvec[b];
    out_td[pair] = td ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// ids (B, M) int32; out_d (B, M) f32 (BIG at id < 0); out_td (B, M) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int gather_distance_launch(const void* ids, const void* q, const void* vec,
                           const void* norms, const void* ints,
                           const void* floats, const void* valid,
                           const void* imask, const void* flo, const void* fhi,
                           const void* dvec, int B, int M, int d, int mi,
                           int mf, int W, void* out_d, void* out_td,
                           void* stream) {
  const long long pairs = (long long)B * M;
  const unsigned blocks = (unsigned)((pairs + WARPS - 1) / WARPS);
  gd_kernel<<<blocks, WARPS * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(q),
      static_cast<const float*>(vec), static_cast<const float*>(norms),
      static_cast<const int*>(ints), static_cast<const float*>(floats),
      static_cast<const float*>(valid), static_cast<const long long*>(imask),
      static_cast<const float*>(flo), static_cast<const float*>(fhi),
      static_cast<const float*>(dvec), B, M, d, mi, mf, W,
      static_cast<float*>(out_d), static_cast<int*>(out_td));
  return (int)cudaGetLastError();
}

}  // extern "C"
