// Merge of per-split top-k lists (shared by the scan kernels in this
// directory).  A scan kernel's blocks each keep one query's k best (distance,
// id) pairs over one DB split, sorted by (distance, id), with BIG / -1 in
// the empty slots; this pass picks each query's k best over all splits in
// the same (distance, id) order -- the reference's lower-id tie rule -- and
// fills what is left with BIG / -1.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "filter_program.cuh"

namespace favor {

// part_d / part_i: (B, S, k); out_d / out_i: (B, k).  One thread per query;
// each step takes, in every split, the first entry after the last one
// written (a binary search: the entries up to it are a prefix of the sorted
// list), and writes the least of them -- k * S * log2(k) reads a query.
__global__ void merge_splits(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int B, int S,
                             int k, float* __restrict__ out_d,
                             int* __restrict__ out_i) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= B) return;
  const float* pd = part_d + (size_t)qi * S * k;
  const int* pi = part_i + (size_t)qi * S * k;
  float prev_d = -INFINITY;
  int prev_i = -1;
  int t = 0;
  for (; t < k; ++t) {
    float bd = BIG;
    int bi = -1;
    for (int s = 0; s < S; ++s) {
      const float* sd = pd + (size_t)s * k;
      const int* si = pi + (size_t)s * k;
      int lo = 0, hi = k;  // first entry not at or before (prev_d, prev_i)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float md = sd[mid];
        if (md < prev_d || (md == prev_d && si[mid] <= prev_i)) lo = mid + 1;
        else hi = mid;
      }
      if (lo == k) continue;
      const float cd = sd[lo];
      if (!(cd < BIG)) continue;
      const int ci = si[lo];
      if (cd < bd || (cd == bd && ci < bi)) {
        bd = cd;
        bi = ci;
      }
    }
    if (!(bd < BIG)) break;
    out_d[(size_t)qi * k + t] = bd;
    out_i[(size_t)qi * k + t] = bi;
    prev_d = bd;
    prev_i = bi;
  }
  for (; t < k; ++t) {
    out_d[(size_t)qi * k + t] = BIG;
    out_i[(size_t)qi * k + t] = -1;
  }
}

}  // namespace favor
