// Product-quantization ADC kernels: the compressed brute route's fused scan
// (pq_adc_topr) and the compressed graph route's neighbour scoring
// (pq_adc_gather).
//
// Replaces the TPU kernels src/repro/kernels/pq_adc/kernel.py:
// pq_adc_pallas (body _kernel) and pq_adc_gather_pallas (body
// _gather_kernel).  Those express each LUT lookup as a one-hot matmul,
// because TPU Pallas has no in-kernel gather; on Hopper a lookup is a plain
// load, so neither kernel carries that over.
//
// ADC sum: an entry's squared distance is the sum of its M table entries,
// taken in subspace order from 0.0f with __fadd_rn (nothing contracted, no
// fast math).  The Pallas kernels' one-hot products are exact, so they
// accumulate exactly that sequence: kernel, plain version and the Pallas
// interpret mode agree bit for bit.
//
// pq_adc_topr -- what bounds it on an H100: operations.  B*N*M table adds
// against N*M code bytes read once (favor-anns: 1024 x 4M x 32 = 1.3e11 adds
// against 128 MB); the shared-memory lookups, one per add, are the
// practical ceiling of this design (~32 a clock per SM with no bank
// conflict).  Design:
//  * one block per (query tile of QT queries, DB split); the tile's LUTs
//    are staged in shared memory as f32 (bf16 tables are widened on the
//    way), QT*M*K*4 bytes -- 32 KB a query at favor-anns widths, so the
//    wrapper picks QT for two blocks per SM (QT = 3 there).  When one
//    query's table does not fit beside its list (f32 at K = 256 and
//    M >~ 220) the wrapper hands f32 tables and lut_global = 1, and the
//    lookups read global memory (L2) instead: the same entries summed in
//    the same order, so the same bits;
//  * each thread takes one row of a 256-row tile, reads its code row as
//    32-bit words (kept in registers) and sums each query's M lookups.
//    Layout: query q's table at q*M*K, subspace m's K entries contiguous.
//    At any one lookup the lanes of a warp read the same query's same
//    subspace table at their rows' codes, so the query stride never maps
//    lanes onto one bank; the codes are random, so the bank pattern is
//    random (a few lanes per bank at worst);
//  * a (query, row) pair is a candidate only when its sum is below the
//    query's current R-th distance (strict: rows come in increasing id, an
//    equal distance never displaces an earlier row) and, when the wrapper
//    gives a per-query lower bound (after_d, after_i), when its (sum, id)
//    comes strictly after it -- how the wrapper chains passes of RMAX for
//    a longer R (kernels/_common.py chain_topk); the filter program is
//    evaluated for candidates only, and they are appended to a per-query
//    shared-memory buffer (R = rerank * k is 80 at favor-anns: too long for
//    a per-thread register list);
//  * after the tile, the block merges each query's buffer into its sorted
//    (distance, id) top-R list in shared memory by ranks: every element's
//    new slot is its own rank plus its rank in the other sorted run;
//  * pad rows (norm +inf or >= BIG, as prefbf.pad_db writes them) are gated
//    as at kernel.py:73; a second kernel (topk_merge.cuh) merges the
//    splits' lists per query.
//
// pq_adc_gather -- what bounds it: bytes, a few MB of scattered code rows,
// LUT entries and ids; at the graph route's shapes launch latency
// dominates.  One thread per (query, neighbour) reads the neighbour's code
// row and sums its M entries of that query's LUT straight from global
// memory (a 1024-query batch of bf16 tables is 16 MB: L2-resident).  The
// TPU kernel's bq-fold redundant scoring of every staged row against every
// query of its tile is dropped.  In filter mode the same thread evaluates
// the query's filter program on the neighbour's attributes (the TD bit)
// and writes dbar = sqrt(max(adc2, 0)) + D * (1 - td) (Eq. 2), the function
// the JAX traversal computes around the TPU kernel; an id < 0 gives BIG
// and td = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "filter_program.cuh"
#include "topk_merge.cuh"

namespace {

using favor::BIG;

constexpr int TPB = 256;     // threads per scan block = rows per tile
constexpr int QTMAX = 8;     // queries per scan block, at most
constexpr int RMAX = 1024;   // longest top-R list
constexpr int MW = 16;       // code words held in registers (M <= 64)

__device__ __forceinline__ float lut_at(const void* luts, int bf16,
                                        size_t idx) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(luts)[idx])
              : reinterpret_cast<const float*>(luts)[idx];
}

// (a.d, a.i) < (b.d, b.i)
__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Sum of query table `lq` over the row's codes, in subspace order.  Words
// holds the row's codes as 32-bit words when M % 4 == 0 and M <= 4 * MW;
// otherwise the bytes are read from `crow`.
__device__ __forceinline__ float adc_sum(const float* lq, int M, int K,
                                         bool packed, const uint32_t* words,
                                         const uint8_t* crow) {
  float acc = 0.f;
  if (packed) {
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (4 * w < M) {
        const uint32_t cw = words[w];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc = __fadd_rn(acc,
                          lq[(4 * w + t) * K + ((cw >> (8 * t)) & 255u)]);
      }
    }
  } else {
    for (int m = 0; m < M; ++m) acc = __fadd_rn(acc, lq[m * K + crow[m]]);
  }
  return acc;
}

template <bool LUT_GLOBAL>
__global__ void __launch_bounds__(TPB) pq_scan(
    const void* __restrict__ luts, int lut_bf16,
    const uint8_t* __restrict__ codes, const float* __restrict__ norms,
    const int* __restrict__ ints, const float* __restrict__ floats,
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi,
    const float* __restrict__ after_d, const int* __restrict__ after_i,
    int B, int N, int M, int K, int mi, int mf, int W, int R, int QT,
    int rows_per_split, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  const int mk = M * K;
  // QT * M * K staged f32 tables, or none when they stay in global memory
  float* lut = reinterpret_cast<float*>(smem4);
  const float* glut =
      reinterpret_cast<const float*>(luts) + (size_t)blockIdx.x * QT * mk;
  float* ld = lut + (LUT_GLOBAL ? 0 : (size_t)QT * mk);  // 2 * QT * R
  int* li = reinterpret_cast<int*>(ld + 2 * QT * R);   // 2 * QT * R
  float* cd = reinterpret_cast<float*>(li + 2 * QT * R);  // QT * TPB
  int* ci = reinterpret_cast<int*>(cd + QT * TPB);         // QT * TPB
  __shared__ int cnt[QTMAX], cur[QTMAX], aft_i[QTMAX];
  __shared__ float thr[QTMAX], aft_d[QTMAX];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, B - q0);
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);
  const bool packed = (M & 3) == 0 && M <= 4 * MW;

  if (!LUT_GLOBAL)
    for (int e = tid; e < nq * mk; e += TPB)
      lut[e] = lut_at(luts, lut_bf16, (size_t)q0 * mk + e);
  for (int e = tid; e < 2 * QT * R; e += TPB) {
    ld[e] = BIG;
    li[e] = -1;
  }
  if (tid < QTMAX) {
    cnt[tid] = 0;
    cur[tid] = 0;
    thr[tid] = tid < nq ? BIG : -INFINITY;
    const bool lb = after_d != nullptr && tid < nq;
    aft_d[tid] = lb ? after_d[q0 + tid] : -INFINITY;
    aft_i[tid] = lb ? after_i[q0 + tid] : -1;
  }
  __syncthreads();

  for (int base = row0; base < row1; base += TPB) {
    const int row = base + tid;
    if (row < row1 && norms[row] < BIG) {  // pad rows never score
      const uint8_t* crow = codes + (size_t)row * M;
      uint32_t words[MW];
      if (packed) {
        const uint32_t* c4 = reinterpret_cast<const uint32_t*>(crow);
#pragma unroll
        for (int w = 0; w < MW; ++w)
          if (4 * w < M) words[w] = __ldg(c4 + w);
      }
      for (int q = 0; q < nq; ++q) {
        const float acc = adc_sum((LUT_GLOBAL ? glut : lut) + (size_t)q * mk,
                                  M, K, packed, words, crow);
        if (!(acc < thr[q])) continue;
        if (!before(aft_d[q], aft_i[q], acc, row)) continue;
        const int qi = q0 + q;
        if (!favor::eval_row(valid + (size_t)qi * W,
                             imask + (size_t)qi * W * mi,
                             flo + (size_t)qi * W * mf,
                             fhi + (size_t)qi * W * mf, W, mi, mf,
                             ints + (size_t)row * mi,
                             floats + (size_t)row * mf))
          continue;
        const int pos = atomicAdd(&cnt[q], 1);
        cd[q * TPB + pos] = acc;
        ci[q * TPB + pos] = row;
      }
    }
    __syncthreads();
    bool any = false;
    for (int q = 0; q < nq; ++q) any |= cnt[q] > 0;
    // every thread has read the counts before any of them appends to the
    // next tile's buffers: without it a fast warp's atomicAdd could reach a
    // slow warp still reading, and the warps would part ways here
    __syncthreads();
    if (!any) continue;  // uniform: every thread read the same counts

    for (int q = 0; q < nq; ++q) {
      const int c = cnt[q];
      if (c == 0) continue;
      const float* od = ld + (cur[q] * QT + q) * R;
      const int* oi = li + (cur[q] * QT + q) * R;
      float* nd = ld + ((cur[q] ^ 1) * QT + q) * R;
      int* ni = li + ((cur[q] ^ 1) * QT + q) * R;
      const float* bd = cd + q * TPB;
      const int* bi = ci + q * TPB;
      for (int e = tid; e < R + c; e += TPB) {
        float kd;
        int ki, pos = 0;
        if (e < R) {  // list entry: its index + candidates before it
          kd = od[e];
          ki = oi[e];
          pos = e;
          for (int j = 0; j < c; ++j) pos += before(bd[j], bi[j], kd, ki);
        } else {      // candidate: list entries before it + candidates
          kd = bd[e - R];
          ki = bi[e - R];
          int lo = 0, hi = R;  // lower bound in the sorted list
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (before(od[mid], oi[mid], kd, ki)) lo = mid + 1;
            else hi = mid;
          }
          pos = lo;
          for (int j = 0; j < c; ++j) pos += before(bd[j], bi[j], kd, ki);
        }
        if (pos < R) {
          nd[pos] = kd;
          ni[pos] = ki;
        }
      }
    }
    __syncthreads();
    if (tid < nq && cnt[tid] > 0) {
      cur[tid] ^= 1;
      thr[tid] = ld[(cur[tid] * QT + tid) * R + R - 1];
      cnt[tid] = 0;
    }
    __syncthreads();
  }

  for (int q = 0; q < nq; ++q) {
    const size_t off = ((size_t)(q0 + q) * gridDim.y + split) * R;
    const float* od = ld + (cur[q] * QT + q) * R;
    const int* oi = li + (cur[q] * QT + q) * R;
    for (int t = tid; t < R; t += TPB) {
      part_d[off + t] = od[t];
      part_i[off + t] = oi[t];
    }
  }
}

__global__ void __launch_bounds__(256) pq_gather(
    const int* __restrict__ ids, const void* __restrict__ luts, int lut_bf16,
    const uint8_t* __restrict__ codes, const int* __restrict__ ints,
    const float* __restrict__ floats, const float* __restrict__ valid,
    const long long* __restrict__ imask, const float* __restrict__ flo,
    const float* __restrict__ fhi, const float* __restrict__ dvec, int B,
    int M0, int M, int K, int mi, int mf, int W, int filter,
    float* __restrict__ out_d, int* __restrict__ out_td) {
  const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= (long long)B * M0) return;
  const int b = (int)(pair / M0);
  const int id = ids[pair];
  if (id < 0) {
    out_d[pair] = BIG;
    if (filter) out_td[pair] = 0;
    return;
  }
  const uint8_t* crow = codes + (size_t)id * M;
  const size_t lb = (size_t)b * M * K;
  float acc = 0.f;
  if ((M & 3) == 0) {
    const uint32_t* c4 = reinterpret_cast<const uint32_t*>(crow);
    for (int w = 0; w < (M >> 2); ++w) {
      const uint32_t cw = __ldg(c4 + w);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        acc = __fadd_rn(acc, lut_at(luts, lut_bf16,
                                    lb + (size_t)(4 * w + t) * K +
                                        ((cw >> (8 * t)) & 255u)));
    }
  } else {
    for (int m = 0; m < M; ++m)
      acc = __fadd_rn(acc, lut_at(luts, lut_bf16,
                                  lb + (size_t)m * K + crow[m]));
  }
  if (!filter) {
    out_d[pair] = acc;
    return;
  }
  const float dist = sqrtf(fmaxf(acc, 0.f));
  const bool td = favor::eval_row(
      valid + (size_t)b * W, imask + (size_t)b * W * mi,
      flo + (size_t)b * W * mf, fhi + (size_t)b * W * mf, W, mi, mf,
      ints + (size_t)id * mi, floats + (size_t)id * mf);
  out_d[pair] = td ? dist : __fadd_rn(dist, dvec[b]);
  out_td[pair] = td ? 1 : 0;
}

}  // namespace

extern "C" {

int pq_adc_max_r() { return RMAX; }
int pq_adc_max_qt() { return QTMAX; }
int pq_adc_tile_rows() { return TPB; }

size_t pq_adc_topr_smem_bytes(int M, int K, int R, int QT, int lut_global) {
  return sizeof(float) * (lut_global ? 0 : (size_t)QT * M * K) +
         (sizeof(float) + sizeof(int)) * ((size_t)2 * QT * R +
                                          (size_t)QT * TPB);
}

// luts (B, M*K) f32 or bf16 (lut_bf16; f32 when lut_global, which reads
// them from global memory instead of staging them); codes (N, M) uint8;
// after_d / after_i: (B,) per-query lower bound, or both null; part_d /
// part_i: (B, splits, R) scratch; out_d / out_i: (B, R).
// Returns cudaGetLastError() after the launches (0 = launched).
int pq_adc_topr_launch(const void* luts, int lut_bf16, int lut_global,
                       const void* codes, const void* norms, const void* ints,
                       const void* floats, const void* valid,
                       const void* imask, const void* flo, const void* fhi,
                       const void* after_d, const void* after_i, int B, int N,
                       int M, int K, int mi, int mf, int W, int R, int QT,
                       int splits, void* part_d, void* part_i, void* out_d,
                       void* out_i, void* stream) {
  const size_t smem = pq_adc_topr_smem_bytes(M, K, R, QT, lut_global);
  auto kern = lut_global ? pq_scan<true> : pq_scan<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = (N + splits - 1) / splits;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((B + QT - 1) / QT, splits);
  kern<<<grid, TPB, smem, st>>>(
      luts, lut_bf16, static_cast<const uint8_t*>(codes),
      static_cast<const float*>(norms), static_cast<const int*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(valid),
      static_cast<const long long*>(imask), static_cast<const float*>(flo),
      static_cast<const float*>(fhi), static_cast<const float*>(after_d),
      static_cast<const int*>(after_i), B, N, M, K, mi, mf, W, R, QT,
      rows_per_split, static_cast<float*>(part_d), static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  favor::merge_splits<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      splits, R, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// ids (B, M0) int32; luts (B, M*K) f32 or bf16; codes (N, M) uint8.
// filter = 0: out_d = adc2 (BIG at id < 0); filter = 1: out_d = dbar and
// out_td = TD bit (int32).  Returns cudaGetLastError() after the launch.
int pq_adc_gather_launch(const void* ids, const void* luts, int lut_bf16,
                         const void* codes, const void* ints,
                         const void* floats, const void* valid,
                         const void* imask, const void* flo, const void* fhi,
                         const void* dvec, int B, int M0, int M, int K, int mi,
                         int mf, int W, int filter, void* out_d, void* out_td,
                         void* stream) {
  const long long pairs = (long long)B * M0;
  const unsigned blocks = (unsigned)((pairs + 255) / 256);
  pq_gather<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), luts, lut_bf16,
      static_cast<const uint8_t*>(codes), static_cast<const int*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(valid),
      static_cast<const long long*>(imask), static_cast<const float*>(flo),
      static_cast<const float*>(fhi), static_cast<const float*>(dvec), B, M0,
      M, K, mi, mf, W, filter, static_cast<float*>(out_d),
      static_cast<int*>(out_td));
  return (int)cudaGetLastError();
}

}  // extern "C"
