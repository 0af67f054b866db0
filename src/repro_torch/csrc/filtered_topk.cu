// Fused filtered brute-force top-k: L2 distance + DNF filter program +
// PreFBF mask (fail -> BIG) or exclusion distance (+D, Eq. 2) + running top-k.
//
// Replaces the TPU kernel src/repro/kernels/filtered_topk/kernel.py:
// filtered_topk_pallas (body _kernel, helpers _eval_program_tile and
// _topk_merge).
//
// What bounds it on an H100: operations.  Every (query, row) pair costs a
// d-long dot product, 2*B*N*d f32 operations against 4*N*d bytes read once,
// so at B = 1024 the scan sits far above the f32 ridge point of the card
// (about 20 operations per byte: 67 TFLOP/s over 3.35 TB/s).  No tensor
// cores in this version: the distances must stay IEEE f32 (TF32 keeps ~3
// digits and breaks the 1e-5 bar).
//
// Design:
//  * each thread owns QPT = 4 queries and the block's TPB = 64 threads own
//    256; all threads of a warp read the SAME shared-memory DB element at a
//    time, so every 16-byte shared-memory load is a broadcast that feeds
//    QPT * 4 = 16 FMAs per thread -- the FMA pipes, not shared memory, set
//    the pace;
//  * the block walks its DB split (gridDim.y splits, rows_per_split rows
//    each) in tiles of RT = 16 rows staged in shared memory; each thread
//    holds DC = 16 dims of its queries in registers at a time and
//    accumulates QPT x RT dot products in registers, each one FMA chain in
//    a fixed order over the dims;
//  * the queries come transposed, (d, B): a warp's 32 threads load one dim
//    of 32 consecutive queries from one 128-byte line, where the (B, d)
//    layout would touch 32 lines per load and starve the FMA pipes;
//  * a (query, row) pair is a candidate only when its distance beats the
//    query's current k-th (D >= 0 never lowers a distance): the unrolled
//    hot loop only flags candidates (a 64-bit mask, distances staged in
//    shared memory), and a short loop outside it evaluates the filter
//    program and inserts -- so the filter runs for few rows and the hot
//    loop keeps its accumulators in registers;
//  * each query's running top-k is kept ordered by (distance, id): rows
//    are visited in increasing id, an equal distance never displaces an
//    earlier row, which is the reference's lower-id tie rule;
//  * pad rows -- norm +inf or >= BIG, as prefbf.pad_db writes them -- and
//    rows past the split are gated explicitly and never returned, in both
//    modes (the reference kernel returns pad ids in exclusion mode);
//  * no block carries state into another: a second small kernel
//    (favor::merge_splits, topk_merge.cuh) merges the splits' lists per
//    query in the same (distance, id) order.
#include <cuda_runtime.h>
#include <math.h>

#include "filter_program.cuh"
#include "topk_merge.cuh"

namespace {

using favor::BIG;

constexpr int QPT = 4;              // queries per thread
constexpr int TPB = 64;             // threads per block
constexpr int QB = QPT * TPB;       // queries per block
constexpr int RT = 16;              // DB rows per shared-memory tile
constexpr int DC = 16;              // query dims held in registers at a time
constexpr int KMAX = 64;            // largest k the running lists hold
static_assert(QPT * RT <= 64, "candidate mask is 64 bits");

__device__ __forceinline__ void topk_insert(float* bd, int* bi, int k,
                                            float key, int id) {
  int j = k - 1;
  while (j > 0 && bd[j - 1] > key) {
    bd[j] = bd[j - 1];
    bi[j] = bi[j - 1];
    --j;
  }
  bd[j] = key;
  bi[j] = id;
}

// Query qq of this thread is query blockIdx.x * QB + qq * TPB + threadIdx.x:
// consecutive threads hold consecutive queries.
__global__ void __launch_bounds__(TPB) ft_scan(
    const float* __restrict__ qt, const float* __restrict__ vec,
    const float* __restrict__ norms, const int* __restrict__ ints,
    const float* __restrict__ floats, const float* __restrict__ valid,
    const long long* __restrict__ imask, const float* __restrict__ flo,
    const float* __restrict__ fhi, const float* __restrict__ dvec, int B,
    int N, int d, int dp, int mi, int mf, int W, int k, int exclude,
    int rows_per_split, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // RT * dp, zero padded
  float* ns = vs + RT * dp;                     // RT norms
  float* sd = ns + RT;                          // QPT * RT * TPB staged dists
  float* fs = sd + QPT * RT * TPB;              // RT * mf
  int* is = reinterpret_cast<int*>(fs + RT * mf);  // RT * mi

  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);

  int qid[QPT];
  bool live[QPT];
  float qn[QPT], D[QPT], worst[QPT];
#pragma unroll
  for (int qq = 0; qq < QPT; ++qq) {
    qid[qq] = blockIdx.x * QB + qq * TPB + tid;
    live[qq] = qid[qq] < B;
    const int qs = live[qq] ? qid[qq] : 0;
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const float x = __ldg(&qt[(size_t)j * B + qs]);
      s = fmaf(x, x, s);
    }
    qn[qq] = s;
    D[qq] = dvec[qs];
    worst[qq] = live[qq] ? BIG : -INFINITY;  // dead lanes take nothing
  }
  float best_d[QPT * KMAX];
  int best_i[QPT * KMAX];
  for (int t = 0; t < QPT * k; ++t) {
    best_d[t] = BIG;
    best_i[t] = -1;
  }

  for (int base = row0; base < row1; base += RT) {
    const int nrows = min(RT, row1 - base);
    __syncthreads();  // the previous tile is consumed
    if ((d & 3) == 0) {
      const int d4 = d >> 2, dp4 = dp >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(vec);
      for (int e = tid; e < RT * dp4; e += TPB) {
        const int r = e / dp4, c = e - r * dp4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < nrows && c < d4) v = __ldg(&g4[(size_t)(base + r) * d4 + c]);
        smem4[e] = v;
      }
    } else {
      for (int e = tid; e < RT * dp; e += TPB) {
        const int r = e / dp, c = e - r * dp;
        vs[e] = (r < nrows && c < d) ? __ldg(&vec[(size_t)(base + r) * d + c])
                                     : 0.f;
      }
    }
    for (int r = tid; r < RT; r += TPB) {
      const bool in = r < nrows;
      ns[r] = in ? norms[base + r] : INFINITY;
      for (int c = 0; c < mf; ++c)
        fs[r * mf + c] = in ? floats[(size_t)(base + r) * mf + c] : NAN;
      for (int c = 0; c < mi; ++c)
        is[r * mi + c] = in ? ints[(size_t)(base + r) * mi + c] : -1;
    }
    __syncthreads();

    float acc[QPT][RT];
#pragma unroll
    for (int qq = 0; qq < QPT; ++qq)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[qq][r] = 0.f;
    for (int c0 = 0; c0 < dp; c0 += DC) {
      float qr[QPT][DC];
#pragma unroll
      for (int qq = 0; qq < QPT; ++qq) {
        const int qs = live[qq] ? qid[qq] : 0;
#pragma unroll
        for (int j = 0; j < DC; ++j)
          qr[qq][j] =
              (c0 + j < d) ? __ldg(&qt[(size_t)(c0 + j) * B + qs]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4* row4 = reinterpret_cast<const float4*>(vs + r * dp + c0);
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
          const float4 v = row4[j];
#pragma unroll
          for (int qq = 0; qq < QPT; ++qq) {
            acc[qq][r] = fmaf(qr[qq][4 * j + 0], v.x, acc[qq][r]);
            acc[qq][r] = fmaf(qr[qq][4 * j + 1], v.y, acc[qq][r]);
            acc[qq][r] = fmaf(qr[qq][4 * j + 2], v.z, acc[qq][r]);
            acc[qq][r] = fmaf(qr[qq][4 * j + 3], v.w, acc[qq][r]);
          }
        }
      }
    }

    // flag candidates; stage their distances (slot-major: conflict-free)
    unsigned long long cand = 0ull;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float vn = ns[r];
      if (!(vn < BIG)) continue;  // pad row or past the split: never a result
#pragma unroll
      for (int qq = 0; qq < QPT; ++qq) {
        const float dist = favor::l2_from_dot(vn, qn[qq], acc[qq][r]);
        if (dist < worst[qq] || (live[qq] && D[qq] < 0.f)) {
          sd[(qq * RT + r) * TPB + tid] = dist;
          cand |= 1ull << (qq * RT + r);
        }
      }
    }
    while (cand) {
      const int slot = __ffsll((long long)cand) - 1;
      cand &= cand - 1;
      const int qq = slot / RT, r = slot - qq * RT;
      float w = BIG, Dq = 0.f;
      int qi = 0;
#pragma unroll
      for (int t = 0; t < QPT; ++t)
        if (t == qq) {
          w = worst[t];
          Dq = D[t];
          qi = qid[t];
        }
      const float dist = sd[slot * TPB + tid];
      if (!(dist < w) && Dq >= 0.f) continue;
      const bool pass = favor::eval_row(
          valid + (size_t)qi * W, imask + (size_t)qi * W * mi,
          flo + (size_t)qi * W * mf, fhi + (size_t)qi * W * mf, W, mi, mf,
          is + r * mi, fs + r * mf);
      float key;
      if (exclude) {
        key = pass ? dist : dist + Dq;
      } else {
        if (!pass) continue;
        key = dist;
      }
      key = fminf(key, BIG);
      if (!(key < w)) continue;
      topk_insert(best_d + qq * k, best_i + qq * k, k, key, base + r);
      w = best_d[qq * k + k - 1];
#pragma unroll
      for (int t = 0; t < QPT; ++t)
        if (t == qq) worst[t] = w;
    }
  }

#pragma unroll
  for (int qq = 0; qq < QPT; ++qq) {
    if (!live[qq]) continue;
    const size_t off = ((size_t)qid[qq] * gridDim.y + split) * k;
    for (int t = 0; t < k; ++t) {
      part_d[off + t] = best_d[qq * k + t];
      part_i[off + t] = best_i[qq * k + t];
    }
  }
}

}  // namespace

extern "C" {

int filtered_topk_max_k() { return KMAX; }

size_t filtered_topk_smem_bytes(int d, int mi, int mf) {
  const int dp = (d + DC - 1) / DC * DC;
  return sizeof(float) * ((size_t)RT * dp + RT + (size_t)QPT * RT * TPB +
                          (size_t)RT * mf) +
         sizeof(int) * (size_t)RT * mi;
}

// qt: the queries transposed, (d, B); part_d / part_i: (B, splits, k)
// scratch; out_d / out_i: (B, k).
// Returns cudaGetLastError() after the launches (0 = launched).
int filtered_topk_launch(const void* qt, const void* vec, const void* norms,
                         const void* ints, const void* floats,
                         const void* valid, const void* imask, const void* flo,
                         const void* fhi, const void* dvec, int B, int N, int d,
                         int mi, int mf, int W, int k, int exclude, int splits,
                         void* part_d, void* part_i, void* out_d, void* out_i,
                         void* stream) {
  const int dp = (d + DC - 1) / DC * DC;
  const size_t smem = filtered_topk_smem_bytes(d, mi, mf);
  cudaError_t err = cudaFuncSetAttribute(
      ft_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = (N + splits - 1) / splits;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((B + QB - 1) / QB, splits);
  ft_scan<<<grid, TPB, smem, st>>>(
      static_cast<const float*>(qt), static_cast<const float*>(vec),
      static_cast<const float*>(norms), static_cast<const int*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(valid),
      static_cast<const long long*>(imask), static_cast<const float*>(flo),
      static_cast<const float*>(fhi), static_cast<const float*>(dvec), B, N, d,
      dp, mi, mf, W, k, exclude, rows_per_split, static_cast<float*>(part_d),
      static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  favor::merge_splits<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      splits, k, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
