// Graph-expansion distances: for each (query, neighbour id) pair, gather the
// DB row, take the L2 distance, evaluate the query's filter program on the
// row's attributes (TD bit) and compose the exclusion distance
// dbar = d + D * (1 - td) (Eq. 2).  The wrapper's epilogue is done here too:
// an id < 0, a dbar >= BIG and a query the lane mask turns off give +inf
// (td = 0 for the first and the last), and the TD bit is written as one
// byte (a torch.bool).
//
// Replaces the TPU kernel src/repro/kernels/gather_distance/kernel.py:
// gather_distance_pallas (body _kernel, helper _eval_row).
//
// What bounds it on an H100: bytes.  Each pair reads one scattered d-float
// row (512 bytes at d = 128) for 2*d operations -- 0.5 operations per byte,
// far below the card's f32 ridge point -- so the gather's memory traffic is
// the whole cost, and what keeps a kernel from it is latency: each round
// trip to device memory that waits on another (id -> row -> norm and
// attributes -> program) costs about a microsecond, against ~5 us for all
// the bytes of a 1024 x 32 batch, and a batch that needs two waves of
// blocks pays the chain twice.
//
// Design: one warp per query (per QPB queries when M is small), lane j for
// neighbour j, so a block needs no barrier and a 1024 x 32 batch is one wave
// of blocks (~18 KB of shared memory each, 12 per SM):
//  * lane j loads id j (one coalesced load), then issues the bulk
//    asynchronous copy (cp.async.bulk ... mbarrier::complete_tx) of its
//    row into shared memory, lanes j < QPB the copy of query j's vector,
//    all completing on one mbarrier: every row of the query is in flight at
//    once and holds no register;
//  * meanwhile the warp stages the queries' filter programs (valid, imask,
//    flo, fhi of W disjuncts), D and lane-mask bits in shared memory, and
//    lane j fetches its row's norm and attribute row and evaluates the
//    filter with favor::eval_row on the program in shared memory;
//  * then lane j takes its own pair's dot from shared memory (rows padded by
//    16 bytes, so the 32 lanes' 16-byte reads fall in distinct banks), and
//    writes its own dbar and TD byte;
//  * same bits as before the redesign: the old kernel's lane c accumulated
//    float4 chunk c, then c + 32, ... with fmaf in x, y, z, w order, and the
//    warp reduced with xor shuffles at offsets 16, 8, 4, 2, 1.  Lane j now
//    computes those 32 partial sums itself and adds them in the shuffle
//    tree's order (tree_sum), which gives lane 0's result bit for bit;
//    |q|^2 is taken once per query by the warp, as before; then
//    favor::l2_from_dot and one f32 add of D.  So a
//    pair's distance does not depend on the batch width or on its block
//    mates (bucket padding and lane compaction rely on that,
//    src/repro/core/scoring.py:46-60).
// A row width d that is not a multiple of 4 floats cannot be bulk-copied
// (rows are not 16-byte aligned), and rows wider than ~1,700 floats do not
// fit a block's shared memory 32 at a time: lane j then reads its row from
// device memory, in the same order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "filter_program.cuh"

namespace {

using favor::BIG;

constexpr int LANES = 32;    // pairs per tile: one warp, one lane each
constexpr int QMAX = 8;      // queries per block, at most (M small)
constexpr int ROW_PAD = 4;   // floats after each staged row (bank spread)

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of one block, byte offsets: the mbarrier, the tile's rows
// (bulk path), the queries' vectors, programs, D and lane-mask bits, and
// each lane's attribute row.
struct Layout {
  size_t bar, rows, q, imask, valid, flo, fhi, dv, ri, rf, ok, bytes;
  int stride;  // floats from one staged row (or query vector) to the next
};

__host__ __device__ inline Layout make_layout(int QPB, int d, int W, int mi,
                                              int mf, bool stage) {
  Layout L;
  L.stride = (d & 3) == 0 ? d + ROW_PAD : d;
  size_t o = 0;
  L.bar = o;
  o += 16;
  L.rows = o;
  o += stage ? (size_t)4 * LANES * L.stride : 0;
  L.q = o;
  o = align16(o + (size_t)4 * QPB * L.stride);
  L.imask = o;
  o += (size_t)8 * QPB * W * mi;
  L.valid = o;
  o += (size_t)4 * QPB * W;
  L.flo = o;
  o += (size_t)4 * QPB * W * mf;
  L.fhi = o;
  o += (size_t)4 * QPB * W * mf;
  L.dv = o;
  o += (size_t)4 * QPB;
  L.ri = o;
  o += (size_t)4 * LANES * mi;
  L.rf = o;
  o += (size_t)4 * LANES * mf;
  L.ok = o;
  o += (size_t)QPB;
  L.bytes = align16(o);
  return L;
}

// -- Hopper bulk copies completing on an mbarrier --------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a phase, expecting ``bytes`` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One level of a warp's xor-shuffle reduction, in one thread.
template <int OFF>
__device__ __forceinline__ void tree_level(float (&p)[LANES]) {
#pragma unroll
  for (int l = 0; l < OFF; ++l) p[l] += p[l + OFF];
}

// The sum a warp's xor-shuffle reduction at offsets 16, 8, 4, 2, 1 leaves in
// every lane, from the lanes' values p[0..31], in one thread: each level
// adds the same two operands as the shuffle step (f32 addition commutes).
__device__ __forceinline__ float tree_sum(float (&p)[LANES]) {
  tree_level<16>(p);
  tree_level<8>(p);
  tree_level<4>(p);
  tree_level<2>(p);
  tree_level<1>(p);
  return p[0];
}

// |q|^2 of the query vector a (shared memory) as the old kernel's warp took
// it: lane c's fmaf chain over chunks c, c + 32, ..., then the shuffles.
template <bool VEC4>
__device__ __forceinline__ float warp_sq_norm(const float* a, int d,
                                              int lane) {
  float acc = 0.f;
  if constexpr (VEC4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    for (int c = lane; c < (d >> 2); c += LANES) {
      const float4 x = a4[c];
      acc = fmaf(x.x, x.x, acc);
      acc = fmaf(x.y, x.y, acc);
      acc = fmaf(x.z, x.z, acc);
      acc = fmaf(x.w, x.w, acc);
    }
  } else {
    for (int c = lane; c < d; c += LANES) acc = fmaf(a[c], a[c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// sum_k a[k] * b[k] over d floats as the old kernel's warp took it: lane c
// owned chunks c, c + 32, ... (float4 when vec4, else single floats), each an
// fmaf chain; then the shuffle tree.
template <bool VEC4>
__device__ __forceinline__ float warp_order_dot(const float* a,
                                                const float* b, int d) {
  float p[LANES];
#pragma unroll
  for (int c = 0; c < LANES; ++c) p[c] = 0.f;
  if constexpr (VEC4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int nc = d >> 2;
    for (int k0 = 0; k0 < nc; k0 += LANES) {
#pragma unroll
      for (int c = 0; c < LANES; ++c) {
        if (k0 + c < nc) {
          const float4 x = a4[k0 + c], y = b4[k0 + c];
          p[c] = fmaf(x.x, y.x, p[c]);
          p[c] = fmaf(x.y, y.y, p[c]);
          p[c] = fmaf(x.z, y.z, p[c]);
          p[c] = fmaf(x.w, y.w, p[c]);
        }
      }
    }
  } else {
    for (int k0 = 0; k0 < d; k0 += LANES) {
#pragma unroll
      for (int c = 0; c < LANES; ++c)
        if (k0 + c < d) p[c] = fmaf(a[k0 + c], b[k0 + c], p[c]);
    }
  }
  return tree_sum(p);
}

template <typename IdT>
__device__ __forceinline__ int load_id(const IdT* ids, size_t at) {
  const long long v = (long long)ids[at];
  return v < 0 ? -1 : (int)v;
}

// VEC4: d % 4 == 0 (float4 arithmetic, query vectors bulk-copied); STAGE:
// rows bulk-copied into shared memory too.
template <bool VEC4, bool STAGE, typename IdT>
__global__ void __launch_bounds__(LANES) gd_kernel(
    const IdT* __restrict__ ids, const float* __restrict__ q,
    const float* __restrict__ vec, const float* __restrict__ norms,
    const int* __restrict__ ints, const float* __restrict__ floats,
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi,
    const float* __restrict__ dvec, const uint8_t* __restrict__ lane_ok,
    int B, int M, int d, int mi, int mf, int W, int QPB, Layout L,
    float* __restrict__ out_d, uint8_t* __restrict__ out_td) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  float* s_rows = reinterpret_cast<float*>(smem + L.rows);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  long long* s_imask = reinterpret_cast<long long*>(smem + L.imask);
  float* s_valid = reinterpret_cast<float*>(smem + L.valid);
  float* s_flo = reinterpret_cast<float*>(smem + L.flo);
  float* s_fhi = reinterpret_cast<float*>(smem + L.fhi);
  float* s_dv = reinterpret_cast<float*>(smem + L.dv);
  int* s_ri = reinterpret_cast<int*>(smem + L.ri);
  float* s_rf = reinterpret_cast<float*>(smem + L.rf);
  uint8_t* s_ok = smem + L.ok;

  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * QPB;
  const int nq = min(QPB, B - b0);
  const int pairs = nq * M;
  const size_t pair0 = (size_t)b0 * M;   // first pair of the block
  const int S = L.stride;
  const uint32_t row_bytes = 4u * d;

  if (VEC4 && lane == 0) mbar_init(s_bar);
  int id = lane < pairs ? load_id(ids, pair0 + lane) : -1;
  // -- the queries' vectors: bulk copies (VEC4), else lane-strided loads --
  if constexpr (!VEC4) {
    for (int i = lane; i < nq * d; i += LANES)
      s_q[i] = q[(size_t)b0 * d + i];
  }
  // -- programs, D, lane-mask bits (read by every lane of their query) ----
#pragma unroll 4
  for (int i = lane; i < nq * W; i += LANES)
    s_valid[i] = valid[(size_t)b0 * W + i];
#pragma unroll 4
  for (int i = lane; i < nq * W * mi; i += LANES)
    s_imask[i] = imask[(size_t)b0 * W * mi + i];
#pragma unroll 4
  for (int i = lane; i < nq * W * mf; i += LANES) {
    s_flo[i] = flo[(size_t)b0 * W * mf + i];
    s_fhi[i] = fhi[(size_t)b0 * W * mf + i];
  }
  if (lane < nq) {
    s_dv[lane] = dvec[b0 + lane];
    s_ok[lane] = lane_ok == nullptr ? 1 : lane_ok[b0 + lane];
  }

  float qq = 0.f;  // |q|^2 of this lane's query
  for (int t0 = 0; t0 < pairs; t0 += LANES) {
    if (t0 > 0) {
      id = t0 + lane < pairs ? load_id(ids, pair0 + t0 + lane) : -1;
      if constexpr (STAGE)  // this lane's slot was read by this lane only
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    const int p = t0 + lane;
    const int qi = min(p / M, nq - 1);
    // -- every row of the tile (and, first, every query) in flight --------
    if constexpr (VEC4) {
      const unsigned live = STAGE ? __ballot_sync(0xffffffffu, id >= 0) : 0u;
      const int nvec = t0 == 0 ? nq : 0;
      if (lane == 0) mbar_expect(s_bar, row_bytes * (__popc(live) + nvec));
      __syncwarp();
      if (lane < nvec)
        bulk_copy(s_q + (size_t)lane * S, q + (size_t)(b0 + lane) * d,
                  row_bytes, s_bar);
      if (STAGE && id >= 0)
        bulk_copy(s_rows + (size_t)lane * S, vec + (size_t)id * d, row_bytes,
                  s_bar);
    }
    // -- meanwhile: norm, attributes and the filter of this lane's pair ----
    float nrm = 0.f;
    int td = 0;
    if (id >= 0) {
      nrm = __ldg(norms + id);
      for (int c = 0; c < mi; ++c)
        s_ri[lane * mi + c] = __ldg(ints + (size_t)id * mi + c);
      for (int c = 0; c < mf; ++c)
        s_rf[lane * mf + c] = __ldg(floats + (size_t)id * mf + c);
    }
    __syncwarp();  // the staged programs (first tile)
    if (id >= 0)
      td = favor::eval_row(s_valid + qi * W, s_imask + (size_t)qi * W * mi,
                           s_flo + qi * W * mf, s_fhi + qi * W * mf, W, mi, mf,
                           s_ri + lane * mi, s_rf + lane * mf)
               ? 1 : 0;
    // -- the rows have landed: this lane's distance and output -------------
    if constexpr (VEC4) mbar_wait(s_bar, (uint32_t)((t0 / LANES) & 1));
    else __syncwarp();
    if (t0 == 0) {  // |q|^2 of each query, once, by the whole warp
      for (int j = 0; j < nq; ++j) {
        const float v = warp_sq_norm<VEC4>(s_q + (size_t)j * S, d, lane);
        if (j == qi) qq = v;
      }
    }
    if (p < pairs) {
      float out = INFINITY;
      if (id >= 0 && s_ok[qi]) {
        const float* qrow = s_q + (size_t)qi * S;
        const float* vrow =
            STAGE ? s_rows + (size_t)lane * S : vec + (size_t)id * d;
        const float dot = warp_order_dot<VEC4>(qrow, vrow, d);
        const float dist = favor::l2_from_dot(nrm, qq, dot);
        out = td ? dist : dist + s_dv[qi];
        if (out >= BIG) out = INFINITY;
      } else {
        td = 0;
      }
      out_d[pair0 + p] = out;
      out_td[pair0 + p] = (uint8_t)td;
    }
  }
}

// Queries per block: LANES / M (at least one, at most QMAX), then fewer
// until the block's state fits the default 48 KB of shared memory.
int queries_per_block(int B, int M, int d, int W, int mi, int mf,
                      bool stage) {
  int qpb = M >= LANES ? 1 : LANES / M;
  qpb = qpb < QMAX ? qpb : QMAX;
  qpb = qpb < B ? qpb : B;
  while (qpb > 1 && make_layout(qpb, d, W, mi, mf, stage).bytes > 48 * 1024)
    --qpb;
  return qpb < 1 ? 1 : qpb;
}

template <bool VEC4, bool STAGE, typename IdT>
int launch(const void* ids, const void* q, const void* vec, const void* norms,
           const void* ints, const void* floats, const void* valid,
           const void* imask, const void* flo, const void* fhi,
           const void* dvec, const void* lane_ok, int B, int M, int d, int mi,
           int mf, int W, void* out_d, void* out_td, cudaStream_t st) {
  const int qpb = queries_per_block(B, M, d, W, mi, mf, STAGE);
  const Layout L = make_layout(qpb, d, W, mi, mf, STAGE);
  if (L.bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(gd_kernel<VEC4, STAGE, IdT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((B + qpb - 1) / qpb);
  gd_kernel<VEC4, STAGE, IdT><<<blocks, LANES, L.bytes, st>>>(
      static_cast<const IdT*>(ids), static_cast<const float*>(q),
      static_cast<const float*>(vec), static_cast<const float*>(norms),
      static_cast<const int*>(ints), static_cast<const float*>(floats),
      static_cast<const float*>(valid), static_cast<const long long*>(imask),
      static_cast<const float*>(flo), static_cast<const float*>(fhi),
      static_cast<const float*>(dvec), static_cast<const uint8_t*>(lane_ok),
      B, M, d, mi, mf, W, qpb, L, static_cast<float*>(out_d),
      static_cast<uint8_t*>(out_td));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ids (B, M) int32 (ids64 = 0) or int64 (ids64 = 1); lane_ok (B,) uint8 or
// null; out_d (B, M) f32 (+inf at id < 0, at dbar >= BIG and on dead lanes);
// out_td (B, M) uint8.  Returns the first CUDA error of the launch (0 =
// launched).
int gather_distance_launch(const void* ids, int ids64, const void* q,
                           const void* vec, const void* norms,
                           const void* ints, const void* floats,
                           const void* valid, const void* imask,
                           const void* flo, const void* fhi, const void* dvec,
                           const void* lane_ok, int B, int M, int d, int mi,
                           int mf, int W, void* out_d, void* out_td,
                           void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec4 = (d & 3) == 0;
  bool stage = vec4;
  const size_t need = make_layout(1, d, W, mi, mf, true).bytes;
  if (stage && need > 48 * 1024) {  // only very wide rows ask the card
    int dev = 0, limit = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    stage = need <= (size_t)limit;
  }
  auto go = stage ? (ids64 ? &launch<true, true, long long>
                           : &launch<true, true, int>)
            : vec4 ? (ids64 ? &launch<true, false, long long>
                            : &launch<true, false, int>)
                   : (ids64 ? &launch<false, false, long long>
                            : &launch<false, false, int>);
  return go(ids, q, vec, norms, ints, floats, valid, imask, flo, fhi, dvec,
            lane_ok, B, M, d, mi, mf, W, out_d, out_td, st);
}

}  // extern "C"
