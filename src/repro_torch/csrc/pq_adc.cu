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
// fast math; adc_exact below).  The Pallas kernels' one-hot products are
// exact, so they accumulate exactly that sequence: kernel, plain version and
// the Pallas interpret mode agree bit for bit.  Codes are taken to be < K
// (as quant.encode writes them).
//
// pq_adc_topr -- what bounds it on an H100: operations.  B*N*M table
// lookups and adds against N*M code bytes (favor-anns: 1024 x 4M x 32 =
// 1.3e11 against 128 MB).  Done as one f32 add each from an f32 table in
// shared memory, the lookups alone cap it near 60 ms (one 4-byte load per
// lookup, random banks); this kernel screens every pair with an 8-bit copy
// of the tables, 16 queries per 16-byte shared-memory load, and computes the
// exact f32 sum only for the few pairs the screen cannot rule out.  No
// returned number passes through the 8-bit tables.
//
// The screen.  Per query, subspace m of M and code c < K, with the table
// entry x = lut[m][c] (bf16 tables widened to f32 exactly):
//   lo_m = min_c lut[m][c];  L = min(255, floor(32767 / M)) levels;
//   D = ru(max_m ru(hi_m - lo_m) / L), or 1 when every table is flat
//     (hi_m = max_c lut[m][c]; D > 0 always);
//   q[m][c] = min(L, floor(rd(rd(x - lo_m) / D)))    (an integer in 0..L),
// with rd / ru rounding down / up.  Every rounding goes down, so
// D * q[m][c] <= x - lo_m in real arithmetic.  For a row with codes c_m,
// Q = sum_m q[m][c_m] is an exact integer <= L * M <= 32767, and the real
// sum S = sum_m x_m >= sum_m lo_m + D * Q.  The exact key the kernel
// returns is the chain k = fl(..fl(fl(0 + x_1) + x_2).. + x_M), within
// gamma_{M-1} * sum_m |x_m| of S (recursive summation: gamma_n =
// n u / (1 - n u), u = 2^-24), and sum_m |x_m| <= A = sum_m max_c |x|.
// With Slo = sum_m lo_m summed rounding down, E = ru(ru(gamma_{M-1}) * A)
// (A summed rounding up) and
//   lb(Q) = rd(rd(D * Q + Slo) - E)               (one fma, one sub),
// lb(Q) <= sum lo_m + D Q - gamma A <= S - gamma A <= k.  A pair can enter
// a list whose last key is tau only when k <= tau (an equal key may still
// win on its lower id), and then lb(Q) <= tau.  lb is monotone in Q, so
//   candidate  <=>  Q < T(tau),  T(tau) = 1 + max{Q : lb(Q) <= tau}
// (0 when none; screen_threshold finds it by bisection whenever tau
// changes), and no pair that can enter the list is screened out.  A key
// that overflows to inf never enters, so the bound need not hold there.
// A query with a non-finite table entry, or whose Slo, D or E is not
// finite, is unscreened (T = 32768: every pair is a candidate, and the
// exact path decides as the plain version does).  The lower bound (after_d,
// after_i) is applied to the exact key only.
//
// Q in packed form.  The 8-bit table holds, per (m, c), one byte per query
// of the block's QT = 4 * NW queries side by side, so one NW-word load
// (LDS.128 at QT = 16) returns a lookup for each of them.  A word holds 4
// queries; its even and odd bytes go to two accumulators as u16 pairs
// (x & 0x00FF00FF, (x >> 8) & 0x00FF00FF) and plain 32-bit adds sum two
// queries at once: a lane stays <= 32767, so none carries into the next,
// and the test (lane | 0x8000) - T keeps bit 15 clear exactly when the
// lane's Q < T (T <= 0x8000).  The screen does about one integer
// instruction per lookup and no floating point.
//
// Design:
//  * one block of TPB = 512 threads per (query tile of QT queries, DB
//    split), one block per SM; the prologue builds the tile's 8-bit table
//    in shared memory from the f32 / bf16 LUTs (M * K * QT bytes: 128 KB at
//    favor-anns' M = 32, K = 256, QT = 16), with its quantizer (lo_m, D,
//    Slo, E) -- no extra launch and no torch op;
//  * each thread owns one row of each 512-row tile: it reads the row's code
//    bytes and its first AMAX int and float attributes from global memory
//    straight into registers one tile ahead (the block holds one query
//    group, so no other thread needs them and a shared-memory stage would
//    only add a copy), looks up its M entries and tests its QT sums
//    against the tile's thresholds;
//  * a pair that passes the screen meets a pre-check in the same thread:
//    favor::may_pass (filter_program.cuh), a necessary condition of its
//    filter on the attributes in registers, so that most pairs of a
//    selective filter never reach the buffer.  (Evaluating the whole
//    program there was slower: one lane's long evaluation stalls the
//    warp's screen.);
//  * a pair that passes both goes to a block-wide buffer of CAP entries,
//    processed -- every thread takes entries -- when 3/4 full, when it
//    overflows and at the end of the split: the filter program
//    (favor::eval_row, on the block's programs staged in shared memory),
//    then the exact key (adc_exact, from the LUTs in global memory: a
//    batch's f32 tables are 32 MB, L2-resident), then the key against the
//    list's last entry and the lower bound; admitted pairs wait in a
//    per-query pending buffer of PC entries, and the block merges every
//    query's buffer into its sorted (key, id) list by ranks (each element's
//    new slot is its rank in its own run plus its rank in the other); an
//    entry that finds its pending buffer full waits for the next round;
//  * pad rows (norm +inf or >= BIG, as prefbf.pad_db writes them) never
//    score; dead query lanes (past B) have T = 0;
//  * when the 8-bit table does not fit at QT = 4 (M * K * 4 bytes beside
//    the lists: K = 256 and M >~ 180), the no-table instantiation computes
//    every pair's exact key from the LUTs in global memory instead and
//    passes only pairs before the list's last entry: the same sums, the
//    same bits;
//  * no block carries state into another: favor::merge_splits
//    (topk_merge.cuh) merges the splits' lists per query in the same
//    (key, id) order.
//
// pq_adc_gather -- what bounds it: bytes, and at the graph route's widths
// latency.  A 1024 x 32 batch reads ~29,000 scattered 32-byte code rows and
// attribute rows, and its lookups touch ~85 % of the 32-byte sectors of
// each query's 16 KB bf16 table (~14 MB; ~5 us at 3.35 TB/s, the design's
// bound); the tables are read again every wave, so in the traversal they
// sit in L2.  Each pair waits on three dependent round trips: its id, then
// its code row, then its table entries.
//
// Design: one thread per (query, neighbour), a query's M0 threads side by
// side in a block of up to GTPB threads holding GTPB / M0 queries (at most
// GQMAX, so the descent's M0 = 1 launches many small blocks):
//  * the prologue stages the block's filter programs, D and lane-mask bits
//    in shared memory (each read once, not once per pair) while every
//    thread loads its id;
//  * at M = 32, K = 256 with bf16 tables (favor-anns; the FIXED
//    instantiation) a thread reads its code row as two 16-byte loads and
//    issues all 32 table lookups before the first add: a warp's 32 lookups
//    of one subspace fall in that subspace's 512-byte slice, a few sectors;
//    the sum is adc_exact's chain in subspace order (the same bits).  Any
//    other M, K or f32 tables go through adc_exact itself;
//  * the row's attributes are fetched beside its codes, and the thread
//    evaluates the filter (favor::eval_row on the program in shared memory)
//    and writes dbar = sqrt(max(adc2, 0)) + D * (1 - td) (Eq. 2) and the TD
//    byte, or +inf at an id < 0, a value >= BIG or a dead lane: the
//    wrapper's epilogue, so a call is one launch.
// Staging each query's table in shared memory with one bulk copy was
// measured against this and did not win (PERF.md, the kernel table).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "filter_program.cuh"
#include "topk_merge.cuh"

namespace {

using favor::BIG;

constexpr int TPB = 512;         // threads per scan block = rows per tile
constexpr int AMAX = 4;          // attributes of each kind pre-checked
constexpr int QTMAX = 16;        // queries per scan block, at most
constexpr int RMAX = 1024;       // longest top-R list of one pass
constexpr int MW = 16;           // code words held in registers (M <= 64)
constexpr int PC = 128;          // pending entries per query and round
constexpr int CAP = 2048;        // candidate buffer entries per block
constexpr int GTPB = 128;        // threads per gather block, one pair each
constexpr int GQMAX = 8;         // queries per gather block, at most
constexpr int QSUM_MAX = 32767;  // largest Q: a u16 lane with bit 15 free
constexpr int KEYED = 1 << 8;    // candidate tag: exact key known
constexpr int SCORED = 1 << 9;   // candidate tag: filter passed, key known
constexpr int QMASK = KEYED - 1;
constexpr uint32_t LANE_TOPS = 0x80008000u;
constexpr uint32_t EVEN_BYTES = 0x00FF00FFu;

__host__ __device__ inline int screen_levels(int M) {
  return M * 255 <= QSUM_MAX ? 255 : QSUM_MAX / M;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Shared memory of one scan block, byte offsets: the 8-bit table (table
// mode), the quantizer's per-(query, subspace) scratch (lo, range, max |x|),
// the queries' filter programs (imask, valid, flo, fhi), the
// double-buffered lists, the pending buffers, the candidate buffer.
struct Layout {
  size_t table, scratch, prog, lists, pend, cand, bytes;
};

__host__ __device__ inline Layout make_layout(int M, int K, int R, int QT,
                                              int table, int W, int mi,
                                              int mf) {
  Layout L;
  L.table = 0;
  L.scratch = table ? align16((size_t)M * K * QT) : 0;
  L.prog = L.scratch + (table ? align16((size_t)12 * QT * M) : 0);
  L.lists = L.prog + align16((size_t)QT * W * (8 * mi + 4 + 8 * mf));
  L.pend = L.lists + (size_t)16 * QT * R;  // 2 runs x (key, id)
  L.cand = L.pend + (size_t)8 * QT * PC;
  L.bytes = L.cand + (size_t)12 * CAP;     // row, tag, key
  return L;
}

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

// The exact ADC key of one row for one query: the query's table (at qoff)
// summed over the row's codes in subspace order from 0.f with __fadd_rn.
__device__ __forceinline__ float adc_exact(const void* luts, int bf16,
                                          size_t qoff,
                                          const uint8_t* __restrict__ crow,
                                          int M, int K) {
  float acc = 0.f;
  if ((M & 3) == 0) {
    const uint32_t* c4 = reinterpret_cast<const uint32_t*>(crow);
    for (int w = 0; w < (M >> 2); ++w) {
      const uint32_t cw = __ldg(c4 + w);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        acc = __fadd_rn(acc, lut_at(luts, bf16,
                                    qoff + (size_t)(4 * w + t) * K +
                                        ((cw >> (8 * t)) & 255u)));
    }
  } else {
    for (int m = 0; m < M; ++m)
      acc = __fadd_rn(acc, lut_at(luts, bf16,
                                  qoff + (size_t)m * K + __ldg(crow + m)));
  }
  return acc;
}

// T(tau) of the note at the top: 1 + the largest Q in [0, qmax] whose
// lb(Q) <= tau, or 0 when lb(0) > tau.
__device__ int screen_threshold(float tau, float slo, float delta, float err,
                                int qmax) {
  auto lb = [&](int q) {
    return __fsub_rd(__fmaf_rd(delta, (float)q, slo), err);
  };
  if (!(lb(0) <= tau)) return 0;
  int lo = 0, hi = qmax;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lb(mid) <= tau) lo = mid;
    else hi = mid - 1;
  }
  return lo + 1;
}

// One table entry's NW words (queries 4j..4j+3 in word j).
template <int NW>
__device__ __forceinline__ void load_entry(const uint8_t* p, uint32_t* e) {
  if constexpr (NW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    e[0] = v.x;
    e[1] = v.y;
  } else {
    e[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Two entries added to the packed sums: acc[2j] gets queries 4j, 4j+2 (the
// even bytes of word j) and acc[2j+1] queries 4j+1, 4j+3 (the odd bytes,
// moved down by a byte permute) as u16 lanes, two entries per add.
template <int NW>
__device__ __forceinline__ void add_entries(const uint32_t* a,
                                            const uint32_t* b,
                                            uint32_t* acc) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    acc[2 * j] += (a[j] & EVEN_BYTES) + (b[j] & EVEN_BYTES);
    acc[2 * j + 1] +=
        __byte_perm(a[j], 0u, 0x4341) + __byte_perm(b[j], 0u, 0x4341);
  }
}

// Halfword slot of query q's threshold in the packed threshold words (the
// lane order of the accumulators above).
__host__ __device__ inline int tslot(int q) {
  return 4 * (q >> 2) + 2 * (q & 1) + ((q >> 1) & 1);
}

// The screen of one row: bit q set when query q's Q is below its threshold.
// `words` holds the row's codes when `packed` (M % 4 == 0, M <= 4 * MW);
// else they are read from `crow`.  MT, KT > 0 fix M and K at compile time
// (the table offsets of each subspace become immediates).
template <int NW, int MT, int KT>
__device__ __forceinline__ unsigned screen_row(const uint8_t* table, int m_,
                                               int k_, bool packed,
                                               const uint32_t* words,
                                               const uint8_t* crow,
                                               const uint32_t* tp) {
  constexpr int EB = 4 * NW;  // bytes per table entry
  constexpr int NWORDS = MT ? MT / 4 : MW;
  const int M = MT ? MT : m_;
  const int K = KT ? KT : k_;
  uint32_t acc[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) acc[j] = 0u;
  if (MT || packed) {
#pragma unroll
    for (int w = 0; w < NWORDS; ++w) {
      if (MT || 4 * w < M) {
        uint32_t e[4][NW];
#pragma unroll
        for (int t = 0; t < 4; ++t) {  // byte t of the word: subspace 4w+t
          const uint32_t c = __byte_perm(words[w], 0u, 0x4440 | t);
          load_entry<NW>(table + (uint32_t)((4 * w + t) * K) * EB + c * EB,
                         e[t]);
        }
        add_entries<NW>(e[0], e[1], acc);
        add_entries<NW>(e[2], e[3], acc);
      }
    }
  } else {
    uint32_t z[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) z[j] = 0u;
    for (int m = 0; m < M; ++m) {
      uint32_t e[NW];
      load_entry<NW>(table + ((uint32_t)m * K + __ldg(crow + m)) * EB, e);
      add_entries<NW>(e, z, acc);
    }
  }
  uint32_t below[2 * NW], any = 0u;
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) {
    below[j] = ~((acc[j] | LANE_TOPS) - tp[j]) & LANE_TOPS;
    any |= below[j];
  }
  if (!any) return 0u;
  unsigned mask = 0u;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    mask |= ((below[2 * j] >> 15) & 1u) << (4 * j) |
            (below[2 * j] >> 31) << (4 * j + 2) |
            ((below[2 * j + 1] >> 15) & 1u) << (4 * j + 1) |
            (below[2 * j + 1] >> 31) << (4 * j + 3);
  return mask;
}

// NW > 0: the screen with an 8-bit table of QT = 4 * NW queries; NW = 0:
// no table, every pair's exact key from global memory (QT <= QTMAX).  MT,
// KT > 0: M and K fixed at compile time (favor-anns' 32 x 256).
template <int NW, int MT = 0, int KT = 0>
__global__ void __launch_bounds__(TPB, 1) pq_screen(
    const void* __restrict__ luts, int lut_bf16,
    const uint8_t* __restrict__ codes, const float* __restrict__ norms,
    const int* __restrict__ ints, const float* __restrict__ floats,
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi,
    const float* __restrict__ after_d, const int* __restrict__ after_i,
    int B, int N, int M, int K, int mi, int mf, int W, int R, int QT,
    int rows_per_split, Layout L, int* __restrict__ counts,
    int* __restrict__ rescored, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  constexpr bool TABLE = NW > 0;
  if constexpr (MT > 0) M = MT;  // the launch checked that they agree
  if constexpr (KT > 0) K = KT;
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* table = sm + L.table;
  float* qlo = reinterpret_cast<float*>(sm + L.scratch);  // QT x M each
  float* qrg = qlo + QT * M;
  float* qam = qrg + QT * M;
  long long* pm = reinterpret_cast<long long*>(sm + L.prog);  // QT x W x mi
  float* pv = reinterpret_cast<float*>(pm + QT * W * mi);     // QT x W
  float* pl = pv + QT * W;                                     // QT x W x mf
  float* ph = pl + QT * W * mf;
  float* ld = reinterpret_cast<float*>(sm + L.lists);     // 2 x QT x R
  int* li = reinterpret_cast<int*>(ld + 2 * QT * R);
  float* pd = reinterpret_cast<float*>(sm + L.pend);      // QT x PC
  int* pi = reinterpret_cast<int*>(pd + QT * PC);
  int* cand_row = reinterpret_cast<int*>(sm + L.cand);
  int* cand_tag = cand_row + CAP;                         // q | flags, -1
  float* cand_val = reinterpret_cast<float*>(cand_tag + CAP);
  __shared__ int cnt[QTMAX], cur[QTMAX], aft_i[QTMAX], scnt[QTMAX],
      rcnt[QTMAX], mode[QTMAX];  // mode: 0 dead lane, 1 screened, 2 not
  __shared__ float aft_d[QTMAX], q_slo[QTMAX], q_delta[QTMAX], q_err[QTMAX];
  __shared__ uint32_t tpk[QTMAX / 2];  // thresholds, u16 lanes (tslot)
  __shared__ favor::Hull<AMAX> hull[QTMAX];  // the pre-check, per query
  __shared__ int ncand;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, B - q0);
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);
  const int mk = M * K;
  const int levels = screen_levels(M);

  // -- the prologue: lists, per-query state, the 8-bit table ---------------
  for (int e = tid; e < 2 * QT * R; e += TPB) {
    ld[e] = BIG;
    li[e] = -1;
  }
  if (tid < QTMAX) {
    cnt[tid] = 0;
    cur[tid] = 0;
    scnt[tid] = 0;
    rcnt[tid] = 0;
    const bool lb = after_d != nullptr && tid < nq;
    aft_d[tid] = lb ? after_d[q0 + tid] : -INFINITY;
    aft_i[tid] = lb ? after_i[q0 + tid] : -1;
  }
  if (tid == 0) ncand = 0;
  for (int e = tid; e < nq * W; e += TPB) {  // the tile's filter programs
    const size_t g = (size_t)q0 * W + e;
    pv[e] = valid[g];
    for (int c = 0; c < mi; ++c) pm[e * mi + c] = imask[g * mi + c];
    for (int c = 0; c < mf; ++c) {
      pl[e * mf + c] = flo[g * mf + c];
      ph[e * mf + c] = fhi[g * mf + c];
    }
  }
  __syncthreads();  // the programs are staged
  if (tid < QTMAX)  // dead lanes get an empty hull
    favor::build_hull<AMAX>(pv + tid * W, pm + (size_t)tid * W * mi,
                            pl + tid * W * mf, ph + tid * W * mf,
                            tid < nq ? W : 0, mi, mf, hull[tid]);
  if constexpr (TABLE) {
    // per (query, subspace): lo, the range rounded up, max |x| (inf when
    // an entry is not finite); one warp each, lanes over the K entries
    for (int p = warp; p < QT * M; p += TPB / 32) {
      const int q = p / M, m = p - q * M;
      float lo = INFINITY, hi = -INFINITY;
      bool bad = false;
      if (q < nq) {
        const size_t base = (size_t)(q0 + q) * mk + (size_t)m * K;
        for (int c = lane; c < K; c += 32) {
          const float v = lut_at(luts, lut_bf16, base + c);
          bad |= !isfinite(v);
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
#pragma unroll
      for (int s = 16; s; s >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
      }
      bad = __any_sync(0xffffffffu, bad);
      if (lane == 0) {
        qlo[p] = lo;
        qrg[p] = __fsub_ru(hi, lo);
        qam[p] = bad ? INFINITY : fmaxf(fabsf(lo), fabsf(hi));
      }
    }
    __syncthreads();
    // per query: Slo (rounded down), D, E (rounded up), the mode
    if (tid < QTMAX) {
      const int q = tid;
      int md = 0;
      float slo = 0.f, delta = 1.f, err = 0.f;
      if (q < nq) {
        float rg = 0.f, a = 0.f;
        for (int m = 0; m < M; ++m) {
          slo = __fadd_rd(slo, qlo[q * M + m]);
          rg = fmaxf(rg, qrg[q * M + m]);
          a = __fadd_ru(a, qam[q * M + m]);
        }
        if (rg > 0.f) delta = __fdiv_ru(rg, (float)levels);
        const float nu = __fmul_rn((float)(M - 1), 0x1p-24f);  // exact
        err = __fmul_ru(__fdiv_ru(nu, __fsub_rd(1.f, nu)), a);
        md = (isfinite(slo) && isfinite(delta) && isfinite(err)) ? 1 : 2;
      }
      mode[q] = md;
      q_slo[q] = slo;
      q_delta[q] = delta;
      q_err[q] = err;
    }
    __syncthreads();
    // the table: entry e = m * K + c holds QT bytes, query q's at byte q
    for (int e = tid; e < mk; e += TPB) {
      const int m = e / K;
      uint32_t wd[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) wd[j] = 0u;
#pragma unroll
      for (int q = 0; q < 4 * NW; ++q) {
        if (mode[q] == 1) {
          const float x = lut_at(luts, lut_bf16, (size_t)(q0 + q) * mk + e);
          const float t =
              __fdiv_rd(__fsub_rd(x, qlo[q * M + m]), q_delta[q]);
          const uint32_t code = (uint32_t)fminf(floorf(t), (float)levels);
          wd[q >> 2] |= code << (8 * (q & 3));
        }
      }
#pragma unroll
      for (int j = 0; j < NW; ++j)
        reinterpret_cast<uint32_t*>(table + (size_t)e * 4 * NW)[j] = wd[j];
    }
  }

  // T of query q from its list's last key (table mode)
  auto set_threshold = [&](int q) {
    int t = 0;
    if (mode[q] == 1)
      t = screen_threshold(ld[(cur[q] * QT + q) * R + R - 1], q_slo[q],
                           q_delta[q], q_err[q], levels * M);
    else if (mode[q] == 2)
      t = QSUM_MAX + 1;
    reinterpret_cast<unsigned short*>(tpk)[tslot(q)] = (unsigned short)t;
  };
  if constexpr (TABLE) {
    __syncthreads();  // the modes are read by the owners
    if (tid < QT) set_threshold(tid);
  }
  __syncthreads();

  // -- candidates: filter, exact key, pending; then the rank merge --------
  // Entry i of the buffer: row, tag = query | KEYED (no-table mode: the key
  // is in cand_val) | SCORED (filter passed, key known), -1 when done.
  auto flush = [&](int n) {
    for (;;) {
      bool deferred = false;
      for (int i = tid; i < n; i += TPB) {
        int tag = cand_tag[i];
        if (tag < 0) continue;
        const int q = tag & QMASK, row = cand_row[i];
        float key = cand_val[i];
        if (!(tag & SCORED)) {
          // the query's staged program
          if (!favor::eval_row(pv + q * W, pm + (size_t)q * W * mi,
                               pl + q * W * mf, ph + q * W * mf, W, mi, mf,
                               ints + (size_t)row * mi,
                               floats + (size_t)row * mf)) {
            cand_tag[i] = -1;
            continue;
          }
          if (!(tag & KEYED)) {
            key = adc_exact(luts, lut_bf16, (size_t)(q0 + q) * mk,
                            codes + (size_t)row * M, M, K);
            if (rescored != nullptr) atomicAdd(&rcnt[q], 1);
          }
          tag |= SCORED;
          cand_tag[i] = tag;
          cand_val[i] = key;
        }
        const int tail = (cur[q] * QT + q) * R + R - 1;
        if (!(key < BIG) || !before(key, row, ld[tail], li[tail]) ||
            !before(aft_d[q], aft_i[q], key, row)) {
          cand_tag[i] = -1;
          continue;
        }
        const int pos = atomicAdd(&cnt[q], 1);
        if (pos >= PC) {  // full: again after this round's merge
          deferred = true;
          continue;
        }
        pd[q * PC + pos] = key;
        pi[q * PC + pos] = row;
        cand_tag[i] = -1;
      }
      __syncthreads();
      // each query's pending run (unsorted, distinct ids) into its list
      const int span = R + PC;
      for (int e = tid; e < QT * span; e += TPB) {
        const int q = e / span, j = e - q * span;
        const int c = min(cnt[q], PC);
        if (c == 0 || j >= R + c) continue;
        const float* od = ld + (cur[q] * QT + q) * R;
        const int* oi = li + (cur[q] * QT + q) * R;
        const float* bd = pd + q * PC;
        const int* bi = pi + q * PC;
        float kd;
        int ki, pos;
        if (j < R) {  // list entry: its index + pending entries before it
          kd = od[j];
          ki = oi[j];
          pos = j;
        } else {      // pending entry: list entries before it + pending
          kd = bd[j - R];
          ki = bi[j - R];
          int lo = 0, hi = R;  // lower bound in the sorted list
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (before(od[mid], oi[mid], kd, ki)) lo = mid + 1;
            else hi = mid;
          }
          pos = lo;
        }
        for (int p = 0; p < c; ++p) pos += before(bd[p], bi[p], kd, ki);
        if (pos < R) {
          const int o = ((cur[q] ^ 1) * QT + q) * R + pos;
          ld[o] = kd;
          li[o] = ki;
        }
      }
      __syncthreads();
      if (tid < QT && cnt[tid] > 0) {
        cur[tid] ^= 1;
        cnt[tid] = 0;
        if constexpr (TABLE) set_threshold(tid);
      }
      if (!__syncthreads_or(deferred)) break;
    }
  };

  // -- the scan: one row per thread and tile, codes one tile ahead --------
  const bool packed = (M & 3) == 0 && M <= 4 * MW;
  uint32_t words[MW], next[MW];
  int ri[AMAX], ri_next[AMAX];
  float rf[AMAX], rf_next[AMAX];
#pragma unroll
  for (int w = 0; w < MW; ++w) next[w] = 0u;
#pragma unroll
  for (int c = 0; c < AMAX; ++c) {
    ri_next[c] = 0;
    rf_next[c] = 0.f;
  }
  float norm_next = BIG;
  auto load_row = [&](int row) {
    if (row < row1) {
      norm_next = __ldg(norms + row);
#pragma unroll
      for (int c = 0; c < AMAX; ++c) {
        if (c < mi) ri_next[c] = __ldg(ints + (size_t)row * mi + c);
        if (c < mf) rf_next[c] = __ldg(floats + (size_t)row * mf + c);
      }
      if (packed) {
        const uint32_t* c4 =
            reinterpret_cast<const uint32_t*>(codes + (size_t)row * M);
#pragma unroll
        for (int w = 0; w < MW; ++w)
          if (4 * w < M) next[w] = __ldg(c4 + w);
      }
    }
  };
  load_row(row0 + tid);
  for (int base = row0; base < row1; base += TPB) {
    const int row = base + tid;
    const bool live = row < row1 && norm_next < BIG;  // pad rows never score
#pragma unroll
    for (int w = 0; w < MW; ++w) words[w] = next[w];
#pragma unroll
    for (int c = 0; c < AMAX; ++c) {
      ri[c] = ri_next[c];
      rf[c] = rf_next[c];
    }
    load_row(row + TPB);
    unsigned mask = 0u;
    float keys[QTMAX];
    if constexpr (TABLE) {
      uint32_t tp[2 * NW];
#pragma unroll
      for (int j = 0; j < 2 * NW; ++j) tp[j] = tpk[j];
      if (live)
        mask = screen_row<NW, MT, KT>(table, M, K, packed, words,
                                      codes + (size_t)row * M, tp);
    } else {
#pragma unroll
      for (int q = 0; q < QTMAX; ++q) {
        keys[q] = BIG;
        if (live && q < nq) {
          const float key = adc_exact(luts, lut_bf16, (size_t)(q0 + q) * mk,
                                      codes + (size_t)row * M, M, K);
          const int tail = (cur[q] * QT + q) * R + R - 1;
          if (key < BIG && before(key, row, ld[tail], li[tail]) &&
              before(aft_d[q], aft_i[q], key, row)) {
            keys[q] = key;
            mask |= 1u << q;
          }
        }
      }
    }
    // the pre-check on the row's attributes in registers: a pair that fails
    // it can never pass its filter, and stays out of the buffer
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int q = __ffs(mm) - 1;
      if (counts != nullptr) atomicAdd(&scnt[q], 1);
      if (!favor::may_pass<AMAX>(hull[q], ri, rf, mi, mf)) mask &= ~(1u << q);
    }
    // append to the candidate buffer; flush it when 3/4 full, or when it
    // overflowed (what did not fit goes in after the flush)
    for (;;) {
      const int want = __popc(mask);
      int slot = want ? atomicAdd(&ncand, want) : 0;
#pragma unroll
      for (int bit = 0; bit < QTMAX; ++bit) {
        if ((mask >> bit & 1u) && slot < CAP) {
          cand_row[slot] = row;
          cand_tag[slot] = TABLE ? bit : bit | KEYED;
          cand_val[slot] = TABLE ? 0.f : keys[bit];
          mask &= ~(1u << bit);
          ++slot;
        }
      }
      // every append is done; the count is read before the next one
      const bool over = __syncthreads_or(mask != 0u);
      const int n = min(ncand, CAP);
      if (!over && n < CAP - CAP / 4) break;
      flush(n);
      if (tid == 0) ncand = 0;
      __syncthreads();
      if (!over) break;
    }
  }
  __syncthreads();
  if (ncand > 0) flush(ncand);  // uniform: every thread reads the count
  __syncthreads();  // the lists are final (and initialised when no tile ran)

  for (int e = tid; e < nq * R; e += TPB) {
    const int q = e / R, j = e - q * R;
    const size_t off = ((size_t)(q0 + q) * gridDim.y + split) * R + j;
    part_d[off] = ld[(cur[q] * QT + q) * R + j];
    part_i[off] = li[(cur[q] * QT + q) * R + j];
  }
  if (counts != nullptr && tid < nq) atomicAdd(counts + q0 + tid, scnt[tid]);
  if (rescored != nullptr && tid < nq)
    atomicAdd(rescored + q0 + tid, rcnt[tid]);
}

// Shared memory of one gather block, byte offsets: per query its filter
// program, D and lane-mask bit; per thread its pair's attribute row.
struct GatherLayout {
  size_t imask, valid, flo, fhi, dv, ri, rf, ok, bytes;
};

__host__ __device__ inline GatherLayout make_gather_layout(int QPB, int W,
                                                           int mi, int mf) {
  GatherLayout L;
  size_t o = 0;
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
  o += (size_t)4 * GTPB * mi;
  L.rf = o;
  o += (size_t)4 * GTPB * mf;
  L.ok = o;
  o += (size_t)QPB;
  L.bytes = align16(o);
  return L;
}

template <typename IdT>
__device__ __forceinline__ int load_id(const IdT* ids, size_t at) {
  const long long v = (long long)ids[at];
  return v < 0 ? -1 : (int)v;
}

// The exact ADC key at M = 32, K = 256 from a bf16 table: the row's 32 codes
// in two 16-byte loads, all 32 lookups issued before the first add, then
// adc_exact's chain (the same sum, the same bits).
__device__ __forceinline__ float adc_exact_m32k256(
    const unsigned short* __restrict__ lq, const uint4& w0, const uint4& w1) {
  const uint32_t cw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float x[32];
#pragma unroll
  for (int m = 0; m < 32; ++m)
    x[m] = __uint_as_float(
        (uint32_t)__ldg(lq + m * 256 + ((cw[m >> 2] >> (8 * (m & 3))) & 255u))
        << 16);
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < 32; ++m) acc = __fadd_rn(acc, x[m]);
  return acc;
}

// One thread per (query, neighbour) pair, QPB queries per block of up to
// GTPB threads (lane j of a query's run of M0 threads takes neighbour j).  FIXED
// = 1 is the M = 32, K = 256 bf16 instantiation; FIXED = 0 reads any M, K
// and either table type through adc_exact.
template <int FIXED, typename IdT>
__global__ void __launch_bounds__(GTPB) pq_gather(
    const IdT* __restrict__ ids, const void* __restrict__ luts, int lut_bf16,
    const uint8_t* __restrict__ codes, const int* __restrict__ ints,
    const float* __restrict__ floats, const float* __restrict__ valid,
    const long long* __restrict__ imask, const float* __restrict__ flo,
    const float* __restrict__ fhi, const float* __restrict__ dvec,
    const uint8_t* __restrict__ lane_ok, int B, int M0, int M, int K, int mi,
    int mf, int W, int filter, int QPB, GatherLayout L,
    float* __restrict__ out_d, uint8_t* __restrict__ out_td) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_imask = reinterpret_cast<long long*>(smem + L.imask);
  float* s_valid = reinterpret_cast<float*>(smem + L.valid);
  float* s_flo = reinterpret_cast<float*>(smem + L.flo);
  float* s_fhi = reinterpret_cast<float*>(smem + L.fhi);
  float* s_dv = reinterpret_cast<float*>(smem + L.dv);
  int* s_ri = reinterpret_cast<int*>(smem + L.ri) + threadIdx.x * mi;
  float* s_rf = reinterpret_cast<float*>(smem + L.rf) + threadIdx.x * mf;
  uint8_t* s_ok = smem + L.ok;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * QPB;
  const int nq = min(QPB, B - b0);
  const int pairs = nq * M0;
  const size_t pair0 = (size_t)b0 * M0;
  int id = tid < pairs ? load_id(ids, pair0 + tid) : -1;
  if (filter) {
#pragma unroll 4
    for (int i = tid; i < nq * W; i += nt)
      s_valid[i] = valid[(size_t)b0 * W + i];
#pragma unroll 4
    for (int i = tid; i < nq * W * mi; i += nt)
      s_imask[i] = imask[(size_t)b0 * W * mi + i];
#pragma unroll 4
    for (int i = tid; i < nq * W * mf; i += nt) {
      s_flo[i] = flo[(size_t)b0 * W * mf + i];
      s_fhi[i] = fhi[(size_t)b0 * W * mf + i];
    }
    if (tid < nq) s_dv[tid] = dvec[b0 + tid];
  }
  if (tid < nq) s_ok[tid] = lane_ok == nullptr ? 1 : lane_ok[b0 + tid];
  __syncthreads();

  for (int p = tid; p < pairs; p += nt) {
    if (p != tid) id = load_id(ids, pair0 + p);
    const int qi = p / M0;
    float out = INFINITY;
    int td = 0;
    if (id >= 0 && s_ok[qi]) {
      const size_t qoff = (size_t)(b0 + qi) * M * K;
      uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
      if constexpr (FIXED) {
        const uint4* c4 =
            reinterpret_cast<const uint4*>(codes + (size_t)id * 32);
        w0 = __ldg(c4);
        w1 = __ldg(c4 + 1);
      }
      if (filter) {  // the attribute row, fetched beside the codes
        for (int c = 0; c < mi; ++c)
          s_ri[c] = __ldg(ints + (size_t)id * mi + c);
        for (int c = 0; c < mf; ++c)
          s_rf[c] = __ldg(floats + (size_t)id * mf + c);
      }
      float acc;
      if constexpr (FIXED)
        acc = adc_exact_m32k256(
            reinterpret_cast<const unsigned short*>(luts) + qoff, w0, w1);
      else
        acc = adc_exact(luts, lut_bf16, qoff, codes + (size_t)id * M, M, K);
      if (!filter) {
        out = acc;
      } else {
        td = favor::eval_row(s_valid + qi * W, s_imask + (size_t)qi * W * mi,
                             s_flo + qi * W * mf, s_fhi + qi * W * mf, W, mi,
                             mf, s_ri, s_rf)
                 ? 1 : 0;
        const float dist = sqrtf(fmaxf(acc, 0.f));
        out = td ? dist : __fadd_rn(dist, s_dv[qi]);
      }
      if (out >= BIG) out = INFINITY;
    }
    out_d[pair0 + p] = out;
    if (filter) out_td[pair0 + p] = (uint8_t)td;
  }
}

// Gather queries per block: GTPB / M0, at least one and at most GQMAX (a
// block stages its queries' programs, so a narrow launch -- the descent's
// M0 = 1 -- takes more, smaller blocks), then fewer until the programs fit
// the default 48 KB of shared memory.
int gather_queries_per_block(int B, int M0, int W, int mi, int mf) {
  int qpb = M0 >= GTPB ? 1 : GTPB / M0;
  qpb = qpb < GQMAX ? qpb : GQMAX;
  qpb = qpb < B ? qpb : B;
  while (qpb > 1 && make_gather_layout(qpb, W, mi, mf).bytes > 48 * 1024)
    --qpb;
  return qpb < 1 ? 1 : qpb;
}

// The pre-check against the filter (a test probe): per (query, row), bit 0
// is favor::eval_row and bit 1 favor::may_pass on the query's hull and the
// row's first AMAX attributes of each kind, as the scan reads them.
__global__ void __launch_bounds__(256) precheck_probe(
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi,
    const int* __restrict__ ints, const float* __restrict__ floats, int B,
    int N, int W, int mi, int mf, int* __restrict__ out) {
  const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= (long long)B * N) return;
  const int b = (int)(pair / N), row = (int)(pair - (long long)b * N);
  const float* v = valid + (size_t)b * W;
  const long long* im = imask + (size_t)b * W * mi;
  const float* lo = flo + (size_t)b * W * mf;
  const float* hi = fhi + (size_t)b * W * mf;
  favor::Hull<AMAX> h;
  favor::build_hull<AMAX>(v, im, lo, hi, W, mi, mf, h);
  int ri[AMAX];
  float rf[AMAX];
#pragma unroll
  for (int c = 0; c < AMAX; ++c) {
    ri[c] = c < mi ? ints[(size_t)row * mi + c] : 0;
    rf[c] = c < mf ? floats[(size_t)row * mf + c] : 0.f;
  }
  const bool pass = favor::eval_row(v, im, lo, hi, W, mi, mf,
                                    ints + (size_t)row * mi,
                                    floats + (size_t)row * mf);
  out[pair] = (int)pass | (int)favor::may_pass<AMAX>(h, ri, rf, mi, mf) << 1;
}

// The scan kernel that runs for a (table, QT, M, K).
auto scan_kernel(int table, int QT, int M, int K) -> decltype(&pq_screen<0>) {
  return !table                          ? pq_screen<0>
         : QT == 16 && M == 32 && K == 256 ? pq_screen<4, 32, 256>
         : QT == 16                        ? pq_screen<4>
         : QT == 8                         ? pq_screen<2>
                                           : pq_screen<1>;
}

}  // namespace

extern "C" {

int pq_adc_max_r() { return RMAX; }
int pq_adc_max_qt() { return QTMAX; }
int pq_adc_tile_rows() { return TPB; }
int pq_adc_screen_levels(int M) { return screen_levels(M); }

// The most shared memory, static and dynamic, that one block of the
// current device may opt in to.
int pq_adc_smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// Shared memory of a scan block, the dynamic layout plus the kernel's
// static arrays: `table` = 1 for the screen with an 8-bit table (QT must be
// 4, 8 or 16, and M <= 32767), 0 for the no-table instantiation;
// (size_t)-1 when the combination is not available.
size_t pq_adc_topr_smem_bytes(int M, int K, int R, int QT, int table, int W,
                              int mi, int mf) {
  if (QT < 1 || QT > QTMAX || R < 1 || R > RMAX) return (size_t)-1;
  if (table && ((QT != 4 && QT != 8 && QT != 16) || M > QSUM_MAX))
    return (size_t)-1;
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, scan_kernel(table, QT, M, K)) != cudaSuccess)
    return (size_t)-1;
  return make_layout(M, K, R, QT, table, W, mi, mf).bytes + a.sharedSizeBytes;
}

// luts (B, M*K) f32 or bf16 (lut_bf16); codes (N, M) uint8; after_d /
// after_i: (B,) per-query lower bound, or both null; counts / rescored:
// (B,) int32 the screen's candidates / the exact re-scores are added to,
// or null; part_d / part_i: (B, splits, R) scratch; out_d / out_i: (B, R).
// Returns cudaGetLastError() after the launches (0 = launched).
int pq_adc_topr_launch(const void* luts, int lut_bf16, int table,
                       const void* codes, const void* norms, const void* ints,
                       const void* floats, const void* valid,
                       const void* imask, const void* flo, const void* fhi,
                       const void* after_d, const void* after_i, int B, int N,
                       int M, int K, int mi, int mf, int W, int R, int QT,
                       int splits, void* counts, void* rescored, void* part_d,
                       void* part_i, void* out_d, void* out_i, void* stream) {
  if (pq_adc_topr_smem_bytes(M, K, R, QT, table, W, mi, mf) == (size_t)-1)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(M, K, R, QT, table, W, mi, mf);
  const auto kern = scan_kernel(table, QT, M, K);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = (N + splits - 1) / splits;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((B + QT - 1) / QT, splits);
  kern<<<grid, TPB, L.bytes, st>>>(
      luts, lut_bf16, static_cast<const uint8_t*>(codes),
      static_cast<const float*>(norms), static_cast<const int*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(valid),
      static_cast<const long long*>(imask), static_cast<const float*>(flo),
      static_cast<const float*>(fhi), static_cast<const float*>(after_d),
      static_cast<const int*>(after_i), B, N, M, K, mi, mf, W, R, QT,
      rows_per_split, L, static_cast<int*>(counts),
      static_cast<int*>(rescored), static_cast<float*>(part_d),
      static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  favor::merge_splits<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      splits, R, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// ids (B, M0) int32 (ids64 = 0) or int64 (ids64 = 1); luts (B, M*K) f32
// or bf16; codes (N, M) uint8; lane_ok (B,) uint8 or null.  filter = 0:
// out_d = adc2; filter = 1: out_d = dbar and out_td = TD bit (uint8); +inf
// at id < 0, at values >= BIG and on dead lanes.  Returns the first CUDA
// error of the launch.
int pq_adc_gather_launch(const void* ids, int ids64, const void* luts,
                         int lut_bf16, const void* codes, const void* ints,
                         const void* floats, const void* valid,
                         const void* imask, const void* flo, const void* fhi,
                         const void* dvec, const void* lane_ok, int B, int M0,
                         int M, int K, int mi, int mf, int W, int filter,
                         void* out_d, void* out_td, void* stream) {
  if (!filter) mi = mf = W = 0;
  const int qpb = gather_queries_per_block(B, M0, W, mi, mf);
  const GatherLayout L = make_gather_layout(qpb, W, mi, mf);
  const bool fixed = lut_bf16 && M == 32 && K == 256;
  void* kern = fixed ? (ids64 ? (void*)pq_gather<1, long long>
                              : (void*)pq_gather<1, int>)
                     : (ids64 ? (void*)pq_gather<0, long long>
                              : (void*)pq_gather<0, int>);
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int* i32 = static_cast<const int*>(ids);
  const long long* i64 = static_cast<const long long*>(ids);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const int* ip = static_cast<const int*>(ints);
  const float* fp = static_cast<const float*>(floats);
  const float* va = static_cast<const float*>(valid);
  const long long* im = static_cast<const long long*>(imask);
  const float* lo = static_cast<const float*>(flo);
  const float* hi = static_cast<const float*>(fhi);
  const float* dv = static_cast<const float*>(dvec);
  const uint8_t* ok = static_cast<const uint8_t*>(lane_ok);
  float* od = static_cast<float*>(out_d);
  uint8_t* ot = static_cast<uint8_t*>(out_td);
  const unsigned blocks = (unsigned)((B + qpb - 1) / qpb);
  const int pairs = qpb * M0;
  const int threads = pairs >= GTPB ? GTPB : 32 * ((pairs + 31) / 32);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define PQ_GATHER_ARGS                                                      \
  luts, lut_bf16, cd, ip, fp, va, im, lo, hi, dv, ok, B, M0, M, K, mi, mf, \
      W, filter, qpb, L, od, ot
  if (fixed && ids64)
    pq_gather<1, long long><<<blocks, threads, L.bytes, st>>>(i64, PQ_GATHER_ARGS);
  else if (fixed)
    pq_gather<1, int><<<blocks, threads, L.bytes, st>>>(i32, PQ_GATHER_ARGS);
  else if (ids64)
    pq_gather<0, long long><<<blocks, threads, L.bytes, st>>>(i64, PQ_GATHER_ARGS);
  else
    pq_gather<0, int><<<blocks, threads, L.bytes, st>>>(i32, PQ_GATHER_ARGS);
#undef PQ_GATHER_ARGS
  return (int)cudaGetLastError();
}

// The pre-check probe over B programs (valid (B, W), imask (B, W, mi),
// flo / fhi (B, W, mf)) and N rows (ints (N, mi), floats (N, mf)): out (B,
// N) int32 as precheck_probe writes it.  Returns cudaGetLastError().
int pq_adc_precheck_probe(const void* valid, const void* imask,
                          const void* flo, const void* fhi, const void* ints,
                          const void* floats, int B, int N, int W, int mi,
                          int mf, void* out, void* stream) {
  const long long pairs = (long long)B * N;
  const unsigned blocks = (unsigned)((pairs + 255) / 256);
  precheck_probe<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(valid), static_cast<const long long*>(imask),
      static_cast<const float*>(flo), static_cast<const float*>(fhi),
      static_cast<const int*>(ints), static_cast<const float*>(floats), B, N,
      W, mi, mf, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
