// Fused filtered brute-force top-k: L2 distance + DNF filter program +
// PreFBF mask (fail -> dropped) or exclusion distance (+D, Eq. 2) + running
// top-k, on one of two paths chosen per query on the card: a TF32
// tensor-core screen followed by an exact f32 re-score (every query in
// exclusion mode, dense filters in PreFBF mode), or, in PreFBF mode, the
// filter first and an exact f32 distance for the passing pairs only.
//
// Replaces the TPU kernel src/repro/kernels/filtered_topk/kernel.py:
// filtered_topk_pallas (body _kernel, helpers _eval_program_tile and
// _topk_merge).
//
// What bounds each path on an H100.  The screen: operations.  Every
// (query, row) pair costs a d-long dot product, 2*B*N*d operations against
// 4*N*d bytes read once (B = 1024, N = 4M, d = 128: 1.05e12 operations,
// 2.1 GB).  Computed exactly on the f32 FMA pipes that is 15.6 ms at 67
// TFLOP/s; the screen computes every dot approximately on the tensor cores
// in TF32 (495 TFLOP/s dense: a 2.12 ms bound) and exactly only for the
// pairs that the approximation cannot rule out.  The filter-first path:
// bytes.  It tests every pair's filter (a few instructions for 32 pairs, on
// attributes read once per 32 queries) and reads the d-long row and query
// of each passing pair only, about 2*B*N*s*d operations at a passing share
// s.  Rows read once would bound it (B = 1000, N = 1M, d = 960, s = 0.1-0.5
// %: 3.86 GB, 1.15 ms); it reads each passing pair's row on its own, 2.7e6
// rows (10.4 GB) there, and takes ~6.3 ms on an H100.
//
// The choice (ft_screen_count, filter_first).  In PreFBF mode a count pass
// first counts, per query, the non-pad rows its filter passes; a query
// whose count is at most FF_SHARE * N (N the rows scanned, pad rows
// included, as both paths visit them) takes the filter-first path, the
// others the screen; each kernel treats the other path's queries as dead
// lanes, and a block with no query of its own returns at once.
// FF_SHARE is the break-even of the two paths' per-pair costs measured on
// an H100 (see FF_SHARE).  Exclusion mode always takes the screen: there a
// failing row is still an answer (key + D).  Both paths return the exact
// filtered top-k by (key, id) of the same per-pair chain below, so the
// choice moves only time, never a bit.
//
// The screen.  mma.sync.m16n8k8 (TF32 inputs, f32 accumulators) gives an
// approximate dot a~ for every pair of a tile.  The operands go in as their
// f32 bits: the tensor cores use the upper 19 bits, so each operand carries
// a relative error below u = 2^-10 (truncation; 2^-11 if the hardware
// rounded).  Each product of two TF32 values is exact; the accumulation is
// f32 with truncation, at most 9 units of 2^-23 of the running magnitude
// per eight-term step, below d * 2^-22 * (1 + u)^2 * sum |q_i v_i| over d
// terms.  The dot the kernel returns is one fmaf chain over dims 0..d-1,
// within 1.01 * d * 2^-24 * sum |q_i v_i| of the real dot.  With sum
// |q_i v_i| <= |q| |v| (Cauchy-Schwarz):
//   |a~ - dot_exact_kernel| <= eps0 |q| |v|,
//   eps0 = 2u + u^2 + d 2^-22 (1 + u)^2 + 1.01 d 2^-24,
// and the kernel takes eps = 2 * eps0 (screen_eps in
// kernels/filtered_topk/ops.py, passed in as `eps`): the factor 2 covers
// the f32 rounding of |q| (sqrt of the kernel's own |q|^2), of |v|
// (computed here from the row tile, not taken from the `norms` argument),
// of e = eps |q| |v| and of U below, each O(d 2^-24) relative.  Inputs are
// assumed in the normal f32 range (the tensor cores may flush subnormals).
//
// A pair is a candidate when the lower bound of its exact key can reach
// the query's current k-th key tau (its list's last entry):
//   U  = fma(eps |q|, |v|, a~)            >= the exact kernel dot,
//   L2 = fma(-2, U, fl(|v|^2 + |q|^2))    <= the exact squared form
//        (|v|^2 the `norms` argument: fl(S - 2 U) is monotone in U, and
//        2 U is exact, so this is the exact formula's rounding at U),
//   pass threshold tau2p = next_up(tau)^2, rounded up: a row that passes
//        the filter has key = dist;
//   fail threshold tau2f = (next_up(tau) - D)^2, rounded up, when
//        next_up(tau) - D > 0 (else none): a failing row has key
//        fl(dist + D), exclusion mode only (PreFBF drops it);
//   candidate  <=>  L2 <= tau2p  or  L2 <= tau2f.
// The lower bound with min(D, 0) of the plain derivation is the larger of
// the two.  Rounding is monotone and tau representable, so key <= tau
// implies dist < next_up(tau) (pass) or dist < next_up(tau) - D (fail),
// hence d2 below that threshold and L2 <= d2: no pair that can enter the
// list is screened out.  There is no sqrt per pair: the comparison is in
// the squared domain.
//
// Per screen candidate, in this order: the filter program
// (favor::eval_row); the screen's L2 against the threshold of that
// outcome (in PreFBF mode a failing row stops here); the exact distance --
// one fmaf chain over dims 0..d-1 from 0.f, then favor::l2_from_dot --
// from the exact query and row values; + D where the row fails, in
// exclusion mode; clamp to BIG;
// insertion when (key, id) comes before the list's last entry and strictly
// after the per-query lower bound (after_d, after_i) when one is given
// (how the wrapper chains passes of KMAX for a larger k,
// kernels/_common.py chain_topk).  The filter-first path runs the same
// steps on each non-pad pair whose filter passes, without the screen's L2.
// Every returned distance comes from that per-pair chain, so it does not
// depend on the path, the tile, the split or the batch width: bucket
// padding relies on it.
//
// Design of the screen (ft_screen):
//  * a block owns a tile of QB = 128 queries for its whole run, staged in
//    shared memory once (when it fits beside the rest: d <= 288 at k = 10;
//    wider queries stream with the rows, chunk by chunk, from L2); blocks
//    of one DB split hold different query tiles and walk the same rows at
//    about the same pace, so the rows come from HBM about once;
//  * it walks one long DB split (about one block per SM over the grid), so
//    each query's threshold tightens early and few pairs pass the screen;
//  * the split's rows stream through a two-stage cp.async ring of RT = 64
//    rows, whole rows when they fit (one barrier per row tile),
//    else DCMIN = 32 dims at a time, at a stride of 4 floats more than a
//    multiple of 32 (the mma fragment loads hit 32 different banks); the
//    tile's norms ride with its last chunk;
//  * eight warps, each a 32 query x 32 row tile of m16n8k8 products,
//    accumulate over the chunks; |v|^2 of each row is summed from the B
//    fragments on the way (a lane quad holds all of a row's dims), so the
//    screen needs no extra pass or barrier;
//  * each thread screens its 32 pairs and appends its candidates to a
//    block-wide buffer of CAP entries (row, query, L2); the buffer is
//    processed -- every thread takes entries -- when 3/4 full, when it
//    overflows, and at the end of the split, so a rare candidate does not
//    stall the block for the latency of one exact re-score each tile;
//  * each query's list is kept in shared memory sorted by (key, id),
//    slot-major (slot j of query q at j * QB + q: the owners read
//    consecutive banks); an admitted candidate goes to its query's pending
//    buffer of PC entries, and after each round the owner thread of each
//    query inserts them; an entry that finds its buffer full waits for the
//    next round (__syncthreads_or), so no buffer overflows;
//  * pad rows -- norm +inf or >= BIG, as prefbf.pad_db writes them -- and
//    rows past the split are gated (their squared form is NaN, which no
//    comparison passes) and never returned, in either mode; dead query
//    lanes (past B) take nothing (their thresholds are NaN);
//  * __fadd_rn / __fmul_rn / __fmaf_rn where the formula is written out,
//    no fast math;
//  * no block carries state into another: favor::merge_splits
//    (topk_merge.cuh) merges the splits' lists per query in the same
//    (key, id) order.
//
// Design of the filter-first path (ft_screen_count, ft_screen_prefilter):
//  * both kernels walk the grid of the screen's DB splits with blocks of
//    FQ = 32 queries and FW = 4 warps; a warp takes rounds of 32
//    consecutive rows of the split (warp w: rounds w, w + FW, ...), lane l
//    row l of the round, whose norm and first AMAX attributes of each kind
//    it loads coalesced, one round ahead;
//  * the block's hulls (favor::build_hull) become tables that map a row's
//    value to the mask of the 32 queries that admit it: per int column
//    and value, per float column the 64 sorted interval ends with the mask
//    at each end and in each gap (a binary search); so a lane tests its
//    row against all 32 hulls in a few instructions.  Where a query's hull
//    is its program (one live disjunct, no NaN bound, at most AMAX columns
//    of each kind) the tables decide; else favor::eval_row does;
//  * a 32 x 32 bit transpose (shuffles) turns the round's per-row query
//    masks into per-query row masks;
//  * ft_screen_count writes each block's passing count per query to a
//    (B, splits) scratch, which each block of the other two kernels sums
//    for its own queries: no buffer needs zeroing, no host reads it;
//  * ft_screen_prefilter appends each round's passing pairs (prefix count
//    over the lanes) to a buffer of its warp; each time it holds 32, the
//    warp copies the pairs' rows and queries TD dims at a time with
//    cp.async (coalesced, all in flight) into two tiles, lane i runs pair
//    i's chain over them, and each owner lane inserts its query's keys
//    into its list -- one list per (warp, query), slot-major, no atomics,
//    no block barrier in the row loop;
//  * at the end the FW lists of each query are merged by its owner thread
//    into the block's list for the split, in (key, id) order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "filter_program.cuh"
#include "topk_merge.cuh"

namespace {

using favor::BIG;

constexpr int QB = 128;             // queries per block
constexpr int RT = 64;              // DB rows per row tile
constexpr int DCMIN = 32;           // dims per ring stage, at least
constexpr int WARPS = 8;            // 4 (queries) x 2 (rows) warp tiles
constexpr int TPB = 32 * WARPS;
// The longest list of one pass: the most for which the resident layout
// (query tile and whole-row stages) fits at d = 128, 45,568 words beside
// 256 words per list entry within 58,112 (make_layout); a larger k chains
// passes in the wrapper.
constexpr int KMAX = 48;
constexpr int STAGES = 2;           // cp.async ring stages
constexpr int PC = 16;              // pending candidates per query a round
constexpr int CAP = 2048;           // candidate buffer entries per block
constexpr int SCORED = 1 << 16;     // candidate tag bit: exact key known
// The filter-first path (ft_screen_count, ft_screen_prefilter).
constexpr int FQ = 32;              // queries per block: one per lane
constexpr int FW = 4;               // warps per block: row phases
constexpr int FTPB = 32 * FW;
constexpr int FBUF = 64;            // a warp's passing pairs, buffered
constexpr int AMAX = 4;             // attributes of each kind pre-checked
// The break-even passing share: a query whose filter passes at most
// FF_SHARE * N rows takes the filter-first path.  Measured on an H100 SXM
// (700 W; tools/time_filtered_topk.py: one range filter of share s for the
// whole batch, PreFBF mode against exclusion mode with D = +inf, which
// answers the same on the screen): the filter-first call costs 1.4 ps per
// evaluated pair + s * 225 ps per passing pair at d = 128 (B 1,024, N 4M;
// 2.0 + s * 1,643 ps at d = 960, B 1,000, N 1M), the screen 6.1-5.6 ps a
// pair at s = 2-5 % (d = 128; 76-71 ps at d = 960).  They meet at s = 2.1 %
// at d = 128 and 4.2 % at d = 960; the constant takes the lower, so no
// query of either width leaves the screen for a slower path.
constexpr double FF_SHARE = 0.02;
static_assert((QB / 32) * (RT / 32) == WARPS, "warp tiles cover the block");
static_assert(TPB >= QB, "one owner thread per query");

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x8, row) * b (8x8, col), TF32 inputs given as f32 bits
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Squared-domain thresholds of a query whose list ends at key tau (see the
// note at the top): t2[0] for a row that passes the filter, t2[1] for one
// that fails it (NaN, which nothing passes, in PreFBF mode or when no
// failing row can enter).
__device__ __forceinline__ void screen_tau2(float tau, float D, int exclude,
                                            float* t2) {
  const float te = nextafterf(tau, INFINITY);
  t2[0] = __fmul_ru(te, te);
  const float tf = __fadd_ru(te, -D);
  t2[1] = exclude && tf > 0.f ? __fmul_ru(tf, tf) : NAN;
}

// PreFBF mode's route of query qi: the filter-first path when the count
// pass's partial counts (B x S, ft_screen_count) sum to at most `cut`.
__device__ __forceinline__ bool filter_first(const int* __restrict__ pcount,
                                             int S, int qi, long long cut) {
  long long c = 0;
  for (int s = 0; s < S; ++s) c += pcount[(size_t)qi * S + s];
  return c <= cut;
}

struct Layout {
  int dp, ldq, dc, ldv, stage, resident;
  size_t ring, perq, lists, pend, cand;  // offsets in 4-byte words
  size_t words;
};

// Shared memory of one block, in 4-byte words: the resident query tile
// (QB x ldq) when `resident`; the ring, STAGES stages of RT rows x dc dims
// (stride ldv), the QB x dc query chunk when not resident, and the tile's
// RT norms; the per-query state; the lists; the pending buffers; the
// candidate buffer.
inline Layout make_layout(int d, int k, int resident, int full_rows) {
  Layout L;
  L.dp = (d + DCMIN - 1) / DCMIN * DCMIN;
  L.ldq = L.dp + 4;
  L.dc = full_rows ? L.dp : DCMIN;
  L.ldv = L.dc + 4;
  L.resident = resident;
  L.stage = RT * L.ldv + (resident ? 0 : QB * L.ldv) + RT;
  L.ring = resident ? (size_t)QB * L.ldq : 0;
  L.perq = L.ring + (size_t)STAGES * L.stage;   // 11 arrays of QB
  L.lists = L.perq + 11 * QB;                   // k x QB keys, k x QB ids
  L.pend = L.lists + 2 * (size_t)k * QB;        // PC x QB keys, ids
  L.cand = L.pend + 2 * (size_t)PC * QB;        // CAP rows, tags, values
  L.words = L.cand + 3 * (size_t)CAP;
  return L;
}

constexpr size_t SMEM_LIMIT = 227 * 1024;

// The first that fits: the query tile resident with whole rows per stage
// (one barrier per row tile), resident with DCMIN-dim chunks, or both
// streamed in chunks (any d).
inline Layout pick_layout(int d, int k) {
  for (int resident = 1; resident >= 0; --resident)
    for (int full = resident; full >= 0; --full) {
      const Layout L = make_layout(d, k, resident, full);
      if (L.words * 4 <= SMEM_LIMIT) return L;
    }
  return make_layout(d, k, 0, 0);  // too large: reported by the launch
}

__global__ void __launch_bounds__(TPB, 1) ft_screen(
    const float* __restrict__ queries, const float* __restrict__ vec,
    const float* __restrict__ norms, const int* __restrict__ ints,
    const float* __restrict__ floats, const float* __restrict__ valid,
    const long long* __restrict__ imask, const float* __restrict__ flo,
    const float* __restrict__ fhi, const float* __restrict__ dvec,
    const float* __restrict__ after_d, const int* __restrict__ after_i,
    int B, int N, int d, int mi, int mf, int W, int k, int exclude,
    int rows_per_split, float eps, Layout L, const int* __restrict__ pcount,
    long long cut, int* __restrict__ routes, int* __restrict__ counts,
    int* __restrict__ rescored, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qtile = sm;                           // QB x ldq (resident)
  float* ring = sm + L.ring;
  float* qn = sm + L.perq;                     // |q|^2 (the kernel's chain)
  float* qe = qn + QB;                         // eps |q|
  float* tau2 = qe + QB;                       // pass, fail: 2 x QB
  float* Dq = tau2 + 2 * QB;
  float* aft_d = Dq + QB;
  int* aft_i = reinterpret_cast<int*>(aft_d + QB);
  int* cnt = aft_i + QB;                       // pending entries
  int* scnt = cnt + QB;                        // screen candidates
  int* rcnt = scnt + QB;                       // exact re-scores
  int* mine = rcnt + QB;                       // the query takes the screen
  float* list_d = sm + L.lists;                // slot j of q: j * QB + q
  int* list_i = reinterpret_cast<int*>(list_d + (size_t)k * QB);
  float* pend_d = sm + L.pend;
  int* pend_i = reinterpret_cast<int*>(pend_d + PC * QB);
  int* cand_row = reinterpret_cast<int*>(sm + L.cand);
  int* cand_tag = cand_row + CAP;              // q | SCORED, or -1 (done)
  float* cand_val = reinterpret_cast<float*>(cand_tag + CAP);  // L2 or key
  __shared__ int ncand;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, B - q0);
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);
  const int tiles = row1 > row0 ? (row1 - row0 + RT - 1) / RT : 0;
  const int dc = L.dc, ldv = L.ldv;
  const int nch = L.dp / dc;
  const int total = tiles * nch;
  const bool vec4 = (d & 3) == 0;

  // -- the block's queries: those of the screen (all in exclusion mode) -----
  const bool own =
      tid < nq && (pcount == nullptr ||
                   !filter_first(pcount, gridDim.y, q0 + tid, cut));
  if (pcount != nullptr && !__syncthreads_or(own)) return;

  // -- the query tile, |q|^2, the per-query state ---------------------------
  if (L.resident) {
    for (int e = tid; e < QB * L.dp; e += TPB) {
      const int q = e / L.dp, c = e - q * L.dp;
      qtile[q * L.ldq + c] =
          (q < nq && c < d) ? __ldg(&queries[(size_t)(q0 + q) * d + c]) : 0.f;
    }
    __syncthreads();
  }
  if (tid == 0) ncand = 0;
  if (tid < QB) {
    const int q = tid;
    float s = 0.f;
    if (q < nq) {
      for (int j = 0; j < d; ++j) {
        const float x = L.resident ? qtile[q * L.ldq + j]
                                   : __ldg(&queries[(size_t)(q0 + q) * d + j]);
        s = fmaf(x, x, s);
      }
    }
    qn[q] = s;
    qe[q] = eps * sqrtf(s);
    Dq[q] = q < nq ? dvec[q0 + q] : 0.f;
    mine[q] = own;
    float t2[2] = {NAN, NAN};
    if (own) screen_tau2(BIG, Dq[q], exclude, t2);
    tau2[q] = t2[0];
    tau2[QB + q] = t2[1];
    const bool lb = after_d != nullptr && q < nq;
    aft_d[q] = lb ? after_d[q0 + q] : -INFINITY;
    aft_i[q] = lb ? after_i[q0 + q] : -1;
    cnt[q] = 0;
    scnt[q] = 0;
    rcnt[q] = 0;
    for (int j = 0; j < k; ++j) {
      list_d[j * QB + q] = BIG;
      list_i[j * QB + q] = -1;
    }
  }

  // -- the ring: stage s holds chunk s % nch of row tile s / nch ------------
  auto prefetch = [&](int s) {
    if (s < total) {
      float* st = ring + (size_t)(s % STAGES) * L.stage;
      const int tile = s / nch, ch = s - tile * nch;
      const int base = row0 + tile * RT, col0 = ch * dc;
      const int w = vec4 ? 4 : 1;          // floats per copy
      const int per = dc / w;              // copies per row
      for (int e = tid; e < (RT + (L.resident ? 0 : QB)) * per; e += TPB) {
        const int r = e / per, c = col0 + w * (e - r * per);
        const float* src;
        bool in;
        if (r < RT) {                      // a DB row
          in = base + r < row1 && c < d;
          src = vec + (size_t)(base + r) * d + c;
        } else {                           // a query (streamed tile)
          in = r - RT < nq && c < d;
          src = queries + (size_t)(q0 + r - RT) * d + c;
        }
        float* dst = st + r * ldv + (c - col0);
        if (vec4) cp_async16(dst, in ? src : vec, in ? 16 : 0);
        else cp_async4(dst, in ? src : vec, in ? 4 : 0);
      }
      if (ch == nch - 1 && tid < RT) {  // the tile's norms
        const bool in = base + tid < row1;
        cp_async4(st + L.stage - RT + tid, in ? norms + base + tid : norms,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

  // -- candidates: filter, exact key, pending; the owners merge -------------
  // Entry i of the buffer: row, tag = query | SCORED once its key is known
  // (-1 when done), and the screen's L2 -- later the exact key.  Rounds
  // repeat while some admitted entry found its query's pending buffer full.
  auto flush = [&](int n) {
    for (;;) {
      bool deferred = false;
      for (int i = tid; i < n; i += TPB) {
        int tag = cand_tag[i];
        if (tag < 0) continue;
        const int q = tag & (SCORED - 1), qi = q0 + q, row = cand_row[i];
        float key = cand_val[i];
        if (!(tag & SCORED)) {
          const bool pass = favor::eval_row(
              valid + (size_t)qi * W, imask + (size_t)qi * W * mi,
              flo + (size_t)qi * W * mf, fhi + (size_t)qi * W * mf, W, mi, mf,
              ints + (size_t)row * mi, floats + (size_t)row * mf);
          // the screen's bound against the current threshold of that case
          if (!(key <= tau2[pass ? q : QB + q])) {
            cand_tag[i] = -1;
            continue;
          }
          float dot = 0.f;
          const float* vp = vec + (size_t)row * d;
          if (L.resident) {
            const float* qp = qtile + (size_t)q * L.ldq;
            if (vec4) {
              const float4* v4 = reinterpret_cast<const float4*>(vp);
              for (int j = 0; j < (d >> 2); ++j) {
                const float4 v = __ldg(v4 + j);
                dot = fmaf(qp[4 * j + 0], v.x, dot);
                dot = fmaf(qp[4 * j + 1], v.y, dot);
                dot = fmaf(qp[4 * j + 2], v.z, dot);
                dot = fmaf(qp[4 * j + 3], v.w, dot);
              }
            } else {
              for (int j = 0; j < d; ++j) dot = fmaf(qp[j], __ldg(vp + j), dot);
            }
          } else {
            const float* qp = queries + (size_t)qi * d;
            for (int j = 0; j < d; ++j)
              dot = fmaf(__ldg(qp + j), __ldg(vp + j), dot);
          }
          if (rescored != nullptr) atomicAdd(&rcnt[q], 1);
          key = favor::l2_from_dot(norms[row], qn[q], dot);
          if (!pass) key = __fadd_rn(key, Dq[q]);  // exclusion mode only
          key = fminf(key, BIG);
          tag |= SCORED;
          cand_tag[i] = tag;
          cand_val[i] = key;
        }
        if (!(key < BIG) ||
            !before(key, row, list_d[(k - 1) * QB + q],
                    list_i[(k - 1) * QB + q]) ||
            !before(aft_d[q], aft_i[q], key, row)) {
          cand_tag[i] = -1;
          continue;
        }
        const int pos = atomicAdd(&cnt[q], 1);
        if (pos >= PC) {  // full: again after this round's merge
          deferred = true;
          continue;
        }
        pend_d[pos * QB + q] = key;
        pend_i[pos * QB + q] = row;
        cand_tag[i] = -1;
      }
      __syncthreads();
      if (tid < QB && cnt[tid] > 0) {
        const int q = tid, c = min(cnt[q], PC);
        for (int p = 0; p < c; ++p) {
          const float kd = pend_d[p * QB + q];
          const int ki = pend_i[p * QB + q];
          int j = k - 1;
          if (!before(kd, ki, list_d[j * QB + q], list_i[j * QB + q]))
            continue;
          while (j > 0 && before(kd, ki, list_d[(j - 1) * QB + q],
                                 list_i[(j - 1) * QB + q])) {
            list_d[j * QB + q] = list_d[(j - 1) * QB + q];
            list_i[j * QB + q] = list_i[(j - 1) * QB + q];
            --j;
          }
          list_d[j * QB + q] = kd;
          list_i[j * QB + q] = ki;
        }
        cnt[q] = 0;
        float t2[2];
        screen_tau2(list_d[(k - 1) * QB + q], Dq[q], exclude, t2);
        tau2[q] = t2[0];
        tau2[QB + q] = t2[1];
      }
      if (!__syncthreads_or(deferred)) break;
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) prefetch(s);

  const int wq = (warp >> 1) * 32, wr = (warp & 1) * 32;
  float acc[2][4][4];
  float vn2[4];  // |v|^2 shares of rows wr + nt * 8 + g (this lane's dims)

  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed everywhere; stage s - 1 consumed
    prefetch(s + STAGES - 1);

    const float* st = ring + (size_t)(s % STAGES) * L.stage;
    const int tile = s / nch, ch = s - tile * nch;
    if (ch == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) vn2[nt] = 0.f;
    }
    const float* A = L.resident ? qtile + (size_t)wq * L.ldq + ch * dc
                                : st + (RT + wq) * ldv;
    const int lda = L.resident ? L.ldq : ldv;
    const float* Bv = st + wr * ldv;
#pragma unroll 4
    for (int kk = 0; kk < dc; kk += 8) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = A + (mt * 16 + g) * lda + kk + t4;
        a[mt][0] = __float_as_uint(ap[0]);
        a[mt][1] = __float_as_uint(ap[8 * lda]);
        a[mt][2] = __float_as_uint(ap[4]);
        a[mt][3] = __float_as_uint(ap[8 * lda + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = Bv + (nt * 8 + g) * ldv + kk + t4;
        const float b0 = bp[0], b1 = bp[4];
        b[nt][0] = __float_as_uint(b0);
        b[nt][1] = __float_as_uint(b1);
        vn2[nt] = fmaf(b1, b1, fmaf(b0, b0, vn2[nt]));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a[mt], b[nt]);
    }
    if (ch != nch - 1) continue;

    // -- the row tile is complete: the screen -------------------------------
    // L2 of each of this thread's 32 pairs, in place of its dot (pair bit =
    // mt * 16 + nt * 4 + 2 * h + c: query wq + mt * 16 + g + 8 * h, row
    // wr + nt * 8 + 2 * t4 + c).  A quad's four lanes hold all dims of rows
    // wr + nt * 8 + g between them; |v| of row 2 * t4 + c of each group of
    // eight comes from the quad of that g.
    const int base = row0 + tile * RT;
    unsigned mask = 0u;
    {
      float rr[4][2], rg[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v = vn2[nt];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = wr + nt * 8 + 2 * t4 + c;
          rr[nt][c] = sqrtf(__shfl_sync(0xffffffffu, v, (2 * t4 + c) * 4));
          const float vn = st[L.stage - RT + r];
          rg[nt][c] = (base + r < row1 && vn < BIG) ? vn : NAN;  // gate
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = wq + mt * 16 + g + 8 * h;
          const float e = qe[q], n2 = qn[q], tp = tau2[q], tf = tau2[QB + q];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& a = acc[mt][nt][2 * h + c];
              const float U = __fmaf_rn(e, rr[nt][c], a);
              a = __fmaf_rn(-2.f, U, __fadd_rn(rg[nt][c], n2));
              if (a <= tp || a <= tf)
                mask |= 1u << (mt * 16 + nt * 4 + 2 * h + c);
            }
        }
    }
    if (counts != nullptr) {
      for (unsigned m = mask; m; m &= m - 1) {
        const int bit = __ffs(m) - 1;
        atomicAdd(&scnt[wq + (bit >> 4) * 16 + g + 8 * ((bit >> 1) & 1)], 1);
      }
    }
    // append to the candidate buffer; flush it when 3/4 full, or when it
    // overflowed (what did not fit goes in after the flush)
    for (;;) {
      const int want = __popc(mask);
      int slot = want ? atomicAdd(&ncand, want) : 0;
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        if ((mask >> bit & 1u) && slot < CAP) {
          cand_row[slot] = base + wr + ((bit >> 2) & 3) * 8 + 2 * t4 + (bit & 1);
          cand_tag[slot] = wq + (bit >> 4) * 16 + g + 8 * ((bit >> 1) & 1);
          cand_val[slot] = acc[bit >> 4][(bit >> 2) & 3][bit & 3];
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
  cp_async_wait<0>();
  __syncthreads();
  if (ncand > 0) flush(ncand);  // uniform: every thread reads the count
  __syncthreads();  // the lists are final (and initialised when no tile ran)

  for (int e = tid; e < nq * k; e += TPB) {
    const int q = e / k, j = e - q * k;
    if (!mine[q]) continue;                  // the filter-first path's
    const size_t off = ((size_t)(q0 + q) * gridDim.y + split) * k + j;
    part_d[off] = list_d[j * QB + q];
    part_i[off] = list_i[j * QB + q];
  }
  if (!own) return;
  if (counts != nullptr) atomicAdd(counts + q0 + tid, scnt[tid]);
  if (rescored != nullptr) atomicAdd(rescored + q0 + tid, rcnt[tid]);
  if (routes != nullptr && split == 0) routes[q0 + tid] = 0;
}


// -- the filter-first path ---------------------------------------------------

// The hull of a block's queries as tables, per attribute column c < AMAX,
// that give for a row's value the mask of the queries whose hull admits it
// (bit q for query q): for an int column, allow[c][v] for v < 32 (no
// query admits another value); for a float column, the 2 FQ interval ends
// sorted, e[0..63], and the mask at each end and in each gap between two
// (gap g lies between e[g - 1] and e[g]; gaps 0 and 64 are empty, as no
// interval reaches past its own ends).  A float's mask is found by binary
// search; NaN gets none.
constexpr int SEG = 64 + 64 + 65;   // e, at-end masks, gap masks

// Shared memory of a filter-first block, in 4-byte words: the hull tables,
// |q|^2, per (warp, query) counts; with `lists`, the FW x k x FQ lists,
// each warp's FBUF buffered pairs, its 32 scored keys and its two tiles of
// 32 pairs x TD dims (rows, queries).  Every offset is even: the tiles
// take 8-byte copies.  (The programs stay in global memory: favor::eval_row
// reads them only where a hull is not its program.)
struct FLayout {
  size_t allow, seg, qn, cnt, ld, li, brow, bq, bkey, tv, tq, words;
};

constexpr int TD = 64;              // dims of a pair per tile chunk
constexpr int TLD = TD + 2;         // a tile's row stride: the float2 reads
                                    // of 16 lanes hit 32 different banks

inline FLayout make_flayout(int k, int lists) {
  FLayout F;
  const size_t tile = (size_t)FW * 32 * TLD;
  F.allow = 0;
  F.seg = F.allow + AMAX * 32;
  F.qn = F.seg + AMAX * SEG;
  F.cnt = F.qn + FQ;
  F.ld = F.cnt + (size_t)FW * FQ;
  F.li = F.ld + (lists ? (size_t)FW * k * FQ : 0);
  F.brow = F.li + (lists ? (size_t)FW * k * FQ : 0);
  F.bq = F.brow + (lists ? (size_t)FW * FBUF : 0);
  F.bkey = F.bq + (lists ? (size_t)FW * FBUF : 0);
  F.tv = F.bkey + (lists ? (size_t)FW * 32 : 0);
  F.tq = F.tv + (lists ? tile : 0);
  F.words = F.tq + (lists ? tile : 0);
  return F;
}

// Query qi's program.
struct Program {
  const float* valid;
  const long long* imask;
  const float* flo;
  const float* fhi;
};

__device__ __forceinline__ Program program_of(
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi, int qi,
    int W, int mi, int mf) {
  const size_t g = (size_t)qi * W;
  return {valid + g, imask + g * mi, flo + g * mf, fhi + g * mf};
}

// The block's filters, set up by warp 0 (lane q for query q): the hull
// tables of favor::build_hull's hulls, and two masks over the queries,
// returned to every thread: `live` (the `mine` queries) and `exact`, whose
// hull is its program (one live disjunct, every column within the hull,
// no NaN bound: on one disjunct the hull's bit and interval tests are
// favor::eval_row's), so that the tables decide alone.
__device__ __forceinline__ void setup_filters(
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi, int q0,
    int nq, int W, int mi, int mf, const FLayout& F, float* sm, int tid,
    bool mine, unsigned& live, unsigned& exact) {
  unsigned* allow = reinterpret_cast<unsigned*>(sm + F.allow);
  unsigned* flags = reinterpret_cast<unsigned*>(sm + F.cnt);  // 2 words
  if (tid < 32) {
    const int q = tid;
    const bool in = q < nq;
    const Program P =
        program_of(valid, imask, flo, fhi, q0 + (in ? q : 0), W, mi, mf);
    favor::Hull<AMAX> h;
    favor::build_hull<AMAX>(P.valid, P.imask, P.flo, P.fhi, in ? W : 0, mi,
                            mf, h);
    int nlive = 0, w1 = 0;
    for (int w = 0; w < (in ? W : 0); ++w)
      if (P.valid[w] > 0.f) {
        ++nlive;
        w1 = w;
      }
    bool ex = nlive == 1 && mi <= AMAX && mf <= AMAX;
    for (int c = 0; c < mf && ex; ++c)
      ex = !isnan(P.flo[w1 * mf + c]) && !isnan(P.fhi[w1 * mf + c]);
    for (int c = 0; c < min(mi, AMAX); ++c)
      for (int v = 0; v < 32; ++v) {
        const unsigned b = __ballot_sync(0xffffffffu, h.ints[c] >> v & 1u);
        if (q == 0) allow[c * 32 + v] = b;
      }
    for (int c = 0; c < min(mf, AMAX); ++c) {
      float* e = sm + F.seg + c * SEG;
      unsigned* at = reinterpret_cast<unsigned*>(e + 64);
      unsigned* gap = at + 64;
      const float lo = h.lo[c], hi = h.hi[c];  // never NaN (build_hull)
      // the 64 ends in order: rank = smaller ends + equal ends before
      int rlo = 0, rhi = 0;
      for (int i = 0; i < 64; ++i) {
        const float x = __shfl_sync(0xffffffffu, i < 32 ? lo : hi, i & 31);
        rlo += x < lo || (x == lo && i < q);
        rhi += x < hi || (x == hi && i < 32 + q);
      }
      e[rlo] = lo;
      e[rhi] = hi;
      __syncwarp();
      for (int i = 0; i < 64; ++i) {
        const float x = e[i];
        const unsigned b = __ballot_sync(0xffffffffu, lo <= x && x <= hi);
        const unsigned g = __ballot_sync(
            0xffffffffu, i > 0 && lo <= e[i - 1] && hi >= x);
        if (q == 0) {
          at[i] = b;
          gap[i] = g;
        }
      }
      if (q == 0) gap[64] = 0u;
    }
    const unsigned lv = __ballot_sync(0xffffffffu, in && mine);
    const unsigned xm = __ballot_sync(0xffffffffu, ex);
    if (q == 0) {
      flags[0] = lv;
      flags[1] = xm;
    }
  }
  __syncthreads();
  live = flags[0];
  exact = flags[1];
  __syncthreads();  // the counts' words are free again
}

// The queries of a float column's table whose hull interval holds f.
__device__ __forceinline__ unsigned float_mask(const float* seg, float f) {
  if (isnan(f)) return 0u;
  int n = 0;  // the ends <= f
#pragma unroll
  for (int step = 32; step; step >>= 1)
    if (seg[n + step - 1] <= f) n += step;
  n += n == 63 && seg[63] <= f;
  const unsigned* at = reinterpret_cast<const unsigned*>(seg + 64);
  return n > 0 && seg[n - 1] == f ? at[n - 1] : at[64 + n];
}

// 32 x 32 bit transpose across a warp: lane r's bit c becomes lane c's
// bit r.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned lowm[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
    x = lane & j ? (x & ~lowm[s]) | ((y & ~lowm[s]) >> j)
                 : (x & lowm[s]) | ((y & lowm[s]) << j);
  }
  return x;
}

// The rows of a block's split, walked by each warp in rounds of 32
// consecutive rows (warp w takes rounds w, w + FW, ...).  Lane l takes row
// base + l: its norm and first AMAX attributes of each kind, loaded
// coalesced one round ahead; the tables give the live queries whose hull
// admits them, and favor::eval_row decides for each query whose hull is
// not its program.  The warp transposes the rows' query masks, and calls
// at(base, rows), rows lane q's mask of the round's rows that pass query
// q's filter.  Returns the warp's count of non-pad rows.
template <typename At>
__device__ __forceinline__ int walk_rows(
    const float* __restrict__ norms, const int* __restrict__ ints,
    const float* __restrict__ floats, int row0, int row1, int warp, int lane,
    const float* __restrict__ valid, const long long* __restrict__ imask,
    const float* __restrict__ flo, const float* __restrict__ fhi, int q0,
    int W, int mi, int mf, const FLayout& F, float* sm, unsigned live,
    unsigned exact, At at) {
  const unsigned* allow = reinterpret_cast<const unsigned*>(sm + F.allow);
  const int rounds = row1 > row0 ? (row1 - row0 + 31) / 32 : 0;
  const int ni = min(mi, AMAX), nf = min(mf, AMAX);
  int gated = 0;
  float vn = NAN;
  int ai[AMAX];
  float af[AMAX];
  auto load = [&](int rd) {
    const int r = row0 + rd * 32 + lane;
    const bool in = rd < rounds && r < row1;
    vn = in ? __ldg(norms + r) : NAN;
#pragma unroll
    for (int c = 0; c < AMAX; ++c) {
      ai[c] = in && c < ni ? __ldg(ints + (size_t)r * mi + c) : 0;
      af[c] = in && c < nf ? __ldg(floats + (size_t)r * mf + c) : 0.f;
    }
  };
  load(warp);
  for (int rd = warp; rd < rounds; rd += FW) {
    const int base = row0 + rd * 32, row = base + lane;
    const bool real = vn < BIG;  // a pad row's norm is +inf or >= BIG
    unsigned pass = real ? live : 0u;
#pragma unroll
    for (int c = 0; c < AMAX; ++c)
      if (c < ni) {
        const unsigned v = (unsigned)ai[c];
        pass &= v < 32u ? allow[c * 32 + v] : 0u;
      }
#pragma unroll
    for (int c = 0; c < AMAX; ++c)
      if (c < nf && pass) pass &= float_mask(sm + F.seg + c * SEG, af[c]);
    load(rd + FW);
    gated += __popc(__ballot_sync(0xffffffffu, real));
    for (unsigned m = pass & ~exact; m; m &= m - 1) {
      const int q = __ffs(m) - 1;
      const Program P = program_of(valid, imask, flo, fhi, q0 + q, W, mi, mf);
      if (!favor::eval_row(P.valid, P.imask, P.flo, P.fhi, W, mi, mf,
                           ints + (size_t)row * mi, floats + (size_t)row * mf))
        pass &= ~(1u << q);
    }
    at(base, transpose32(pass, lane));
  }
  return gated;
}

// The count pass: each block's count of the non-pad rows of its split that
// each of its queries' filters passes, to pcount (B x S).
__global__ void __launch_bounds__(FTPB, 8) ft_screen_count(
    const float* __restrict__ norms, const int* __restrict__ ints,
    const float* __restrict__ floats, const float* __restrict__ valid,
    const long long* __restrict__ imask, const float* __restrict__ flo,
    const float* __restrict__ fhi, int B, int N, int mi, int mf, int W,
    int rows_per_split, FLayout F, int* __restrict__ pcount) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  int* cnt = reinterpret_cast<int*>(sm + F.cnt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * FQ, nq = min(FQ, B - q0);
  const int split = blockIdx.y, S = gridDim.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);
  unsigned live, exact;
  setup_filters(valid, imask, flo, fhi, q0, nq, W, mi, mf, F, sm, tid, true,
                live, exact);
  int c = 0;  // lane q: query q's passing rows
  walk_rows(norms, ints, floats, row0, row1, warp, lane, valid, imask, flo,
            fhi, q0, W, mi, mf, F, sm, live, exact,
            [&](int, unsigned rows) { c += __popc(rows); });
  cnt[warp * FQ + lane] = c;
  __syncthreads();
  if (tid < nq) {
    int t = 0;
    for (int w = 0; w < FW; ++w) t += cnt[w * FQ + tid];
    pcount[(size_t)(q0 + tid) * S + split] = t;
  }
}

// The filter-first top-k of the block's queries that the count pass routed
// here (see the note at the top): per split, like ft_screen, into part_d /
// part_i; the other queries' lists are ft_screen's.
__global__ void __launch_bounds__(FTPB, 4) ft_screen_prefilter(
    const float* __restrict__ queries, const float* __restrict__ vec,
    const float* __restrict__ norms, const int* __restrict__ ints,
    const float* __restrict__ floats, const float* __restrict__ valid,
    const long long* __restrict__ imask, const float* __restrict__ flo,
    const float* __restrict__ fhi, const float* __restrict__ after_d,
    const int* __restrict__ after_i, int B, int N, int d, int mi, int mf,
    int W, int k, int rows_per_split, FLayout F,
    const int* __restrict__ pcount, long long cut, int* __restrict__ routes,
    int* __restrict__ counts, int* __restrict__ rescored,
    float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qn = sm + F.qn;                      // |q|^2 (the kernel's chain)
  int* cnt = reinterpret_cast<int*>(sm + F.cnt);
  float* ld = sm + F.ld;                      // slot j of (warp, q):
  int* li = reinterpret_cast<int*>(sm + F.li);  //   (warp * k + j) * FQ + q
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* brow = reinterpret_cast<int*>(sm + F.brow) + warp * FBUF;
  int* bq = reinterpret_cast<int*>(sm + F.bq) + warp * FBUF;
  float* bkey = sm + F.bkey + warp * 32;
  float* tv = sm + F.tv + warp * 32 * TLD;    // pair i's dims at i * TLD
  float* tq = sm + F.tq + warp * 32 * TLD;    // pair i's query dims
  const int q0 = blockIdx.x * FQ, nq = min(FQ, B - q0);
  const int split = blockIdx.y, S = gridDim.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(N, row0 + rows_per_split);
  const int qi = q0 + lane;
  const bool mine = lane < nq && filter_first(pcount, S, qi, cut);
  if (!__syncthreads_or(mine)) return;
  unsigned live, exact;
  setup_filters(valid, imask, flo, fhi, q0, nq, W, mi, mf, F, sm, tid, mine,
                live, exact);
  if (tid < FQ) {
    float s = 0.f;
    if (tid < nq) {
      const float* x = queries + (size_t)(q0 + tid) * d;
#pragma unroll 16
      for (int j = 0; j < d; ++j) s = fmaf(__ldg(x + j), __ldg(x + j), s);
    }
    qn[tid] = s;
  }
  for (int j = 0; j < k; ++j) {
    ld[(warp * k + j) * FQ + lane] = BIG;
    li[(warp * k + j) * FQ + lane] = -1;
  }
  __syncthreads();
  const bool lb = after_d != nullptr && mine;
  const float aft_d = lb ? after_d[qi] : -INFINITY;
  const int aft_i = lb ? after_i[qi] : -1;
  float* my_d = ld + warp * k * FQ + lane;   // this lane's list, stride FQ
  int* my_i = li + warp * k * FQ + lane;
  int passed = 0;
  float dot = 0.f;  // lane i's running chain for buffered pair i

  // The exact keys of buffered pairs 0..n-1, lane i pair i: dims in chunks
  // of TD, each pair's chunk of its row and of its query copied by the
  // whole warp (cp.async, coalesced, every copy of the chunk in flight at
  // once) into the warp's two tiles; then each lane's fmaf chain runs on
  // over its own pair's chunk: dims 0..d-1 in order, so the chain is the
  // one of the note at the top.  Then each owner lane inserts its query's
  // keys, all owners at once.
  auto score = [&](int n) {
    __syncwarp();
    const bool even = (d & 1) == 0;  // 8-byte copies (2 dims a lane)
    for (int j0 = 0; j0 < d; j0 += TD) {
      const int w = min(TD, d - j0);
      for (int i = 0; i < n; ++i) {
        const float* vr = vec + (size_t)brow[i] * d + j0;
        const float* qr = queries + (size_t)(q0 + bq[i]) * d + j0;
        float* dv = tv + i * TLD;
        float* dq = tq + i * TLD;
        if (even) {
          const int c = 2 * lane;
          if (c < w) {
            cp_async8(dv + c, vr + c);
            cp_async8(dq + c, qr + c);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = lane + 32 * h;
            if (c < w) {
              cp_async4(dv + c, vr + c, 4);
              cp_async4(dq + c, qr + c, 4);
            }
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      if (lane < n) {
        const float2* vp = reinterpret_cast<const float2*>(tv + lane * TLD);
        const float2* qp = reinterpret_cast<const float2*>(tq + lane * TLD);
        for (int j = 0; j < (w >> 1); ++j) {
          const float2 v = vp[j], x = qp[j];
          dot = fmaf(x.x, v.x, dot);
          dot = fmaf(x.y, v.y, dot);
        }
        if (w & 1)
          dot = fmaf(tq[lane * TLD + w - 1], tv[lane * TLD + w - 1], dot);
      }
      __syncwarp();
    }
    if (lane < n) {
      const int q = bq[lane];
      const float key = favor::l2_from_dot(__ldg(norms + brow[lane]), qn[q],
                                           dot);
      bkey[lane] = fminf(key, BIG);
      dot = 0.f;
    }
    __syncwarp();
    unsigned own = 0u;  // the entries of this lane's query: every owner
    for (int e = 0; e < n; ++e) own |= (unsigned)(bq[e] == lane) << e;
    passed += __popc(own);  // inserts its own at once
    for (; own; own &= own - 1) {
      const int e = __ffs(own) - 1;
      const float key = bkey[e];
      const int row = brow[e];
      if (!(key < BIG) || !before(key, row, my_d[(k - 1) * FQ],
                                  my_i[(k - 1) * FQ]) ||
          !before(aft_d, aft_i, key, row))
        continue;
      int j = k - 1;
      while (j > 0 &&
             before(key, row, my_d[(j - 1) * FQ], my_i[(j - 1) * FQ])) {
        my_d[j * FQ] = my_d[(j - 1) * FQ];
        my_i[j * FQ] = my_i[(j - 1) * FQ];
        --j;
      }
      my_d[j * FQ] = key;
      my_i[j * FQ] = row;
    }
    __syncwarp();
  };

  // each lane's passing pairs (each row of its mask, its query) go to the
  // warp's buffer in lane order, as many as fit; 32 at a time are scored
  int nb = 0;
  const int gated = walk_rows(
      norms, ints, floats, row0, row1, warp, lane, valid, imask, flo, fhi, q0,
      W, mi, mf, F, sm, live, exact, [&](int base, unsigned rows) {
        if (!__any_sync(0xffffffffu, rows != 0u)) return;
        for (unsigned rest = rows;;) {
          const int own = __popc(rest);
          int pre, total;  // exclusive prefix over the lanes, and the sum
          if (__all_sync(0xffffffffu, own <= 1)) {
            const unsigned b = __ballot_sync(0xffffffffu, own);
            pre = __popc(b & ((1u << lane) - 1u));
            total = __popc(b);
          } else {
            pre = own;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int t = __shfl_up_sync(0xffffffffu, pre, o);
              if (lane >= o) pre += t;
            }
            total = __shfl_sync(0xffffffffu, pre, 31);
            pre -= own;
          }
          if (total == 0) break;
          for (int slot = nb + pre; rest && slot < FBUF; ++slot) {
            brow[slot] = base + __ffs(rest) - 1;
            bq[slot] = lane;
            rest &= rest - 1;
          }
          nb = min(FBUF, nb + total);
          while (nb >= 32) {
            score(32);
            if (lane < nb - 32) {  // the tail moves to the front
              brow[lane] = brow[32 + lane];
              bq[lane] = bq[32 + lane];
            }
            nb -= 32;
            __syncwarp();
          }
        }
      });
  if (nb > 0) score(nb);

  // -- the FW lists of each query, merged by its owner thread --------------
  cnt[warp * FQ + lane] = passed;
  __syncthreads();
  if (tid < FQ && mine) {
    int head[FW];
    int rs = 0;
#pragma unroll
    for (int w = 0; w < FW; ++w) {
      head[w] = 0;
      rs += cnt[w * FQ + tid];
    }
    float* pd = part_d + ((size_t)qi * S + split) * k;
    int* pi = part_i + ((size_t)qi * S + split) * k;
    for (int t = 0; t < k; ++t) {
      float bd = BIG;
      int bi = -1, bw = -1;
#pragma unroll
      for (int w = 0; w < FW; ++w) {
        const int h = head[w];
        if (h >= k) continue;
        const float cd = ld[(w * k + h) * FQ + tid];
        const int ci = li[(w * k + h) * FQ + tid];
        if (cd < BIG && (bw < 0 || before(cd, ci, bd, bi))) {
          bd = cd;
          bi = ci;
          bw = w;
        }
      }
      pd[t] = bd;
      pi[t] = bi;
#pragma unroll
      for (int w = 0; w < FW; ++w) head[w] += w == bw;
    }
    if (rescored != nullptr) atomicAdd(rescored + qi, rs);
    if (routes != nullptr && split == 0) routes[qi] = 1;
  }
  if (counts != nullptr) {  // the non-pad rows: the warps' gated rows
    __syncthreads();
    if (lane == 0) cnt[warp * FQ] = gated;
    __syncthreads();
    if (tid < FQ && mine) {
      int g = 0;
      for (int w = 0; w < FW; ++w) g += cnt[w * FQ];
      atomicAdd(counts + qi, g);
    }
  }
}

}  // namespace

extern "C" {

int filtered_topk_max_k() { return KMAX; }
int filtered_topk_query_tile() { return QB; }
int filtered_topk_tile_rows() { return RT; }

// queries (B, d); after_d / after_i: (B,) per-query lower bound, or both
// null; counts / rescored: (B,) int32 the screen's candidates (on the
// filter-first path: the non-pad rows) / the exact re-scores are added to,
// or null; routes: (B,) int32 set to 1 where the query took the
// filter-first path and 0 where it took the screen, or null; pcount:
// (B, splits) int32 scratch of the count pass (PreFBF mode; null in
// exclusion mode); part_d / part_i: (B, splits, k) scratch; out_d / out_i:
// (B, k).  Returns cudaGetLastError() after the launches (0 = launched).
int filtered_topk_launch(const void* queries, const void* vec,
                         const void* norms, const void* ints,
                         const void* floats, const void* valid,
                         const void* imask, const void* flo, const void* fhi,
                         const void* dvec, const void* after_d,
                         const void* after_i, int B, int N, int d, int mi,
                         int mf, int W, int k, int exclude, int splits,
                         float eps, void* counts, void* rescored,
                         void* routes, void* pcount, void* part_d,
                         void* part_i, void* out_d, void* out_i,
                         void* stream) {
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  if (!exclude && pcount == nullptr) return (int)cudaErrorInvalidValue;
  const Layout L = pick_layout(d, k);
  const size_t smem = 4 * L.words;
  cudaError_t err = cudaFuncSetAttribute(
      ft_screen, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = (N + splits - 1) / splits;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long cut = (long long)(FF_SHARE * (double)N);
  const dim3 fgrid((B + FQ - 1) / FQ, splits);
  const FLayout FC = make_flayout(k, 0);
  const FLayout FP = make_flayout(k, 1);
  if (!exclude) {
    err = cudaFuncSetAttribute(ft_screen_count,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(4 * FC.words));
    if (err != cudaSuccess) return (int)err;
    ft_screen_count<<<fgrid, FTPB, 4 * FC.words, st>>>(
        static_cast<const float*>(norms), static_cast<const int*>(ints),
        static_cast<const float*>(floats), static_cast<const float*>(valid),
        static_cast<const long long*>(imask), static_cast<const float*>(flo),
        static_cast<const float*>(fhi), B, N, mi, mf, W, rows_per_split, FC,
        static_cast<int*>(pcount));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + QB - 1) / QB, splits);
  ft_screen<<<grid, TPB, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(vec),
      static_cast<const float*>(norms), static_cast<const int*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(valid),
      static_cast<const long long*>(imask), static_cast<const float*>(flo),
      static_cast<const float*>(fhi), static_cast<const float*>(dvec),
      static_cast<const float*>(after_d), static_cast<const int*>(after_i), B,
      N, d, mi, mf, W, k, exclude, rows_per_split, eps, L,
      exclude ? nullptr : static_cast<const int*>(pcount), cut,
      static_cast<int*>(routes), static_cast<int*>(counts),
      static_cast<int*>(rescored), static_cast<float*>(part_d),
      static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!exclude) {
    err = cudaFuncSetAttribute(ft_screen_prefilter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(4 * FP.words));
    if (err != cudaSuccess) return (int)err;
    ft_screen_prefilter<<<fgrid, FTPB, 4 * FP.words, st>>>(
        static_cast<const float*>(queries), static_cast<const float*>(vec),
        static_cast<const float*>(norms), static_cast<const int*>(ints),
        static_cast<const float*>(floats), static_cast<const float*>(valid),
        static_cast<const long long*>(imask), static_cast<const float*>(flo),
        static_cast<const float*>(fhi), static_cast<const float*>(after_d),
        static_cast<const int*>(after_i), B, N, d, mi, mf, W, k,
        rows_per_split, FP, static_cast<const int*>(pcount), cut,
        static_cast<int*>(routes), static_cast<int*>(counts),
        static_cast<int*>(rescored), static_cast<float*>(part_d),
        static_cast<int*>(part_i));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  favor::merge_splits<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      splits, k, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
