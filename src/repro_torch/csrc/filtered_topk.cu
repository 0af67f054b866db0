// Fused filtered brute-force top-k: L2 distance + DNF filter program +
// PreFBF mask (fail -> dropped) or exclusion distance (+D, Eq. 2) + running
// top-k, as a TF32 tensor-core screen followed by an exact f32 re-score.
//
// Replaces the TPU kernel src/repro/kernels/filtered_topk/kernel.py:
// filtered_topk_pallas (body _kernel, helpers _eval_program_tile and
// _topk_merge).
//
// What bounds it on an H100: operations.  Every (query, row) pair costs a
// d-long dot product, 2*B*N*d operations against 4*N*d bytes read once
// (B = 1024, N = 4M, d = 128: 1.05e12 operations, 2.1 GB).  Computed
// exactly on the f32 FMA pipes that is 15.6 ms at 67 TFLOP/s; this kernel
// computes every dot approximately on the tensor cores in TF32 (495 TFLOP/s
// dense: a 2.12 ms bound) and exactly only for the few pairs that the
// approximation cannot rule out.  No returned number passes through TF32.
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
// Per candidate, in this order: the filter program (favor::eval_row); the
// screen's L2 against the threshold of that outcome (in PreFBF mode a
// failing row stops here); the exact distance -- one fmaf chain over dims
// 0..d-1 from 0.f, then favor::l2_from_dot -- from the exact query and row
// values; + D where the row fails, in exclusion mode; clamp to BIG;
// insertion when (key, id) comes before the list's last entry and strictly
// after the per-query lower bound (after_d, after_i) when one is given
// (how the wrapper chains passes of KMAX for a larger k,
// kernels/_common.py chain_topk).  Every returned distance comes from that
// per-pair chain, so it does not depend on the tile, the split or the
// batch width: bucket padding relies on it.
//
// Design:
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
// (query tile and whole-row stages) fits at d = 128, 45,440 words beside
// 256 words per list entry within 58,112 (make_layout); a larger k chains
// passes in the wrapper.
constexpr int KMAX = 48;
constexpr int STAGES = 2;           // cp.async ring stages
constexpr int PC = 16;              // pending candidates per query a round
constexpr int CAP = 2048;           // candidate buffer entries per block
constexpr int SCORED = 1 << 16;     // candidate tag bit: exact key known
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
  L.perq = L.ring + (size_t)STAGES * L.stage;   // 10 arrays of QB
  L.lists = L.perq + 10 * QB;                   // k x QB keys, k x QB ids
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
    int rows_per_split, float eps, Layout L, int* __restrict__ counts,
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
    float t2[2] = {NAN, NAN};
    if (q < nq) screen_tau2(BIG, Dq[q], exclude, t2);
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
    const size_t off = ((size_t)(q0 + q) * gridDim.y + split) * k + j;
    part_d[off] = list_d[j * QB + q];
    part_i[off] = list_i[j * QB + q];
  }
  if (counts != nullptr && tid < nq) atomicAdd(counts + q0 + tid, scnt[tid]);
  if (rescored != nullptr && tid < nq)
    atomicAdd(rescored + q0 + tid, rcnt[tid]);
}

}  // namespace

extern "C" {

int filtered_topk_max_k() { return KMAX; }
int filtered_topk_query_tile() { return QB; }
int filtered_topk_tile_rows() { return RT; }

// queries (B, d); after_d / after_i: (B,) per-query lower bound, or both
// null; counts / rescored: (B,) int32 the screen's candidates / the exact
// re-scores are added to, or null; part_d / part_i: (B, splits, k)
// scratch; out_d / out_i: (B, k).
// Returns cudaGetLastError() after the launches (0 = launched).
int filtered_topk_launch(const void* queries, const void* vec,
                         const void* norms, const void* ints,
                         const void* floats, const void* valid,
                         const void* imask, const void* flo, const void* fhi,
                         const void* dvec, const void* after_d,
                         const void* after_i, int B, int N, int d, int mi,
                         int mf, int W, int k, int exclude, int splits,
                         float eps, void* counts, void* rescored,
                         void* part_d, void* part_i, void* out_d, void* out_i,
                         void* stream) {
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  const Layout L = pick_layout(d, k);
  const size_t smem = 4 * L.words;
  cudaError_t err = cudaFuncSetAttribute(
      ft_screen, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = (N + splits - 1) / splits;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((B + QB - 1) / QB, splits);
  ft_screen<<<grid, TPB, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(vec),
      static_cast<const float*>(norms), static_cast<const int*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(valid),
      static_cast<const long long*>(imask), static_cast<const float*>(flo),
      static_cast<const float*>(fhi), static_cast<const float*>(dvec),
      static_cast<const float*>(after_d), static_cast<const int*>(after_i), B,
      N, d, mi, mf, W, k, exclude, rows_per_split, eps, L,
      static_cast<int*>(counts), static_cast<int*>(rescored),
      static_cast<float*>(part_d), static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  favor::merge_splits<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      splits, k, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
