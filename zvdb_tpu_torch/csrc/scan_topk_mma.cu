// Exact flat top-k (kernels E and F) with a tensor-core filter, for sm_90a.
//
// Replaces examples/pallas_scan_v1.py:_scan_kernel (wrapper flat_topk_pallas)
// and examples/pallas_scan_v2.py:_scan_kernel (wrapper flat_topk_pallas2),
// and the CUDA-core kernels of csrc/scan_topk.cu (zvdb_flat_topk_v1 and
// zvdb_flat_topk_v2_passes), whose one function both entry points here
// compute bit for bit: for each query the chunks of `chunk` rows
// are taken in order; a chunk's effect is its k smallest (score, row) pairs,
// ties to the lower row, replayed against a k-slot buffer (first argmax
// slot, strict <, stop at the first pair not taken), with
//
//     s = nrm - 2.f * acc   (l2)     s = -acc   (any other metric),
//     acc = fmaf(q_d, x_d, acc) over d = 0 .. D-1 in order,
//     nrm = fmaf(x_d, x_d, nrm) over d = 0 .. D-1 in order,
//
// both chains in f32 from 0, exactly as csrc/scan_topk.cu:score_chunk sums
// them. Ids are -1 wherever the final score is not finite; the output is in
// slot order.
//
// What bounds it. The f32 function is 2*B*N*D operations: 7.83 ms at B=2048,
// N=1M, D=128 on the 67 TFLOP/s f32 pipes, which is the old kernel's bound.
// Here the tensor cores only filter: three bf16 products (q_hi.x_hi +
// q_hi.x_lo + q_lo.x_hi) over the rounded-up depth DP are 6*B*N*DP
// operations, 1.59 ms at the 989 TFLOP/s dense bf16 rate. Each query tile
// streams the bf16 planes (544 MB at 1M x 128 with the row padding) from L2:
// B/QT x 544 MB a batch, 70 GB at QT = 16. That stream sets the pace:
// topk_tile_sweep.py times the kernel without its mmas and without its copies.
//
// Design.
//   1. Pre-pass (prep_kernel): one read of the f32 corpus writes the bf16
//      planes x_hi = rn(x), x_lo = rn(x - x_hi), tiled as the scan copies
//      them ([plane][D chunk][row][KC + 8], zero past D), the exact f32 norms
//      nrm (the chain above, equal to the old kernel's bit for bit) and
//      xn >= ||x||. The split runs once a call, not once per query tile.
//   2. Scan. One block per tile of QT = 16 queries walks every chunk in
//      order: 8 consumer warps and one producer warp. The tile's hi/lo
//      planes sit in shared memory for the whole walk (all of DP) and feed
//      ldmatrix. Each step of NT = 128 rows (a D chunk of KC <= 128 at a
//      time) arrives by bulk copies (one per plane, plus the step's nrm and
//      xn) into a ring of up to three stages: the producer issues a slot's
//      copies, across chunk boundaries, as soon as every consumer warp has
//      arrived on the slot's empty mbarrier, and they complete on its full
//      mbarrier. A consumer warp owns 16 columns: per k16, 4 ldmatrix feed
//      6 mma.sync.m16n8k16 bf16 with f32 accumulation, the three products in
//      turn over both tiles. With a producer warp the copies no longer wait
//      for the slowest consumer's mmas behind a block barrier.
//   3. Filter, on the accumulator fragments. s~ = nrm - 2 acc~ (or -acc~).
//      T_b is query b's buffer worst at the start of the chunk (it only
//      falls within a chunk). Column c goes to b's candidate list (shared
//      memory, an atomic counter) when s~ <= T_b + margin(b, c). A query whose
//      buffer is not full yet (T_b = +inf) pushes nothing.
//   4. Replay, one warp per query. Each candidate is re-scored with the exact
//      chains above from the f32 row (which L2 still holds), then candidates
//      are taken in (score, row) order against the buffer with the first
//      argmax slot, strict <, stopping at the first pair not taken (and
//      after k rounds). A query with T_b = +inf, or whose list overflowed its
//      capacity (max(64, 2k)), re-scores the whole chunk exactly into a row
//      of global scratch and runs the old kernel's k rounds: never
//      approximate. The copies of the next chunk's first steps are in flight
//      meanwhile.
//   Why this is exact: every column outside the list has an exact score
//   s > T_b >= the buffer's worst at any time during the chunk, so it can
//   never be taken, and every pair after it in (score, row) order cannot be
//   taken either; so the replay of the list gives the chunk's whole effect.
//   Every legal shape fits: a deep D takes a smaller KC, a large k or chunk
//   fewer ring stages (make_plan).
//
// F, zvdb_flat_topk_v2_mma: E's pre-pass, then the contract of csrc/
// scan_topk.cu's F in three passes. The pairs pass (a filter pass and a
// select pass) writes each (query, chunk)'s k smallest (score, row) pairs,
// ascending, ties to the lower row, (+inf, -1) past the chunk's finite
// scores; the fold (scan_topk.cu's, by copy) replays them per query in chunk
// order. What F has that E lacks is parallelism over chunks: a block takes a
// tile of QF = 64 queries (16 when B <= 16 or the lists do not fit) and the
// chunks j = blockIdx.y + m gy of query tiles blockIdx.x + m' gx, gx * gy ~
// one block per SM, so a batch streams the planes B / 64 times (17.4 GB at
// B = 2048 and 1M x 128), not B / 16 times, and a small batch still fills
// the card. The mma step and the bf16x3 products are E's; the block has
// eight warps and no producer warp (lane 0 of warp 0 issues the copies: a
// ninth warp caps every thread at 168 registers). What F cannot borrow is
// E's threshold, an exact score carried over from earlier chunks: a chunk's
// pairs depend on that chunk alone, so the block finds a bound inside it.
//   Filter pass. For query b and column c, M_c = margin(b, c) (below),
//   L_c = s~_c - M_c (rounded down), U_c = s~_c + M_c (rounded up). Query b's
//   list in shared memory holds (s~, M rounded up to bf16 precision, column)
//   for every column with L_c <= T_b, pushed from the accumulator fragments
//   (one atomic per row and group of 4 lanes). T_b only falls:
//   - k <= 32: each of the 32 lanes that see b's columns keeps the smallest
//     key of U among them, and T_b = the k-th smallest of those 32 minima,
//     taken after the chunk's first step (before its pushes), after steps 1,
//     3, 7, ... and at its end; between those T_b holds, and the filter needs
//     no barrier. After the first step a lane's minimum takes only columns
//     the filter took: one not taken has U > T_b, and T_b = min(T_b, bound).
//   - k > 32: T_b = the k-th smallest U of the list (a radix select), once
//     the list holds k columns (it holds every column until then) and when
//     it passes cap - headroom entries.
//   A list past cap - headroom at a bound drops the entries with L > T_b. At
//   the chunk's end the entries with L <= T_b are kept and their columns go
//   to a scratch for the select pass. A list that overflows its capacity
//   (more than the headroom survives a bound: near-ties) has the whole chunk
//   re-scored exactly into a global row and scan_topk.cu's k rounds run
//   over it, in the filter pass: never approximate.
//   Select pass. One warp per (query, chunk) re-scores the survivors with the
//   exact chains from the f32 rows and sorts them on (score, column): about
//   k + 2 chains per (query, chunk), 1.2e7 at B = 2048 over 1M rows (E needs
//   0.14 per chunk), each a chain of dependent loads. Many warps hide those
//   loads, which at the filter pass's chunk end stalled every warp.
//   Why this is exact. Let s_k be the chunk's k-th smallest exact score. T_b
//   is always U of k distinct columns or above: the k-th smallest of some U
//   (the lanes' minima are U of 32 distinct columns). Those k columns have
//   exact scores s <= U <= T_b, so s_k <= T_b. A column kept out of the
//   list, or dropped from it, had L > T' for a T' >= T_b, so its exact score
//   s >= L > T_b >= s_k: it is strictly outside the chunk's k smallest pairs
//   whatever the tie rule, and so those pairs are the k smallest of the
//   survivors, whose scores are the exact chains.
//
// The margin, proven. u = 2^-24; P = sum_d |q_d x_d| <= ||q|| ||x||;
// DP = D rounded up to 16; a = the exact chain's dot, a~ the filter's.
//   (a) Split. bf16 has 8 significant bits, so |v - hi| <= 2^-8 |v| and
//       |v - hi - lo| <= 2^-16 |v|. The terms dropped from q.x per depth
//       (q_hi r_x, q_lo x_lo, r_q x_hi and smaller) are <= 3.03 * 2^-16
//       |q_d x_d| = 776 u |q_d x_d|.
//   (b) Tensor cores. The bf16 products are exact in f32; each mma adds 16
//       of them to its accumulator in a way that is not IEEE round-to-
//       nearest. A generous model: one mma's error <= 16 u (|c| + sum|ab|),
//       and |c| + sum|ab| <= 1.02 P. There are 3 DP / 16 mmas per score:
//       <= 3.06 DP u P.
//   (c) The exact chain itself: |a - q.x| <= 1.0001 D u P.
//   So |a~ - a| <= u P (776 + 4.07 DP). (d) Both scores round nrm - 2a once:
//   |s~ - s| <= 2 |a~ - a| (1 + u) + 2 u (nrm + 2.001 P)
//           <= u ((1557 + 8.15 DP) P + 2 nrm).
//   (e) Near underflow (bf16 or f32 subnormals flushed inside the mma, the
//       chains' subnormal roundings) each depth adds at most 2^-126
//       (|q_d| + |x_d| + 3) absolutely: <= 2^-100 DP (1 + ||q|| + ||x||).
// The kernel uses, with at least 2x headroom on every term,
//   margin = 2^-24 ((4096 + 18 DP) qn xn + 5 nrm) + 2^-100 DP (1 + qn + xn)
// with qn >= ||q|| and xn >= ||x|| (sqrtf of the chain, times 1 + 2^-13, plus
// 2^-60 for sums that underflowed), and rounds the threshold T_b + margin
// upwards (__fadd_ru). ops/scan_topk.py:filter_margin states the same
// formula, and its CPU test checks it against an emulated split. Inputs are
// taken finite and below bf16's largest value (~3.39e38) in magnitude.
//
// Built like scan_topk.cu: -O3, no fast-math, so fmaf and sqrtf are IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// Tile constants; topk_tile_sweep.py builds other values to time them.
#ifndef ZVDB_TOPK_MQ
#define ZVDB_TOPK_MQ 1   // m16 query tiles per block
#endif
#ifndef ZVDB_TOPK_NJ
#define ZVDB_TOPK_NJ 2   // n8 column tiles per warp
#endif
#ifndef ZVDB_TOPK_DIAG
#define ZVDB_TOPK_DIAG 0   // timing only: 1 skips the mmas, 2 the copies, and in F 3 the
                           // lists (so the mmas too: the copies alone) (wrong results);
                           // F 5 runs as 0 with its filter pass's counts replaced by the
                           // warps' cycles in: the mma steps, the waits (copies,
                           // barriers) with the bounds, the filter, the mmas' drain
                           // before it, the chunk ends
#endif
// F's pairs pass; topk_tile_sweep.py builds other values to time them.
#ifndef ZVDB_TOPK2_MQ
#define ZVDB_TOPK2_MQ 4    // m16 query tiles per block when B > 16 (16 queries at most else)
#endif
#ifndef ZVDB_TOPK2_HEAD
#define ZVDB_TOPK2_HEAD 0  // a list's headroom in entries; 0: 64 for k <= 32, else 2k
                           // clamped to [32, 128]
#endif
#ifndef ZVDB_TOPK2_PARTS
#define ZVDB_TOPK2_PARTS 0 // blocks along the chunks per query tile; 0: fill the SMs
#endif

namespace {

constexpr int MQ = ZVDB_TOPK_MQ;
constexpr int QT = 16 * MQ;          // queries per block
constexpr int NJ = ZVDB_TOPK_NJ;
constexpr int DIAG = ZVDB_TOPK_DIAG;
constexpr int NT = 128;              // corpus rows per step
constexpr int WARPS = NT / (8 * NJ); // each owns 8*NJ of the step's columns
constexpr int THREADS = 32 * (WARPS + 1);   // the consumer warps and one producer warp
constexpr int SMAX = 3;              // deepest ring of corpus steps
constexpr int PAD = 8;               // bf16 of padding per plane row (ldmatrix banks)
constexpr int KMAX = 256;
constexpr int CHUNK_MAX = 4096;
constexpr int DMAX = 1024;
constexpr int PREP_ROWS = 128;       // rows per pre-pass block
constexpr int PREP_DK = 32;          // depths per pre-pass stage
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 0x7fffffff;
constexpr int FMQ = ZVDB_TOPK2_MQ;
constexpr int FOLD_QT = 8;           // queries per block of F's fold, one warp each
constexpr int SEL_WARPS = 8;         // (query, chunk) lists per block of F's select pass
constexpr int KPL = 13;              // list entries per lane in a select: the largest cap is 388
constexpr float XN_SLACK = 1.f + 0x1p-13f;
constexpr float XN_FLOOR = 0x1p-60f;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8
// (registers only, so not volatile: the compiler may interleave it with the
// next k step's ldmatrix).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the old kernel's replay rules (csrc/scan_topk.cu), by copy ----------

// The smallest (score, column) of row[0, width), ties to the lower column:
// every lane of the warp gets it. (+inf, NONE) when nothing is below +inf.
__device__ __forceinline__ void warp_argmin(const float* row, int width, float& m, int& am) {
  const int lane = threadIdx.x & 31;
  float v = pos_inf();
  int i = NONE;
  for (int c = lane; c < width; c += 32) {
    const float s = row[c];
    if (s < v) {
      v = s;
      i = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (v2 < v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
  m = v;
  am = i;
}

// The buffer's largest score and its FIRST slot, to every lane.
__device__ __forceinline__ void warp_argmax(const float* bs, int k, float& worst, int& aw) {
  const int lane = threadIdx.x & 31;
  float v = -pos_inf();
  int i = NONE;
  for (int s = lane; s < k; s += 32) {
    const float b = bs[s];
    if (i == NONE || b > v) {
      v = b;
      i = s;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (i2 != NONE && (i == NONE || v2 > v || (v2 == v && i2 < i))) {
      v = v2;
      i = i2;
    }
  }
  worst = v;
  aw = i;
}

// Slot aw of the warp's buffer takes (m, id) when m < worst; the new worst
// and its first slot follow. Returns whether it took the pair.
__device__ __forceinline__ bool fold_pair(float m, int id, float* bs, int* bi, int k,
                                          float& worst, int& aw) {
  if (!(m < worst)) return false;
  if ((threadIdx.x & 31) == 0) {
    bs[aw] = m;
    bi[aw] = id;
  }
  __syncwarp();
  warp_argmax(bs, k, worst, aw);
  return true;
}

// ---- exact scores -------------------------------------------------------

// acc = fmaf(q_d, x_d, acc) over d = 0 .. D-1 in order, from 0. The loads
// of a batch of depths are issued before its FMAs, so that a row read from
// L2 or device memory costs a few round trips, not one per depth.
template <bool VEC>
__device__ __forceinline__ float exact_dot(const float* __restrict__ q,
                                           const float* __restrict__ x, int D) {
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int U = 4;   // float4 per batch
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = D / 4;
    for (int d0 = 0; d0 < n4; d0 += U) {
      float4 a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d0 + u < n4) {
          a[u] = __ldg(q4 + d0 + u);
          b[u] = __ldg(x4 + d0 + u);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d0 + u < n4) {
          acc = fmaf(a[u].x, b[u].x, acc);
          acc = fmaf(a[u].y, b[u].y, acc);
          acc = fmaf(a[u].z, b[u].z, acc);
          acc = fmaf(a[u].w, b[u].w, acc);
        }
    }
  } else {
    constexpr int U = 16;
    for (int d0 = 0; d0 < D; d0 += U) {
      float a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d0 + u < D) {
          a[u] = __ldg(q + d0 + u);
          b[u] = __ldg(x + d0 + u);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d0 + u < D) acc = fmaf(a[u], b[u], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float exact_score(float acc, float nrm, bool l2) {
  return l2 ? nrm - 2.f * acc : -acc;
}

// The smallest (score, id) of the n candidates, ties to the lower id; its
// position in the list to every lane (-1 when nothing is below +inf).
__device__ __forceinline__ void warp_argmin_pair(const float* sc, const int* ids, int n,
                                                 float& m, int& id, int& pos) {
  const int lane = threadIdx.x & 31;
  float v = pos_inf();
  int i = NONE, p = -1;
  for (int c = lane; c < n; c += 32) {
    const float s = sc[c];
    const int j = ids[c];
    if (s < v || (s == v && j < i)) {
      v = s;
      i = j;
      p = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    const int p2 = __shfl_xor_sync(FULL, p, o);
    if (v2 < v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
      p = p2;
    }
  }
  m = v;
  id = i;
  pos = p;
}

// ---- 1. the pre-pass ----------------------------------------------------

// The bf16 planes, tiled for the scan: plane p (0 hi, 1 lo), D chunk ch,
// row r at planes[((p * nch + ch) * npad + r) * xrow + d % kc] (zero past D;
// the row padding and the rows past N are never read as data); nrm [N] the
// exact chain; xn [N] >= ||x||.
__global__ void __launch_bounds__(PREP_ROWS)
prep_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes,
            float* __restrict__ nrm, float* __restrict__ xn, int N, int D, int dp, int kc,
            long long npad) {
  __shared__ float tile[PREP_ROWS][PREP_DK + 1];
  const long long row0 = (long long)blockIdx.x * PREP_ROWS;
  const int rows = (int)min((long long)PREP_ROWS, (long long)N - row0);
  const int t = threadIdx.x, nch = dp / kc, xrow = kc + PAD;
  float acc = 0.f;
  for (int d0 = 0; d0 < dp; d0 += PREP_DK) {
    for (int e = t; e < PREP_ROWS * PREP_DK; e += PREP_ROWS) {
      const int r = e / PREP_DK, c = e % PREP_DK, d = d0 + c;
      if (r < rows && d < dp) {
        const long long row = row0 + r;
        const float v = d < D ? __ldg(x + row * D + d) : 0.f;
        tile[r][c] = v;
        const __nv_bfloat16 h = __float2bfloat16_rn(v);
        const long long at = ((long long)(d / kc) * npad + row) * xrow + d % kc;
        planes[at] = h;
        planes[at + nch * npad * xrow] = __float2bfloat16_rn(v - __bfloat162float(h));
      }
    }
    __syncthreads();
    if (t < rows) {
      const int dn = min(PREP_DK, D - d0);
      for (int c = 0; c < dn; ++c) acc = fmaf(tile[t][c], tile[t][c], acc);
    }
    __syncthreads();
  }
  if (t < rows) {
    nrm[row0 + t] = acc;
    xn[row0 + t] = sqrtf(acc) * XN_SLACK + XN_FLOOR;
  }
}

// ---- 2-4. scan, filter, replay -----------------------------------------

struct Stats {   // optional counters (stats != nullptr): see the entry point
  unsigned long long cand, cand_max, overflow, cold, lists;
};

// The launch's shape: the D chunk kc, the ring depth, the list capacity, and
// the byte sizes the kernel and the wrapper share.
struct Plan {
  int dp, kc, nch, stages, cap, cw;
  long long npad;
  size_t stage_bytes, smem, planes_bytes, scratch_bytes;
};

constexpr size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

// The deepest D chunk (a multiple of 16 dividing DP, at most 128), then the
// deepest ring (3 or 2 stages), that fit `smem_max`; kc = 0 when none does.
Plan make_plan(int B, int N, int D, int k, int chunk, int smem_max) {
  Plan p{};
  p.dp = (D + 15) / 16 * 16;
  p.cap = std::max(64, 2 * k);
  p.cw = (chunk + 3) & ~3;
  p.npad = (long long)N + NT;
  const size_t fixed = 16 * 4 + (size_t)2 * QT * (p.dp + PAD) * 2 + (size_t)QT * p.cap * 4 +
                       (size_t)WARPS * p.cap * 4 + (size_t)QT * k * 8 + (size_t)QT * 16;
  for (int c = std::min(p.dp, 128) / 16 * 16; c >= 16 && p.kc == 0; c -= 16) {
    if (p.dp % c) continue;
    const size_t stage = (size_t)2 * NT * (c + PAD) * 2 + 2 * (size_t)(NT + 4) * 4;
    for (int s = SMAX; s >= 2; --s)
      if (fixed + s * stage <= (size_t)smem_max) {
        p.kc = c;
        p.stages = s;
        p.stage_bytes = stage;
        p.smem = fixed + s * stage;
        break;
      }
  }
  if (p.kc == 0) return p;
  p.nch = p.dp / p.kc;
  p.planes_bytes = align256((size_t)2 * p.nch * p.npad * (p.kc + PAD) * 2);
  const size_t grid = (B + QT - 1) / QT;
  p.scratch_bytes = p.planes_bytes + 2 * align256((size_t)(p.npad + 8) * 4) +
                    align256(grid * WARPS * p.cw * 4);
  return p;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Whether the barrier's phase of this parity has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// A barrier of the consumer warps alone (the producer warp runs on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from 16-byte aligned global memory into shared
// memory; completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory (dynamic), in order: the ring's full barriers [SMAX] u64; the
// query planes [2][QT][QROW] bf16; the ring, `stages` slots of [2][NT][XROW]
// bf16 planes then nrm and xn [NT + 4] f32 each; the candidate lists
// [QT][cap] int and one list of exact scores [cap] f32 per warp; the buffers
// [QT][k] f32 and [QT][k] int; per query the list length, T_b', the margin's
// coefficient and the ||q|| bound.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
topk_mma_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const __nv_bfloat16* __restrict__ planes, const float* __restrict__ nrm,
                const float* __restrict__ xn, float* __restrict__ fsc,
                float* __restrict__ out_s, int* __restrict__ out_i, Stats* stats, int B, int N,
                int D, int k, int chunk, int l2, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = pl.dp, kc = pl.kc, nch = pl.nch, cap = pl.cap, ns = pl.stages;
  const int QROW = dp + PAD, XROW = kc + PAD;
  unsigned char* p = smem;
  const uint32_t bars = smem_addr(p);
  p += 16 * 4;
  __nv_bfloat16* qpl = reinterpret_cast<__nv_bfloat16*>(p);
  p += (size_t)2 * QT * QROW * 2;
  unsigned char* ring = p;
  p += ns * pl.stage_bytes;
  int* cand = reinterpret_cast<int*>(p);
  p += (size_t)QT * cap * 4;
  float* lsc = reinterpret_cast<float*>(p);
  p += (size_t)WARPS * cap * 4;
  float* bs = reinterpret_cast<float*>(p);
  int* bi = reinterpret_cast<int*>(p + (size_t)QT * k * 4);
  p += (size_t)QT * k * 8;
  int* cnt = reinterpret_cast<int*>(p);
  float* tq = reinterpret_cast<float*>(p + QT * 4);
  float* aq = reinterpret_cast<float*>(p + QT * 8);
  float* qnq = reinterpret_cast<float*>(p + QT * 12);

  const float inf = pos_inf();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b0 = blockIdx.x * QT;
  const bool isl2 = l2 != 0;
  const float c1 = (4096.f + 18.f * dp) * 0x1p-24f, c2 = 5.f * 0x1p-24f;
  const float z = dp * 0x1p-100f;
  const uint32_t plane_bytes = NT * XROW * 2;
  const long long plane_stride = (long long)nch * pl.npad * XROW;   // hi -> lo, in bf16
  const int steps_full = (chunk + NT - 1) / NT;
  const int nchunks = (int)(((long long)N + chunk - 1) / chunk);

  // prologue: the ring's barriers, the query planes, empty buffers and lists,
  // each query's margin coefficient and T_b' = +inf (the buffer is not full)
  if (tid < ns) {
    mbar_init(bars + 8 * tid, 1);                   // full: the producer's expect
    mbar_init(bars + 8 * (SMAX + tid), WARPS);      // empty: every consumer warp
  }
  for (int e = tid; e < QT * dp; e += THREADS) {
    const int r = e / dp, d = e % dp, b = b0 + r;
    const float v = (b < B && d < D) ? __ldg(q + (long long)b * D + d) : 0.f;
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    qpl[r * QROW + d] = h;
    qpl[(QT + r) * QROW + d] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
  for (int e = tid; e < QT * k; e += THREADS) {
    bs[e] = inf;
    bi[e] = -1;
  }
  if (tid < QT) {
    const int b = b0 + tid;
    float s = 0.f;
    if (b < B)
      for (int d = 0; d < D; ++d) {
        const float v = __ldg(q + (long long)b * D + d);
        s = fmaf(v, v, s);
      }
    const float qn = sqrtf(s) * XN_SLACK + XN_FLOOR;
    cnt[tid] = 0;
    tq[tid] = inf;
    qnq[tid] = qn;
    aq[tid] = fmaf(c1, qn, z);   // margin = aq * xn + c2 * nrm + z, T_b' = T_b + z * qn
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // The producer (lane 0 of the last warp) walks the tiles in order, (chunk,
  // step, D chunk), across chunk boundaries, up to `ns` ahead of the
  // consumers: a slot is refilled once every consumer warp has arrived on
  // its empty barrier.
  int pj = 0, pt = 0, pch = 0;   // the next tile to issue
  uint32_t pg = 0;
  auto issue = [&]() {
    if (pj >= nchunks) return;
    const long long base = (long long)pj * chunk;
    const int width = (int)min((long long)chunk, (long long)N - base);
    const long long row0 = base + (long long)pt * NT;
    const uint32_t slot = smem_addr(ring + (pg % ns) * pl.stage_bytes);
    const uint32_t bar = bars + 8 * (pg % ns);
    const bool last = pch == nch - 1;   // the step's norms ride with its last D chunk
    mbar_expect(bar, 2 * plane_bytes + (last ? 2 * (NT + 4) * 4 : 0));
    const __nv_bfloat16* src = planes + ((long long)pch * pl.npad + row0) * XROW;
    const long long a0 = row0 & ~3LL;
    bulk_copy(slot, src, plane_bytes, bar);
    bulk_copy(slot + plane_bytes, src + plane_stride, plane_bytes, bar);
    if (last) {
      bulk_copy(slot + 2 * plane_bytes, nrm + a0, (NT + 4) * 4, bar);
      bulk_copy(slot + 2 * plane_bytes + (NT + 4) * 4, xn + a0, (NT + 4) * 4, bar);
    }
    ++pg;
    if (++pch == nch) {
      pch = 0;
      if (++pt == (width + NT - 1) / NT) {
        pt = 0;
        ++pj;
      }
    }
  };
  if (warp == WARPS) {   // the producer warp: each slot again once every consumer freed it
    if (lane == 0 && DIAG != 2)
      for (uint32_t gi = 0; pj < nchunks; ++gi) {
        if (gi >= (uint32_t)ns) mbar_wait(bars + 8 * (SMAX + gi % ns), (gi / ns - 1) & 1);
        issue();
      }
    return;
  }

  const uint32_t a_addr = smem_addr(qpl + (lane & 15) * QROW + (lane >> 4) * 8);
  const uint32_t a_tile = 16 * QROW * 2, a_plane = QT * QROW * 2;
  const uint32_t b_off =
      ((warp * 8 * NJ + (lane & 7) + ((lane >> 4) << 3)) * XROW + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t b_pair = 16 * XROW * 2;
  uint32_t cg = 0;   // the consumers' tile
  float* fsw = fsc + ((size_t)blockIdx.x * WARPS + warp) * pl.cw;   // full-path scores
  float* lsw = lsc + warp * cap;

  for (int j = 0; j < nchunks; ++j) {
    const long long base = (long long)j * chunk;
    const int width = (int)min((long long)chunk, (long long)N - base);
    const int nsteps = j + 1 < nchunks ? steps_full : (width + NT - 1) / NT;
    float tr[MQ][2], ar[MQ][2];   // T_b' and the margin coefficient of this lane's rows
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tr[i][h] = tq[i * 16 + g + 8 * h];
        ar[i][h] = aq[i * 16 + g + 8 * h];
      }

    float acc[MQ][NJ][4];
    float fn[NJ][2], fx[NJ][2];   // the norms and norm bounds of this lane's columns
    for (int t = 0; t < nsteps; ++t) {
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
      for (int ch = 0; ch < nch; ++ch, ++cg) {
        const uint32_t slot = smem_addr(ring + (cg % ns) * pl.stage_bytes);
        if (DIAG != 2) mbar_wait(bars + 8 * (cg % ns), (cg / ns) & 1);
        const uint32_t b_addr = slot + b_off;
        const uint32_t aa = a_addr + ch * kc * 2;
#pragma unroll 2
        for (int kk = 0; kk < (DIAG == 1 ? 0 : kc); kk += 16) {
          uint32_t ah[MQ][4], al[MQ][4], bh[NJ / 2][4], bl[NJ / 2][4];
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            ldmatrix_x4(ah[i], aa + i * a_tile + kk * 2);
            ldmatrix_x4(al[i], aa + a_plane + i * a_tile + kk * 2);
          }
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            ldmatrix_x4(bh[jp], b_addr + jp * b_pair + kk * 2);
            ldmatrix_x4(bl[jp], b_addr + plane_bytes + jp * b_pair + kk * 2);
          }
          // the three products in turn over every tile, so that consecutive
          // mmas accumulate into different tiles
#pragma unroll
          for (int pr = 0; pr < 3; ++pr)
#pragma unroll
            for (int i = 0; i < MQ; ++i)
#pragma unroll
              for (int jj = 0; jj < NJ; ++jj) {
                const uint32_t(&bx)[4] = pr == 1 ? bl[jj >> 1] : bh[jj >> 1];
                mma_bf16(acc[i][jj], pr == 2 ? al[i] : ah[i], bx[(jj & 1) * 2],
                         bx[(jj & 1) * 2 + 1]);
              }
        }
        if (ch == nch - 1) {   // the step's norms, out of the slot before it is released
          const float* snrm = reinterpret_cast<const float*>(
                                  ring + (cg % ns) * pl.stage_bytes + 2 * plane_bytes) +
                              (t * NT + base) % 4;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cl = warp * 8 * NJ + 2 * t4 + jj * 8 + h;
              fn[jj][h] = snrm[cl];
              fx[jj][h] = snrm[NT + 4 + cl];
            }
        }
        __syncwarp();   // the warp is done with the slot
        if (lane == 0) mbar_arrive(bars + 8 * (SMAX + cg % ns));
      }
      // the filter: push (query, row) when s~ <= T_b' + margin
      const int c00 = t * NT + warp * 8 * NJ + 2 * t4;   // column in the chunk
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c00 + jj * 8 + h;
          if (c < width) {
            const float nv = fn[jj][h], xv = fx[jj][h];
            const float mc = fmaf(c2, nv, z);
#pragma unroll
            for (int i = 0; i < MQ; ++i)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float a = acc[i][jj][2 * r + h];
                const float s = isl2 ? fmaf(-2.f, a, nv) : -a;
                const float thr = __fadd_ru(tr[i][r], fmaf(ar[i][r], xv, mc));
                if (DIAG == 0 && tr[i][r] < inf && s <= thr) {
                  const int row = i * 16 + g + 8 * r;
                  const int at = atomicAdd(cnt + row, 1);
                  if (at < cap) cand[row * cap + at] = (int)(base + c);
                }
              }
          }
        }
    }
    consumers_sync();   // every list of the chunk is complete

    for (int i = warp; i < QT; i += WARPS) {
      const int b = b0 + i;
      if (b >= B) continue;   // warp-uniform
      float* bsw = bs + i * k;
      int* biw = bi + i * k;
      const float* qb = q + (long long)b * D;
      const int n = cnt[i];
      float worst;
      int aw;
      warp_argmax(bsw, k, worst, aw);
      const bool cold = !(worst < inf);
      if (cold || n > cap) {   // cold or overflowed: the whole chunk, exactly
        for (int c = lane; c < width; c += 32) {
          const long long id = base + c;
          fsw[c] = exact_score(exact_dot<VEC>(qb, x + id * D, D), __ldg(nrm + id), isl2);
        }
        __syncwarp();
        for (int r = 0; r < k; ++r) {
          float m;
          int am;
          warp_argmin(fsw, width, m, am);
          if (!fold_pair(m, (int)(base + am), bsw, biw, k, worst, aw)) break;
          if (lane == 0) fsw[am] = inf;
          __syncwarp();
        }
        if (stats && lane == 0) atomicAdd(cold ? &stats->cold : &stats->overflow, 1ull);
      } else if (n > 0) {   // the list: exact scores, then (score, row) order
        const int* ids = cand + i * cap;
        for (int c = lane; c < n; c += 32) {
          const long long id = ids[c];
          lsw[c] = exact_score(exact_dot<VEC>(qb, x + id * D, D), __ldg(nrm + id), isl2);
        }
        __syncwarp();
        for (int r = 0; r < k; ++r) {
          float m;
          int id, pos;
          warp_argmin_pair(lsw, ids, n, m, id, pos);
          if (!fold_pair(m, id, bsw, biw, k, worst, aw)) break;
          if (lane == 0) lsw[pos] = inf;
          __syncwarp();
        }
      }
      if (lane == 0) {
        if (stats && !cold && n <= cap) {
          atomicAdd(&stats->cand, (unsigned long long)n);
          atomicMax(&stats->cand_max, (unsigned long long)n);
          atomicAdd(&stats->lists, 1ull);
        }
        cnt[i] = 0;
        tq[i] = worst < inf ? __fadd_ru(worst, z * qnq[i]) : inf;
      }
      __syncwarp();
    }
    consumers_sync();   // T_b' and the emptied lists, for the next chunk's filter
  }

  for (int i = warp; i < QT; i += WARPS) {
    const int b = b0 + i;
    if (b >= B) continue;
    for (int s = lane; s < k; s += 32) {
      const float v = bs[i * k + s];
      out_s[(long long)b * k + s] = v;
      out_i[(long long)b * k + s] = isfinite(v) ? bi[i * k + s] : -1;
    }
  }
}

// ---- F: each chunk's k smallest pairs, and their fold ------------------

struct StatsF {   // optional counters of F's pairs pass (stats != nullptr)
  unsigned long long pushed, most, overflow, rescored, refreshes;
};

// F's launch shape: its query tile (mq m16 tiles), the D chunk kc, the ring
// depth, the list capacity and headroom, the grid (gx query tiles x gy chunk
// strides) and the byte sizes the kernel and the wrapper share.
struct PlanF {
  int mq, dp, kc, nch, stages, cap, head, cw, gx, gy;
  long long npad;
  size_t stage_bytes, smem, planes_bytes, fsc_bytes, surv_bytes, scratch_bytes;
};

// An order-preserving key of a float (a NaN keys as +inf), and back.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(isnan(v) ? pos_inf() : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A list entry is its filter score s~ (f32) and a meta word: the margin M
// rounded up to bf16 precision in the high 16 bits (an f32 whose low bits
// are zero), the column in the chunk in the low 16.
__device__ __forceinline__ uint32_t entry_meta(float margin, int col) {
  return ((__float_as_uint(margin) + 0xffffu) & 0xffff0000u) | (uint32_t)col;
}
__device__ __forceinline__ float entry_margin(uint32_t meta) {
  return __uint_as_float(meta & 0xffff0000u);
}

// The k-th smallest upper bound U = s~ + M (rounded up) of a list's n >= k
// entries, to every lane: a radix select over the keys, two bits a round.
__device__ float kth_upper(const float* ls, const uint32_t* lm, int n, int k) {
  const int lane = threadIdx.x & 31, nr = (n + 31) >> 5;
  uint32_t key[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int e = r * 32 + lane;
    key[r] = 0xffffffffu;   // above every real key (+inf keys as 0xff800000)
    if (r < nr && e < n) key[r] = order_key(__fadd_ru(ls[e], entry_margin(lm[e])));
  }
  uint32_t ans = 0;   // the largest key with fewer than k keys below it
  for (int b = 30; b >= 0; b -= 2) {
    const uint32_t t1 = ans | (1u << b), t2 = ans | (2u << b), t3 = ans | (3u << b);
    unsigned c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      if (r < nr) {
        c1 += key[r] < t1;
        c2 += key[r] < t2;
        c3 += key[r] < t3;
      }
    c1 = __reduce_add_sync(FULL, c1);
    c2 = __reduce_add_sync(FULL, c2);
    c3 = __reduce_add_sync(FULL, c3);
    ans = c3 < (unsigned)k ? t3 : c2 < (unsigned)k ? t2 : c1 < (unsigned)k ? t1 : ans;
  }
  return from_key(ans);
}

// Keeps, in order, the entries whose lower bound L = s~ - M (rounded down)
// is not above T; returns how many.
__device__ int compact(float* ls, uint32_t* lm, int n, float T) {
  const int lane = threadIdx.x & 31;
  int out = 0;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    float s = 0.f;
    uint32_t m = 0;
    bool keep = false;
    if (e < n) {
      s = ls[e];
      m = lm[e];
      keep = !(__fsub_rd(s, entry_margin(m)) > T);
    }
    const unsigned bal = __ballot_sync(FULL, keep);   // every read is done before any write
    if (keep) {
      const int at = out + __popc(bal & ((1u << lane) - 1u));
      ls[at] = s;
      lm[at] = m;
    }
    out += __popc(bal);
  }
  __syncwarp();
  return out;
}

// The whole chunk re-scored exactly into the warp's global row fsw, then
// csrc/scan_topk.cu's k rounds: its pairs, ascending, into ps / pi; returns
// how many (the path of a list that overflowed).
__device__ int whole_chunk(const float* __restrict__ qb, const float* __restrict__ x,
                                        const float* __restrict__ nrm, float* fsw, long long base,
                                        int width, int D, int k, bool l2, bool vec, float* ps,
                                        int* pi) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < width; c += 32) {
    const long long id = base + c;
    const float a = vec ? exact_dot<true>(qb, x + id * D, D) : exact_dot<false>(qb, x + id * D, D);
    fsw[c] = exact_score(a, __ldg(nrm + id), l2);
  }
  __syncwarp();
  int r = 0;
  for (; r < k; ++r) {
    float v;
    int am;
    warp_argmin(fsw, width, v, am);
    if (!(v < pos_inf())) break;
    if (lane == 0) {
      ps[r] = v;
      pi[r] = (int)(base + am);
      fsw[am] = pos_inf();
    }
    __syncwarp();
  }
  return r;
}

// The smallest (score, column) of a list's n entries, ties to the lower
// column, with its position, to every lane (pos -1 when nothing is below +inf).
__device__ __forceinline__ void warp_argmin_list(const float* ls, const uint32_t* lm, int n,
                                                 float& m, int& col, int& pos) {
  const int lane = threadIdx.x & 31;
  float v = pos_inf();
  int i = NONE, p = -1;
  for (int e = lane; e < n; e += 32) {
    const float s = ls[e];
    const int c = (int)(lm[e] & 0xffffu);
    if (s < v || (s == v && c < i)) {
      v = s;
      i = c;
      p = e;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    const int p2 = __shfl_xor_sync(FULL, p, o);
    if (v2 < v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
      p = p2;
    }
  }
  m = v;
  col = i;
  pos = p;
}

// For k <= 32, each of the 32 lanes that see a query row's columns (4 lanes
// in each of the 8 consumer warps) keeps the smallest key of U among them.
// T = the k-th smallest of those 32 minima: they are U of 32 distinct
// columns, so k columns have U <= T (T stays while fewer than k columns have
// been seen). A lane's minimum takes only the columns the filter took after
// the first step: one not taken has U >= L > T and cannot lower the k-th
// smallest below T, so T = min(T, the new bound) loses nothing. The warp
// takes its QPW rows at once, one bitonic sort each, interleaved; a row
// already at -inf keeps it.
template <int QPW>
__device__ void bounds_from_minima(const uint32_t* gm, float* tq, int warp, int k, int b0,
                                   int B) {
  const int lane = threadIdx.x & 31;
  uint32_t v[QPW];
#pragma unroll
  for (int u = 0; u < QPW; ++u) v[u] = gm[(warp + u * WARPS) * 32 + lane];
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool lo = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int u = 0; u < QPW; ++u) {
        const uint32_t o = __shfl_xor_sync(FULL, v[u], stride);
        v[u] = lo ? min(v[u], o) : max(v[u], o);
      }
    }
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const uint32_t kk = __shfl_sync(FULL, v[u], k - 1);
    const int row = warp + u * WARPS;
    if (lane == 0 && b0 + row < B && tq[row] != -pos_inf() && kk != 0xffffffffu)
      tq[row] = fminf(tq[row], from_key(kk));
  }
  __syncwarp();
}

// Shared memory (dynamic), in order: the ring's barriers (as E's); the query
// planes [2][QF][QROW] bf16; the ring; the lists' scores [QF][cap] f32 and
// meta words [QF][cap]; per query the list length, T (+inf: no bound yet;
// -inf: overflowed, or past B), the margin's two coefficients and the
// entries dropped so far; per query the 32 lanes' smallest keys of U
// (k <= 32).
template <int MQF, bool LANEMIN>
__global__ void __launch_bounds__(32 * WARPS, 1)
pairs_mma_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const __nv_bfloat16* __restrict__ planes, const float* __restrict__ nrm,
                 const float* __restrict__ xn, float* __restrict__ fsc,
                 float* __restrict__ pair_s, int* __restrict__ pair_i,
                 uint16_t* __restrict__ surv, int* __restrict__ scnt, StatsF* stats, int B, int N,
                 int D, int k, int chunk, int l2, bool vec, PlanF pl) {
  constexpr int QF = 16 * MQF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = pl.dp, kc = pl.kc, nch = pl.nch, cap = pl.cap, ns = pl.stages;
  const int mark = cap - pl.head;   // a longer list is compacted at the next bound
  const int QROW = dp + PAD, XROW = kc + PAD;
  unsigned char* p = smem;
  const uint32_t bars = smem_addr(p);
  p += 16 * 4;
  __nv_bfloat16* qpl = reinterpret_cast<__nv_bfloat16*>(p);
  p += (size_t)2 * QF * QROW * 2;
  unsigned char* ring = p;
  p += ns * pl.stage_bytes;
  float* ls = reinterpret_cast<float*>(p);
  p += (size_t)QF * cap * 4;
  uint32_t* lm = reinterpret_cast<uint32_t*>(p);
  p += (size_t)QF * cap * 4;
  int* cnt = reinterpret_cast<int*>(p);
  float* tq = reinterpret_cast<float*>(p + QF * 4);
  float* aq = reinterpret_cast<float*>(p + QF * 8);
  float* bq = reinterpret_cast<float*>(p + QF * 12);
  int* dropped = reinterpret_cast<int*>(p + QF * 16);
  uint32_t* gm = reinterpret_cast<uint32_t*>(p + QF * 20);   // [QF][32] the lanes' minima
  unsigned long long* sst = reinterpret_cast<unsigned long long*>(p + QF * 148);   // [5]

  const float inf = pos_inf();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool isl2 = l2 != 0;
  const float c1 = (4096.f + 18.f * dp) * 0x1p-24f, c2 = 5.f * 0x1p-24f;
  const float z = dp * 0x1p-100f;
  const uint32_t plane_bytes = NT * XROW * 2;
  const long long plane_stride = (long long)nch * pl.npad * XROW;   // hi -> lo, in bf16
  const int nchunks = (int)(((long long)N + chunk - 1) / chunk);
  const int tiles = (B + QF - 1) / QF;

  if (tid < ns) {
    mbar_init(bars + 8 * tid, 1);
    mbar_init(bars + 8 * (SMAX + tid), WARPS);
  }
  if (tid < 5) sst[tid] = 0;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // Lane 0 of warp 0 issues the ring's copies, in the consumers' order of
  // (tile, chunk, step, D chunk) tiles across chunk and tile bounds: before
  // the warp consumes tile `need` it issues every tile through `need`
  // (waiting for each slot's earlier tile to be released by every warp), then
  // further ahead while slots are already free. No warp of its own: a ninth
  // warp would put three warps on one scheduler and cap every thread at 168
  // registers, where eight allow 255.
  int p_tx = blockIdx.x, p_j = blockIdx.y, p_t = 0, p_ch = 0;
  bool p_done = false;
  uint32_t pg = 0;   // the next tile to issue
  auto feed = [&](uint32_t need) {
    while (!p_done && pg < need + ns) {
      if (pg >= (uint32_t)ns) {
        const uint32_t eb = bars + 8 * (SMAX + pg % ns), par = (pg / ns - 1) & 1;
        if (pg <= need)
          mbar_wait(eb, par);
        else if (!mbar_test(eb, par))
          break;
      }
      const long long base = (long long)p_j * chunk;
      const int width = (int)min((long long)chunk, (long long)N - base);
      const long long row0 = base + (long long)p_t * NT;
      const uint32_t slot = smem_addr(ring + (pg % ns) * pl.stage_bytes);
      const uint32_t bar = bars + 8 * (pg % ns);
      const bool last = p_ch == nch - 1;
      mbar_expect(bar, 2 * plane_bytes + (last ? 2 * (NT + 4) * 4 : 0));
      const __nv_bfloat16* src = planes + ((long long)p_ch * pl.npad + row0) * XROW;
      bulk_copy(slot, src, plane_bytes, bar);
      bulk_copy(slot + plane_bytes, src + plane_stride, plane_bytes, bar);
      if (last) {
        const long long a0 = row0 & ~3LL;
        bulk_copy(slot + 2 * plane_bytes, nrm + a0, (NT + 4) * 4, bar);
        bulk_copy(slot + 2 * plane_bytes + (NT + 4) * 4, xn + a0, (NT + 4) * 4, bar);
      }
      ++pg;
      if (++p_ch == nch) {
        p_ch = 0;
        if (++p_t == (width + NT - 1) / NT) {
          p_t = 0;
          if ((p_j += gridDim.y) >= nchunks) {
            p_j = blockIdx.y;
            if ((p_tx += gridDim.x) >= tiles) p_done = true;
          }
        }
      }
    }
  };

  const uint32_t a_addr = smem_addr(qpl + (lane & 15) * QROW + (lane >> 4) * 8);
  const uint32_t a_tile = 16 * QROW * 2, a_plane = QF * QROW * 2;
  const uint32_t b_off =
      ((warp * 8 * NJ + (lane & 7) + ((lane >> 4) << 3)) * XROW + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t b_pair = 16 * XROW * 2;
  uint32_t cg = 0;   // the consumers' tile
  constexpr bool lanemin = LANEMIN;   // k <= 32: the bound from the lanes' minima
  // the counters (or, in DIAG 5, cycles), lane 0 of each warp adding
  auto stat_add = [&](int slot, unsigned long long v) {
    if (stats && lane == 0) atomicAdd(sst + slot, v);
  };
  float* fsw = fsc + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * WARPS + warp) * pl.cw;

  for (int tx = blockIdx.x; tx < tiles; tx += gridDim.x) {
    const int b0 = tx * QF;
    consumers_sync();   // the last tile's lists are done with
    for (int e = tid; e < QF * dp; e += 32 * WARPS) {
      const int r = e / dp, d = e % dp, b = b0 + r;
      const float v = (b < B && d < D) ? __ldg(q + (long long)b * D + d) : 0.f;
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      qpl[r * QROW + d] = h;
      qpl[(QF + r) * QROW + d] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
    if (tid < QF) {
      const int b = b0 + tid;
      float s = 0.f;
      if (b < B)
        for (int d = 0; d < D; ++d) {
          const float v = __ldg(q + (long long)b * D + d);
          s = fmaf(v, v, s);
        }
      const float qn = sqrtf(s) * XN_SLACK + XN_FLOOR;
      aq[tid] = fmaf(c1, qn, z);   // M = aq * xn + c2 * nrm + bq
      bq[tid] = fmaf(z, qn, z);
      tq[tid] = b < B ? inf : -inf;
      cnt[tid] = 0;
      dropped[tid] = 0;
    }
    consumers_sync();

    for (int j = blockIdx.y; j < nchunks; j += gridDim.y) {
      const long long base = (long long)j * chunk;
      const int width = (int)min((long long)chunk, (long long)N - base);
      const int nsteps = (width + NT - 1) / NT;
      uint32_t rmin[2 * MQF];   // k <= 32: this lane's smallest key of U per row, this chunk
#pragma unroll
      for (int ir = 0; ir < 2 * MQF; ++ir) rmin[ir] = 0xffffffffu;
      for (int t = 0; t < nsteps; ++t) {
        float acc[MQF][NJ][4];
        float fn[NJ][2], fx[NJ][2];
#pragma unroll
        for (int i = 0; i < MQF; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
        long long clk = DIAG >= 5 ? clock64() : 0;
        for (int ch = 0; ch < nch; ++ch, ++cg) {
          const uint32_t slot = smem_addr(ring + (cg % ns) * pl.stage_bytes);
          if (warp == 0 && lane == 0 && DIAG != 2) feed(cg);
          if (DIAG >= 5) {
            const long long w0 = clock64();
            mbar_wait(bars + 8 * (cg % ns), (cg / ns) & 1);
            stat_add(1, clock64() - w0);
          } else if (DIAG != 2) {
            mbar_wait(bars + 8 * (cg % ns), (cg / ns) & 1);
          }
          const uint32_t b_addr = slot + b_off;
          const uint32_t aa = a_addr + ch * kc * 2;
#pragma unroll 2
          for (int kk = 0; kk < (DIAG == 1 ? 0 : kc); kk += 16) {
            uint32_t ah[MQF][4], al[MQF][4], bh[NJ / 2][4], bl[NJ / 2][4];
#pragma unroll
            for (int i = 0; i < MQF; ++i) {
              ldmatrix_x4(ah[i], aa + i * a_tile + kk * 2);
              ldmatrix_x4(al[i], aa + a_plane + i * a_tile + kk * 2);
            }
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
              ldmatrix_x4(bh[jp], b_addr + jp * b_pair + kk * 2);
              ldmatrix_x4(bl[jp], b_addr + plane_bytes + jp * b_pair + kk * 2);
            }
#pragma unroll
            for (int pr = 0; pr < 3; ++pr)
#pragma unroll
              for (int i = 0; i < MQF; ++i)
#pragma unroll
                for (int jj = 0; jj < NJ; ++jj) {
                  const uint32_t(&bx)[4] = pr == 1 ? bl[jj >> 1] : bh[jj >> 1];
                  mma_bf16(acc[i][jj], pr == 2 ? al[i] : ah[i], bx[(jj & 1) * 2],
                           bx[(jj & 1) * 2 + 1]);
                }
          }
          if (ch == nch - 1) {
            const float* snrm = reinterpret_cast<const float*>(
                                    ring + (cg % ns) * pl.stage_bytes + 2 * plane_bytes) +
                                (t * NT + base) % 4;
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int cl = warp * 8 * NJ + 2 * t4 + jj * 8 + h;
                fn[jj][h] = snrm[cl];
                fx[jj][h] = snrm[NT + 4 + cl];
              }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (SMAX + cg % ns));
        }
        if (DIAG >= 5) {
          const long long now = clock64();
          stat_add(0, now - clk);
          clk = now;
        }
        const int c00 = t * NT + warp * 8 * NJ + 2 * t4;   // column in the chunk
        // k <= 32: a lane's minima take the step's U = s~ + M (rounded up); at
        // the chunk's first step the bound comes before its pushes
        auto take_minima = [&]() {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (c00 + jj * 8 + h < width) {
                const float nv = fn[jj][h], xv = fx[jj][h];
#pragma unroll
                for (int i = 0; i < MQF; ++i)
#pragma unroll
                  for (int r = 0; r < 2; ++r) {
                    const int row = i * 16 + g + 8 * r;
                    const float a = acc[i][jj][2 * r + h];
                    const float sv = isl2 ? fmaf(-2.f, a, nv) : -a;
                    const float m = fmaf(aq[row], xv, fmaf(c2, nv, bq[row]));
                    rmin[2 * i + r] = min(rmin[2 * i + r], order_key(__fadd_ru(sv, m)));
                  }
              }
        };
        auto store_minima = [&]() {
#pragma unroll
          for (int ir = 0; ir < 2 * MQF; ++ir)
            gm[((ir >> 1) * 16 + g + 8 * (ir & 1)) * 32 + warp * 4 + t4] = rmin[ir];
        };
        const bool last = t + 1 == nsteps;
        // k <= 32 bounds its rows after steps 0 (before that step's pushes), 1,
        // 3, 7, ... and at the chunk's end; in between T holds and the filter
        // needs no barrier (a bound from fewer columns is still a bound)
        const bool rebound = lanemin && !last && t > 0 && ((t + 1) & t) == 0;
        if (lanemin && t == 0 && DIAG != 1 && DIAG != 2 && DIAG != 3) {
          consumers_sync();   // the last chunk's end is done with the lists and minima
          take_minima();
          store_minima();
          consumers_sync();
          bounds_from_minima<QF / WARPS>(gm, tq, warp, k, b0, B);
        }
        if (!lanemin || t == 0) consumers_sync();   // the bounds (and lists) this filter reads
        if (DIAG >= 5) {
          const long long now = clock64();
          stat_add(1, now - clk);
          clk = now;
        }

        // The filter: column c goes to query row's list unless its lower bound
        // s~ - M lies above T (T = +inf: every column; -inf: none). A group of
        // 4 lanes shares its rows: one atomic per row and group reserves the
        // group's entries, each lane's offset from a scan by shuffles.
        float tr[MQF][2], ar[MQF][2], br[MQF][2];
#pragma unroll
        for (int i = 0; i < MQF; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = i * 16 + g + 8 * h;
            tr[i][h] = tq[row];
            ar[i][h] = aq[row];
            br[i][h] = bq[row];
          }
        if (DIAG >= 5) {   // the mmas' results, then the clock: their drain apart
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < MQF; ++i)
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) sum += acc[i][jj][e];
          asm volatile("" ::"f"(sum));
          const long long now = clock64();
          stat_add(3, now - clk);
          clk = now;
        }
        uint32_t fl = 0;   // bit 4 (2 i + r) + 2 jj + h: the pair goes to the list
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c00 + jj * 8 + h;
            if (c < width && DIAG != 1 && DIAG != 2 && DIAG != 3) {
              const float nv = fn[jj][h], xv = fx[jj][h];
#pragma unroll
              for (int i = 0; i < MQF; ++i)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const float T = tr[i][r];
                  const float s = isl2 ? fmaf(-2.f, acc[i][jj][2 * r + h], nv) : -acc[i][jj][2 * r + h];
                  const float m = fmaf(ar[i][r], xv, fmaf(c2, nv, br[i][r]));
                  if (T != -inf && !(s > __fadd_ru(T, m))) fl |= 1u << (4 * (2 * i + r) + 2 * jj + h);
                }
            }
          }
        constexpr int RW = (2 * MQF + 3) / 4;   // words of 8-bit per-row counts
        uint32_t own[RW], inc[RW], tot[RW];
#pragma unroll
        for (int u = 0; u < RW; ++u) own[u] = 0;
#pragma unroll
        for (int ir = 0; ir < 2 * MQF; ++ir)
          own[ir >> 2] += (uint32_t)__popc((fl >> (4 * ir)) & 0xfu) << (8 * (ir & 3));
#pragma unroll
        for (int u = 0; u < RW; ++u) {   // inclusive scan over the group (each field <= 16)
          uint32_t v = own[u];
          uint32_t y = __shfl_up_sync(FULL, v, 1, 4);
          if (t4 >= 1) v += y;
          y = __shfl_up_sync(FULL, v, 2, 4);
          if (t4 >= 2) v += y;
          inc[u] = v;
          tot[u] = __shfl_sync(FULL, v, 3, 4);
        }
        int at0[2 * MQF];
#pragma unroll
        for (int ir = 0; ir < 2 * MQF; ++ir) {
          const int tt = (int)((tot[ir >> 2] >> (8 * (ir & 3))) & 0xffu);
          at0[ir] = 0;
          if (t4 == 0 && tt > 0) at0[ir] = atomicAdd(cnt + (ir >> 1) * 16 + g + 8 * (ir & 1), tt);
        }
#pragma unroll
        for (int ir = 0; ir < 2 * MQF; ++ir) {
          const int i = ir >> 1, r = ir & 1, row = i * 16 + g + 8 * r;
          int at = __shfl_sync(FULL, at0[ir], 0, 4) +
                   (int)(((inc[ir >> 2] - own[ir >> 2]) >> (8 * (ir & 3))) & 0xffu);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if ((fl >> (4 * ir + 2 * jj + h)) & 1u) {
                const float nv = fn[jj][h];
                const float sv =
                    isl2 ? fmaf(-2.f, acc[i][jj][2 * r + h], nv) : -acc[i][jj][2 * r + h];
                const float mv = fmaf(ar[i][r], fx[jj][h], fmaf(c2, nv, br[i][r]));
                if (at < cap) {
                  ls[row * cap + at] = sv;
                  lm[row * cap + at] = entry_meta(mv, c00 + jj * 8 + h);
                }
                ++at;
                // only a column taken can lower the bound: one not taken has U > T
                rmin[ir] = min(rmin[ir], order_key(__fadd_ru(sv, mv)));
              }
        }
        if (DIAG >= 5) {
          const long long now = clock64();
          stat_add(2, now - clk);
          clk = now;
        }
        if (lanemin && !last && !rebound) continue;   // T holds: no barrier
        if (lanemin) store_minima();
        consumers_sync();   // every push of the step has landed
        if (DIAG >= 5) {
          const long long now = clock64();
          stat_add(1, now - clk);
          clk = now;
        }

        if (DIAG >= 1 && DIAG <= 3) {   // timing only: no lists, so no survivors
          if (last)
            for (int i = warp; i < QF && lane == 0; i += WARPS)
              if (b0 + i < B) scnt[(long long)(b0 + i) * nchunks + j] = 0;
          continue;
        }
        if (rebound) {   // each warp bounds its own rows
          bounds_from_minima<QF / WARPS>(gm, tq, warp, k, b0, B);
          for (int i = warp; i < QF; i += WARPS) {
            const float T = tq[i];
            if (b0 + i >= B || T == -inf) continue;   // warp-uniform
            const int n = cnt[i];
            if (DIAG < 5 && stats && lane == 0) atomicMax(sst + 1, (unsigned long long)n);
            if (n > cap) {   // overflowed: the chunk is re-scored in full at its end
              if (lane == 0) tq[i] = -inf;
            } else if (n > mark && T != inf) {   // drop what lies above the bound
              const int n2 = compact(ls + i * cap, lm + i * cap, n, T);
              if (lane == 0) {
                cnt[i] = n2;
                dropped[i] += n - n2;
              }
              if (DIAG < 5) stat_add(4, 1);
            }
            __syncwarp();
          }
          if (DIAG >= 5) stat_add(1, clock64() - clk);
          consumers_sync();   // the new bounds, before the next filter reads them
          continue;
        }
        if (!LANEMIN && !last) {
          // The rows that overflowed or need a refresh, one mask from one
          // snapshot in every warp, shared out over the warps in turn.
          bool a0 = false, a1 = false;
          if (lane < QF && b0 + lane < B) {
            const float T = tq[lane];
            const int n = cnt[lane];
            a0 = T != -inf && (n > mark || (T == inf && n >= k));
          }
          if (lane + 32 < QF && b0 + lane + 32 < B) {
            const float T = tq[lane + 32];
            const int n = cnt[lane + 32];
            a1 = T != -inf && (n > mark || (T == inf && n >= k));
          }
          const uint64_t need = (uint64_t)__ballot_sync(FULL, a0) |
                                ((uint64_t)__ballot_sync(FULL, a1) << 32);
          consumers_sync();   // every warp has its snapshot
          int nth = 0;
          for (uint64_t rest = need; rest; rest &= rest - 1, ++nth) {
            if (nth % WARPS != warp) continue;
            const int i = __ffsll((long long)rest) - 1;
            const int n = cnt[i];
            if (DIAG < 5 && stats && lane == 0) atomicMax(sst + 1, (unsigned long long)n);
            if (n > cap) {   // overflowed: the chunk is re-scored in full at its end
              if (lane == 0) tq[i] = -inf;
            } else {         // refresh T, drop what lies above it
              const float T2 = kth_upper(ls + i * cap, lm + i * cap, n, k);
              const int n2 = compact(ls + i * cap, lm + i * cap, n, T2);
              if (lane == 0) {
                tq[i] = T2;
                cnt[i] = n2;
                dropped[i] += n - n2;
              }
              if (DIAG < 5) stat_add(4, 1);
            }
            __syncwarp();
          }
          if (DIAG >= 5) stat_add(1, clock64() - clk);
          continue;
        }

        // The chunk's end, per query row of the warp: the final bound, the
        // survivors (L <= T) compacted, their columns to the select pass (or,
        // for a list that overflowed, the whole chunk re-scored exactly here:
        // never approximate).
        if (lanemin) bounds_from_minima<QF / WARPS>(gm, tq, warp, k, b0, B);
        for (int i = warp; i < QF; i += WARPS) {
          const int b = b0 + i;
          if (b >= B) continue;   // warp-uniform
          const float T = tq[i];
          const int n = T == -inf ? cap + 1 : cnt[i];
          const long long pj = (long long)b * nchunks + j;
          if (n > cap) {
            float* ps = pair_s + pj * k;
            int* pi = pair_i + pj * k;
            const int r =
                whole_chunk(q + (long long)b * D, x, nrm, fsw, base, width, D, k, isl2, vec, ps, pi);
            for (int s2 = r + lane; s2 < k; s2 += 32) {
              ps[s2] = inf;
              pi[s2] = -1;
            }
            if (lane == 0) scnt[pj] = -1;
            if (DIAG < 5) stat_add(2, 1);
          } else {
            if (DIAG < 5 && stats && lane == 0) atomicMax(sst + 1, (unsigned long long)n);
            int m;
            if (lanemin)
              m = T == inf ? n : compact(ls + i * cap, lm + i * cap, n, T);
            else
              m = n >= k ? compact(ls + i * cap, lm + i * cap, n,
                                   kth_upper(ls + i * cap, lm + i * cap, n, k))
                         : n;
            for (int e = lane; e < m; e += 32) surv[pj * cap + e] = (uint16_t)(lm[i * cap + e] & 0xffffu);
            if (lane == 0) scnt[pj] = m;
            if (DIAG < 5) {
              stat_add(0, (unsigned long long)(n + dropped[i]));
              stat_add(3, (unsigned long long)m);
            }
          }
          if (lane == 0) {
            cnt[i] = 0;
            tq[i] = inf;
            dropped[i] = 0;
          }
          __syncwarp();
        }
        if (DIAG >= 5) stat_add(4, clock64() - clk);
      }
    }
  }
  consumers_sync();   // every warp's counts are in
  if (stats && tid == 0) {
    atomicAdd(&stats->pushed, sst[0]);
    if (DIAG >= 5)
      atomicAdd(&stats->most, sst[1]);
    else
      atomicMax(&stats->most, sst[1]);
    atomicAdd(&stats->overflow, sst[2]);
    atomicAdd(&stats->rescored, sst[3]);
    atomicAdd(&stats->refreshes, sst[4]);
  }
}

// F's select pass: one warp per (query, chunk) re-scores the survivors of its
// list exactly (the chains above, from the f32 rows) and writes the k
// smallest (score, row) pairs, ascending, ties to the lower row, (+inf, -1)
// past them, as csrc/scan_topk.cu's pairs pass writes them. Its own pass, so
// that many warps hide the chains' loads (the rows of a chunk, read by all
// its queries' warps together, come from L2); a list that overflowed was
// written by the pairs pass (count -1).
__global__ void __launch_bounds__(SEL_WARPS * 32)
select_kernel(const float* __restrict__ q, const float* __restrict__ x,
              const float* __restrict__ nrm, const uint16_t* __restrict__ surv,
              const int* __restrict__ scnt, float* __restrict__ pair_s, int* __restrict__ pair_i,
              int B, int D, int k, int chunk, int nc, int cap, int l2, bool vec) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * SEL_WARPS + warp, j = blockIdx.y;
  if (b >= B) return;   // warp-uniform; no block barrier follows
  const long long pj = (long long)b * nc + j;
  const int m = scnt[pj];
  if (m < 0) return;
  const float inf = pos_inf();
  const long long base = (long long)j * chunk;
  const uint16_t* cols = surv + pj * cap;
  const float* qb = q + (long long)b * D;
  const bool isl2 = l2 != 0;
  float* ps = pair_s + pj * k;
  int* pi = pair_i + pj * k;
  int r = 0;
  if (m <= 32) {   // one survivor a lane: a bitonic sort on (score, column)
    float v = inf;
    uint64_t key = ~0ull;   // absent, or a score that is not below +inf
    if (lane < m) {
      const int col = cols[lane];
      const long long id = base + col;
      const float a = vec ? exact_dot<true>(qb, x + id * D, D) : exact_dot<false>(qb, x + id * D, D);
      v = exact_score(a, __ldg(nrm + id), isl2);
      if (v < inf)   // -0 keys as +0: the two compare equal, the lower column first
        key = ((uint64_t)order_key(v + 0.f) << 32) | ((uint32_t)col << 8) | (uint32_t)lane;
    }
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint64_t o = __shfl_xor_sync(FULL, key, stride);
        key = (((lane & stride) == 0) == ((lane & size) == 0)) ? min(key, o) : max(key, o);
      }
    const float sv = __shfl_sync(FULL, v, (int)(key & 31u));   // the entry's own bits
    if (lane < k && key != ~0ull) {
      ps[lane] = sv;
      pi[lane] = (int)(base + ((key >> 8) & 0xffffu));
    }
    r = __popc(__ballot_sync(FULL, key != ~0ull));
  } else {   // k rounds of a warp argmin over the exact scores
    float* ls = reinterpret_cast<float*>(sel_smem) + warp * cap;
    uint32_t* lm = reinterpret_cast<uint32_t*>(sel_smem + (size_t)SEL_WARPS * cap * 4) + warp * cap;
    for (int e = lane; e < m; e += 32) {
      const int col = cols[e];
      const long long id = base + col;
      const float a = vec ? exact_dot<true>(qb, x + id * D, D) : exact_dot<false>(qb, x + id * D, D);
      ls[e] = exact_score(a, __ldg(nrm + id), isl2);
      lm[e] = (uint32_t)col;
    }
    __syncwarp();
    for (; r < k; ++r) {
      float v;
      int col, pos;
      warp_argmin_list(ls, lm, m, v, col, pos);
      if (!(v < inf)) break;
      if (lane == 0) {
        ps[r] = v;
        pi[r] = (int)(base + col);
        ls[pos] = inf;
      }
      __syncwarp();
    }
  }
  for (int s2 = r + lane; s2 < k; s2 += 32) {
    ps[s2] = inf;
    pi[s2] = -1;
  }
}

// F's second pass, as csrc/scan_topk.cu's: one warp per query replays the
// chunks' pairs in chunk order; a chunk whose smallest pair is not below the
// buffer's worst is skipped without reading the rest of it.
__global__ void __launch_bounds__(FOLD_QT * 32)
fold_kernel(const float* __restrict__ pair_s, const int* __restrict__ pair_i, float* out_s,
            int* out_i, int B, int k, int nc) {
  extern __shared__ __align__(16) float fold_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * FOLD_QT + warp;
  if (b >= B) return;   // warp-uniform; no block barrier follows
  float* bs = fold_smem + warp * k;
  int* bi = reinterpret_cast<int*>(fold_smem + FOLD_QT * k) + warp * k;
  for (int s = lane; s < k; s += 32) {
    bs[s] = pos_inf();
    bi[s] = -1;
  }
  __syncwarp();
  float worst = pos_inf();
  int aw = 0;
  const float* ps = pair_s + (long long)b * nc * k;
  const int* pi = pair_i + (long long)b * nc * k;
  for (int j0 = 0; j0 < nc; j0 += 32) {
    const float first = (j0 + lane < nc) ? ps[(long long)(j0 + lane) * k] : pos_inf();
    unsigned mask = __ballot_sync(FULL, first < worst);
    while (mask) {
      const int l = __ffs(mask) - 1;
      const long long off = (long long)(j0 + l) * k;
      for (int r = 0; r < k; ++r)
        if (!fold_pair(ps[off + r], pi[off + r], bs, bi, k, worst, aw)) break;
      mask &= ~((2u << l) - 1u);
      mask &= __ballot_sync(FULL, first < worst);
    }
  }
  __syncwarp();
  for (int s = lane; s < k; s += 32) {
    const float v = bs[s];
    out_s[(long long)b * k + s] = v;
    out_i[(long long)b * k + s] = isfinite(v) ? bi[s] : -1;
  }
}

bool bad_args(int B, int N, int D, int k, int chunk) {
  return B < 0 || N < 0 || D < 1 || D > DMAX || k < 1 || k > KMAX || chunk < 1 ||
         chunk > CHUNK_MAX;
}

// The scratch's sections: the tiled planes, nrm, xn, the whole-chunk rows.
struct Scratch {
  __nv_bfloat16* planes;
  float *nrm, *xn, *fsc;
};

template <typename P>
Scratch carve(void* scratch, const P& plan) {
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  const size_t vec = align256((size_t)(plan.npad + 8) * 4);
  return {reinterpret_cast<__nv_bfloat16*>(sp), reinterpret_cast<float*>(sp + plan.planes_bytes),
          reinterpret_cast<float*>(sp + plan.planes_bytes + vec),
          reinterpret_cast<float*>(sp + plan.planes_bytes + 2 * vec)};
}

template <typename P>
cudaError_t run_prep(const float* x, const Scratch& sc, const P& plan, int N, int D,
                     cudaStream_t s) {
  if (N == 0) return cudaSuccess;
  prep_kernel<<<(N + PREP_ROWS - 1) / PREP_ROWS, PREP_ROWS, 0, s>>>(x, sc.planes, sc.nrm, sc.xn,
                                                                    N, D, plan.dp, plan.kc,
                                                                    plan.npad);
  return cudaGetLastError();
}

cudaError_t plan_for(int B, int N, int D, int k, int chunk, Plan& plan) {
  int dev = 0, smem_max = 0;
  cudaError_t rc;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  plan = make_plan(B, N, D, k, chunk, smem_max);
  return plan.kc == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// F's plan for a query tile of mq m16 tiles: the list capacity holds k
// entries plus the headroom pushes may add between two bounds (for k > 32
// also every column until the first bound, NT * ceil(k / NT)); it is 4 mod 8
// so that the lanes' stores fall in distinct banks. Then E's choice of D
// chunk and ring.
PlanF make_plan_f(int B, int N, int D, int k, int chunk, int smem_max, int sms, int mq) {
  PlanF p{};
  const int qf = 16 * mq;
  p.mq = mq;
  p.dp = (D + 15) / 16 * 16;
  p.cw = (chunk + 3) & ~3;
  p.npad = (long long)N + NT;
  const bool lanemin = k <= 32;
  p.head = ZVDB_TOPK2_HEAD > 0 ? std::min(NT, ZVDB_TOPK2_HEAD)
                               : lanemin ? 64 : std::min(NT, std::max(32, 2 * k));
  // with the lanes' minima a list starts small; with selects it first holds
  // every column until k are in
  const int need = lanemin ? k + p.head : std::max(NT * ((k + NT - 1) / NT), k + p.head);
  p.cap = ((need + 3) & ~7) + 4;
  const size_t fixed = 16 * 4 + (size_t)2 * qf * (p.dp + PAD) * 2 + (size_t)qf * p.cap * 8 +
                       (size_t)qf * 20 + (size_t)qf * 32 * 4 + 5 * 8;
  for (int c = std::min(p.dp, 128) / 16 * 16; c >= 16 && p.kc == 0; c -= 16) {
    if (p.dp % c) continue;
    const size_t stage = (size_t)2 * NT * (c + PAD) * 2 + 2 * (size_t)(NT + 4) * 4;
    for (int s = SMAX; s >= 2; --s)
      if (fixed + s * stage <= (size_t)smem_max) {
        p.kc = c;
        p.stages = s;
        p.stage_bytes = stage;
        p.smem = fixed + s * stage;
        break;
      }
  }
  if (p.kc == 0) return p;
  p.nch = p.dp / p.kc;
  p.planes_bytes = align256((size_t)2 * p.nch * p.npad * (p.kc + PAD) * 2);
  const int tiles = (B + qf - 1) / qf;
  const int nc = (int)(((long long)N + chunk - 1) / chunk);
  p.gx = std::max(1, std::min(tiles, sms));
  p.gy = ZVDB_TOPK2_PARTS > 0 ? ZVDB_TOPK2_PARTS : std::max(1, sms / p.gx);
  p.gy = std::max(1, std::min(p.gy, nc));
  p.fsc_bytes = align256((size_t)p.gx * p.gy * WARPS * p.cw * 4);
  p.surv_bytes = align256((size_t)B * nc * p.cap * 2);
  p.scratch_bytes = p.planes_bytes + 2 * align256((size_t)(p.npad + 8) * 4) + p.fsc_bytes +
                    p.surv_bytes + align256((size_t)B * nc * 4);
  return p;
}

// The tile F takes: FMQ m16 tiles when B > 16 and they fit, else one.
cudaError_t plan_f_for(int B, int N, int D, int k, int chunk, PlanF& plan) {
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t rc;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return rc;
  plan.kc = 0;
  if (B > 16 && FMQ > 1) plan = make_plan_f(B, N, D, k, chunk, smem_max, sms, FMQ);
  if (plan.kc == 0) plan = make_plan_f(B, N, D, k, chunk, smem_max, sms, 1);
  return plan.kc == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// F's filter pass (passes & 2) and select pass (passes & 8) on `stream`.
template <int MQF>
cudaError_t launch_pairs(bool vec, const float* q, const float* x, const Scratch& sc,
                         uint16_t* surv, int* scnt, float* ps, int* pi, StatsF* stats, int B,
                         int N, int D, int k, int chunk, int l2, const PlanF& plan, int passes,
                         cudaStream_t s) {
  auto kernel = k <= 32 ? pairs_mma_kernel<MQF, true> : pairs_mma_kernel<MQF, false>;
  cudaError_t rc;
  const int nc = (int)(((long long)N + chunk - 1) / chunk);
  if (passes & 8) {
    if (!(passes & 2)) goto select;
  } else if (!(passes & 2)) {
    return cudaSuccess;
  }
  if ((rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)plan.smem)) != cudaSuccess)
    return rc;
  kernel<<<dim3(plan.gx, plan.gy), 32 * WARPS, plan.smem, s>>>(q, x, sc.planes, sc.nrm, sc.xn,
                                                            sc.fsc, ps, pi, surv, scnt, stats, B,
                                                            N, D, k, chunk, l2, vec, plan);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  if (!(passes & 8)) return cudaSuccess;
select:
  select_kernel<<<dim3((B + SEL_WARPS - 1) / SEL_WARPS, nc), SEL_WARPS * 32,
                  (size_t)SEL_WARPS * plan.cap * 8, s>>>(q, x, sc.nrm, surv, scnt, ps, pi, B, D, k,
                                                        chunk, nc, plan.cap, l2, vec);
  return cudaGetLastError();
}

}  // namespace

// The scratch bytes zvdb_flat_topk_v1_mma needs for these arguments (at
// least 16), or -1 when they are refused.
extern "C" long long zvdb_flat_topk_v1_mma_scratch(int B, int N, int D, int k, int chunk) {
  if (bad_args(B, N, D, k, chunk)) return -1;
  Plan plan;
  if (plan_for(B, N, D, k, chunk, plan) != cudaSuccess) return -1;
  return (long long)std::max<size_t>(plan.scratch_bytes, 16);
}

// Kernel E on the tensor cores on `stream`; returns a CUDA error code (0 on
// success). The arguments of zvdb_flat_topk_v1 (csrc/scan_topk.cu), plus
// `scratch` (zvdb_flat_topk_v1_mma_scratch bytes, 256-byte aligned: the
// pre-pass's tiled bf16 planes, nrm and xn, and the rows of exact scores of
// the whole-chunk path) and `stats` (null, or 5 zeroed uint64: candidates
// pushed, the most in one list, overflowed lists, cold (query, chunk) pairs,
// lists replayed). Needs 1 <= D <= 1024, 1 <= k <= 256, 1 <= chunk <= 4096.
// Allocates nothing, does not sync.
extern "C" int zvdb_flat_topk_v1_mma(const void* q, const void* x, void* scratch, void* out_s,
                                     void* out_i, void* stats, int B, int N, int D, int k,
                                     int chunk, int l2, void* stream) {
  if (bad_args(B, N, D, k, chunk)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 256 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Plan plan;
  cudaError_t rc;
  if ((rc = plan_for(B, N, D, k, chunk, plan)) != cudaSuccess) return (int)rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const Scratch sc = carve(scratch, plan);
  if ((rc = run_prep(xf, sc, plan, N, D, s)) != cudaSuccess) return (int)rc;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  auto kernel = vec ? topk_mma_kernel<true> : topk_mma_kernel<false>;
  if ((rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)plan.smem)) != cudaSuccess)
    return (int)rc;
  kernel<<<(B + QT - 1) / QT, THREADS, plan.smem, s>>>(
      static_cast<const float*>(q), xf, sc.planes, sc.nrm, sc.xn, sc.fsc,
      static_cast<float*>(out_s), static_cast<int*>(out_i), static_cast<Stats*>(stats), B, N, D,
      k, chunk, l2, plan);
  return (int)cudaGetLastError();
}

// The pre-pass of zvdb_flat_topk_v1_mma alone (the same arguments and
// scratch), to time its share; returns a CUDA error code (0 on success).
extern "C" int zvdb_flat_topk_v1_mma_prep(const void* x, void* scratch, int B, int N, int D,
                                          int k, int chunk, void* stream) {
  if (bad_args(B, N, D, k, chunk)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 256 != 0) return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t rc;
  if ((rc = plan_for(B, N, D, k, chunk, plan)) != cudaSuccess) return (int)rc;
  return (int)run_prep(static_cast<const float*>(x), carve(scratch, plan), plan, N, D,
                       static_cast<cudaStream_t>(stream));
}

// The scratch bytes zvdb_flat_topk_v2_mma needs for these arguments (at
// least 16), or -1 when they are refused.
extern "C" long long zvdb_flat_topk_v2_mma_scratch(int B, int N, int D, int k, int chunk) {
  if (bad_args(B, N, D, k, chunk)) return -1;
  PlanF plan;
  if (plan_f_for(B, N, D, k, chunk, plan) != cudaSuccess) return -1;
  return (long long)std::max<size_t>(plan.scratch_bytes, 16);
}

// Kernel F on the tensor cores on `stream`; returns a CUDA error code (0 on
// success). `passes` picks its parts: 1 the pre-pass (E's: the tiled bf16
// planes, nrm and xn into `scratch`), 2 the pairs pass (each (query, chunk)'s
// k smallest (score, row) pairs, ascending, ties to the lower row, (+inf, -1)
// past the chunk's finite scores, into pair_s [B, nc, k] f32 and pair_i
// [B, nc, k] int32, nc = ceil(N / chunk) <= 65535), 4 the fold (the pairs
// replayed per query into out_s / out_i as csrc/scan_topk.cu's fold does); 7
// all three. The other arguments are zvdb_flat_topk_v1_mma's, with `stats`
// null or 5 zeroed uint64: entries pushed to the lists, the longest list,
// lists that overflowed, survivors re-scored, refreshes. Needs 1 <= D <=
// 1024, 1 <= k <= 256, 1 <= chunk <= 4096. Allocates nothing, does not sync.
extern "C" int zvdb_flat_topk_v2_mma(const void* q, const void* x, void* scratch, void* pair_s,
                                     void* pair_i, void* out_s, void* out_i, void* stats, int B,
                                     int N, int D, int k, int chunk, int l2, void* stream,
                                     int passes) {
  if (bad_args(B, N, D, k, chunk)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 256 != 0) return (int)cudaErrorInvalidValue;
  const int nc = (int)(((long long)N + chunk - 1) / chunk);
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  PlanF plan;
  cudaError_t rc;
  if ((rc = plan_f_for(B, N, D, k, chunk, plan)) != cudaSuccess) return (int)rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* ps = static_cast<float*>(pair_s);
  int* pi = static_cast<int*>(pair_i);
  const Scratch sc = carve(scratch, plan);
  if ((passes & 1) && (rc = run_prep(xf, sc, plan, N, D, s)) != cudaSuccess) return (int)rc;
  if ((passes & 10) && nc > 0) {
    const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
    StatsF* st = static_cast<StatsF*>(stats);
    unsigned char* tail = reinterpret_cast<unsigned char*>(sc.fsc) + plan.fsc_bytes;
    uint16_t* surv = reinterpret_cast<uint16_t*>(tail);
    int* scnt = reinterpret_cast<int*>(tail + plan.surv_bytes);
    rc = plan.mq == 1 ? launch_pairs<1>(vec, qf, xf, sc, surv, scnt, ps, pi, st, B, N, D, k,
                                        chunk, l2, plan, passes, s)
                      : launch_pairs<FMQ>(vec, qf, xf, sc, surv, scnt, ps, pi, st, B, N, D, k,
                                          chunk, l2, plan, passes, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (passes & 4) {
    fold_kernel<<<(B + FOLD_QT - 1) / FOLD_QT, FOLD_QT * 32, sizeof(float) * 2 * FOLD_QT * k,
                  s>>>(ps, pi, static_cast<float*>(out_s), static_cast<int*>(out_i), B, k, nc);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  return 0;
}
