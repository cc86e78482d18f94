// Exact flat top-k (kernel E) with a tensor-core filter, for sm_90a.
//
// Replaces examples/pallas_scan_v1.py:_scan_kernel (wrapper flat_topk_pallas)
// and the CUDA-core kernel E of csrc/scan_topk.cu (zvdb_flat_topk_v1), whose
// function it computes bit for bit: for each query the chunks of `chunk` rows
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
#define ZVDB_TOPK_DIAG 0   // timing only: 1 skips the mmas, 2 the copies (wrong results)
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

// acc = fmaf(q_d, x_d, acc) over d = 0 .. D-1 in order, from 0.
template <bool VEC>
__device__ __forceinline__ float exact_dot(const float* __restrict__ q,
                                           const float* __restrict__ x, int D) {
  float acc = 0.f;
  if constexpr (VEC) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int d = 0; d < D / 4; ++d) {
      const float4 a = __ldg(q4 + d), b = __ldg(x4 + d);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < D; ++d) acc = fmaf(__ldg(q + d), __ldg(x + d), acc);
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

bool bad_args(int B, int N, int D, int k, int chunk) {
  return B < 0 || N < 0 || D < 1 || D > DMAX || k < 1 || k > KMAX || chunk < 1 ||
         chunk > CHUNK_MAX;
}

// The scratch's sections: the tiled planes, nrm, xn, the whole-chunk rows.
struct Scratch {
  __nv_bfloat16* planes;
  float *nrm, *xn, *fsc;
};

Scratch carve(void* scratch, const Plan& plan) {
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  const size_t vec = align256((size_t)(plan.npad + 8) * 4);
  return {reinterpret_cast<__nv_bfloat16*>(sp), reinterpret_cast<float*>(sp + plan.planes_bytes),
          reinterpret_cast<float*>(sp + plan.planes_bytes + vec),
          reinterpret_cast<float*>(sp + plan.planes_bytes + 2 * vec)};
}

cudaError_t run_prep(const float* x, const Scratch& sc, const Plan& plan, int N, int D,
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
