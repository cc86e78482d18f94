// Fused 4-bit PQ (ADC) scan with a per-query top-1/top-2 bin fold, for
// Hopper (sm_90a).
//
// Replaces zvdb_tpu/ops/pallas_pq.py:_pq_kernel (wrapper pq_scan_bins).
// Codes are nibble-packed and stored transposed, codes_t [S/2, N]: byte j of
// row c holds subspace 2j in its low nibble and 2j+1 in its high nibble. For
// query b the score of row c is
//
//     s = norms[c] - f * sum_s LUT[b, s, code(c, s)]     (f = 2 for l2, 1 otherwise)
//
// with norms of +inf marking invalid rows. Row c belongs to segment
// c / seg_len and bin c % L; each (query, segment, bin) keeps its best row
// (PER_BIN = 1) or its best two (PER_BIN = 2): out[b, seg*PER_BIN*L + l]
// holds the best, out[b, seg*PER_BIN*L + L + l] the runner-up, -1 / +inf
// where a bin saw fewer valid rows.
//
// The precision is part of the contract, as on the TPU:
//   INT8     the LUT arrives quantized to int8 with a per-query scale; the
//            int32 sum is exact, then dots = float(sum) * scale and
//            s = n - f * dots with __fmul_rn / __fsub_rn, so nothing contracts
//            into an FMA and the scores equal the plain version bit for bit;
//   DEFAULT  bf16-rounded LUT entries (round to nearest even) summed in f32;
//   HIGH     hi = bf16(v), lo = bf16(v - hi): sum(hi) + sum(lo), two f32 sums.
// Sums run over the subspaces in order 0..S-1.
//
// The fold keeps the TPU's tie rules: take1 = s < s1; take2 = !take1 &&
// s < s2, with rows visited in increasing order, so the lower row wins a tie
// and an equal score lands in slot 2. 4-bit codes make many rows
// bit-identical, so ties are common here.
//
// What bounds it. Per call the work is B*N*S table lookups and adds; counted
// as the TPU kernel's one-hot product (2*B*N*S*16 operations, 1.05e12 at
// B=2048, N=1M, S=16) it is bound by the int8 tensor-core rate at ~0.53 ms,
// while its bytes (codes N*S/2, norms, the B x n_seg*PER_BIN*L outputs) take
// ~0.014 ms. This first version does the lookups from shared memory on the
// CUDA cores instead, so the shared-memory pipe (one warp-wide load per
// clock per SM) bounds it: one load per (query, row, subspace) for DEFAULT
// (B*N*S/32 warp loads / (132 SMs * 1.75 GHz), ~4.6 ms at that shape), two
// for HIGH, and for INT8 one per (query PAIR, row, subspace), ~2.3 ms. Tensor
// cores (an int8 mma over a one-hot or a packed-table formulation) and TMA
// are later work.
//
// What the design does about it. The Pallas grid walked corpus chunks in
// order and carried the bins in VMEM. CUDA blocks run in no order, so each
// block owns one (tile of QT queries, slice of bins, segment) and walks rows
// c = seg*seg_len + m*L + l in increasing m; each thread owns one bin and
// keeps its (s1, i1, s2, i2) for all QT queries in registers for the whole
// walk: no merge pass, no atomics, no scratch memory. The query tile's LUT
// sits in shared memory in natural [S, 16] order. A thread loads its row's
// S/2 code bytes once per step (coalesced across the bin slice: neighbouring
// threads read neighbouring bytes of one codes_t row) and reuses them for
// every query it owns. INT8 packs two queries' biased entries into one
// 32-bit word and sums both with one add (adc_row_int8): half the shared
// loads and adds, and half the accumulator registers. Ragged N, +inf rows
// and a B that is no multiple of QT are masked here, with no padded copy.
//
// The per-row ADC sums (adc_row_int8, adc_row_f32) and the fold (fold_row)
// are device functions, shared with the two entry points below.
//
// Kernel C: the grouped IVF-PQ probe scan (zvdb_pq_grouped_scan_bins).
// Replaces zvdb_tpu/ops/pallas_pq.py:pq_grouped_scan_bins, which runs the
// same _pq_kernel over a (cluster, cap-chunk) grid. Cluster c's codes are
// codes_blocks[c] = [S/2, cap] (the flat layout with cap rows), its norms
// norms_blocks[c] (+inf = empty or tombstoned), and qslot[c] = [qcap] lists
// the queries that probed it (-1 = empty slot). Row `pos` of cluster c
// falls in bin pos % L; out[c, slot] holds per-bin positions within the
// cluster, not ids. Rows are folded in increasing position with the TPU's tie
// rules, and the scores come from the same adc_row_* / score calls as the
// flat scan, so for a slot they equal kernel B's on that cluster bit for bit.
//
// What bounds it. A batch scores each cluster against its qcap slots: the
// TPU counted that as a one-hot product of 2*C*qcap*capp*S*16 operations
// (2.7e11 at C=4096, qcap=32, capp=1024, S=16: 0.14 ms at the int8
// tensor-core rate), and the output is C*qcap*PER_BIN*L*8 bytes (0.54 GB at
// per_bin=2, L=256: 0.16 ms at 3.35 TB/s), so bytes bind; most of that
// output belongs to empty slots (about B*P live of C*qcap). The work done is
// small: about cap/L rows per bin per cluster against staging the slot
// tile's table, so launch and latency, not lookups, set the time of this
// first version.
//
// What the design does about it. One block owns one (cluster, tile of QT
// slots, slice of <= 256 bins): the cluster sits on gridDim.x (C passes the
// 65535 that y and z allow at 30M rows). Each thread owns one bin and walks
// positions l, l+L, ... below cap with (s1, i1, s2, i2) for the tile's QT
// slots in registers, as in the flat scan: no merge, no atomics. Positions
// from cap up to the JAX wrapper's padded capp are never read (their +inf
// norms are never taken), so no padded copy is made. The block gathers its
// live slots' rows of the quantized table from lut [B, S, 16] into shared
// memory itself (JAX materializes a [C*qcap, S*16] copy); an empty slot
// stages zero entries (128 in the biased int8 pair word). A tile with no
// live slot skips staging and the walk. The kernel writes the whole output:
// empty slots, and every slot of an empty tile, get +inf / -1 here, not in
// the wrapper.
//
// The pair scan (zvdb_pq_grouped_scan_pairs): kernel C redesigned for the
// card. It computes what the JAX package's search computes from
// zvdb_tpu/ops/pallas_pq.py:pq_grouped_scan_bins and the scatter after it
// (zvdb_tpu/index/ivfpq.py:330-349): for the slot of cluster c holding
// query q at probe rank p, pool[q, p*lw + l] (lw = PER_BIN*L) gets c's bin
// l as kernel C computes it, its position made flat (c * capp + pos); a
// pool no slot names reads +inf / -1.
//
// What bounds it. The TPU needed the [C, qcap, lw] slot output because its
// grid walked clusters in order; at ivfpq_1m that output is 0.72 GB of which
// about B*P of C*qcap slots (9%) are live, and the scatter after it moved
// another 1.4 GB. What the batch needs is each pool written once (B*P*lw*8
// bytes, 67 MB at B=2048, P=8, lw=512), the probed clusters' stored codes
// and norms read once (~12 MB) and the table (0.5 MB): ~0.024 ms at 3.35
// TB/s. The lookups (~48M a batch) are small beside that, so bytes and the
// latency of many small blocks bind, not operations.
//
// What the design does about it. One block (256 threads) owns one cluster.
// It compacts the cluster's live slots, a window of ws at a time, with warp
// ballots (in slot order; the engine fills slots in rank order, so past the
// live count a window is empty and costs one read of the slot table); a
// cluster with no live slot stages nothing. On its first live window it
// stages the cluster's codes [S/2, cap] and norms with cp.async (16 bytes a
// copy where aligned), once, when they fit PAIR_STAGE_BYTES (else the walk
// reads them through the read-only cache), beside the window's tables
// gathered as in kernel C. Work items are (group of NQ = 4 live slots,
// bin): a thread scores its bin's positions for four slots (two int8 pair
// words) with the same adc_row_* / score / fold_row calls as kernels B and
// C, so "int8" scores equal kernel C's bit for bit; at ~3 live slots and
// <= 3 positions a bin at ivfpq_1m, one item a thread keeps the lanes busy
// where a thread a (slot, bin) would idle three in four on a one-slot
// cluster and kernel C's 16-slot tiles computed 13 empty slots. Neighbouring
// threads take neighbouring bins, so the code reads and the pool writes
// coalesce; the epilogue writes each live slot's bins straight into its
// pool. Pools no slot names (pairs q_cap dropped) are covered by the kernel,
// not by a pre-fill of the whole pool (which would write its 67 MB twice):
// each live slot marks its (q, p) in a B*P byte map (zeroed by a memset),
// and a second small kernel writes +inf / -1 over the unmarked pools.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;             // queries per block, all owned by every thread
constexpr int MAX_THREADS = 256;   // bins per block
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use

enum Precision { kDefault = 0, kHigh = 1, kInt8 = 2 };

// Shared-memory words per query tile and table entry: f32 planes (one, or
// hi and lo for HIGH), or for INT8 one 32-bit word per PAIR of queries.
template <int PREC> __host__ __device__ constexpr int lut_words(int sc) {
  return PREC == kInt8 ? QT / 2 * sc : (PREC == kHigh ? 2 : 1) * QT * sc;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// INT8: acc[p] holds two queries' sums, 2p in the low and 2p+1 in the high
// 16 bits. Each table word is (lut[2p] + 128) | (lut[2p+1] + 128) << 16, so
// both halves stay in [0, 255] and a half's sum over S <= 256 subspaces
// stays below 2**16: one 32-bit add sums two queries with no carry between
// them. Subspaces are summed in order 0..S-1 (integer sums: exact).
// NP pair words (QT / 2 in kernels B and C, NQ / 2 in the pair scan);
// LDG reads the codes through the read-only cache (device memory), else
// plainly (codes staged in shared memory).
template <bool LDG = true, int NP>
__device__ __forceinline__ void adc_row_int8(const unsigned* __restrict__ lut, int sc,
                                             const uint8_t* __restrict__ codes_t,
                                             long long n_rows, long long c, int nb,
                                             unsigned (&acc)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0u;
  for (int j = 0; j < nb; ++j) {
    const uint8_t* at = codes_t + (long long)j * n_rows + c;
    const unsigned byte = LDG ? __ldg(at) : *at;
    const int o0 = (2 * j) * 16 + (byte & 15u);
    const int o1 = (2 * j + 1) * 16 + (byte >> 4);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      acc[p] += lut[p * sc + o0];
      acc[p] += lut[p * sc + o1];
    }
  }
}

// Query q's exact integer sum out of the packed pair sums.
template <int NP>
__device__ __forceinline__ int int8_sum(const unsigned (&acc)[NP], int q, int n_sub) {
  return (int)((acc[q / 2] >> (16 * (q % 2))) & 0xFFFFu) - 128 * n_sub;
}

// DEFAULT / HIGH: acc[q] (and acc_lo[q] for HIGH) = sum over subspaces
// 0..S-1, in that order, of query q's f32 table entry at row c's code. lut
// is [NQ][planes][S*16]; LDG as in adc_row_int8.
template <int PREC, bool LDG = true, int NQ>
__device__ __forceinline__ void adc_row_f32(const float* __restrict__ lut, int sc,
                                            const uint8_t* __restrict__ codes_t,
                                            long long n_rows, long long c, int nb,
                                            float (&acc)[NQ], float (&acc_lo)[NQ]) {
  constexpr int P = PREC == kHigh ? 2 : 1;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    acc[q] = 0.f;
    acc_lo[q] = 0.f;
  }
  for (int j = 0; j < nb; ++j) {
    const uint8_t* at = codes_t + (long long)j * n_rows + c;
    const unsigned byte = LDG ? __ldg(at) : *at;
    const int o0 = (2 * j) * 16 + (byte & 15u);
    const int o1 = (2 * j + 1) * 16 + (byte >> 4);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float* l = lut + q * P * sc;
      acc[q] = __fadd_rn(acc[q], l[o0]);
      acc[q] = __fadd_rn(acc[q], l[o1]);
      if constexpr (PREC == kHigh) {
        acc_lo[q] = __fadd_rn(acc_lo[q], l[sc + o0]);
        acc_lo[q] = __fadd_rn(acc_lo[q], l[sc + o1]);
      }
    }
  }
}

// The surrogate score from a row's dot product, with no contraction into an FMA.
__device__ __forceinline__ float score(float dots, float nrm, float factor) {
  return __fsub_rn(nrm, __fmul_rn(factor, dots));
}

// Fold row c's score into one bin's best (and runner-up), the TPU's rules.
template <int PER_BIN>
__device__ __forceinline__ void fold_row(float s, int c, float& s1, int& i1, float& s2,
                                         int& i2) {
  const bool take1 = s < s1;
  if constexpr (PER_BIN == 2) {
    const bool take2 = !take1 && s < s2;
    if (take1) {
      s2 = s1;
      i2 = i1;
    } else if (take2) {
      s2 = s;
      i2 = c;
    }
  }
  if (take1) {
    s1 = s;
    i1 = c;
  }
}

template <int PREC, int PER_BIN>
__global__ void __launch_bounds__(MAX_THREADS)
pq_scan_kernel(const void* __restrict__ lut_in, const float* __restrict__ scales,
               const uint8_t* __restrict__ codes_t, const float* __restrict__ norms,
               float* __restrict__ out_s, int* __restrict__ out_i, int B, int N,
               int n_sub, int L, long long seg_len, float factor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sc = n_sub * 16;
  unsigned* lut_w = reinterpret_cast<unsigned*>(smem);        // INT8 pair words
  float* lut_f = reinterpret_cast<float*>(smem);              // f32 planes
  float* scl = reinterpret_cast<float*>(smem) + lut_words<PREC>(sc);   // [QT]

  const int b0 = blockIdx.x * QT;
  const int l = blockIdx.y * blockDim.x + threadIdx.x;     // this thread's bin
  const int seg = blockIdx.z;

  if constexpr (PREC == kInt8) {
    const int8_t* lut8 = static_cast<const int8_t*>(lut_in);
    for (int e = threadIdx.x; e < QT / 2 * sc; e += blockDim.x) {
      const int p = e / sc, k = e % sc;
      const int b = b0 + 2 * p;
      const unsigned lo = b < B ? (unsigned)((int)lut8[(long long)b * sc + k] + 128) : 128u;
      const unsigned hi =
          b + 1 < B ? (unsigned)((int)lut8[(long long)(b + 1) * sc + k] + 128) : 128u;
      lut_w[e] = lo | (hi << 16);
    }
  } else {
    constexpr int P = PREC == kHigh ? 2 : 1;
    const float* lut32 = static_cast<const float*>(lut_in);
    for (int e = threadIdx.x; e < QT * sc; e += blockDim.x) {
      const int q = e / sc, k = e % sc;
      const int b = b0 + q;
      const float v = b < B ? lut32[(long long)b * sc + k] : 0.f;
      const float hi = bf16_round(v);
      lut_f[q * P * sc + k] = hi;
      if constexpr (PREC == kHigh) lut_f[q * P * sc + sc + k] = bf16_round(v - hi);
    }
  }
  if (threadIdx.x < QT) {
    const int b = b0 + threadIdx.x;
    scl[threadIdx.x] = (PREC == kInt8 && b < B) ? scales[b] : 1.f;
  }
  __syncthreads();
  if (l >= L) return;

  const float inf = __int_as_float(0x7f800000);
  float s1[QT], s2[QT];
  int i1[QT], i2[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    s1[q] = inf;
    s2[q] = inf;
    i1[q] = -1;
    i2[q] = -1;
  }

  float scale[QT];   // INT8 dequantization scales (unused otherwise)
#pragma unroll
  for (int q = 0; q < QT; ++q) scale[q] = scl[q];

  const long long seg_lo = (long long)seg * seg_len;
  const long long seg_hi = seg_lo + seg_len < N ? seg_lo + seg_len : (long long)N;
  for (long long c = seg_lo + l; c < seg_hi; c += L) {
    const float nrm = __ldg(norms + c);
    if (nrm == inf) continue;   // invalid row: its score is +inf, never taken
    if constexpr (PREC == kInt8) {
      unsigned acc[QT / 2];
      adc_row_int8(lut_w, sc, codes_t, N, c, n_sub / 2, acc);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float dots = __fmul_rn(__int2float_rn(int8_sum(acc, q, n_sub)), scale[q]);
        fold_row<PER_BIN>(score(dots, nrm, factor), (int)c, s1[q], i1[q], s2[q], i2[q]);
      }
    } else {
      float acc[QT], acc_lo[QT];
      adc_row_f32<PREC>(lut_f, sc, codes_t, N, c, n_sub / 2, acc, acc_lo);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float dots = PREC == kHigh ? __fadd_rn(acc[q], acc_lo[q]) : acc[q];
        fold_row<PER_BIN>(score(dots, nrm, factor), (int)c, s1[q], i1[q], s2[q], i2[q]);
      }
    }
  }

  const int lw = PER_BIN * L;
  const long long width = (long long)gridDim.z * lw;
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    const int b = b0 + q;
    if (b >= B) continue;
    const long long o = (long long)b * width + (long long)seg * lw + l;
    out_s[o] = s1[q];
    out_i[o] = i1[q];
    if constexpr (PER_BIN == 2) {
      out_s[o + L] = s2[q];
      out_i[o + L] = i2[q];
    }
  }
}

template <int PREC, int PER_BIN>
int launch(dim3 grid, int threads, size_t smem, cudaStream_t stream, const void* lut,
           const float* scales, const uint8_t* codes_t, const float* norms, float* out_s,
           int* out_i, int B, int N, int n_sub, int L, long long seg_len, float factor) {
  auto kernel = pq_scan_kernel<PREC, PER_BIN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(lut, scales, codes_t, norms, out_s, out_i, B, N,
                                          n_sub, L, seg_len, factor);
  return (int)cudaGetLastError();
}

template <int PREC>
int launch_prec(int per_bin, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                const void* lut, const float* scales, const uint8_t* codes_t,
                const float* norms, float* out_s, int* out_i, int B, int N, int n_sub, int L,
                long long seg_len, float factor) {
  if (per_bin == 1)
    return launch<PREC, 1>(grid, threads, smem, stream, lut, scales, codes_t, norms, out_s,
                           out_i, B, N, n_sub, L, seg_len, factor);
  return launch<PREC, 2>(grid, threads, smem, stream, lut, scales, codes_t, norms, out_s,
                         out_i, B, N, n_sub, L, seg_len, factor);
}

template <int PREC, int PER_BIN>
__global__ void __launch_bounds__(MAX_THREADS)
pq_grouped_scan_kernel(const void* __restrict__ lut_in, const float* __restrict__ scales,
                       const int* __restrict__ qslot, const uint8_t* __restrict__ codes_blocks,
                       const float* __restrict__ norms_blocks, float* __restrict__ out_s,
                       int* __restrict__ out_i, int B, int qcap, int cap, int n_sub, int L,
                       float factor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sc = n_sub * 16;
  unsigned* lut_w = reinterpret_cast<unsigned*>(smem);        // INT8 pair words
  float* lut_f = reinterpret_cast<float*>(smem);              // f32 planes
  float* scl = reinterpret_cast<float*>(smem) + lut_words<PREC>(sc);   // [QT]
  int* slot_q = reinterpret_cast<int*>(scl + QT);             // [QT] query per slot, -1 empty

  const long long c = blockIdx.x;
  const int t0 = blockIdx.y * QT;                          // first slot of the tile
  const int l = blockIdx.z * blockDim.x + threadIdx.x;     // this thread's bin
  const int lw = PER_BIN * L;
  const float inf = __int_as_float(0x7f800000);

  if (threadIdx.x < QT) {
    const int slot = t0 + threadIdx.x;
    const int b = slot < qcap ? qslot[c * qcap + slot] : -1;
    slot_q[threadIdx.x] = (b >= 0 && b < B) ? b : -1;
  }
  __syncthreads();
  bool live = false;   // read from shared memory by every thread: a uniform branch
#pragma unroll
  for (int q = 0; q < QT; ++q) live |= slot_q[q] >= 0;
  if (!live) {
    if (l < L) {
      for (int q = 0; q < QT && t0 + q < qcap; ++q) {
        const long long o = (c * qcap + t0 + q) * lw + l;
        out_s[o] = inf;
        out_i[o] = -1;
        if constexpr (PER_BIN == 2) {
          out_s[o + L] = inf;
          out_i[o + L] = -1;
        }
      }
    }
    return;
  }

  if constexpr (PREC == kInt8) {
    const int8_t* lut8 = static_cast<const int8_t*>(lut_in);
    for (int e = threadIdx.x; e < QT / 2 * sc; e += blockDim.x) {
      const int p = e / sc, k = e % sc;
      const int b0 = slot_q[2 * p], b1 = slot_q[2 * p + 1];
      const unsigned lo = b0 >= 0 ? (unsigned)((int)lut8[(long long)b0 * sc + k] + 128) : 128u;
      const unsigned hi = b1 >= 0 ? (unsigned)((int)lut8[(long long)b1 * sc + k] + 128) : 128u;
      lut_w[e] = lo | (hi << 16);
    }
  } else {
    constexpr int P = PREC == kHigh ? 2 : 1;
    const float* lut32 = static_cast<const float*>(lut_in);
    for (int e = threadIdx.x; e < QT * sc; e += blockDim.x) {
      const int q = e / sc, k = e % sc;
      const int b = slot_q[q];
      const float v = b >= 0 ? lut32[(long long)b * sc + k] : 0.f;
      const float hi = bf16_round(v);
      lut_f[q * P * sc + k] = hi;
      if constexpr (PREC == kHigh) lut_f[q * P * sc + sc + k] = bf16_round(v - hi);
    }
  }
  if (threadIdx.x < QT) {
    const int b = slot_q[threadIdx.x];
    scl[threadIdx.x] = (PREC == kInt8 && b >= 0) ? scales[b] : 1.f;
  }
  __syncthreads();
  if (l >= L) return;

  float s1[QT], s2[QT];
  int i1[QT], i2[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    s1[q] = inf;
    s2[q] = inf;
    i1[q] = -1;
    i2[q] = -1;
  }
  float scale[QT];   // INT8 dequantization scales (unused otherwise)
#pragma unroll
  for (int q = 0; q < QT; ++q) scale[q] = scl[q];

  const int nb = n_sub / 2;
  const uint8_t* codes_c = codes_blocks + c * nb * (long long)cap;   // [S/2, cap]
  const float* norms_c = norms_blocks + c * (long long)cap;
  for (int pos = l; pos < cap; pos += L) {
    const float nrm = __ldg(norms_c + pos);
    if (nrm == inf) continue;   // empty or tombstoned row: +inf, never taken
    if constexpr (PREC == kInt8) {
      unsigned acc[QT / 2];
      adc_row_int8(lut_w, sc, codes_c, cap, pos, nb, acc);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float dots = __fmul_rn(__int2float_rn(int8_sum(acc, q, n_sub)), scale[q]);
        fold_row<PER_BIN>(score(dots, nrm, factor), pos, s1[q], i1[q], s2[q], i2[q]);
      }
    } else {
      float acc[QT], acc_lo[QT];
      adc_row_f32<PREC>(lut_f, sc, codes_c, cap, pos, nb, acc, acc_lo);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float dots = PREC == kHigh ? __fadd_rn(acc[q], acc_lo[q]) : acc[q];
        fold_row<PER_BIN>(score(dots, nrm, factor), pos, s1[q], i1[q], s2[q], i2[q]);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (t0 + q >= qcap) continue;
    const bool empty = slot_q[q] < 0;
    const long long o = (c * qcap + t0 + q) * lw + l;
    out_s[o] = empty ? inf : s1[q];
    out_i[o] = empty ? -1 : i1[q];
    if constexpr (PER_BIN == 2) {
      out_s[o + L] = empty ? inf : s2[q];
      out_i[o + L] = empty ? -1 : i2[q];
    }
  }
}

template <int PREC, int PER_BIN>
int launch_grouped(dim3 grid, int threads, size_t smem, cudaStream_t stream, const void* lut,
                   const float* scales, const int* qslot, const uint8_t* codes_blocks,
                   const float* norms_blocks, float* out_s, int* out_i, int B, int qcap,
                   int cap, int n_sub, int L, float factor) {
  auto kernel = pq_grouped_scan_kernel<PREC, PER_BIN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(lut, scales, qslot, codes_blocks, norms_blocks, out_s,
                                          out_i, B, qcap, cap, n_sub, L, factor);
  return (int)cudaGetLastError();
}

template <int PREC>
int launch_grouped_prec(int per_bin, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        const void* lut, const float* scales, const int* qslot,
                        const uint8_t* codes_blocks, const float* norms_blocks, float* out_s,
                        int* out_i, int B, int qcap, int cap, int n_sub, int L, float factor) {
  if (per_bin == 1)
    return launch_grouped<PREC, 1>(grid, threads, smem, stream, lut, scales, qslot,
                                   codes_blocks, norms_blocks, out_s, out_i, B, qcap, cap,
                                   n_sub, L, factor);
  return launch_grouped<PREC, 2>(grid, threads, smem, stream, lut, scales, qslot, codes_blocks,
                                 norms_blocks, out_s, out_i, B, qcap, cap, n_sub, L, factor);
}

// ---------------------------------------------------------------------------
// The pair scan (zvdb_pq_grouped_scan_pairs): kernel C's scores, written
// straight into each (query, probe) pool. See the note at the top.

constexpr int PAIR_THREADS = 256;   // threads a block: one block a cluster
constexpr int NQ = 4;               // slots a thread scores at once (two int8 pair words)
constexpr int PAIR_LUT_BYTES = 16384;     // tables of a window of slots, at most (>= NQ slots)
constexpr int PAIR_STAGE_BYTES = 49152;   // a cluster's codes and norms are staged up to this

// Shared-memory bytes of one slot's table: half an int8 pair word an entry,
// or one f32 word an entry and plane.
template <int PREC> __host__ __device__ constexpr int slot_bytes(int sc) {
  return PREC == kInt8 ? 2 * sc : (PREC == kHigh ? 2 : 1) * 4 * sc;
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Copy `bytes` (a multiple of 4, both ends 4-aligned) from device memory to
// shared memory with cp.async, 16 bytes a copy where the source and the
// length allow it (dst is 16-aligned). The caller commits and waits.
__device__ __forceinline__ void stage_async(void* dst, const void* src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes) & 15) == 0) {
    for (int o = 16 * threadIdx.x; o < bytes; o += 16 * PAIR_THREADS) cp_async16(d + o, s + o);
  } else {
    for (int o = 4 * threadIdx.x; o < bytes; o += 4 * PAIR_THREADS) cp_async4(d + o, s + o);
  }
}

template <int PREC, int PER_BIN, bool STAGE>
__global__ void __launch_bounds__(PAIR_THREADS)
pq_grouped_pairs_kernel(const void* __restrict__ lut_in, const float* __restrict__ scales,
                        const int* __restrict__ qslot, const int* __restrict__ pslot,
                        const uint8_t* __restrict__ codes_blocks,
                        const float* __restrict__ norms_blocks, float* __restrict__ pool_s,
                        int* __restrict__ pool_i, uint8_t* __restrict__ covered, int B, int P,
                        int qcap, int cap, int capp, int n_sub, int L, int ws, float factor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sc = n_sub * 16;
  const int nb = n_sub / 2;
  const long long c = blockIdx.x;
  const int t = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  // [codes nb*cap | norms cap] when staged, then the window's tables, its
  // scales, its live slots' queries and probe ranks, and a count a warp
  const int codes_bytes = STAGE ? round16(nb * cap) + round16(4 * cap) : 0;
  uint8_t* s_codes = smem;
  float* s_norms = reinterpret_cast<float*>(smem + round16(nb * cap));
  unsigned* lut_w = reinterpret_cast<unsigned*>(smem + codes_bytes);   // INT8 pair words
  float* lut_f = reinterpret_cast<float*>(lut_w);                       // f32 planes
  float* scl = reinterpret_cast<float*>(smem + codes_bytes + ws * slot_bytes<PREC>(sc));
  int* list_q = reinterpret_cast<int*>(scl + ws);
  int* list_p = list_q + ws;
  int* warp_n = list_p + ws;

  const uint8_t* codes_c = codes_blocks + c * nb * (long long)cap;   // [S/2, cap]
  const float* norms_c = norms_blocks + c * (long long)cap;
  const uint8_t* codes = STAGE ? s_codes : codes_c;
  const long long row = (long long)P * PER_BIN * L;   // a query's pool width
  bool staged = false;

  for (int w0 = 0; w0 < qcap; w0 += ws) {
    // the window's live slots, compacted in slot order
    int q = -1, p = -1;
    if (t < ws && w0 + t < qcap) {
      q = qslot[c * qcap + w0 + t];
      p = pslot[c * qcap + w0 + t];
      if (q < 0 || q >= B || p < 0 || p >= P) q = -1;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, q >= 0);
    if (t % 32 == 0) warp_n[t / 32] = __popc(ballot);
    __syncthreads();
    int before = 0, n_live = 0;
#pragma unroll
    for (int w = 0; w < PAIR_THREADS / 32; ++w) {
      before += w < t / 32 ? warp_n[w] : 0;
      n_live += warp_n[w];
    }
    if (q >= 0) {
      const int k = before + __popc(ballot & ((1u << (t % 32)) - 1u));
      list_q[k] = q;
      list_p[k] = p;
      covered[(long long)q * P + p] = 1;
    }
    if (n_live == 0) {   // uniform: every thread read the same counts
      __syncthreads();   // warp_n is rewritten by the next window
      continue;
    }
    if (STAGE && !staged) {   // the cluster, once, on its first live window
      stage_async(s_codes, codes_c, nb * cap);
      stage_async(s_norms, norms_c, 4 * cap);
      asm volatile("cp.async.commit_group;\n" ::);
      staged = true;
    }
    __syncthreads();   // list_q / list_p complete
    const int groups = (n_live + NQ - 1) / NQ;
    if constexpr (PREC == kInt8) {
      const int8_t* lut8 = static_cast<const int8_t*>(lut_in);
      for (int e = t; e < groups * (NQ / 2) * sc; e += PAIR_THREADS) {
        const int pp = e / sc, k = e % sc;
        const int a = 2 * pp, b = 2 * pp + 1;
        const unsigned lo =
            a < n_live ? (unsigned)((int)lut8[(long long)list_q[a] * sc + k] + 128) : 128u;
        const unsigned hi =
            b < n_live ? (unsigned)((int)lut8[(long long)list_q[b] * sc + k] + 128) : 128u;
        lut_w[e] = lo | (hi << 16);
      }
    } else {
      constexpr int PL = PREC == kHigh ? 2 : 1;
      const float* lut32 = static_cast<const float*>(lut_in);
      for (int e = t; e < groups * NQ * sc; e += PAIR_THREADS) {
        const int a = e / sc, k = e % sc;
        const float v = a < n_live ? lut32[(long long)list_q[a] * sc + k] : 0.f;
        const float hi = bf16_round(v);
        lut_f[a * PL * sc + k] = hi;
        if constexpr (PREC == kHigh) lut_f[a * PL * sc + sc + k] = bf16_round(v - hi);
      }
    }
    for (int a = t; a < groups * NQ; a += PAIR_THREADS)
      scl[a] = (PREC == kInt8 && a < n_live) ? scales[list_q[a]] : 1.f;
    if (STAGE) asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // one item = (group of NQ live slots, bin); neighbouring threads take
    // neighbouring bins, so code reads and pool writes coalesce
    for (int item = t; item < groups * L; item += PAIR_THREADS) {
      const int g = item / L, l = item % L;
      float s1[NQ], s2[NQ], scale[NQ];
      int i1[NQ], i2[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        s1[j] = inf;
        s2[j] = inf;
        i1[j] = -1;
        i2[j] = -1;
        scale[j] = scl[g * NQ + j];
      }
      for (int pos = l; pos < cap; pos += L) {
        const float nrm = STAGE ? s_norms[pos] : __ldg(norms_c + pos);
        if (nrm == inf) continue;   // empty or tombstoned row: +inf, never taken
        if constexpr (PREC == kInt8) {
          unsigned acc[NQ / 2];
          adc_row_int8<!STAGE>(lut_w + g * (NQ / 2) * sc, sc, codes, cap, pos, nb, acc);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float dots = __fmul_rn(__int2float_rn(int8_sum(acc, j, n_sub)), scale[j]);
            fold_row<PER_BIN>(score(dots, nrm, factor), pos, s1[j], i1[j], s2[j], i2[j]);
          }
        } else {
          constexpr int PL = PREC == kHigh ? 2 : 1;
          float acc[NQ], acc_lo[NQ];
          adc_row_f32<PREC, !STAGE>(lut_f + g * NQ * PL * sc, sc, codes, cap, pos, nb, acc,
                                    acc_lo);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float dots = PREC == kHigh ? __fadd_rn(acc[j], acc_lo[j]) : acc[j];
            fold_row<PER_BIN>(score(dots, nrm, factor), pos, s1[j], i1[j], s2[j], i2[j]);
          }
        }
      }
      // the epilogue: each live slot's bins go to its own pool, positions
      // made flat (cluster * capp + pos)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int k = g * NQ + j;
        if (k >= n_live) break;
        const long long o = list_q[k] * row + (long long)list_p[k] * PER_BIN * L + l;
        pool_s[o] = s1[j];
        pool_i[o] = i1[j] >= 0 ? (int)(c * capp + i1[j]) : -1;
        if constexpr (PER_BIN == 2) {
          pool_s[o + L] = s2[j];
          pool_i[o + L] = i2[j] >= 0 ? (int)(c * capp + i2[j]) : -1;
        }
      }
    }
    __syncthreads();   // the next window rewrites the tables and lists
  }
}

// +inf / -1 over every pool no slot covered: the pairs q_cap dropped, and
// probe ranks no slot names. One warp a pool.
__global__ void __launch_bounds__(PAIR_THREADS)
fill_uncovered_kernel(const uint8_t* __restrict__ covered, float* __restrict__ pool_s,
                      int* __restrict__ pool_i, long long n_pools, int lw) {
  const long long pool = (long long)blockIdx.x * (PAIR_THREADS / 32) + threadIdx.x / 32;
  if (pool >= n_pools || covered[pool]) return;
  const float inf = __int_as_float(0x7f800000);
  for (int e = threadIdx.x % 32; e < lw; e += 32) {
    pool_s[pool * lw + e] = inf;
    pool_i[pool * lw + e] = -1;
  }
}

template <int PREC, int PER_BIN, bool STAGE>
int launch_pairs(int C, size_t smem, cudaStream_t stream, const void* lut, const float* scales,
                 const int* qslot, const int* pslot, const uint8_t* codes_blocks,
                 const float* norms_blocks, float* pool_s, int* pool_i, uint8_t* covered, int B,
                 int P, int qcap, int cap, int capp, int n_sub, int L, int ws, float factor) {
  auto kernel = pq_grouped_pairs_kernel<PREC, PER_BIN, STAGE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<C, PAIR_THREADS, smem, stream>>>(lut, scales, qslot, pslot, codes_blocks,
                                             norms_blocks, pool_s, pool_i, covered, B, P, qcap,
                                             cap, capp, n_sub, L, ws, factor);
  return (int)cudaGetLastError();
}

template <int PREC>
int launch_pairs_prec(int per_bin, bool stage, int C, size_t smem, cudaStream_t stream,
                      const void* lut, const float* scales, const int* qslot, const int* pslot,
                      const uint8_t* codes_blocks, const float* norms_blocks, float* pool_s,
                      int* pool_i, uint8_t* covered, int B, int P, int qcap, int cap, int capp,
                      int n_sub, int L, int ws, float factor) {
#define ZVDB_PAIRS(PB, ST)                                                                    \
  return launch_pairs<PREC, PB, ST>(C, smem, stream, lut, scales, qslot, pslot, codes_blocks, \
                                    norms_blocks, pool_s, pool_i, covered, B, P, qcap, cap,   \
                                    capp, n_sub, L, ws, factor)
  if (per_bin == 1) {
    if (stage) ZVDB_PAIRS(1, true);
    ZVDB_PAIRS(1, false);
  }
  if (stage) ZVDB_PAIRS(2, true);
  ZVDB_PAIRS(2, false);
#undef ZVDB_PAIRS
}

}  // namespace

// Launches the scan on `stream`; returns a CUDA error code (0 on success).
// lut [B, S, 16]: int8 (precision 2, S <= 256) or f32 (0 default, 1 high); scales [B]
// f32 (read for int8 only); codes_t [S/2, N] uint8; norms [N] f32;
// out_s [B, n_seg*per_bin*L] f32, out_i the same int32; every array
// contiguous on the device. Segment z covers rows [z*seg_len, (z+1)*seg_len).
// Allocates nothing, does not sync.
extern "C" int zvdb_pq_scan_bins(const void* lut, const void* scales, const void* codes_t,
                                 const void* norms, void* out_s, void* out_i, int B, int N,
                                 int n_sub, int L, long long seg_len, int n_seg,
                                 float factor, int precision, int per_bin, void* stream) {
  if (B <= 0 || N < 0 || L <= 0 || n_sub <= 0 || n_sub % 2 != 0 || seg_len <= 0 ||
      n_seg <= 0 || n_seg > 65535 || precision < 0 || precision > 2 || per_bin < 1 ||
      per_bin > 2 || (precision == kInt8 && n_sub > 256))
    return (int)cudaErrorInvalidValue;
  const int threads = L < MAX_THREADS ? ((L + 31) / 32) * 32 : MAX_THREADS;
  const dim3 grid((B + QT - 1) / QT, (L + threads - 1) / threads, n_seg);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int sc = n_sub * 16;
  const int words = precision == kInt8 ? lut_words<kInt8>(sc)
                    : precision == kHigh ? lut_words<kHigh>(sc) : lut_words<kDefault>(sc);
  const size_t smem = ((size_t)words + QT) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes_t);
  const float* scl = static_cast<const float*>(scales);
  const float* nr = static_cast<const float*>(norms);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  switch (precision) {
    case kInt8:
      return launch_prec<kInt8>(per_bin, grid, threads, smem, s, lut, scl, c, nr, os, oi, B,
                                N, n_sub, L, seg_len, factor);
    case kHigh:
      return launch_prec<kHigh>(per_bin, grid, threads, smem, s, lut, scl, c, nr, os, oi, B,
                                N, n_sub, L, seg_len, factor);
    default:
      return launch_prec<kDefault>(per_bin, grid, threads, smem, s, lut, scl, c, nr, os, oi, B,
                                   N, n_sub, L, seg_len, factor);
  }
}

// Launches the grouped scan on `stream`; returns a CUDA error code (0 on
// success). lut [B, S, 16]: int8 (precision 2, S <= 256) or f32 (0 default,
// 1 high); scales [B] f32 (read for int8 only); qslot [C, qcap] int32, a
// query in [0, B) or -1 (anything else reads as empty); codes_blocks
// [C, S/2, cap] uint8; norms_blocks [C, cap] f32; out_s [C, qcap, per_bin*L]
// f32 and out_i the same int32, every element written. Every array
// contiguous on the device. Allocates nothing, does not sync.
extern "C" int zvdb_pq_grouped_scan_bins(const void* lut, const void* scales, const void* qslot,
                                         const void* codes_blocks, const void* norms_blocks,
                                         void* out_s, void* out_i, int B, int C, int qcap,
                                         int cap, int n_sub, int L, float factor, int precision,
                                         int per_bin, void* stream) {
  if (B <= 0 || C <= 0 || qcap <= 0 || cap < 0 || L <= 0 || n_sub <= 0 || n_sub % 2 != 0 ||
      precision < 0 || precision > 2 || per_bin < 1 || per_bin > 2 ||
      (precision == kInt8 && n_sub > 256))
    return (int)cudaErrorInvalidValue;
  const int threads = L < MAX_THREADS ? ((L + 31) / 32) * 32 : MAX_THREADS;
  const dim3 grid(C, (qcap + QT - 1) / QT, (L + threads - 1) / threads);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int sc = n_sub * 16;
  const int words = precision == kInt8 ? lut_words<kInt8>(sc)
                    : precision == kHigh ? lut_words<kHigh>(sc) : lut_words<kDefault>(sc);
  const size_t smem = ((size_t)words + 2 * QT) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(qslot);
  const uint8_t* cb = static_cast<const uint8_t*>(codes_blocks);
  const float* scl = static_cast<const float*>(scales);
  const float* nrm = static_cast<const float*>(norms_blocks);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  switch (precision) {
    case kInt8:
      return launch_grouped_prec<kInt8>(per_bin, grid, threads, smem, s, lut, scl, qs, cb, nrm,
                                        os, oi, B, qcap, cap, n_sub, L, factor);
    case kHigh:
      return launch_grouped_prec<kHigh>(per_bin, grid, threads, smem, s, lut, scl, qs, cb, nrm,
                                        os, oi, B, qcap, cap, n_sub, L, factor);
    default:
      return launch_grouped_prec<kDefault>(per_bin, grid, threads, smem, s, lut, scl, qs, cb,
                                           nrm, os, oi, B, qcap, cap, n_sub, L, factor);
  }
}

// Launches the pair scan on `stream`; returns a CUDA error code (0 on
// success). lut, scales, codes_blocks and norms_blocks as for the grouped
// scan; qslot and pslot [C, qcap] int32: slot r of cluster c holds query
// qslot[c, r] in [0, B) at probe rank pslot[c, r] in [0, P), or is empty
// (anything else); no two slots name one (query, rank). pool_s [B,
// P*per_bin*L] f32 and pool_i the same int32 are every element written:
// query q's pool p holds the bins of the slot naming (q, p), with positions
// c * capp + pos, else +inf / -1. covered [B*P] uint8 is scratch. Every
// array contiguous on the device. Allocates nothing, does not sync.
extern "C" int zvdb_pq_grouped_scan_pairs(const void* lut, const void* scales, const void* qslot,
                                          const void* pslot, const void* codes_blocks,
                                          const void* norms_blocks, void* pool_s, void* pool_i,
                                          void* covered, int B, int P, int C, int qcap, int cap,
                                          int capp, int n_sub, int L, float factor,
                                          int precision, int per_bin, void* stream) {
  if (B <= 0 || P <= 0 || C < 0 || qcap < 0 || cap < 0 || capp < cap || L <= 0 || n_sub <= 0 ||
      n_sub % 8 != 0 || precision < 0 || precision > 2 || per_bin < 1 || per_bin > 2 ||
      (precision == kInt8 && n_sub > 256) || (long long)C * capp >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int sc = n_sub * 16;
  const int per = precision == kInt8 ? slot_bytes<kInt8>(sc)
                  : precision == kHigh ? slot_bytes<kHigh>(sc) : slot_bytes<kDefault>(sc);
  // the window: as many slots as PAIR_LUT_BYTES of tables hold, a multiple
  // of NQ, at least NQ, at most a thread each and qcap rounded up to NQ
  int ws = PAIR_LUT_BYTES / per / NQ * NQ;
  ws = ws < NQ ? NQ : (ws > PAIR_THREADS ? PAIR_THREADS : ws);
  const int q_round = (qcap + NQ - 1) / NQ * NQ;
  ws = ws < q_round ? ws : q_round;
  const long long stage_bytes =
      ((long long)(n_sub / 2) * cap + 15) / 16 * 16 + (4ll * cap + 15) / 16 * 16;
  const bool stage = stage_bytes <= PAIR_STAGE_BYTES;
  const size_t smem = (stage ? (size_t)stage_bytes : 0) + (size_t)ws * per
                      + (size_t)ws * 12 + (PAIR_THREADS / 32) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pools = (long long)B * P;
  cudaError_t e = cudaMemsetAsync(covered, 0, n_pools, s);
  if (e != cudaSuccess) return (int)e;
  float* ps = static_cast<float*>(pool_s);
  int* pi = static_cast<int*>(pool_i);
  uint8_t* cov = static_cast<uint8_t*>(covered);
  if (C > 0 && qcap > 0) {
    const int* qs = static_cast<const int*>(qslot);
    const int* pp = static_cast<const int*>(pslot);
    const uint8_t* cb = static_cast<const uint8_t*>(codes_blocks);
    const float* scl = static_cast<const float*>(scales);
    const float* nrm = static_cast<const float*>(norms_blocks);
    int rc;
    switch (precision) {
      case kInt8:
        rc = launch_pairs_prec<kInt8>(per_bin, stage, C, smem, s, lut, scl, qs, pp, cb, nrm, ps,
                                      pi, cov, B, P, qcap, cap, capp, n_sub, L, ws, factor);
        break;
      case kHigh:
        rc = launch_pairs_prec<kHigh>(per_bin, stage, C, smem, s, lut, scl, qs, pp, cb, nrm, ps,
                                      pi, cov, B, P, qcap, cap, capp, n_sub, L, ws, factor);
        break;
      default:
        rc = launch_pairs_prec<kDefault>(per_bin, stage, C, smem, s, lut, scl, qs, pp, cb, nrm,
                                         ps, pi, cov, B, P, qcap, cap, capp, n_sub, L, ws,
                                         factor);
    }
    if (rc != 0) return rc;
  }
  const long long blocks = (n_pools + PAIR_THREADS / 32 - 1) / (PAIR_THREADS / 32);
  fill_uncovered_kernel<<<(unsigned)blocks, PAIR_THREADS, 0, s>>>(cov, ps, pi, n_pools,
                                                                  per_bin * L);
  return (int)cudaGetLastError();
}
