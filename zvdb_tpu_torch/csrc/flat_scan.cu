// Fused flat scan with a per-query bin fold on the CUDA cores, for Hopper
// (sm_90a): the "highest" route of kernels A and D.
//
// Replaces zvdb_tpu/ops/pallas_topk.py:_scan_kernel (wrapper flat_scan_bins)
// in "highest", whose f32 products cannot use the bf16 tensor cores; its
// "default" and "high" run on the tensor cores in csrc/flat_scan_mma.cu
// (and kernel D's in csrc/block_bins.cu). The entry point still takes every
// precision, so the tensor-core kernels can be held against it.
// For every query b and every bin l in [0, L) it computes
//
//     bin_s[b, l] = min over rows c with c % L == l of  norms[c] - f * (q[b] . x[c])
//     bin_i[b, l] = the row that attains it (the lowest such row on a tie),
//                   or -1 when the bin saw no row with a finite score,
//
// with f = 2 for l2 and 1 for dot/cosine; norms of +inf mark invalid rows.
// The dot product follows the named precision, as the TPU kernel computes it:
//   HIGHEST  plain f32 products;
//   DEFAULT  q and x rounded to bf16 (round to nearest even), f32 products and sums;
//   HIGH     bf16x3: hi = bf16(v), lo = bf16(v - hi), sum of hi*hi + hi*lo + lo*hi.
//            Staged here as q_hi*(x_hi + x_lo) + q_lo*x_hi: two FMAs per term
//            instead of three (x_hi + x_lo holds x to ~16 bits).
//
// What bounds it. Per call the work is B*N*D multiply-adds (2*2048*1M*128 =
// 5.2e11 operations at the main-path shape), against one read of the corpus
// (512 MB in f32): about 1000 operations per byte, far above the H100's ridge,
// so the kernel is bound by arithmetic, never by memory. In "highest" its
// floor is the f32 FMA pipes' rate (67 TFLOP/s peak, 7.8 ms at the
// main-path shape), where it runs.
//
// What the design does about it. The Pallas grid walked corpus chunks in
// order and carried the bins in VMEM from one grid step to the next. CUDA
// blocks run in no order, so nothing carries between them: each block owns
// one (tile of BQ queries, slice of BL bins) pair and walks the rows
// c = m*L + l for l in its slice in increasing m. Its running (min, row)
// pairs sit in registers for the whole walk, so no merge pass, no atomics and
// no scratch memory are needed, and the strict < keeps the lower row on a tie
// exactly as the TPU fold does. Per step m the slice's rows are contiguous,
// so they load coalesced into shared memory, D in chunks of DK; each thread
// then computes a 4x4 register tile of dot products (8 shared loads feed 16
// FMAs). Blocks that share a bin slice are launched next to each other
// (blockIdx.x walks the query tiles) so they read the same rows out of L2.
// Inputs are read in their storage type (f32 or bf16) with any N and D; the
// ragged edges are masked here, so no padded copy of the corpus is made.
//
// Second entry point, zvdb_block_bins: the graph build's block scorer.
// Replaces zvdb_tpu/ops/pallas_block.py:_kernel (wrapper block_bins). For a
// batch of cc blocks of B rows each, every row is scored against every row of
// its own block, the self-pair (the diagonal) excluded, and folded into the
// same [L] modular-bin minima by column m*L + l, ids -1 where a bin saw no
// finite score. It is the walk above with the block as both the queries and
// the corpus: blockIdx.z picks the block, and the fold skips row == column.
// Work per launch is 2*cc*B*B*D operations per product (three products for
// "high"), against cc*B*D*4 bytes read and cc*B*L*8 written: about 400
// operations per byte at the build's shape (cc=12, B=1640, D=128, L=128), so
// it is bound by arithmetic, like kernel A. The TPU pads B to a multiple of
// its row tile and D to 128; here both edges are masked instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BL = 64;        // bins per block
constexpr int DK = 32;        // depth staged in shared memory per step
constexpr int TM = 4;         // queries per thread
constexpr int TN = 4;         // bins per thread
constexpr int THREADS = (BQ / TM) * (BL / TN);   // 256
constexpr int QSTRIDE = BQ + 4;   // padded rows, still 16-byte aligned
constexpr int XSTRIDE = BL + 4;

enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// BLOCK = false: kernel A (one query batch against one corpus).
// BLOCK = true: kernel D (blockIdx.z picks a block whose B = N rows are both
// the queries and the corpus; the diagonal is skipped).
template <int PREC, bool BLOCK, typename T>
__global__ void __launch_bounds__(THREADS, 2)
scan_bins_kernel(const float* __restrict__ q, const T* __restrict__ x,
                 const float* __restrict__ norms, float* __restrict__ out_s,
                 int* __restrict__ out_i, int B, int N, int D, int L,
                 float factor) {
  constexpr int NOP = (PREC == kHigh) ? 2 : 1;   // operand planes per side
  if constexpr (BLOCK) {
    const long long z = blockIdx.z;
    q += z * B * D;
    x += z * N * D;
    norms += z * N;
    out_s += z * B * L;
    out_i += z * B * L;
  }
  __shared__ __align__(16) float qs[NOP * DK * QSTRIDE];
  __shared__ __align__(16) float xs[NOP * DK * XSTRIDE];

  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int tx = tid % (BL / TN);
  const int ty = tid / (BL / TN);
  const int b0 = blockIdx.x * BQ;
  const int l0 = blockIdx.y * BL;

  float best_s[TM][TN];
  int best_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      best_s[i][j] = inf;
      best_i[i][j] = -1;
    }

  // base = m*L + l0: the first row of this block's bin slice at step m.
  for (long long base = l0; base < N; base += L) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();   // the previous chunk's readers are done
      for (int e = tid; e < BQ * DK; e += THREADS) {
        const int r = e / DK, k = e % DK;
        const int b = b0 + r, d = d0 + k;
        const float v = (b < B && d < D) ? __ldg(q + (long long)b * D + d) : 0.f;
        if constexpr (PREC == kHighest) {
          qs[k * QSTRIDE + r] = v;
        } else if constexpr (PREC == kDefault) {
          qs[k * QSTRIDE + r] = bf16_round(v);
        } else {
          const float hi = bf16_round(v);
          qs[k * QSTRIDE + r] = hi;
          qs[(DK + k) * QSTRIDE + r] = bf16_round(v - hi);
        }
      }
      for (int e = tid; e < BL * DK; e += THREADS) {
        const int r = e / DK, k = e % DK;
        const long long c = base + r;
        const int d = d0 + k;
        const float v = (l0 + r < L && c < N && d < D) ? to_f32(x[c * D + d]) : 0.f;
        if constexpr (PREC == kHighest) {
          xs[k * XSTRIDE + r] = v;
        } else if constexpr (PREC == kDefault) {
          xs[k * XSTRIDE + r] = bf16_round(v);
        } else {
          const float hi = bf16_round(v);
          xs[k * XSTRIDE + r] = hi + bf16_round(v - hi);
          xs[(DK + k) * XSTRIDE + r] = hi;
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[k * QSTRIDE + ty * TM]);
        const float4 w = *reinterpret_cast<const float4*>(&xs[k * XSTRIDE + tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float wv[TN] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        if constexpr (NOP == 2) {
          const float4 a2 =
              *reinterpret_cast<const float4*>(&qs[(DK + k) * QSTRIDE + ty * TM]);
          const float4 w2 =
              *reinterpret_cast<const float4*>(&xs[(DK + k) * XSTRIDE + tx * TN]);
          const float av2[TM] = {a2.x, a2.y, a2.z, a2.w};
          const float wv2[TN] = {w2.x, w2.y, w2.z, w2.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av2[i], wv2[j], acc[i][j]);
        }
      }
    }

    // fold step m into the running bin minima: strict <, so the lower row
    // (the earlier m) keeps a tie; kernel D never takes a row's own column
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = tx * TN + j;
      const long long c = base + r;
      const float nrm = (l0 + r < L && c < N) ? __ldg(norms + c) : inf;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float s = nrm - factor * acc[i][j];
        const bool self = BLOCK && c == b0 + ty * TM + i;
        if (s < best_s[i][j] && !self) {
          best_s[i][j] = s;
          best_i[i][j] = (int)c;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int l = l0 + tx * TN + j;
      if (l >= L) continue;
      out_s[(long long)b * L + l] = best_s[i][j];
      // kernel D: -1 where the bin's minimum is not finite, as JAX masks it
      out_i[(long long)b * L + l] =
          (BLOCK && !isfinite(best_s[i][j])) ? -1 : best_i[i][j];
    }
  }
}

template <bool BLOCK, typename T>
void launch(int precision, dim3 grid, cudaStream_t stream, const float* q,
            const T* x, const float* norms, float* out_s, int* out_i, int B,
            int N, int D, int L, float factor) {
  switch (precision) {
    case kHighest:
      scan_bins_kernel<kHighest, BLOCK, T><<<grid, THREADS, 0, stream>>>(
          q, x, norms, out_s, out_i, B, N, D, L, factor);
      break;
    case kHigh:
      scan_bins_kernel<kHigh, BLOCK, T><<<grid, THREADS, 0, stream>>>(
          q, x, norms, out_s, out_i, B, N, D, L, factor);
      break;
    default:
      scan_bins_kernel<kDefault, BLOCK, T><<<grid, THREADS, 0, stream>>>(
          q, x, norms, out_s, out_i, B, N, D, L, factor);
      break;
  }
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() (0 on success).
// q [B, D] f32, x [N, D] f32 (x_is_bf16 = 0) or bf16 (1), norms [N] f32,
// out_s [B, L] f32, out_i [B, L] int32; every array contiguous on the device.
// precision: 0 highest, 1 high, 2 default. Allocates nothing, does not sync.
extern "C" int zvdb_flat_scan_bins(const void* q, const void* x, int x_is_bf16,
                                   const void* norms, void* out_s, void* out_i,
                                   int B, int N, int D, int L, float factor,
                                   int precision, void* stream) {
  if (B <= 0 || L <= 0 || D < 0 || N < 0 || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + BQ - 1) / BQ, (L + BL - 1) / BL);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    launch<false>(precision, grid, s, static_cast<const float*>(q),
           static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norms),
           static_cast<float*>(out_s), static_cast<int*>(out_i), B, N, D, L, factor);
  else
    launch<false>(precision, grid, s, static_cast<const float*>(q),
           static_cast<const float*>(x), static_cast<const float*>(norms),
           static_cast<float*>(out_s), static_cast<int*>(out_i), B, N, D, L, factor);
  return (int)cudaGetLastError();
}

// Launches kernel D on `stream`; returns cudaGetLastError() (0 on success).
// v [cc, B, D] f32, vn [cc, B] f32 (+inf marks an invalid slot), out_s
// [cc, B, L] f32, out_i [cc, B, L] int32 column ids within the block; every
// array contiguous on the device. precision: 0 highest, 1 high, 2 default.
// Allocates nothing, does not sync.
extern "C" int zvdb_block_bins(const void* v, const void* vn, void* out_s, void* out_i,
                               int cc, int B, int D, int L, float factor,
                               int precision, void* stream) {
  if (cc <= 0 || B <= 0 || L <= 0 || D < 0 || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + BQ - 1) / BQ, (L + BL - 1) / BL, cc);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const float* vf = static_cast<const float*>(v);
  launch<true>(precision, grid, static_cast<cudaStream_t>(stream), vf, vf,
               static_cast<const float*>(vn), static_cast<float*>(out_s),
               static_cast<int*>(out_i), B, B, D, L, factor);
  return (int)cudaGetLastError();
}
