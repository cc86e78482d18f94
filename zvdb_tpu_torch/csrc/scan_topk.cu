// Exact flat top-k scans for Hopper (sm_90a): kernels E and F.
//
// Replaces examples/pallas_scan_v1.py:_scan_kernel (wrapper flat_topk_pallas,
// kernel E) and examples/pallas_scan_v2.py:_scan_kernel (wrapper
// flat_topk_pallas2, kernel F). Both TPU kernels compute one function, and so
// do both entry points here. For each query the corpus is taken in chunks of
// `chunk` rows, in order; per chunk
//
//     s[c] = ||x_c||^2 - 2 q.x_c   (l2; the norm recomputed in f32 from the row)
//     s[c] = -q.x_c                (any other metric),   rows at or past N: +inf,
//
// in plain f32 (FMAs, no tensor cores: this is an exact oracle). A k-slot
// buffer starts at (+inf, -1). Each of k rounds takes the chunk's minimum m
// and its FIRST argmin am, and the buffer's maximum and its FIRST argmax aw;
// if m < worst (strict), slot aw takes (m, base + am); column am becomes
// +inf either way. After the last chunk an id is -1 wherever its score is
// not finite. The output is in slot order, not sorted.
//
// Two facts shape both kernels. (1) Round r extracts the chunk's r-th
// smallest (score, index) pair, ties to the lower index, whatever the buffer
// holds. (2) The buffer's worst never rises, so once a round takes nothing,
// no later round of that chunk can take anything. So a chunk's whole effect
// is its k smallest pairs replayed in order against the buffer, and the
// replay may stop at the first pair that is not taken.
//
// What bounds them on this card. The scores are 2*B*N*D f32 operations
// (5.4e11 at B=2048, N=1M, D=128: 7.8 ms at the 67 TFLOP/s f32 rate) against
// one read of the corpus (512 MB, 0.15 ms): bound by arithmetic. The TPU grid
// walked chunks in order with the buffer in VMEM; CUDA blocks run in no
// order, so the walk over chunks is a loop inside one block (E) or a second
// pass (F). A block holds QT=8 queries, one warp each; every chunk's scores
// for those queries sit in shared memory (QT x chunk f32: 64 KB at 2048),
// which is what bounds `chunk`. Corpus rows are staged through shared memory
// (1024 rows x 8 depths per step, coalesced, the next step prefetched into
// registers) and each thread keeps an 8-query x 4-row register tile, so
// three 16-byte shared loads feed 32 FMAs. Each block re-reads the whole
// corpus: at QT=8 a 2048-query batch streams it 256 times (131 GB), which the
// 50 MB L2 serves only as far as the blocks walk the chunks together; QT=8
// keeps all 256 blocks of such a batch resident at once (two per SM) so that
// they do.
//
// E, zvdb_flat_topk_v1: one pass. One block per query tile walks every chunk,
// scores it, and folds it into each query's buffer by warp reductions on
// (score, index) with the first-index tie rule, stopping a chunk's rounds at
// the first pair not taken (fact 2).
//
// F, zvdb_flat_topk_v2: two passes over the same contract. Pass 1 runs one
// block per (query tile, chunk), all in parallel, and writes each chunk's k
// smallest pairs, ascending with ties to the lower index (fact 1), into a
// scratch array the wrapper allocates ([B, n_chunks, k] scores and ids).
// Pass 2 replays them per query (one warp each) in chunk order; a ballot over
// 32 chunks' first pairs skips every chunk whose smallest pair is not below
// the buffer's worst (fact 2), so the replay reads little beyond those firsts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 8;                 // queries per block, one warp each
constexpr int THREADS = QT * 32;      // 256
constexpr int TR = 4 * THREADS;       // corpus rows per staged sub-tile (4 per thread)
constexpr int DK = 8;                 // depths per staged step
constexpr int XS = TR + 4;            // staged row stride in floats (bank-conflict padding)
constexpr int KMAX = 256;             // largest k (the buffer lives in shared memory)
constexpr int CHUNK_MAX = 4096;       // largest chunk (its scores live in shared memory)
constexpr int DMAX = 1024;            // largest D (the query tile lives in shared memory)
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 0x7fffffff;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// The block's QT queries, transposed to [dp][QT] (dp = D rounded up to DK),
// zero past D and past B.
__device__ void load_queries(const float* __restrict__ q, int q0, int B, int D, int dp,
                             float* qs) {
  for (int e = threadIdx.x; e < dp * QT; e += THREADS) {
    const int d = e / QT, i = e % QT;
    const int b = q0 + i;
    qs[e] = (b < B && d < D) ? __ldg(q + (long long)b * D + d) : 0.f;
  }
}

// Loads rows [row0, row0 + rows) x depths [d0, d0 + DK) into registers:
// VEC as float4 (D % 4 == 0, x 16-byte aligned), else as floats.
template <bool VEC>
__device__ __forceinline__ void fetch(const float* __restrict__ x, long long row0, int rows,
                                      int D, int d0, float* pre) {
  if constexpr (VEC) {
#pragma unroll
    for (int p = 0; p < TR * DK / 4 / THREADS; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int r = e >> 1, d = d0 + 4 * (e & 1);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && d < D)
        v = __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * D + d));
      pre[4 * p + 0] = v.x;
      pre[4 * p + 1] = v.y;
      pre[4 * p + 2] = v.z;
      pre[4 * p + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < TR * DK / THREADS; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int r = e / DK, d = d0 + e % DK;
      pre[p] = (r < rows && d < D) ? __ldg(x + (row0 + r) * D + d) : 0.f;
    }
  }
}

// Stores the fetched registers transposed into xs[depth][row].
template <bool VEC>
__device__ __forceinline__ void stash(const float* pre, float* xs) {
  if constexpr (VEC) {
#pragma unroll
    for (int p = 0; p < TR * DK / 4 / THREADS; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int r = e >> 1, h = 4 * (e & 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) xs[(h + c) * XS + r] = pre[4 * p + c];
    }
  } else {
#pragma unroll
    for (int p = 0; p < TR * DK / THREADS; ++p) {
      const int e = threadIdx.x + p * THREADS;
      xs[(e % DK) * XS + e / DK] = pre[p];
    }
  }
}

// Scores rows [base, base + width) against the block's queries into
// sc[i * cp + c] for c < width (width <= chunk <= cp, N - base >= width).
// Ends in a barrier; its first barrier waits for every reader of sc.
template <bool VEC>
__device__ void score_chunk(const float* __restrict__ x, long long base, int width, int D,
                            bool l2, const float* qs, float* xs, float* sc, int cp) {
  constexpr int PER = TR * DK / THREADS;   // fetched floats per thread per step
  const int tid = threadIdx.x;
  const float inf = pos_inf();
  for (int t0 = 0; t0 < width; t0 += TR) {
    const int rows = min(TR, width - t0);
    const long long row0 = base + t0;
    const bool active = 4 * (tid & ~31) < rows;   // warp-uniform: the warp owns a row here
    float acc[QT][4];
    float nrm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nrm[j] = 0.f;
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i][j] = 0.f;
    }
    float pre[PER];
    fetch<VEC>(x, row0, rows, D, 0, pre);
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();   // readers of xs, and of sc from the last chunk's rounds, are done
      stash<VEC>(pre, xs);
      __syncthreads();
      if (d0 + DK < D) fetch<VEC>(x, row0, rows, D, d0 + DK, pre);   // in flight meanwhile
      if (active) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + (d0 + kk) * QT);
          const float4 qb = *reinterpret_cast<const float4*>(qs + (d0 + kk) * QT + 4);
          const float4 xv = *reinterpret_cast<const float4*>(xs + kk * XS + 4 * tid);
          const float qv[QT] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            nrm[j] = fmaf(xr[j], xr[j], nrm[j]);
#pragma unroll
            for (int i = 0; i < QT; ++i) acc[i][j] = fmaf(qv[i], xr[j], acc[i][j]);
          }
        }
      }
    }
    const int c0 = t0 + 4 * tid;   // this thread's first column
    if (active && c0 < width) {
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = (c0 + j < width) ? (l2 ? nrm[j] - 2.f * acc[i][j] : -acc[i][j]) : inf;
        *reinterpret_cast<float4*>(sc + i * cp + c0) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  __syncthreads();   // the chunk's scores are complete
}

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

__device__ __forceinline__ void init_buffer(float* bs, int* bi, int k) {
  for (int s = threadIdx.x & 31; s < k; s += 32) {
    bs[s] = pos_inf();
    bi[s] = -1;
  }
  __syncwarp();
}

__device__ __forceinline__ void write_out(const float* bs, const int* bi, int k, int b,
                                          float* out_s, int* out_i) {
  __syncwarp();
  for (int s = threadIdx.x & 31; s < k; s += 32) {
    const float v = bs[s];
    out_s[(long long)b * k + s] = v;
    out_i[(long long)b * k + s] = isfinite(v) ? bi[s] : -1;
  }
}

// Kernel E: one block per QT queries walks every chunk.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
topk_v1_kernel(const float* __restrict__ q, const float* __restrict__ x, float* out_s,
               int* out_i, int B, int N, int D, int k, int chunk, int l2) {
  extern __shared__ __align__(16) float smem[];
  const int cp = (chunk + 3) & ~3, dp = (D + DK - 1) / DK * DK;
  float* sc = smem;                 // [QT][cp] the chunk's scores
  float* xs = sc + QT * cp;         // [DK][XS] staged rows
  float* qs = xs + DK * XS;         // [dp][QT] the queries
  float* bs = qs + dp * QT;         // [QT][k]  buffers
  int* bi = reinterpret_cast<int*>(bs + QT * k);
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * QT + warp;
  float* bsw = bs + warp * k;
  int* biw = bi + warp * k;
  load_queries(q, blockIdx.x * QT, B, D, dp, qs);
  init_buffer(bsw, biw, k);
  float worst = pos_inf();
  int aw = 0;
  for (long long base = 0; base < N; base += chunk) {
    const int width = (int)min((long long)chunk, (long long)N - base);
    score_chunk<VEC>(x, base, width, D, l2 != 0, qs, xs, sc, cp);
    if (b < B) {
      float* row = sc + warp * cp;
      for (int r = 0; r < k; ++r) {
        float m;
        int am;
        warp_argmin(row, width, m, am);
        if (!fold_pair(m, (int)(base + am), bsw, biw, k, worst, aw)) break;   // fact 2
        if ((threadIdx.x & 31) == 0) row[am] = pos_inf();
        __syncwarp();
      }
    }
  }
  if (b < B) write_out(bsw, biw, k, b, out_s, out_i);
}

// Kernel F, pass 1: one block per (query tile, chunk) writes each query's k
// smallest pairs of the chunk, ascending, ties to the lower index; (+inf, -1)
// past the chunk's finite scores.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
topk_v2_pairs_kernel(const float* __restrict__ q, const float* __restrict__ x, float* pair_s,
                     int* pair_i, int B, int N, int D, int k, int chunk, int nc, int l2) {
  extern __shared__ __align__(16) float smem[];
  const int cp = (chunk + 3) & ~3, dp = (D + DK - 1) / DK * DK;
  float* sc = smem;
  float* xs = sc + QT * cp;
  float* qs = xs + DK * XS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * QT + warp;
  const int j = blockIdx.y;
  const long long base = (long long)j * chunk;
  const int width = (int)min((long long)chunk, (long long)N - base);
  load_queries(q, blockIdx.x * QT, B, D, dp, qs);
  score_chunk<VEC>(x, base, width, D, l2 != 0, qs, xs, sc, cp);
  if (b >= B) return;
  float* ps = pair_s + ((long long)b * nc + j) * k;
  int* pi = pair_i + ((long long)b * nc + j) * k;
  float* row = sc + warp * cp;
  int r = 0;
  for (; r < k; ++r) {
    float m;
    int am;
    warp_argmin(row, width, m, am);
    if (!(m < pos_inf())) break;
    if (lane == 0) {
      ps[r] = m;
      pi[r] = (int)(base + am);
      row[am] = pos_inf();
    }
    __syncwarp();
  }
  for (int s = r + lane; s < k; s += 32) {
    ps[s] = pos_inf();
    pi[s] = -1;
  }
}

// Kernel F, pass 2: one warp per query replays the chunks' pairs in chunk
// order; a chunk whose smallest pair is not below the buffer's worst is
// skipped without reading the rest of it (fact 2).
__global__ void __launch_bounds__(THREADS)
topk_v2_fold_kernel(const float* __restrict__ pair_s, const int* __restrict__ pair_i,
                    float* out_s, int* out_i, int B, int k, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * QT + warp;
  if (b >= B) return;   // warp-uniform; no block barrier follows
  float* bs = smem + warp * k;
  int* bi = reinterpret_cast<int*>(smem + QT * k) + warp * k;
  init_buffer(bs, bi, k);
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
      mask &= ~((2u << l) - 1u);                     // chunks after j0 + l
      mask &= __ballot_sync(FULL, first < worst);    // that can still take a pair
    }
  }
  write_out(bs, bi, k, b, out_s, out_i);
}

size_t scan_smem(int chunk, int D, int k) {
  const size_t cp = (chunk + 3) & ~3, dp = (D + DK - 1) / DK * DK;
  return sizeof(float) * (QT * cp + DK * XS + dp * QT + 2 * (size_t)QT * k);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_args(int B, int N, int D, int k, int chunk) {
  return B < 0 || N < 0 || D < 1 || D > DMAX || k < 1 || k > KMAX || chunk < 1 ||
         chunk > CHUNK_MAX;
}

bool vec_ok(const void* x, int D) { return D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// Kernel E on `stream`; returns a CUDA error code (0 on success).
// q [B, D] f32, x [N, D] f32, out_s [B, k] f32, out_i [B, k] int32, all
// contiguous on the device; l2 = 1 for the l2 surrogate, 0 for -q.x.
// Needs 1 <= D <= 1024, 1 <= k <= 256, 1 <= chunk <= 4096. Allocates
// nothing, does not sync.
extern "C" int zvdb_flat_topk_v1(const void* q, const void* x, void* out_s, void* out_i, int B,
                                 int N, int D, int k, int chunk, int l2, void* stream) {
  if (bad_args(B, N, D, k, chunk)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = scan_smem(chunk, D, k);
  const dim3 grid((B + QT - 1) / QT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  cudaError_t rc;
  if (vec_ok(x, D)) {
    if ((rc = allow_smem(topk_v1_kernel<true>, smem)) != cudaSuccess) return (int)rc;
    topk_v1_kernel<true><<<grid, THREADS, smem, s>>>(qf, xf, os, oi, B, N, D, k, chunk, l2);
  } else {
    if ((rc = allow_smem(topk_v1_kernel<false>, smem)) != cudaSuccess) return (int)rc;
    topk_v1_kernel<false><<<grid, THREADS, smem, s>>>(qf, xf, os, oi, B, N, D, k, chunk, l2);
  }
  return (int)cudaGetLastError();
}

// Kernel F on `stream` (both passes); returns a CUDA error code (0 on
// success). As zvdb_flat_topk_v1, plus the scratch pair_s [B, nc, k] f32 and
// pair_i [B, nc, k] int32 with nc = ceil(N / chunk) <= 65535.
extern "C" int zvdb_flat_topk_v2(const void* q, const void* x, void* pair_s, void* pair_i,
                                 void* out_s, void* out_i, int B, int N, int D, int k,
                                 int chunk, int l2, void* stream) {
  if (bad_args(B, N, D, k, chunk)) return (int)cudaErrorInvalidValue;
  const int nc = (int)(((long long)N + chunk - 1) / chunk);
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* ps = static_cast<float*>(pair_s);
  int* pi = static_cast<int*>(pair_i);
  const int tiles = (B + QT - 1) / QT;
  cudaError_t rc;
  if (nc > 0) {
    const size_t smem = scan_smem(chunk, D, 0);
    const dim3 grid(tiles, nc);
    if (vec_ok(x, D)) {
      if ((rc = allow_smem(topk_v2_pairs_kernel<true>, smem)) != cudaSuccess) return (int)rc;
      topk_v2_pairs_kernel<true><<<grid, THREADS, smem, s>>>(qf, xf, ps, pi, B, N, D, k, chunk,
                                                             nc, l2);
    } else {
      if ((rc = allow_smem(topk_v2_pairs_kernel<false>, smem)) != cudaSuccess) return (int)rc;
      topk_v2_pairs_kernel<false><<<grid, THREADS, smem, s>>>(qf, xf, ps, pi, B, N, D, k,
                                                              chunk, nc, l2);
    }
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  const size_t smem2 = sizeof(float) * 2 * (size_t)QT * k;
  topk_v2_fold_kernel<<<tiles, THREADS, smem2, s>>>(ps, pi, static_cast<float*>(out_s),
                                                    static_cast<int*>(out_i), B, k, nc);
  return (int)cudaGetLastError();
}
