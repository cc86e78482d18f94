// Binned partial top-k, smallest first (jax.lax.approx_min_k), for sm_90a.
//
// Replaces no Pallas kernel: on a TPU, approx_min_k is XLA's ApproxTopK, the
// TPU-KNN partial reduce run in hardware, which the JAX package calls at
// seven places (zvdb_tpu/index/flat.py:_search, parallel/sharded_flat.py,
// index/pqflat.py:_pq_scan, index/ivf.py's probes and pair scan,
// index/knn_graph.py's per-block cut, index/cagra.py's seeds). PyTorch has
// no such operation, so the port brings it to the card here. Wrapper:
// zvdb_tpu_torch/ops/approx_topk.py:approx_min_k, which also holds the plain
// version (_approx_min_k_plain) that this kernel equals bit for bit.
//
// For each row of a contiguous f32 score tile s [rows, N], with L bins
// (ops/approx_topk.py:reduction_output_size, L <= N):
//
//     bin b keeps the minimum of s[c] over the columns c = b + j*L < N,
//           the lowest such column on a tie (a strict < in increasing j);
//     out   the k smallest (value, column) pairs of the L bins, ascending,
//           -0.0 ordered as +0.0; each value as s holds it, positions int64.
//
// What bounds it. The function reads the tile once and writes k pairs a
// row: rows*N*4 + rows*k*12 bytes, against about rows*N compares. At every
// site the bytes dominate ([10000, 100000] f32 is 4 GB, 1.19 ms at 3.35
// TB/s); the select stage's work over L << N bins is small beside it.
//
// What the design does about it.
//   * Fold (fold_kernel). A thread owns a bin and walks its columns b + j*L,
//     so the 32 lanes of a warp load 32 neighbouring floats at every window:
//     each load is coalesced, and each byte of the tile is read once, with
//     the streaming hint (__ldcs) since nothing reads it again. Eight windows'
//     loads are issued before their compares, so enough bytes are in flight.
//   * Few long rows. A block folds one row's windows [j0, j1) (a split); the
//     wrapper cuts each row's windows into splits so that rows x splits is
//     about 2048 blocks, which fills the 132 SMs even for 16 rows of 1M
//     columns. Each split writes its bins as 64-bit keys (ordered value bits
//     << 32 | column) to a scratch [rows, splits, L] from the wrapper; the
//     smallest key of a bin over its splits is then the bin's (minimum,
//     lowest column), since the key order is the (value, column) order. The
//     ordered-bits map would put -0.0 below +0.0; the key is taken of
//     (v == 0 ? +0.0 : v), so the two tie as they do in the fold's float
//     compare and in the plain version. No atomics: the merge is a min over
//     a few keys in the select kernel, so the result does not depend on the
//     order the blocks ran in.
//   * Select (select_kernel). A block per row merges its bins' keys into
//     shared memory (L padded to a power of two P with the largest key, 8
//     bytes a key: 128 KB at L = 16384, the kernel's limit, above 48 KB by
//     opt-in) and sorts them with a bitonic network. The first k keys give
//     the columns; each value is read back from s at its column, so -0.0
//     comes out as the row held it.
//   * Every bin holds at least its column b < L <= N from split 0, so a
//     position is always inside the row; a bin of only +inf keeps column b.
//     NaN is never taken by the fold (callers mark invalid entries +inf).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int UNROLL = 8;               // windows whose loads are in flight at once
constexpr int MAX_BINS = 16384;         // P * 8 bytes of shared memory: 128 KB
constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float v, long long col) {
  unsigned int b = __float_as_uint(v == 0.0f ? 0.0f : v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned int>(col);
}

__global__ void fold_kernel(const float* __restrict__ s, unsigned long long* __restrict__ part,
                            long long n, int L, long long per) {
  const long long row = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const float* r = s + row * n;
  const long long cend = min((static_cast<long long>(split) + 1) * per * L, n);
  unsigned long long* out = part + (row * splits + split) * L;
  for (int b = threadIdx.x; b < L; b += blockDim.x) {
    long long c = static_cast<long long>(split) * per * L + b;
    float best = __int_as_float(0x7f800000);   // +inf
    long long col = c;
    for (; c + (UNROLL - 1) * static_cast<long long>(L) < cend; c += UNROLL * static_cast<long long>(L)) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(r + c + u * static_cast<long long>(L));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (v[u] < best) {
          best = v[u];
          col = c + u * static_cast<long long>(L);
        }
      }
    }
    for (; c < cend; c += L) {
      const float v = __ldcs(r + c);
      if (v < best) {
        best = v;
        col = c;
      }
    }
    out[b] = make_key(best, col);
  }
}

__global__ void select_kernel(const float* __restrict__ s,
                              const unsigned long long* __restrict__ part,
                              float* __restrict__ vals, long long* __restrict__ pos, long long n,
                              int L, int k, int splits, int P) {
  extern __shared__ unsigned long long keys[];
  const long long row = blockIdx.x;
  const unsigned long long* p = part + row * splits * L;
  for (int b = threadIdx.x; b < P; b += blockDim.x) {
    unsigned long long key = EMPTY;
    if (b < L) {
      for (int q = 0; q < splits; ++q) {
        const unsigned long long x = p[static_cast<long long>(q) * L + b];
        key = x < key ? x : key;
      }
    }
    keys[b] = key;
  }
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const long long c = static_cast<long long>(keys[i] & 0xffffffffull);
    pos[row * k + i] = c;
    vals[row * k + i] = s[row * n + c];
  }
}

}  // namespace

// s [rows, n] f32 contiguous; part [rows, splits, L] 64-bit scratch; vals
// [rows, k] f32 and pos [rows, k] int64 out. Each split folds `per` windows
// of L columns; splits * per must cover ceil(n / L). Returns a cudaError_t.
extern "C" int zvdb_approx_min_k(const void* s, void* part, void* vals, void* pos, int rows,
                                 long long n, int L, int k, int splits, long long per,
                                 void* stream) {
  if (rows <= 0 || n <= 0 || n >= (1ll << 31) || L <= 0 || L > MAX_BINS || L > n || k < 1 ||
      k > L || splits < 1 || splits > 65535 || per < 1)
    return (int)cudaErrorInvalidValue;
  const long long windows = (n + L - 1) / L;
  if (static_cast<long long>(splits) * per < windows || static_cast<long long>(splits - 1) * per >= windows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  unsigned long long* pk = static_cast<unsigned long long*>(part);
  const int ft = L < FOLD_THREADS ? (L + 31) / 32 * 32 : FOLD_THREADS;
  fold_kernel<<<dim3(rows, splits), ft, 0, st>>>(sf, pk, n, L, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int P = 64;
  while (P < L) P <<= 1;
  const size_t smem = static_cast<size_t>(P) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = P / 2 < 1024 ? P / 2 : 1024;
  select_kernel<<<rows, threads, smem, st>>>(sf, pk, static_cast<float*>(vals),
                                             static_cast<long long*>(pos), n, L, k, splits, P);
  return (int)cudaGetLastError();
}
