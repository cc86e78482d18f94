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
// row: rows*N*4 + rows*k*12 bytes at 3.35 TB/s, against about rows*N
// compares. That is 1.19 ms at the flat row's [10000, 100000] tile, but only
// 0.010-0.041 ms at the short rows (the IVF probes [2048, 4096], the pair
// cut [4096, 2456], the graph build's block cut [19680, 1640], the PQ decode
// tile [2048, 16384]): there a row is 4-16 windows of L, and whatever a row
// costs besides its bytes (a second launch, a scratch round trip, barriers,
// the select's instructions) sets the time unless the design keeps it small.
//
// What the design does about it.
//   * One launch (approx_fused_kernel) wherever a row's windows are not
//     split, which ops/approx_topk.py:fold_splits decides from the shape
//     alone (one split from 2048 rows up, so at every site): the row's
//     threads fold its bins into shared memory and select from them there.
//     No [rows, splits, L] scratch is written or read back.
//   * Fold (fold_row). A thread owns bins b, b + T, ... and walks each bin's
//     columns b + j*L in increasing j with a strict <, so a warp's 32 lanes
//     load 32 neighbouring floats at every window (coalesced), with the
//     streaming hint (__ldcs) since nothing reads the tile again. A thread
//     takes its bins 4, 2 or 1 at a time and has FOLD_LOADS (8) loads in
//     flight across them; the last batch is masked with +inf (never taken),
//     so a short row's few windows are loaded at once, not one by one.
//   * Select (select_row), one routine for both routes, over 64-bit keys:
//     ordered value bits (of v == 0 ? +0.0 : v, so -0.0 and +0.0 tie as the
//     fold's float compare ties them) << 32 | column. Key order is the
//     (value, column) order, and a row's keys are distinct (bin b's column
//     is b mod L). It finds a bound at or above the k-th key below which at
//     most sort_max = max(next_pow2(k), 64) keys lie, compacts those keys in
//     place to the front (a chunk of T keys a step, each chunk read before
//     any of it is written), sorts only them with a bitonic network (one
//     warp with __syncwarp up to 64 keys, the row's threads above), keeps
//     the first k and reads each value back from s at its column, so -0.0
//     comes out as the row held it. The bound:
//       - where a warp owns the row and k <= 32 (every short-row site but
//         the PQ tile), the k-th smallest of the 32 lanes' minima, sorted
//         across the warp by shuffles: k lanes' minima lie at or below it,
//         and on rows without heavy ties about 1.3 k keys do. Taken when at
//         most sort_max keys lie at or below it;
//       - else a radix select on the key, 8 bits at a time from the top: a
//         histogram of the digit over the keys still in the k-th key's
//         bucket (each warp adds equal digits once, __match_any_sync, so
//         rows of ties do not serialise on one shared-memory atomic), one
//         warp's scan picks the bucket, and it stops once that bucket and
//         all below it hold at most sort_max keys. Column digits are read
//         only where a value is shared by more keys than that (rows of ties,
//         +inf, +-0.0).
//     Its work grows with L, not with the log2(P)(log2(P) + 1)/2 barrier
//     stages of a bitonic sort of all P = next_pow2(L) bins.
//   * Work in flight (row_threads). A long row (32 windows or more) gets 256
//     threads, where the fold sets the pace; a short row the fewest of 32,
//     64, 128, 256 that leave a thread at most 16 bins, since there its
//     select costs as much as its fold: a warp a row at the block cut, the
//     pair cut and the IVF probes, 256 threads at the PQ tile. A block holds
//     BLOCK_THREADS / T rows (4 warp rows), each row waiting only on its own
//     threads (__syncwarp, or the row's named barrier), so one row's select
//     overlaps the others' loads. Shared memory a row: max(L, sort_max) + 132
//     keys of 8 bytes (5.1 KB at L = 512, 33.8 KB at the PQ tile, 129 KB at
//     L = 16384, above 48 KB by opt-in). Registers (ptxas, sm_90a, capped at
//     64 by __launch_bounds__(256, 4)): approx_fused_kernel 60 (64 for a
//     warp a row), approx_select_kernel 64, approx_fold_kernel 64, no
//     spills; so 1024 threads an SM: 32 warp rows, or 4 rows of 256.
//   * Few long rows (split route). Where rows are few, a row's windows are
//     cut into splits folded by blocks of their own (approx_fold_kernel,
//     rows x splits ~ 2048 blocks, which fills the 132 SMs even for 16 rows
//     of 1M columns); each split writes its bins' keys to a scratch [rows,
//     splits, L] from the wrapper, and approx_select_kernel takes a bin's
//     smallest key over its splits (the bin's (minimum, lowest column), since
//     key order is the (value, column) order) into shared memory and runs
//     select_row. No atomics across blocks: the result does not depend on
//     block order.
//   * Every bin holds at least its column b < L <= N from split 0, so a
//     position is always inside the row; a bin of only +inf keeps column b.
//     NaN is never taken by the fold (callers mark invalid entries +inf).
//
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int BLOCK_THREADS = 128;      // a block: rows x threads a row
constexpr int FOLD_LOADS = 8;           // loads a thread has in flight in the fold
constexpr int MIN_BLOCKS = 4;           // __launch_bounds__(256, this): 64 registers a thread
constexpr int FOLD_THREADS = 256;       // approx_fold_kernel's block (split route)
constexpr int MAX_BINS = 16384;         // L keys of 8 bytes in shared memory: 128 KB
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SLICE_EXTRA = RADIX / 2 + 4;   // u64 words of a row's histogram and state
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_DIGIT = 0xffffffffu;
constexpr u64 EMPTY = ~0ull;

struct SelectState {
  u64 thr;          // the k-th key's digits found so far
  unsigned need;    // keys still needed from the k-th key's bucket
  int done;
  unsigned count;   // keys compacted so far
};

__device__ __forceinline__ u64 make_key(float v, long long col) {
  unsigned int b = __float_as_uint(v == 0.0f ? 0.0f : v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<u64>(b) << 32) | static_cast<unsigned int>(col);
}

// The G threads of a row wait for each other: a warp by __syncwarp, more by
// the named barrier of their row (ids 1.., so rows of a block never wait for
// each other and a block's last rows may be absent).
template <int G>
__device__ __forceinline__ void row_sync(int gid) {
  if (G == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(gid + 1), "r"(G) : "memory");
}

// Folds GB bins b0, b0 + bstride, ... (those below L) over the windows from
// column `first` (a multiple of L) to cend, WB windows a batch: GB * WB
// loads in flight. Batches wholly inside the row load unmasked; the rest
// masked with +inf, which is never taken.
template <int GB, int WB>
__device__ __forceinline__ void fold_group(const float* __restrict__ r, long long first,
                                           long long cend, int L, int b0, int bstride,
                                           u64* out) {
  const long long step = static_cast<long long>(L);
  float best[GB];
  int win[GB];
#pragma unroll
  for (int i = 0; i < GB; ++i) {
    best[i] = __int_as_float(0x7f800000);   // +inf
    win[i] = 0;
  }
  const int reach = b0 + (GB - 1) * bstride;   // the last bin
  long long c = first;
  int j = 0;
  if (reach < L) {
    for (; c + (WB - 1) * step + reach < cend; c += WB * step, j += WB) {
      const float* p = r + c + b0;   // 32-bit offsets from here: u * L + i * bstride < 2^31
      float v[GB][WB];
#pragma unroll
      for (int i = 0; i < GB; ++i)
#pragma unroll
        for (int u = 0; u < WB; ++u) v[i][u] = __ldcs(p + (u * L + i * bstride));
#pragma unroll
      for (int i = 0; i < GB; ++i)
#pragma unroll
        for (int u = 0; u < WB; ++u)
          if (v[i][u] < best[i]) {
            best[i] = v[i][u];
            win[i] = j + u;
          }
    }
  }
  for (; c + b0 < cend; c += WB * step, j += WB) {
    const float* p = r + c + b0;
    const long long left = cend - c - b0;   // columns of the row from p on
    float v[GB][WB];
#pragma unroll
    for (int i = 0; i < GB; ++i)
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int off = u * L + i * bstride;
        v[i][u] = b0 + i * bstride < L && off < left ? __ldcs(p + off)
                                                     : __int_as_float(0x7f800000);
      }
#pragma unroll
    for (int i = 0; i < GB; ++i)
#pragma unroll
      for (int u = 0; u < WB; ++u)
        if (v[i][u] < best[i]) {
          best[i] = v[i][u];
          win[i] = j + u;
        }
  }
#pragma unroll
  for (int i = 0; i < GB; ++i) {
    const int b = b0 + i * bstride;
    if (b < L) out[b] = make_key(best[i], first + b + static_cast<long long>(win[i]) * step);
  }
}

// The fold of a row by `nt` threads, thread gl owning bins gl, gl + nt, ...:
// each bin walks its columns b + j*L in increasing j with a strict <, so a
// warp's 32 lanes load 32 neighbouring floats at every window (coalesced),
// with the streaming hint since nothing reads the tile again. A thread takes
// its bins 4, 2 or 1 at a time, FOLD_LOADS loads in flight.
__device__ __forceinline__ void fold_row(const float* __restrict__ r, long long first,
                                         long long cend, int L, int gl, int nt, u64* out) {
  constexpr int FL = FOLD_LOADS;
  const int nb = gl < L ? (L - gl + nt - 1) / nt : 0;
  int m = 0;
  for (; m + 4 <= nb; m += 4) fold_group<4, FL / 4>(r, first, cend, L, gl + m * nt, nt, out);
  if (m + 2 <= nb) {
    fold_group<2, FL / 2>(r, first, cend, L, gl + m * nt, nt, out);
    m += 2;
  }
  if (m < nb) fold_group<1, FL>(r, first, cend, L, gl + m * nt, nt, out);
}

// Ascending bitonic sort of keys[0, p), p a power of two, by threads t0,
// t0 + nt, ... of one warp (WARP) or of the row's G threads; keys are ready
// on entry.
template <int G, bool WARP>
__device__ __forceinline__ void bitonic(u64* keys, int p, int t0, int nt, int gid) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll 1
      for (int t = t0; t < p / 2; t += nt) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const u64 a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      if (WARP)
        __syncwarp();
      else
        row_sync<G>(gid);
    }
  }
}

// The k smallest of the L distinct keys in keys[0, L) (shared memory with
// room for max(L, sort_max) keys), ascending, to vals[0, k) / pos[0, k) with
// each value read back from row r. Called by all G threads of the row (gl
// its thread's index, gid the row's index in the block) after they wrote
// the keys. The digits stop once the keys up to the k-th key's bucket are
// few enough to sort (at most sort_max = max(next_pow2(k), 64)).
template <int G>
__device__ __forceinline__ void select_row(u64* keys, unsigned* hist, SelectState& st, int L, int k,
                           int sort_max, const float* __restrict__ r, float* __restrict__ vals,
                           long long* __restrict__ pos, int gl, int gid) {
  const int lane = gl & 31, warp = gl >> 5;
  for (int i = gl; i < RADIX; i += G) hist[i] = 0;
  if (gl == 0) st.count = 0;
  row_sync<G>(gid);

  u64 lim = EMPTY;   // the compaction keeps the keys <= lim: at least k, at most sort_max
  bool bounded = false;
  if (G == 32 && k <= 32) {
    // A warp owns the row: the k-th smallest of the 32 lanes' minima bounds
    // the k-th key from above (the k lanes' minima lie at or below it), and
    // on rows without heavy ties leaves about 1.3 k keys; taken when it
    // leaves at most sort_max.
    u64 m = EMPTY;
#pragma unroll 1
    for (int i = lane; i < L; i += 32) m = keys[i] < m ? keys[i] : m;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)   // the lanes' minima sorted across the warp
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const u64 o = __shfl_xor_sync(FULL, m, stride);
        m = (((lane & stride) == 0) == ((lane & size) == 0)) ? (o < m ? o : m) : (o > m ? o : m);
      }
    const u64 t = __shfl_sync(FULL, m, k - 1);
    unsigned c = 0;
#pragma unroll 1
    for (int i = lane; i < L; i += 32) c += keys[i] <= t;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
    if (c <= static_cast<unsigned>(sort_max)) {
      lim = t;
      bounded = true;
    }
  }

  // else the radix select of the k-th smallest key, digits from the top
  u64 thr = 0;
  unsigned need = static_cast<unsigned>(k);
  int shift = 64;
  while (!bounded) {
    const int low = shift - RADIX_BITS;
    const u64 hi = shift == 64 ? 0ull : (~0ull << shift);   // the digits found so far
#pragma unroll 1
    for (int base = 0; base < L; base += G) {               // warp-uniform trip count
      const int i = base + gl;
      unsigned dig = NO_DIGIT;
      if (i < L) {
        const u64 key = keys[i];
        if (((key ^ thr) & hi) == 0) dig = static_cast<unsigned>(key >> low) & (RADIX - 1);
      }
      const unsigned peers = __match_any_sync(FULL, dig);
      if (dig != NO_DIGIT && lane == __ffs(peers) - 1)
        atomicAdd(&hist[dig], static_cast<unsigned>(__popc(peers)));
    }
    row_sync<G>(gid);
    if (warp == 0) {   // a lane scans 8 buckets; the one holding the need-th key decides
      constexpr int PER = RADIX / 32;
      unsigned h[PER], sum = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        h[j] = hist[lane * PER + j];
        hist[lane * PER + j] = 0;
        sum += h[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += t;
      }
      unsigned below = incl - sum;
      if (below < need && need <= incl) {
        bool found = false;
        unsigned d = 0, hd = 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (!found) {
            if (below + h[j] >= need) {
              found = true;
              d = lane * PER + j;
              hd = h[j];
            } else {
              below += h[j];
            }
          }
        }
        const unsigned rem = need - below;   // keys needed from bucket d, 1 <= rem <= hd
        st.thr = thr | (static_cast<u64>(d) << low);
        st.need = rem;
        st.done = hd == rem || k + (hd - rem) <= static_cast<unsigned>(sort_max) || low == 0;
      }
    }
    row_sync<G>(gid);
    thr = st.thr;
    need = st.need;
    shift = low;
    if (st.done) {
      lim = thr | ((1ull << shift) - 1);   // the k-th key's bucket and all below it
      break;
    }
  }

  // the keys <= lim (the k smallest among them): to the front, in place
#pragma unroll 1
  for (int base = 0; base < L; base += G) {
    const int i = base + gl;
    const u64 key = i < L ? keys[i] : EMPTY;
    const bool sel = i < L && key <= lim;
    row_sync<G>(gid);   // the chunk is read before any of it is overwritten
    const unsigned ball = __ballot_sync(FULL, sel);
    unsigned slot = 0;
    if (lane == 0 && ball) slot = atomicAdd(&st.count, static_cast<unsigned>(__popc(ball)));
    slot = __shfl_sync(FULL, slot, 0);
    if (sel) keys[slot + __popc(ball & ((1u << lane) - 1))] = key;
  }
  row_sync<G>(gid);
  const int count = static_cast<int>(st.count);
  const int ps = count > 1 ? 1 << (32 - __clz(count - 1)) : 1;   // <= sort_max
  for (int i = count + gl; i < ps; i += G) keys[i] = EMPTY;
  row_sync<G>(gid);
  if (ps <= 64) {
    if (warp == 0) bitonic<G, true>(keys, ps, lane, 32, gid);
    row_sync<G>(gid);
  } else {
    bitonic<G, false>(keys, ps, gl, G, gid);
  }
  for (int i = gl; i < k; i += G) {
    const long long c = static_cast<long long>(keys[i] & 0xffffffffull);
    pos[i] = c;
    vals[i] = r[c];
  }
}

// A row's slice of the block's shared memory: `cap` keys, its histogram and
// its state.
struct Slice {
  u64* keys;
  unsigned* hist;
  SelectState* st;
  __device__ Slice(u64* smem, int gid, int cap) {
    keys = smem + static_cast<long long>(gid) * (cap + SLICE_EXTRA);
    hist = reinterpret_cast<unsigned*>(keys + cap);
    st = reinterpret_cast<SelectState*>(keys + cap + RADIX / 2);
  }
};

// One launch a row (the row's windows are not split): G threads a row,
// blockDim.x / G rows a block; the fold and the select in shared memory.
template <int G>
__global__ void __launch_bounds__(256, MIN_BLOCKS)
    approx_fused_kernel(const float* __restrict__ s, float* __restrict__ vals,
                        long long* __restrict__ pos, int rows, long long n, int L, int k,
                        int sort_max, int cap) {
  extern __shared__ u64 smem[];
  const int gid = threadIdx.x / G, gl = threadIdx.x % G;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / G) + gid;
  if (row >= rows) return;
  Slice sl(smem, gid, cap);
  const float* r = s + row * n;
  fold_row(r, 0, n, L, gl, G, sl.keys);
  select_row<G>(sl.keys, sl.hist, *sl.st, L, k, sort_max, r, vals + row * k, pos + row * k, gl,
                gid);
}

// Split route, first launch: split blockIdx.y of a row folds its `per`
// windows into part[row, split, :].
__global__ void __launch_bounds__(FOLD_THREADS)
    approx_fold_kernel(const float* __restrict__ s, u64* __restrict__ part, long long n, int L,
                       long long per) {
  const long long row = blockIdx.x;
  const long long split = blockIdx.y;
  const long long first = split * per * L;
  fold_row(s + row * n, first, min(first + per * L, n), L, threadIdx.x, blockDim.x,
           part + (row * gridDim.y + split) * L);
}

// Split route, second launch: a bin's smallest key over its splits, then
// the select.
template <int G>
__global__ void __launch_bounds__(256, MIN_BLOCKS)
    approx_select_kernel(const float* __restrict__ s, const u64* __restrict__ part,
                         float* __restrict__ vals, long long* __restrict__ pos, int rows,
                         long long n, int L, int k, int splits, int sort_max, int cap) {
  extern __shared__ u64 smem[];
  const int gid = threadIdx.x / G, gl = threadIdx.x % G;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / G) + gid;
  if (row >= rows) return;
  Slice sl(smem, gid, cap);
  const u64* p = part + row * splits * L;
  for (int b = gl; b < L; b += G) {
    u64 key = EMPTY;
    for (int q = 0; q < splits; ++q) {
      const u64 x = p[static_cast<long long>(q) * L + b];
      key = x < key ? x : key;
    }
    sl.keys[b] = key;
  }
  select_row<G>(sl.keys, sl.hist, *sl.st, L, k, sort_max, s + row * n, vals + row * k,
                pos + row * k, gl, gid);
}

// Threads a row: 256 for a long row (32 windows or more: the fold sets the
// pace), else the fewest of 32, 64, 128, 256 that leave a thread at most 16
// of the row's bins (a short row's select costs it as much as its fold).
int row_threads(int L, long long windows) {
  if (windows >= 32) return 256;
  int g = 32;
  while (g < 256 && g * 16 < L) g <<= 1;
  return g;
}

template <int G>
cudaError_t launch(const float* s, const u64* part, float* vals, long long* pos, int rows,
                   long long n, int L, int k, int splits, int sort_max, int cap,
                   cudaStream_t st) {
  const size_t slice = static_cast<size_t>(cap + SLICE_EXTRA) * sizeof(u64);
  int per_block = BLOCK_THREADS / G > 1 ? BLOCK_THREADS / G : 1;
  while (per_block > 1 && per_block * slice > static_cast<size_t>(SMEM_LIMIT)) --per_block;
  const size_t smem = per_block * slice;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  cudaError_t err = cudaSuccess;
  if (splits == 1) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(approx_fused_kernel<G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    approx_fused_kernel<G><<<blocks, per_block * G, smem, st>>>(s, vals, pos, rows, n, L, k,
                                                                sort_max, cap);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(approx_select_kernel<G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    approx_select_kernel<G><<<blocks, per_block * G, smem, st>>>(s, part, vals, pos, rows, n, L,
                                                                 k, splits, sort_max, cap);
  }
  return cudaGetLastError();
}

}  // namespace

// s [rows, n] f32 contiguous; vals [rows, k] f32 and pos [rows, k] int64 out.
// Each split folds `per` windows of L columns; splits * per must cover
// ceil(n / L). splits == 1: one launch, part unused (may be null). splits >
// 1: part is a [rows, splits, L] 64-bit scratch and two launches. Returns a
// cudaError_t.
extern "C" int zvdb_approx_min_k(const void* s, void* part, void* vals, void* pos, int rows,
                                 long long n, int L, int k, int splits, long long per,
                                 void* stream) {
  if (rows <= 0 || n <= 0 || n >= (1ll << 31) || L <= 0 || L > MAX_BINS || L > n || k < 1 ||
      k > L || splits < 1 || splits > 65535 || per < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long windows = (n + L - 1) / L;
  if (static_cast<long long>(splits) * per < windows ||
      static_cast<long long>(splits - 1) * per >= windows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  u64* pk64 = static_cast<u64*>(part);
  if (splits > 1) {
    approx_fold_kernel<<<dim3(rows, splits), FOLD_THREADS, 0, st>>>(sf, pk64, n, L, per);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int sort_max = 64;
  while (sort_max < k) sort_max <<= 1;
  const int cap = L > sort_max ? L : sort_max;
  float* vf = static_cast<float*>(vals);
  long long* pl = static_cast<long long*>(pos);
  switch (row_threads(L, windows)) {
    case 32: return (int)launch<32>(sf, pk64, vf, pl, rows, n, L, k, splits, sort_max, cap, st);
    case 64: return (int)launch<64>(sf, pk64, vf, pl, rows, n, L, k, splits, sort_max, cap, st);
    case 128: return (int)launch<128>(sf, pk64, vf, pl, rows, n, L, k, splits, sort_max, cap, st);
    case 256: return (int)launch<256>(sf, pk64, vf, pl, rows, n, L, k, splits, sort_max, cap, st);
  }
  return (int)cudaErrorInvalidValue;
}
