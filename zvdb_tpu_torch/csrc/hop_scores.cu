// Fused graph-hop scorer for Hopper (sm_90a): kernel G.
//
// Replaces examples/exp_r3_hopkernel.py:_hop_kernel (wrapper fused_hop_scores):
//
//     scores[b, j] = q[b] . x[idx[b, j]]      (f32 products and sums)
//
// for idx [B, K] int32, q [B, D] f32 and x [N, D] f32, without writing the
// gathered [B, K, D] rows to device memory. An id outside [0, N) is the
// caller's error, as in the TPU kernel; here it reads nothing and scores NaN.
//
// What bounds it on this card: bytes. The least a call must move is each
// distinct candidate row once, plus the ids, q and the output, over the
// memory rate: 0.1141 ms at the experiment's B=4992, K=256, N=1M, D=128
// (uniform ids: ~721k distinct rows of 1.28M gathers), 0.0282 ms at the
// cagra_1m hop (B=2048, K=128 of which 96 live: ~178k of 262k). A row is
// used for D multiply-adds (0.25 operations per byte), so operations never
// bound it. A scorer that takes the ids in their order reads a repeated id
// from device memory again (L2 holds a tenth of a 512 MB corpus), so it
// moves nearly every gather: B*K*D*4 bytes, 0.2 ms at the experiment. And
// whatever the order, one operand of every pair (654 MB there) crosses from
// L2 to the SMs. A corpus that fits in L2 scores the experiment's list in
// 0.087 ms (654 MB at about 7.5 TB/s), so that crossing, not device memory,
// is taken to be the floor the routes meet: inferred from times, since no
// byte counter of the card was read. The TPU version issued one DMA per
// row and lost 31x to XLA's hardware gather; a GPU gathers rows with
// ordinary loads, eight lanes a row, each lane 16 bytes at a time.
//
// Two routes share one scorer (hop_kernel): a warp takes items of 32
// pairs, loads their (position, id) with one coalesced load, shares them by
// shuffle and issues the row loads of STEPS x 4 pairs before their FMAs.
//  - direct (hop_kernel<false>): an item is 32 candidates of one query in
//    idx's order, the query row held in registers; a persistent grid (as
//    many blocks as stay resident) in which a warp loads its next item's
//    ids before scoring this one. For lists with few repeats, such as the
//    cagra_1m hop.
//  - grouped (window_hist, window_scan, window_scatter, then
//    hop_kernel<true>): a counting pass puts the B*K pair positions in
//    order of row window (2^shift rows a window, sized by the wrapper to a
//    part of L2), stably, so that within a window the pairs keep their
//    (b, j) order. The scorer, a warp an item, walks that list front to
//    back and writes each score at its pair's position: the resident warps
//    cover a few windows at a time, so a row's repeats mostly hit L2, and a
//    query's candidates in a window stay adjacent, so its row comes from
//    L1. For lists with many repeats, such as the experiment's shape.
// The wrapper (ops/hop_scores.py) picks the route from (B, K, N) alone.
// D % 4 != 0, D > 256 or unaligned rows take a scalar form of the scorer
// with the same order of work. hop_route_sweep.py times the tunables below.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ZVDB_HOP_STEPS
#define ZVDB_HOP_STEPS 1    // direct route: 4-pair steps whose row loads go out together
#endif
#ifndef ZVDB_HOP_GSTEPS
#define ZVDB_HOP_GSTEPS 2   // grouped route: the same (each pair also loads its query row)
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 32;                  // pairs an item (one a lane)
constexpr int CHUNK = 2048;              // pairs a block of the counting pass
constexpr int ITEMS = CHUNK / THREADS;   // pairs a thread of it
constexpr int MAX_SLOTS = 512;           // windows + 1 (the slot of out-of-range ids)
constexpr int SCAN_TILES = 4;            // 256-count tiles a thread of the row scan loads at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool in_range(int id, int N) { return (unsigned)id < (unsigned)N; }

// Lane s of a row's eight lanes holds float4s s, s + 8, ... of the row.
template <int NV>
__device__ __forceinline__ void load_slices(float4 (&v)[NV], const float* row, bool ok, int s,
                                            int D4) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int f = s + 8 * i;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    v[i] = ok && f < D4 ? __ldg(r4 + f) : zero;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Items of 32 pairs, one a warp at a time. GROUPED: an item is 32 entries
// of `order` ((position b*K + j, id) pairs), one item a warp; else 32
// candidates of one query in idx, and the grid may be smaller than the
// items (a warp then takes every stride-th, loading the next one's ids
// before it scores this one's). NV float4s a lane (D <= 32 * NV), or
// NV == 0 for the scalar form (S must then be 1).
template <bool GROUPED, int NV, int S>
__global__ void __launch_bounds__(THREADS)
hop_kernel(const int* __restrict__ idx, const int2* __restrict__ order,
           const float* __restrict__ q, const float* __restrict__ x, float* __restrict__ out,
           int B, int K, int N, int D) {
  constexpr int NA = NV > 0 ? NV : 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3, s = lane & 7;   // pair within a step, lane within the row
  const int D4 = D >> 2;
  const int runs = (K + RUN - 1) / RUN;
  const int P = B * K;
  const long long items = GROUPED ? ((long long)P + RUN - 1) / RUN : (long long)B * runs;
  const long long stride = (long long)gridDim.x * WARPS;
  long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);

  // this lane's pair of an item: its position in out (-1 past the end) and its id
  auto fetch = [&](long long it) -> int2 {
    if (it >= items) return make_int2(-1, -1);
    if constexpr (GROUPED) {
      const long long e = it * RUN + lane;
      return e < P ? __ldg(order + e) : make_int2(-1, -1);
    } else {
      const int j = (int)it % runs * RUN + lane;
      const int p = (int)it / runs * K + j;
      return j < K ? make_int2(p, __ldg(idx + p)) : make_int2(-1, -1);
    }
  };

  int2 cur = fetch(item);
  for (; item < items; item += stride) {
    const int2 nxt = GROUPED ? make_int2(-1, -1) : fetch(item + stride);
    float4 qr[NA];   // direct: the item's query row, for all its pairs
    if constexpr (!GROUPED && NV > 0)
      load_slices<NV>(qr, q + (long long)((int)item / runs) * D, true, s, D4);
#pragma unroll
    for (int st = 0; st < RUN / 4; st += S) {
      int pos[S], id[S];
      float4 xv[S][NA], qv[S][NA];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int r = 4 * (st + u) + g;
        pos[u] = __shfl_sync(FULL, cur.x, r);
        id[u] = __shfl_sync(FULL, cur.y, r);
        if constexpr (NV > 0) {
          const bool ok = pos[u] >= 0 && in_range(id[u], N);
          load_slices<NV>(xv[u], x + (long long)(ok ? id[u] : 0) * D, ok, s, D4);
          if constexpr (GROUPED)
            load_slices<NV>(qv[u], q + (long long)(pos[u] >= 0 ? pos[u] / K : 0) * D,
                            pos[u] >= 0, s, D4);
        }
      }
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const bool ok = pos[u] >= 0 && in_range(id[u], N);
        float acc = 0.f;
        if constexpr (NV > 0) {
#pragma unroll
          for (int i = 0; i < NV; ++i) acc = dot4(GROUPED ? qv[u][i] : qr[i], xv[u][i], acc);
        } else if (ok) {
          const float* qb = q + (long long)(pos[u] / K) * D;
          const float* xr = x + (long long)id[u] * D;
          for (int d = s; d < D; d += 8) acc = fmaf(__ldg(qb + d), __ldg(xr + d), acc);
        }
        acc += __shfl_xor_sync(FULL, acc, 4);
        acc += __shfl_xor_sync(FULL, acc, 2);
        acc += __shfl_xor_sync(FULL, acc, 1);
        if (s == 0 && pos[u] >= 0) out[pos[u]] = ok ? acc : __int_as_float(0x7fc00000);
      }
    }
    cur = nxt;
  }
}

// ---- the counting pass: pair positions in stable order of row window ----
// Window of an id: id >> shift in [0, W) for ids in [0, N), W for the rest.
// Scratch: order [P] (position, id) pairs, counts [W + 1, nblk] (a block's
// pairs a window, then their exclusive scan along the row), totals [W + 1].

__device__ __forceinline__ int window_of(int id, int N, int shift, int W) {
  return in_range(id, N) ? id >> shift : W;
}

// The lanes whose key equals this lane's, for keys in [0, 2^bits): one
// ballot a bit (what __match_any_sync gives, in a fixed number of steps).
__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  unsigned peers = FULL;
  for (int b = 0; b < bits; ++b) {
    const bool one = (key >> b) & 1;
    const unsigned set = __ballot_sync(FULL, one);
    peers &= one ? set : ~set;
  }
  return peers;
}

// Exclusive scan of v over the block; total gets the block's sum. sums is
// WARPS ints of shared memory, free again on return.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const int c = sums[k];
    before += k < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + inc - v;
}

__global__ void __launch_bounds__(THREADS)
window_hist(const int* __restrict__ idx, int P, int N, int shift, int W, int nblk,
            int* __restrict__ counts) {
  __shared__ int h[MAX_SLOTS];
  for (int w = threadIdx.x; w <= W; w += THREADS) h[w] = 0;
  const int e0 = blockIdx.x * CHUNK + threadIdx.x;
  int ids[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) ids[i] = e0 + i * THREADS < P ? __ldg(idx + e0 + i * THREADS) : 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (e0 + i * THREADS < P) atomicAdd(&h[window_of(ids[i], N, shift, W)], 1);
  __syncthreads();
  for (int w = threadIdx.x; w <= W; w += THREADS) counts[(long long)w * nblk + blockIdx.x] = h[w];
}

// One block a window: the exclusive scan of its row of counts, in place,
// SCAN_TILES x 256 counts at a time (loaded together), and its total.
__global__ void __launch_bounds__(THREADS)
window_scan(int* __restrict__ counts, int nblk, int* __restrict__ totals) {
  __shared__ int sums[WARPS];
  int* row = counts + (long long)blockIdx.x * nblk;
  int carry = 0;
  for (int b0 = 0; b0 < nblk; b0 += SCAN_TILES * THREADS) {
    int v[SCAN_TILES];
#pragma unroll
    for (int i = 0; i < SCAN_TILES; ++i) {
      const int c = b0 + i * THREADS + threadIdx.x;
      v[i] = c < nblk ? row[c] : 0;
    }
#pragma unroll
    for (int i = 0; i < SCAN_TILES; ++i) {
      int total;
      const int ex = block_scan(v[i], sums, total);
      const int c = b0 + i * THREADS + threadIdx.x;
      if (c < nblk) row[c] = carry + ex;
      carry += total;
    }
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Each block sorts its chunk by window in shared memory, stably, then
// writes each window's run of it where it goes (the window's start plus the
// earlier blocks' pairs in it), so the writes are runs of contiguous pairs.
// Warp k takes the chunk's k-th 256 pairs, 32 at a time: it counts them a
// window (one lane of each group of equal windows adds the group's size),
// the block lays the warps' counts out window by window (earlier warps
// first), then each warp places its pairs after its earlier ones, a pair
// at its rank among the lanes of its window.
__global__ void __launch_bounds__(THREADS)
window_scatter(const int* __restrict__ idx, int P, int N, int shift, int W, int nblk,
               const int* __restrict__ counts, const int* __restrict__ totals,
               int2* __restrict__ order) {
  __shared__ int wcnt[WARPS][MAX_SLOTS];   // a warp's pairs a window, then its next place
  __shared__ int dest[MAX_SLOTS];          // a window's place in order, less its place in `sorted`
  __shared__ int2 sorted[CHUNK];
  __shared__ int sums[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, blk = blockIdx.x;
  const int e0 = blk * CHUNK + warp * (CHUNK / WARPS) + lane;
  const int bits = 32 - __clz(W + 1);   // keys: windows 0..W, W + 1 past the end
  const unsigned below_me = (1u << lane) - 1u;
  int ids[ITEMS], win[ITEMS];
  unsigned peers[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) ids[i] = e0 + 32 * i < P ? __ldg(idx + e0 + 32 * i) : 0;
  for (int c = t; c < WARPS * (W + 1); c += THREADS) wcnt[c / (W + 1)][c % (W + 1)] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    win[i] = e0 + 32 * i < P ? window_of(ids[i], N, shift, W) : W + 1;
    peers[i] = peers_of(win[i], bits);
    if (win[i] <= W && (peers[i] & below_me) == 0) wcnt[warp][win[i]] += __popc(peers[i]);
    __syncwarp();
  }
  __syncthreads();
  int start = 0, local = 0;   // running sums of the windows' totals and of this chunk's pairs
  for (int w0 = 0; w0 <= W; w0 += THREADS) {
    const int w = w0 + t;
    int tot = 0, mine = 0;
    if (w <= W) {
      tot = totals[w];
#pragma unroll
      for (int k = 0; k < WARPS; ++k) mine += wcnt[k][w];
    }
    int sum_tot, sum_mine;
    const int ex_tot = block_scan(tot, sums, sum_tot);
    const int ex_mine = block_scan(mine, sums, sum_mine);
    if (w <= W) {
      dest[w] = start + ex_tot + counts[(long long)w * nblk + blk] - (local + ex_mine);
      int run = local + ex_mine;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        const int c = wcnt[k][w];
        wcnt[k][w] = run;
        run += c;
      }
    }
    start += sum_tot;
    local += sum_mine;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int below = __popc(peers[i] & below_me);
    if (win[i] <= W) sorted[wcnt[warp][win[i]] + below] = make_int2(e0 + 32 * i, ids[i]);
    __syncwarp();
    if (win[i] <= W && below == 0) wcnt[warp][win[i]] += __popc(peers[i]);
    __syncwarp();
  }
  __syncthreads();
  const int n = min(CHUNK, P - blk * CHUNK);
  for (int l = t; l < n; l += THREADS) {
    const int2 v = sorted[l];
    order[dest[window_of(v.y, N, shift, W)] + l] = v;
  }
}

int windows(int N, int shift) { return N > 0 ? ((N - 1) >> shift) + 1 : 0; }

long long scratch_ints(int P, int N, int shift) {
  if (P < 0 || N < 0 || shift < 0 || shift > 30) return -1;
  const int W = windows(N, shift);
  if (W + 1 > MAX_SLOTS) return -1;
  return 2LL * P + (long long)(W + 1) * ((P + CHUNK - 1) / CHUNK + 1);
}

int window_order(const int* idx, int P, int N, int shift, int* scratch, long long scratch_len,
                 cudaStream_t s) {
  const long long need = scratch_ints(P, N, shift);
  if (need < 0 || scratch_len < need) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int W = windows(N, shift), nblk = (P + CHUNK - 1) / CHUNK;
  int2* order = reinterpret_cast<int2*>(scratch);
  int* counts = scratch + 2LL * P;
  int* totals = counts + (long long)(W + 1) * nblk;
  window_hist<<<nblk, THREADS, 0, s>>>(idx, P, N, shift, W, nblk, counts);
  window_scan<<<W + 1, THREADS, 0, s>>>(counts, nblk, totals);
  window_scatter<<<nblk, THREADS, 0, s>>>(idx, P, N, shift, W, nblk, counts, totals, order);
  return (int)cudaGetLastError();
}

// The grouped route launches a warp an item: the card then works through
// the order front to back, a few windows at a time. The direct route
// launches a persistent grid (as many blocks as stay resident, or fewer if
// the items run out first; the SM count and occupancy are read once).
template <bool GROUPED, int NV, int S>
int launch(const int* idx, const int2* order, const float* q, const float* x, float* out, int B,
           int K, int N, int D, cudaStream_t st) {
  static int resident = 0;
  if (!GROUPED && resident == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, hop_kernel<GROUPED, NV, S>, THREADS, 0);
    resident = sms * (occ > 0 ? occ : 1);
  }
  const long long items = GROUPED ? ((long long)B * K + RUN - 1) / RUN
                                  : (long long)B * ((K + RUN - 1) / RUN);
  long long blocks = (items + WARPS - 1) / WARPS;
  if (!GROUPED && blocks > resident) blocks = resident;
  hop_kernel<GROUPED, NV, S><<<(unsigned)blocks, THREADS, 0, st>>>(idx, order, q, x, out, B, K,
                                                                   N, D);
  return (int)cudaGetLastError();
}

template <bool GROUPED, int S>
int scores(const int* idx, const int2* order, const float* q, const float* x, float* out, int B,
           int K, int N, int D, cudaStream_t st) {
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec && D <= 32) return launch<GROUPED, 1, S>(idx, order, q, x, out, B, K, N, D, st);
  if (vec && D <= 64) return launch<GROUPED, 2, S>(idx, order, q, x, out, B, K, N, D, st);
  if (vec && D <= 128) return launch<GROUPED, 4, S>(idx, order, q, x, out, B, K, N, D, st);
  if (vec && D <= 256) return launch<GROUPED, 8, S>(idx, order, q, x, out, B, K, N, D, st);
  return launch<GROUPED, 0, 1>(idx, order, q, x, out, B, K, N, D, st);
}

bool bad_shape(int B, int K, int N, int D) {
  return B < 0 || K < 0 || N < 0 || D < 0 || (long long)B * K >= (1LL << 31);
}

}  // namespace

// Kernel G, direct route, on `stream`; returns a CUDA error code (0 on
// success). idx [B, K] int32, q [B, D] f32, x [N, D] f32, out [B, K] f32,
// all contiguous on the device; B * K < 2^31. Allocates nothing, does not
// sync.
extern "C" int zvdb_hop_scores(const void* idx, const void* q, const void* x, void* out, int B,
                               int K, int N, int D, void* stream) {
  if (bad_shape(B, K, N, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  return scores<false, ZVDB_HOP_STEPS>(static_cast<const int*>(idx), nullptr,
                                       static_cast<const float*>(q),
                                       static_cast<const float*>(x), static_cast<float*>(out), B,
                                       K, N, D, static_cast<cudaStream_t>(stream));
}

// int32s of scratch the grouped route needs for B * K pairs over N rows in
// windows of 2^shift rows; -1 where it does not take the shape (more than
// 511 windows, or shift outside [0, 30]).
extern "C" long long zvdb_hop_scratch_ints(int P, int N, int shift) {
  return scratch_ints(P, N, shift);
}

// The counting pass alone: scratch (zvdb_hop_scratch_ints of it) gets the
// [P] (position, id) pairs in stable window order, then [W + 1, nblk]
// counts (scanned along each window's row), then the [W + 1] pairs a window.
extern "C" int zvdb_hop_window_order(const void* idx, int P, int N, int shift, void* scratch,
                                     long long scratch_len, void* stream) {
  return window_order(static_cast<const int*>(idx), P, N, shift, static_cast<int*>(scratch),
                      scratch_len, static_cast<cudaStream_t>(stream));
}

// Kernel G, grouped route: the counting pass into scratch, then the scorer
// over its order. Arguments as zvdb_hop_scores and zvdb_hop_window_order.
extern "C" int zvdb_hop_scores_grouped(const void* idx, const void* q, const void* x, void* out,
                                       int B, int K, int N, int D, int shift, void* scratch,
                                       long long scratch_len, void* stream) {
  if (bad_shape(B, K, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = window_order(static_cast<const int*>(idx), B * K, N, shift,
                              static_cast<int*>(scratch), scratch_len, st);
  if (rc != 0 || B == 0 || K == 0) return rc;
  return scores<true, ZVDB_HOP_GSTEPS>(nullptr, static_cast<const int2*>(scratch),
                                       static_cast<const float*>(q),
                                       static_cast<const float*>(x), static_cast<float*>(out), B,
                                       K, N, D, st);
}
