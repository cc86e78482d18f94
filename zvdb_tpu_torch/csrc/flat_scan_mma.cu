// Fused flat scan with a per-query bin fold (kernel A) on Hopper's tensor
// cores, for sm_90a.
//
// Replaces zvdb_tpu/ops/pallas_topk.py:_scan_kernel (wrapper flat_scan_bins)
// in its bf16 modes, and the CUDA-core version of kernel A (csrc/flat_scan.cu,
// zvdb_flat_scan_bins), which keeps only "highest": f32 products cannot use
// the bf16 tensor cores. For every query b and every bin l in [0, L):
//
//     bin_s[b, l] = min over rows c with c % L == l of  norms[c] - f * (q[b] . x[c])
//     bin_i[b, l] = the row that attains it (the lowest such row on a tie),
//                   or -1 when the bin saw no row with a finite score,
//
// with f = 2 for l2 and 1 for dot/cosine; norms of +inf mark invalid rows.
// The corpus is f32 or bf16 in storage. The dot product follows the named
// precision, as the TPU kernel computes it:
//   DEFAULT  one bf16 product of bf16_rn(q) and bf16_rn(x), f32 accumulation;
//   HIGH     bf16x3: hi = bf16_rn(v), lo = bf16_rn(v - hi), and the three
//            products q_hi.x_hi + q_hi.x_lo + q_lo.x_hi into one f32
//            accumulator (a bf16 corpus has x_lo = 0, so q_hi.x_lo is skipped).
// Every product is one mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: the bf16
// products are exact in f32, so only the order of the sums differs from the
// plain version.
//
// What bounds it. At the main-path shape (B=2048 queries, N=1M rows, D=128,
// L=1024) the products are 2*B*N*D = 5.24e11 operations: 0.530 ms at the
// 989 TFLOP/s dense bf16 rate for "default", 1.59 ms for "high"'s three.
// The fold is ~5 CUDA-core instructions per score (an fma for norm - f*acc,
// a compare, two selects, the row id shared by four scores) over B*N = 2.1e9
// scores on 132 SMs x 128 lanes at 1.98 GHz: ~0.31 ms, under the mma term.
// The bytes are one read of the corpus (512 MB in f32), the norms, the
// queries and the [B, L] bins: ~0.16 ms at 3.35 TB/s. So the kernel is
// bound by the tensor cores; mma.sync does not reach the 989 TFLOP/s that
// only wgmma does.
//
// What the design does about it. Raw mma.sync through inline PTX, fed by
// ldmatrix (the fold needs the accumulator layout, which wmma hides).
//   * Walk. A block owns a tile of BQ queries and a slice of BL = 64 bins and
//     walks the rows c = m*L + l, l in its slice, in increasing m. Its
//     warps are laid out WQ = 4 along the queries by 2 along the bins; a
//     warp owns 16*MT queries x 32 bins, MT m16 tiles by four n8 tiles. Nothing
//     carries between blocks: no atomics, no merge pass, no scratch memory.
//   * Query tile resident. The tile's bf16 hi plane (and lo plane for
//     "high") loads into shared memory once and stays there for the whole
//     walk (~977 steps at N=1M, L=1024); a D deeper than KMAX is walked in
//     chunks, and then the query chunk is reloaded at every step.
//   * Query tile size against the corpus traffic and the registers. Every
//     query tile re-reads the whole corpus from L2 or HBM: 512 MB x B/BQ per
//     batch. "default" takes MT = 4, BQ = 256 (4.1 GB per batch, 128 blocks
//     at B=2048, L=1024: one wave on 132 SMs): 64 fold and 64 accumulator
//     registers a thread, 254 in all, no spills, and ldmatrix feeds 16 mmas
//     from 6 loads. "high" does three times the mmas per byte and needs both
//     planes of both sides in shared memory, so it takes MT = 2, BQ = 128
//     (8.2 GB, two waves). flat_tile_sweep.py times other tile shapes on
//     the card (16 warps of 32 x 32 tiles at 128 registers ran "default"
//     slower). Blocks that share a bin slice are adjacent in the grid
//     (blockIdx.x walks the query tiles), so the L2 serves most of those
//     re-reads.
//   * Staging. The corpus rows of each step move by cp.async into a ring of
//     two raw buffers, two steps ahead of the mmas, one barrier per step.
//     f32 rows are split into bf16 hi/lo planes one step ahead (double-
//     buffered planes), so the split of step m+1 runs beside the mmas of
//     step m; a bf16 corpus copies straight into a ring of hi planes (no
//     split). The step's 64 norms ride one step ahead in registers.
//     Plane rows are padded to KC + 8 bf16, which puts the eight rows of an
//     ldmatrix 8x8 read in eight different 16-byte bank groups.
//   * Fold, in registers. In m16n8k16 a thread holds c0, c1 at row g,
//     columns 2t, 2t+1 and c2, c3 at row g + 8 (g = lane/4, t = lane%4). A
//     column's bin is fixed across steps, so each thread keeps the running
//     (min, row) of exactly its own 16*MT accumulator positions. Each step
//     folds s = norm - f*acc with a strict < (as selects, not branches) and
//     resets the accumulators. Rows c and c + L sit in the same lane and
//     register and sum in the same k order, so duplicated rows score equal
//     bit for bit and the lower row keeps the tie, as on the TPU.
//   * Ragged edges. Missing queries, rows and D past its end load as zeros;
//     missing rows get a norm of +inf; queries past B and bins past L are not
//     written. Nothing is padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BL = 64;      // bins per block: two warp columns of 32
constexpr int KMAX = 128;   // deepest chunk of D held in shared memory
constexpr int PAD = 8;      // bf16 of padding per plane row

enum Precision { kHigh = 1, kDefault = 2 };

// Tile shape by precision (see the header; flat_tile_sweep.py times others):
// warps along the queries (by 2 along the bins), m16 tiles per warp, and raw
// corpus steps in flight.
template <int PREC>
struct Tile {
  static constexpr int WQ = 4;
  static constexpr int MT = PREC == kDefault ? 4 : 2;
  static constexpr int STAGES = 2;
  static constexpr int BQ = 16 * MT * WQ;
  static constexpr int THREADS = 64 * WQ;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies `bytes` (0 or the full size) from global memory and zero-fills the rest.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four consecutive values of one row into its bf16 plane(s): hi = bf16_rn(x),
// and for two planes lo = bf16_rn(x - hi) (x - hi is exact in f32).
template <int NP>
__device__ __forceinline__ void split_store(float4 x, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(hi) = make_uint2(bits(h01), bits(h23));
  if constexpr (NP == 2) {
    const float2 f01 = __bfloat1622float2(h01);
    const float2 f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
    *reinterpret_cast<uint2*>(lo) = make_uint2(bits(l01), bits(l23));
  }
}

// T: the corpus's storage type (float or __nv_bfloat16). VEC: rows and
// queries move in 16-byte pieces (D % 4 == 0 for f32 rows, D % 8 == 0 for
// bf16 rows, both pointers 16-byte aligned).
// Shared memory (dynamic), in order: the query planes [NPQ][BQ][KC+PAD] bf16;
// for f32 rows the raw ring [STAGES][BL][KC] f32 and the corpus planes
// [2][NPX][BL][KC+PAD] bf16, for bf16 rows the ring of hi planes
// [STAGES][BL][KC+PAD] bf16; the norms [2][BL] f32.
template <int PREC, typename T, bool VEC>
__global__ void __launch_bounds__(Tile<PREC>::THREADS, 1)
flat_scan_mma_kernel(const float* __restrict__ q, const T* __restrict__ x,
                     const float* __restrict__ norms, float* __restrict__ out_s,
                     int* __restrict__ out_i, int B, int N, int D, int L, int KC, int nch,
                     float factor) {
  constexpr int BQ = Tile<PREC>::BQ;
  constexpr int MT = Tile<PREC>::MT;
  constexpr int THREADS = Tile<PREC>::THREADS;
  constexpr int S = Tile<PREC>::STAGES;
  constexpr bool SPLIT = sizeof(T) == 4;             // f32 rows: split in shared memory
  constexpr int NPQ = PREC == kHigh ? 2 : 1;        // query planes: hi (, lo)
  constexpr int NPX = SPLIT ? NPQ : 1;              // corpus planes: a bf16 corpus has no lo
  const int SROW = KC + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qpl = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* after_q = smem + (size_t)NPQ * BQ * SROW * 2;
  float* raw = reinterpret_cast<float*>(after_q);   // f32 rows only
  __nv_bfloat16* xpl = reinterpret_cast<__nv_bfloat16*>(
      SPLIT ? after_q + (size_t)S * BL * KC * 4 : after_q);
  float* nrm = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(xpl) + (size_t)(SPLIT ? 2 * NPX : S) * BL * SROW * 2);
  const int xslot = NPX * BL * SROW;                 // bf16 per corpus plane set

  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wq = warp >> 1, wn = warp & 1;          // 16*MT-query group, 32-bin group
  const int g = lane >> 2, t4 = lane & 3;
  const int b0 = blockIdx.x * BQ;
  const int l0 = blockIdx.y * BL;
  const int nsteps = l0 < N ? (N - l0 + L - 1) / L : 0;   // steps m with m*L + l0 < N
  const int ntiles = nsteps * nch;                         // (step, D chunk) pairs

  // the corpus rows of tile `tile` into ring slot tile % S (always one commit)
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const long long base = (long long)(tile / nch) * L + l0;
      const int d0 = (tile % nch) * KC;
      const int slot = tile % S;
      if constexpr (SPLIT) {
        const int K4 = KC / 4;
        float* dst0 = raw + (size_t)slot * BL * KC;
        for (int e = tid; e < BL * K4; e += THREADS) {
          const int r = e / K4, k = (e % K4) * 4;
          const long long c = base + r;
          const int d = d0 + k;
          const bool live = l0 + r < L && c < N;
          const uint32_t dst = smem_addr(dst0 + r * KC + k);
          const T* src = x + c * D + d;
          if constexpr (VEC) {
            const bool in = live && d < D;
            cp_async16(dst, in ? src : x, in ? 16 : 0);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const bool in = live && d + i < D;
              cp_async4(dst + 4 * i, in ? src + i : x, in ? 4 : 0);
            }
          }
        }
      } else {
        const int K8 = KC / 8;
        __nv_bfloat16* dst0 = xpl + (size_t)slot * BL * SROW;
        for (int e = tid; e < BL * K8; e += THREADS) {
          const int r = e / K8, k = (e % K8) * 8;
          const long long c = base + r;
          const int d = d0 + k;
          const bool live = l0 + r < L && c < N;
          const T* src = x + c * D + d;
          if constexpr (VEC) {
            const bool in = live && d < D;
            cp_async16(smem_addr(dst0 + r * SROW + k), in ? src : x, in ? 16 : 0);
          } else {   // rows not 16-byte aligned: a plain load, stored for a later step
            __align__(16) __nv_bfloat16 v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              v[i] = (live && d + i < D) ? src[i] : __float2bfloat16_rn(0.f);
            *reinterpret_cast<uint4*>(dst0 + r * SROW + k) = *reinterpret_cast<uint4*>(v);
          }
        }
      }
    }
    cp_async_commit();
  };
  // this thread's norm of tile `tile`'s step (threads below BL), +inf where missing
  auto fetch_norm = [&](int tile) {
    const long long c = (long long)(tile / nch) * L + l0 + tid;
    return (tile < ntiles && tid < BL && l0 + tid < L && c < N) ? __ldg(norms + c) : inf;
  };
  // f32 rows: ring slot tile % S split into plane set tile & 1
  auto split = [&](int tile) {
    const int K4 = KC / 4;
    const float* src = raw + (size_t)(tile % S) * BL * KC;
    __nv_bfloat16* dst = xpl + (size_t)(tile & 1) * xslot;
    for (int e = tid; e < BL * K4; e += THREADS) {
      const int r = e / K4, k = (e % K4) * 4;
      split_store<NPX>(*reinterpret_cast<const float4*>(src + r * KC + k), dst + r * SROW + k,
                       dst + (BL + r) * SROW + k);
    }
  };
  // the query tile's D chunk at d0, loaded and split into its planes
  auto load_q = [&](int d0) {
    const int K4 = KC / 4;
    for (int e = tid; e < BQ * K4; e += THREADS) {
      const int r = e / K4, k = (e % K4) * 4;
      const int b = b0 + r, d = d0 + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B) {
        const float* p = q + (long long)b * D + d;
        if constexpr (VEC) {
          if (d < D) v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          if (d < D) v.x = __ldg(p);
          if (d + 1 < D) v.y = __ldg(p + 1);
          if (d + 2 < D) v.z = __ldg(p + 2);
          if (d + 3 < D) v.w = __ldg(p + 3);
        }
      }
      split_store<NPQ>(v, qpl + r * SROW + k, qpl + (BQ + r) * SROW + k);
    }
  };

  float best_s[MT][4][4];
  int best_i[MT][4][4];
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        best_s[i][j][e] = inf;
        best_i[i][j][e] = -1;
        acc[i][j][e] = 0.f;
      }

  // ldmatrix addresses of this lane: A rows wq*16*MT + lane%16 (+16 per m
  // tile) at k + 8*(lane/16); B two n8 tiles per x4, column (lane&7) +
  // 8*(lane/16) at k + 8*((lane/8)&1)
  const uint32_t a_addr =
      smem_addr(qpl + (wq * 16 * MT + (lane & 15)) * SROW + (lane >> 4) * 8);
  const uint32_t b_off =
      ((wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * SROW + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t a_tile = 16 * SROW * 2, a_plane = BQ * SROW * 2;
  const uint32_t b_pair = 16 * SROW * 2, b_plane = BL * SROW * 2;

  // prologue: the query tile, the first steps' copies, step 0's planes and norms
  if (nch == 1) load_q(0);
  for (int s = 0; s < (SPLIT ? S : S - 1); ++s) issue(s);
  float pn = fetch_norm(0);
  if constexpr (SPLIT) {
    cp_async_wait<S - 1>();
    __syncthreads();
    if (ntiles > 0) split(0);
  }
  if (tid < BL) nrm[tid] = pn;
  pn = fetch_norm(1);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int ch = tile % nch;
    // f32: tile + 1's raw rows have landed; bf16: tile's planes have
    cp_async_wait<S - 2>();
    __syncthreads();   // ... for every thread; the last tile's readers are done
    issue(SPLIT ? tile + S : tile + S - 1);   // into the slot freed by the last tile
    if (tile + 1 < ntiles) {   // the next tile's planes and norms, beside this tile's mmas
      if constexpr (SPLIT) split(tile + 1);
      if (tid < BL) nrm[((tile + 1) & 1) * BL + tid] = pn;
      pn = fetch_norm(tile + 2);
    }
    if (nch > 1) {   // D in chunks: this tile's query chunk
      load_q(ch * KC);
      __syncthreads();
    }

    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const uint32_t b_addr =
        smem_addr(xpl + (size_t)(SPLIT ? (tile & 1) : tile % S) * xslot) + b_off;
#pragma unroll 4
    for (int k = 0; k < KC; k += 16) {
      uint32_t ah[MT][4], bh[2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(ah[i], a_addr + i * a_tile + k * 2);
      ldmatrix_x4(bh[0], b_addr + k * 2);
      ldmatrix_x4(bh[1], b_addr + b_pair + k * 2);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], ah[i], bh[j >> 1][(j & 1) * 2], bh[j >> 1][(j & 1) * 2 + 1]);
      if constexpr (PREC == kHigh) {
        if constexpr (NPX == 2) {   // q_hi . x_lo
          uint32_t bl[2][4];
          ldmatrix_x4(bl[0], b_addr + b_plane + k * 2);
          ldmatrix_x4(bl[1], b_addr + b_plane + b_pair + k * 2);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[i][j], ah[i], bl[j >> 1][(j & 1) * 2], bl[j >> 1][(j & 1) * 2 + 1]);
        }
        uint32_t al[MT][4];   // q_lo . x_hi
#pragma unroll
        for (int i = 0; i < MT; ++i) ldmatrix_x4(al[i], a_addr + a_plane + i * a_tile + k * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], al[i], bh[j >> 1][(j & 1) * 2], bh[j >> 1][(j & 1) * 2 + 1]);
      }
    }

    if (ch == nch - 1) {   // fold step m: strict <, so the lower row keeps a tie
      const long long base = (long long)(tile / nch) * L + l0;
      const float* nb = nrm + (tile & 1) * BL;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = wn * 32 + j * 8 + 2 * t4;
        const float2 nv = *reinterpret_cast<const float2*>(nb + lc);
        const int c0 = (int)(base + lc);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = fmaf(-factor, acc[i][j][e], (e & 1) ? nv.y : nv.x);
            const bool take = s < best_s[i][j][e];
            best_s[i][j][e] = take ? s : best_s[i][j][e];
            best_i[i][j][e] = take ? c0 + (e & 1) : best_i[i][j][e];
          }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + wq * 16 * MT + i * 16 + g + (e >> 1) * 8;
        const int l = l0 + wn * 32 + j * 8 + 2 * t4 + (e & 1);
        if (b < B && l < L) {
          out_s[(long long)b * L + l] = best_s[i][j][e];
          out_i[(long long)b * L + l] = best_i[i][j][e];
        }
      }
}

template <int PREC, typename T, bool VEC>
int launch(dim3 grid, int kc, int nch, cudaStream_t stream, const float* q, const T* x,
           const float* norms, float* out_s, int* out_i, int B, int N, int D, int L,
           float factor) {
  constexpr int S = Tile<PREC>::STAGES;
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int np = PREC == kHigh ? 2 : 1;
  const size_t srow = kc + PAD;
  const size_t smem = np * Tile<PREC>::BQ * srow * 2 +
                      (SPLIT ? S * BL * kc * 4 + 2 * np * BL * srow * 2 : S * BL * srow * 2) +
                      2 * BL * 4;
  auto kernel = flat_scan_mma_kernel<PREC, T, VEC>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, Tile<PREC>::THREADS, smem, stream>>>(q, x, norms, out_s, out_i, B, N, D, L,
                                                      kc, nch, factor);
  return (int)cudaGetLastError();
}

template <int PREC, typename T>
int launch_vec(bool vec, int kc, int nch, cudaStream_t stream, const float* q, const void* x,
               const float* norms, float* out_s, int* out_i, int B, int N, int D, int L,
               float factor) {
  const dim3 grid((B + Tile<PREC>::BQ - 1) / Tile<PREC>::BQ, (L + BL - 1) / BL);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  return vec ? launch<PREC, T, true>(grid, kc, nch, stream, q, xt, norms, out_s, out_i, B, N, D,
                                     L, factor)
             : launch<PREC, T, false>(grid, kc, nch, stream, q, xt, norms, out_s, out_i, B, N,
                                      D, L, factor);
}

}  // namespace

// Launches kernel A on the tensor cores on `stream`; returns a CUDA error code
// (0 on success). The arguments are those of zvdb_flat_scan_bins
// (csrc/flat_scan.cu): q [B, D] f32, x [N, D] f32 (x_is_bf16 = 0) or bf16
// (1), norms [N] f32, out_s [B, L] f32, out_i [B, L] int32; every array
// contiguous on the device. precision: 1 high, 2 default (0, highest, is
// refused: it runs on the CUDA cores). Allocates nothing, does not sync.
extern "C" int zvdb_flat_scan_bins_mma(const void* q, const void* x, int x_is_bf16,
                                       const void* norms, void* out_s, void* out_i, int B,
                                       int N, int D, int L, float factor, int precision,
                                       void* stream) {
  if (B <= 0 || L <= 0 || D < 0 || N < 0 || (precision != kHigh && precision != kDefault))
    return (int)cudaErrorInvalidValue;
  const int dp = D < 16 ? 16 : (D + 15) / 16 * 16;
  const int nch = (dp + KMAX - 1) / KMAX;
  const int kc = ((dp + nch - 1) / nch + 15) / 16 * 16;
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec = aligned && D % (x_is_bf16 ? 8 : 4) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* nf = static_cast<const float*>(norms);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  if (precision == kHigh)
    return x_is_bf16 ? launch_vec<kHigh, __nv_bfloat16>(vec, kc, nch, s, qf, x, nf, os, oi, B,
                                                         N, D, L, factor)
                     : launch_vec<kHigh, float>(vec, kc, nch, s, qf, x, nf, os, oi, B, N, D, L,
                                                factor);
  return x_is_bf16 ? launch_vec<kDefault, __nv_bfloat16>(vec, kc, nch, s, qf, x, nf, os, oi, B,
                                                          N, D, L, factor)
                   : launch_vec<kDefault, float>(vec, kc, nch, s, qf, x, nf, os, oi, B, N, D, L,
                                                 factor);
}
