// Graph-build block scorer (kernel D) on Hopper's tensor cores, for sm_90a.
//
// Replaces zvdb_tpu/ops/pallas_block.py:_kernel (wrapper block_bins) in its
// bf16 modes, and the CUDA-core version of kernel D (csrc/flat_scan.cu,
// zvdb_block_bins), which keeps only "highest": f32 products cannot use the
// bf16 tensor cores. For a batch of cc blocks of B rows each, every row b is
// scored against every column row c of its own block, the self-pair c == b
// excluded, and folded into L modular bins:
//
//     bin_s[b, l] = min over c with c % L == l, c != b of  vn[c] - f * (v[b] . v[c])
//     bin_i[b, l] = the column that attains it (the lowest on a tie),
//                   or -1 where the minimum is not finite,
//
// with f = 2 for l2 and 1 for dot/cosine; vn of +inf marks an invalid slot.
// The dot product follows the named precision, as the TPU kernel computes it:
//   DEFAULT  one bf16 product of bf16_rn(v) operands, f32 accumulation;
//   HIGH     bf16x3: hi = bf16_rn(v), lo = bf16_rn(v - hi), and the three
//            products hi.hi + hi.lo + lo.hi into one f32 accumulator.
// Every product is one mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: the bf16
// products are exact in f32, so only the order of the sums differs from the
// plain version.
//
// What bounds it. The score matrix of a block is symmetric (v[b].v[c] =
// v[c].v[b], and hi.hi + hi.lo + lo.hi is symmetric too), so the function
// needs only the B*(B-1)/2 distinct pair dots: cc*B*(B-1)*D operations per
// product (three for "high"), against cc*B*D*4 bytes read and cc*B*L*8
// written. At the build's shape (cc=12, B=1640, D=128, L=128) "high" needs
// 1.24e10 operations, 0.0125 ms at 989 TFLOP/s, above its byte time of
// 0.0090 ms at 3.35 TB/s; "default" (0.0042 ms of operations) is bound by
// its bytes. This kernel computes both halves of the matrix, twice the
// operations the function needs: each block owns its rows' bins outright,
// so no pass merges a column's half into another block's rows. The
// CUDA-core version ran at the f32 FMA pipes' rate instead.
//
// What the design does about it. Raw mma.sync through inline PTX, fed by
// ldmatrix, was taken over nvcuda::wmma: wmma hides the accumulator layout,
// and the fold below needs it. (wgmma, TMA and persistent blocks are not
// used; a 64-row warpgroup tile would need a deeper fold per thread.)
//   * Walk. A block owns a tile of BQ = 64 rows and a slice of BL = 64 bins
//     and walks the columns c = m*L + l, l in its slice, in increasing m, as
//     the CUDA-core version does; 8 warps each own 16 rows x 32 bins, four
//     m16n8 accumulator tiles. Nothing carries between blocks: no atomics, no
//     merge pass, no scratch memory.
//   * Operands. The row tile's hi/lo bf16 planes load into shared memory once
//     for the whole walk. Each step's 64 column rows are copied raw (f32) by
//     cp.async into a staging buffer while the previous step's mmas run, then
//     split into hi/lo planes by a short pass in shared memory; the step's 64
//     norms ride one step ahead in registers. Rows and column rows are both
//     K-contiguous, so ldmatrix (no .trans) feeds both the A (row) and the B
//     (col) operand. Each plane row is padded to KC + 8 bf16, which puts the
//     eight rows of an ldmatrix 8x8 read in eight different 16-byte bank
//     groups. D is zero-padded to a multiple of 16 (zeros add nothing); a D
//     deeper than KMAX is walked in chunks, and then the row chunk is
//     reloaded at every step.
//   * Fold, in registers. In m16n8k16 a thread holds c0, c1 at row g,
//     columns 2t, 2t+1 and c2, c3 at row g + 8 (g = lane/4, t = lane%4). A
//     column's bin is fixed across steps, so each thread keeps the running
//     (min, column) of exactly its own accumulator positions: 16 + 16 + 16
//     registers per warp tile. Each step folds s = vn[c] - f*acc with a
//     strict <, skips c == b, and resets the accumulators. One thread folds
//     each (row, bin) in increasing m, so the lower column keeps a tie, as
//     on the TPU; columns c and c + L sit in the same lane and register and
//     sum in the same k order, so duplicated rows score equal bit for bit.
//   * Ragged edges. Missing rows and D past its end load as zeros, missing
//     columns get a norm of +inf; rows past B and bins past L are not
//     written. Nothing is padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // rows per block
constexpr int BL = 64;                 // bins per block
constexpr int WARPS = 8;               // 4 row groups of 16 x 2 bin groups of 32
constexpr int THREADS = WARPS * 32;
constexpr int KMAX = 256;              // deepest chunk of D held in shared memory
constexpr int PAD = 8;                 // bf16 of padding per plane row

enum Precision { kHigh = 1, kDefault = 2 };

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four consecutive values of one row into its bf16 plane(s): hi = bf16_rn(x),
// and for "high" lo = bf16_rn(x - hi) (x - hi is exact in f32).
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

// VEC: D % 4 == 0 and v 16-byte aligned, so rows move as float4 / 16-byte cp.async.
// Shared memory (dynamic): rows [NP][BQ][KC+PAD] bf16, cols [NP][BL][KC+PAD]
// bf16, stage [BL][KC] f32, nrm [BL] f32.
template <int PREC, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
block_bins_mma_kernel(const float* __restrict__ v, const float* __restrict__ vn,
                      float* __restrict__ out_s, int* __restrict__ out_i, int B, int D,
                      int L, int KC, int nch, float factor) {
  constexpr int NP = (PREC == kHigh) ? 2 : 1;   // operand planes per side
  const int SROW = KC + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cols = rows + NP * BQ * SROW;
  float* stage = reinterpret_cast<float*>(cols + NP * BL * SROW);
  float* nrm = stage + BL * KC;

  const long long z = blockIdx.z;
  v += z * B * D;
  vn += z * B;
  out_s += z * B * L;
  out_i += z * B * L;

  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;     // 16-row group, 32-bin group
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * BQ;
  const int l0 = blockIdx.y * BL;
  const int nsteps = l0 < B ? (B - l0 + L - 1) / L : 0;   // steps m with m*L + l0 < B
  const int ntiles = nsteps * nch;                         // (step, D chunk) pairs
  const int K4 = KC / 4;

  // cp.async of tile `tile`'s raw column rows into the staging buffer
  auto issue_cols = [&](int tile) {
    const int base = (tile / nch) * L + l0;
    const int d0 = (tile % nch) * KC;
    for (int e = tid; e < BL * K4; e += THREADS) {
      const int r = e / K4, k = (e % K4) * 4;
      const int c = base + r, d = d0 + k;
      const bool live = l0 + r < L && c < B;
      const uint32_t dst = smem_addr(stage + r * KC + k);
      const float* src = v + (long long)c * D + d;
      if constexpr (VEC) {
        const bool in = live && d < D;
        cp_async16(dst, in ? src : v, in ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = live && d + i < D;
          cp_async4(dst + 4 * i, in ? src + i : v, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  // this thread's norm of tile `tile`'s step (threads below BL), +inf where missing
  auto fetch_norm = [&](int tile) {
    const int c = (tile / nch) * L + l0 + tid;
    return (tid < BL && l0 + tid < L && c < B) ? __ldg(vn + c) : inf;
  };
  // the row tile's D chunk at d0, loaded and split into its planes
  auto load_rows = [&](int d0) {
    for (int e = tid; e < BQ * K4; e += THREADS) {
      const int r = e / K4, k = (e % K4) * 4;
      const int b = b0 + r, d = d0 + k;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B) {
        const float* p = v + (long long)b * D + d;
        if constexpr (VEC) {
          if (d < D) x = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          if (d < D) x.x = __ldg(p);
          if (d + 1 < D) x.y = __ldg(p + 1);
          if (d + 2 < D) x.z = __ldg(p + 2);
          if (d + 3 < D) x.w = __ldg(p + 3);
        }
      }
      split_store<NP>(x, rows + r * SROW + k, rows + (BQ + r) * SROW + k);
    }
  };

  float best_s[4][4];
  int best_i[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      best_s[j][e] = inf;
      best_i[j][e] = -1;
    }
  float acc[4][4] = {};

  // ldmatrix addresses of this lane: A rows wm*16 + lane%16 at k + 8*(lane/16);
  // B two n8 tiles per x4, column (lane&7) + 8*(lane/16) at k + 8*((lane/8)&1)
  const uint32_t a_addr =
      smem_addr(rows + (wm * 16 + (lane & 15)) * SROW + (lane >> 4) * 8);
  const uint32_t b_addr = smem_addr(
      cols + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * SROW + ((lane >> 3) & 1) * 8);
  const uint32_t a_plane = BQ * SROW * 2, b_plane = BL * SROW * 2, b_pair = 16 * SROW * 2;

  float pn = inf;
  if (ntiles > 0) {
    if (nch == 1) load_rows(0);
    issue_cols(0);
    pn = fetch_norm(0);
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    const int ch = tile % nch;
    cp_async_wait_all();
    __syncthreads();   // the stage has landed; the last tile's readers are done
    for (int e = tid; e < BL * K4; e += THREADS) {
      const int r = e / K4, k = (e % K4) * 4;
      split_store<NP>(*reinterpret_cast<const float4*>(stage + r * KC + k),
                      cols + r * SROW + k, cols + (BL + r) * SROW + k);
    }
    if (tid < BL) nrm[tid] = pn;
    if (nch > 1) load_rows(ch * KC);
    __syncthreads();   // the planes are ready; the stage is free
    if (tile + 1 < ntiles) {   // the next tile's copies run under this tile's mmas
      issue_cols(tile + 1);
      pn = fetch_norm(tile + 1);
    }

    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
#pragma unroll 2
    for (int k = 0; k < KC; k += 16) {
      uint32_t ah[4], bh[2][4];
      ldmatrix_x4(ah, a_addr + k * 2);
      ldmatrix_x4(bh[0], b_addr + k * 2);
      ldmatrix_x4(bh[1], b_addr + b_pair + k * 2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[j], ah, bh[j >> 1][(j & 1) * 2], bh[j >> 1][(j & 1) * 2 + 1]);
      if constexpr (NP == 2) {
        uint32_t al[4], bl[2][4];
        ldmatrix_x4(al, a_addr + a_plane + k * 2);
        ldmatrix_x4(bl[0], b_addr + b_plane + k * 2);
        ldmatrix_x4(bl[1], b_addr + b_plane + b_pair + k * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[j], ah, bl[j >> 1][(j & 1) * 2], bl[j >> 1][(j & 1) * 2 + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[j], al, bh[j >> 1][(j & 1) * 2], bh[j >> 1][(j & 1) * 2 + 1]);
      }
    }

    if (ch == nch - 1) {   // fold step m: strict <, never the row's own column
      const int base = (tile / nch) * L + l0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = wn * 32 + j * 8 + 2 * t + (e & 1);
          const int c = base + lc;
          const float s = nrm[lc] - factor * acc[j][e];
          if (s < best_s[j][e] && c != b0 + wm * 16 + g + (e >> 1) * 8) {
            best_s[j][e] = s;
            best_i[j][e] = c;
          }
        }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + wm * 16 + g + (e >> 1) * 8;
      const int l = l0 + wn * 32 + j * 8 + 2 * t + (e & 1);
      if (b < B && l < L) {
        out_s[(long long)b * L + l] = best_s[j][e];
        // -1 where the bin's minimum is not finite, as JAX masks it
        out_i[(long long)b * L + l] = isfinite(best_s[j][e]) ? best_i[j][e] : -1;
      }
    }
}

template <int PREC, bool VEC>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const float* v, const float* vn,
           float* out_s, int* out_i, int B, int D, int L, int KC, int nch, float factor) {
  auto kernel = block_bins_mma_kernel<PREC, VEC>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, stream>>>(v, vn, out_s, out_i, B, D, L, KC, nch, factor);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches kernel D on the tensor cores on `stream`; returns a CUDA error code
// (0 on success). The arguments are those of zvdb_block_bins (csrc/flat_scan.cu):
// v [cc, B, D] f32, vn [cc, B] f32 (+inf marks an invalid slot), out_s
// [cc, B, L] f32, out_i [cc, B, L] int32 column ids within the block; every
// array contiguous on the device. precision: 1 high, 2 default (0, highest,
// is refused: it runs on the CUDA cores). Allocates nothing, does not sync.
extern "C" int zvdb_block_bins_mma(const void* v, const void* vn, void* out_s, void* out_i,
                                   int cc, int B, int D, int L, float factor, int precision,
                                   void* stream) {
  if (cc <= 0 || B <= 0 || L <= 0 || D < 0 || (precision != kHigh && precision != kDefault))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + BQ - 1) / BQ, (L + BL - 1) / BL, cc);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int dp = D < 16 ? 16 : (D + 15) / 16 * 16;
  const int nch = (dp + KMAX - 1) / KMAX;
  const int kc = ((dp + nch - 1) / nch + 15) / 16 * 16;
  const int np = precision == kHigh ? 2 : 1;
  const size_t smem = (size_t)np * (BQ + BL) * (kc + PAD) * 2 + (size_t)BL * kc * 4 + BL * 4;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* nf = static_cast<const float*>(vn);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  if (precision == kHigh)
    return vec ? launch<kHigh, true>(grid, smem, s, vf, nf, os, oi, B, D, L, kc, nch, factor)
               : launch<kHigh, false>(grid, smem, s, vf, nf, os, oi, B, D, L, kc, nch, factor);
  return vec ? launch<kDefault, true>(grid, smem, s, vf, nf, os, oi, B, D, L, kc, nch, factor)
             : launch<kDefault, false>(grid, smem, s, vf, nf, os, oi, B, D, L, kc, nch, factor);
}
