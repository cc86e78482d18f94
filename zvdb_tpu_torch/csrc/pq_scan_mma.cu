// Fused 4-bit PQ (ADC) scan with a per-query top-1/top-2 bin fold, int8, on
// Hopper's tensor cores (sm_90a): kernel B's int8 route.
//
// Replaces zvdb_tpu/ops/pallas_pq.py:_pq_kernel (wrapper pq_scan_bins) in its
// int8 mode, and the CUDA-core version of kernel B (csrc/pq_scan.cu,
// zvdb_pq_scan_bins), which keeps "default" and "high". The function is that
// kernel's: codes are nibble-packed and transposed, codes_t [S/2, N], byte j
// of row c holding subspace 2j in its low nibble and 2j+1 in its high nibble;
// the table lut [B, S, 16] arrives quantized to int8 with a per-query scale,
// and for query b the score of row c is
//
//     sum = sum_s lut[b, s, code(c, s)]                        (int32, exact)
//     s   = norms[c] - f * (float(sum) * scale[b])             (f = 2 for l2, 1 otherwise)
//
// with norms of +inf marking invalid rows. Row c belongs to segment
// c / seg_len and bin c % L; each (query, segment, bin) keeps its best row
// (PER_BIN = 1) or its best two (PER_BIN = 2): out[b, seg*PER_BIN*L + l]
// holds the best, out[b, seg*PER_BIN*L + L + l] the runner-up, -1 / +inf
// where a bin saw fewer valid rows. The scores equal the plain version's
// bit for bit: the integer sum is exact in any order, float(sum) is taken by
// the magic-number add (exact for |sum| < 2**22; |sum| <= 127 * 256 here),
// dots = rn(float(sum) * scale), and s = fma(-f, dots, n) = rn(n - f * dots)
// because f * dots is exact for f in {1, 2}.
//
// What the TPU kernel does, and what this one does. The Pallas kernel builds
// a one-hot of the codes in VMEM and runs one int8 MXU product,
// lut[bq, S*16] @ onehot[S*16, chunk]. Here the product is
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 with the table as A and the
// one-hot as B, k = s*16 + code in the table's natural order, so one k32 step
// covers subspaces 2j and 2j+1: exactly the two nibbles of code byte j. The
// one-hot never exists in memory: in the m16n8k32 B fragment a thread holds
// column n = lane/4 at k = 4*(lane%4) + 0..3 in one register and the same
// k + 16 in the other, so each register is the one-hot of one nibble against
// a 4-code window, 1 << (8*nibble - 32*(lane%4)), zero where the shift leaves
// [0, 32) (PTX shl clamps; C++ << is undefined past 31). The shift amounts of
// four k32 steps are made at once, one per byte of a 32-bit word, by a
// borrow-free byte-wise subtract.
//
// What bounds it. At the pq_1m shape (B=2048, N=1M, S=16) the one-hot
// product is 2*B*N*S*16 = 1.07e12 int8 operations, 0.53 ms at 1979 TOP/s;
// the bytes (codes N*S/2, norms, table, the B x n_seg*PER_BIN*L outputs)
// take ~0.014 ms at 3.35 TB/s. The fold is a third term outside the tensor
// cores: each of the B*N = 2.05e9 scores costs 9 CUDA-core instructions
// (the float conversion, scale and fma; two compares; four selects at
// per_bin=2), 0.55 ms at 132 SMs x 128 lanes x 1.98 GHz: the bound is the
// larger term, the fold's, just above the mmas'. The one-hot build adds two
// integer instructions per B register (a byte extract and the shift), and
// Hopper issues integer instructions at half the f32 rate. So the fold and
// the build, not the mmas, bind, as the copy, split and fold did in kernel
// D (block_bins.cu).
//
// What the design does about it.
//   * Walk (kernel D's). A block owns a tile of BQ = 256 queries, a slice of
//     BL = 8 bins and one segment (blockIdx.z), and walks rows
//     c = seg*seg_len + m*L + l, l in its slice, in increasing m. Each of the
//     8 warps owns 32 queries (two m16 tiles) x the block's 8 bins. Nothing
//     carries between blocks: no atomics, no merge pass, no scratch memory.
//   * Passes of STEPS_MAX = 4 steps. The fold state belongs to a (query,
//     bin), not to a step, so a warp runs four steps' products at once with
//     no more state: each table fragment read feeds 2 x 4 mmas, each one-hot
//     B fragment built feeds the two m16 tiles. Registers bound the rest:
//     the fold state, 32 accumulators and the fragments fit the 128 that two
//     blocks per SM allow; taller or wider warp tiles spilled or halved the
//     blocks per SM and were slower.
//   * A operand. The query tile's int8 table is constant for the whole walk:
//     it loads once into shared memory ([BQ][S*16 + 16] bytes, the padding
//     putting the eight rows of an ldmatrix 8x8 read in eight 16-byte bank
//     groups) and is read with ldmatrix.x4. A table deeper than KMAX bytes
//     (S > 32) is walked in chunks, one step per pass, and then each chunk is
//     reloaded at every step.
//   * B operand. The code bytes of a group of up to 32 steps are loaded into
//     registers a whole group ahead, during the previous group's mmas, and
//     stored transposed as [row][S/2] bytes in one of two staging buffers, so
//     a thread reads the code bytes of four k32 steps of its column as one
//     32-bit word; one barrier per group. The steps' norms ride along.
//   * Fold, in registers. In m16n8k32 a thread holds c0, c1 at query g,
//     columns 2t, 2t+1 and c2, c3 at query g + 8 (g = lane/4, t = lane%4). A
//     column's bin is fixed across steps, so each thread keeps (s1, i1, s2,
//     i2) for exactly its own 8 accumulator positions. One thread folds each
//     (query, bin) in increasing m, the steps of a pass in order, with the
//     TPU's rules as selects, so the lower row wins a tie and an equal score
//     lands in slot 2; rows c and c + L sit in the same lane and register,
//     so duplicated codes score equal bit for bit.
//   * Ragged edges. Missing queries load zero table rows and are not
//     written; missing rows (past N, the segment, the last bin or the last
//     step) get +inf norms and are never taken; a chunk's k past S*16 loads
//     zeros. Nothing is padded in device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 2;                 // m16 query tiles per warp
constexpr int NT = 1;                 // n8 bin tiles per warp
constexpr int WB = 1;                 // warps across the bins (the rest across the queries)
constexpr int STEPS_MAX = 4;          // steps walked per pass, sharing each table fragment
constexpr int MIN_BLOCKS = 2;         // blocks per SM that the registers must allow
constexpr int WARPS = 8;
constexpr int WQ = WARPS / WB;
constexpr int BQ = WQ * 16 * MT;      // queries per block
constexpr int BL = WB * 8 * NT;       // bins per block
constexpr int THREADS = WARPS * 32;
constexpr int KMAX = 131072 / BQ;     // deepest chunk of the table (bytes per query) in smem
constexpr int LPAD = 16;              // bytes of padding per table row
constexpr int MAX_GROUP = 32;         // tiles whose codes load together
constexpr int MAX_ITEMS = 4;          // code words per thread per group: group * BL * NW <= 4 * THREADS
constexpr int MAX_NORMS = (MAX_GROUP * BL + THREADS - 1) / THREADS;   // norms per thread per group
constexpr int kInt8 = 2;              // the precision code of the CUDA-core entry point
// Accumulators start at the bits of 1.5 * 2**23: adding an integer |x| < 2**22
// keeps the exponent, so the bits read as the float 12582912 + x, exactly.
constexpr int MAGIC = 0x4B400000;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one m16n8k32 tile: a row-major 16x32 int8, b column-major 32x8 int8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One byte of a one-hot register: 1 << s, or 0 for any s >= 32 (PTX shl clamps).
__device__ __forceinline__ uint32_t onehot(uint32_t s) {
  uint32_t d;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(d) : "r"(1u), "r"(s));
  return d;
}

// Shift amounts of four k32 steps from a word of four code bytes: byte i of
// the result is (8 * nibble_i - 32 * t) mod 256, nibble_i the low (HI = false)
// or high nibble of byte i. Offsetting every byte by 128 keeps the subtract
// from borrowing across bytes; a negative amount becomes >= 160, which the
// shift clamps to zero like any amount >= 32.
template <bool HI>
__device__ __forceinline__ uint32_t shift_amounts(uint32_t w, uint32_t tsub) {
  const uint32_t x8 = ((HI ? w >> 1 : w << 3) & 0x78787878u) | 0x80808080u;
  return (x8 - tsub) ^ 0x80808080u;
}

// Fold row c's score into one bin's best (and runner-up), the TPU's rules
// (take1 = s < s1; take2 = !take1 && s < s2), written as selects: s1 <= s2
// always, so s < s2 holds whenever take1 does.
template <int PER_BIN>
__device__ __forceinline__ void fold_row(float s, int c, float& s1, int& i1, float& s2,
                                         int& i2) {
  const bool take1 = s < s1;
  if constexpr (PER_BIN == 2) {
    const bool take2 = s < s2;
    s2 = take1 ? s1 : (take2 ? s : s2);
    i2 = take1 ? i1 : (take2 ? c : i2);
  }
  s1 = take1 ? s : s1;
  i1 = take1 ? c : i1;
}

// Shared memory (dynamic): table [BQ][KC + LPAD] int8, codes [2][GP][BL][SW]
// words, norms [2][GP][BL] f32. KC is a multiple of 128: NW = KC / 128 words
// of four code bytes per row and chunk. GP tiles form a group (GP = 1 when
// the table is chunked). NWC > 0 fixes NW at compile time (the engines' S = 16
// has NW = 2), so the word loop unrolls.
template <int PER_BIN, int STEPS, int NWC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pq_scan_mma_kernel(const int8_t* __restrict__ lut, const float* __restrict__ scales,
                   const uint8_t* __restrict__ codes_t, const float* __restrict__ norms,
                   float* __restrict__ out_s, int* __restrict__ out_i, int B, int N,
                   int n_sub, int L, long long seg_len, int KC, int nch, int GP,
                   float factor) {
  const int LROW = KC + LPAD;
  const int NW = NWC > 0 ? NWC : KC / 128;
  const int SW = NW | 1;   // odd: the eight rows of a fragment read hit eight banks
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* lut_s = reinterpret_cast<int8_t*>(smem);
  uint32_t* code_s = reinterpret_cast<uint32_t*>(smem + BQ * LROW);
  float* nrm_s = reinterpret_cast<float*>(code_s + 2 * GP * BL * SW);

  const float inf = __int_as_float(0x7f800000);
  const int K = n_sub * 16;   // table bytes per query
  const int nb = n_sub / 2;   // code bytes per row
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wq = warp % WQ, wb = warp / WQ;   // query group, bin group
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * BQ;
  const int l0 = blockIdx.y * BL;
  const long long seg_lo = (long long)blockIdx.z * seg_len;
  const long long rows = seg_len < N - seg_lo ? seg_len : N - seg_lo;   // rows of the segment
  const int nsteps = l0 < rows ? (int)((rows - l0 + L - 1) / L) : 0;
  const int ntiles = nsteps * nch;   // (step, table chunk) pairs
  const int ngroups = (ntiles + GP - 1) / GP;
  const int NWT = BL * NW;           // code words per tile

  // the table's chunk at byte k0, zeros past B and K
  auto load_lut = [&](int k0) {
    const int V = KC / 16;
    for (int e = tid; e < BQ * V; e += THREADS) {
      const int r = e / V, k = k0 + (e % V) * 16;
      int4 x = make_int4(0, 0, 0, 0);
      if (b0 + r < B && k < K)
        x = __ldg(reinterpret_cast<const int4*>(lut + (long long)(b0 + r) * K + k));
      *reinterpret_cast<int4*>(lut_s + r * LROW + (e % V) * 16) = x;
    }
  };
  // group `grp`'s code words (tile e / NWT of the group, row e % BL, bytes
  // 4*(e % NWT / BL) .. + 3 of the tile's chunk) and norms (tile e / BL, row
  // e % BL), into registers; zeros and +inf where missing
  uint32_t pw[MAX_ITEMS];
  float pn[MAX_NORMS];
  auto fetch = [&](int grp) {
#pragma unroll
    for (int it = 0; it < MAX_ITEMS; ++it) {
      const int e = tid + it * THREADS;
      const int tile = grp * GP + e / NWT, r = e % BL, wi = e % NWT / BL;
      const long long row = (long long)(tile / nch) * L + l0 + r;   // within the segment
      const int j = (tile % nch) * (KC / 32) + 4 * wi;              // first code byte
      uint32_t w = 0;
      if (e < GP * NWT && tile < ntiles && l0 + r < L && row < rows) {
        const uint8_t* p = codes_t + (long long)j * N + seg_lo + row;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j + i < nb) w |= (uint32_t)__ldg(p + (long long)i * N) << (8 * i);
      }
      pw[it] = w;
    }
#pragma unroll
    for (int it = 0; it < MAX_NORMS; ++it) {
      const int e = tid + it * THREADS;
      const int tile = grp * GP + e / BL, r = e % BL;
      const long long row = (long long)(tile / nch) * L + l0 + r;
      pn[it] = (e < GP * BL && tile < ntiles && l0 + r < L && row < rows)
                   ? __ldg(norms + seg_lo + row) : inf;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int it = 0; it < MAX_ITEMS; ++it) {
      const int e = tid + it * THREADS;
      if (e < GP * NWT)
        code_s[((buf * GP + e / NWT) * BL + e % BL) * SW + e % NWT / BL] = pw[it];
    }
#pragma unroll
    for (int it = 0; it < MAX_NORMS; ++it) {
      const int e = tid + it * THREADS;
      if (e < GP * BL) nrm_s[buf * GP * BL + e] = pn[it];
    }
  };

  float s1[MT][NT][4], s2[MT][NT][4];
  int i1[MT][NT][4], i2[MT][NT][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1[u][j][e] = inf;
        s2[u][j][e] = inf;
        i1[u][j][e] = -1;
        i2[u][j][e] = -1;
      }
  int acc[STEPS][MT][NT][4];
  const int q0 = b0 + wq * 16 * MT + g;   // this thread's queries: q0 + 16*u + 8*h
  float scale[MT][2];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + 16 * u + 8 * h;
      scale[u][h] = q < B ? __ldg(scales + q) : 0.f;
    }

  // ldmatrix address of this lane: query wq*16*MT + lane%16 at k + 16*(lane/16);
  // m16 tile u adds 16*u rows
  const uint32_t a_addr =
      smem_addr(lut_s + (wq * 16 * MT + (lane & 15)) * LROW + (lane >> 4) * 16);
  const uint32_t tsub = (uint32_t)(32 * t) * 0x01010101u;
  const int crow = (wb * 8 * NT + g) * SW;   // this lane's column in n8 tile 0; tile j adds 8*j rows

  if (ntiles > 0) {
    if (nch == 1) load_lut(0);
    fetch(0);
    stash(0);
  }
  __syncthreads();
  if (ngroups > 1) fetch(1);   // in flight under group 0's mmas
  // the shift amounts of code word w of each step's n8 tiles' columns
  uint32_t lo[STEPS][NT], hi[STEPS][NT];
  auto words = [&](const uint32_t* cs, int w) {
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t cw = cs[(st * BL + 8 * j) * SW + w];
        lo[st][j] = shift_amounts<false>(cw, tsub);
        hi[st][j] = shift_amounts<true>(cw, tsub);
      }
  };

  // A pass walks STEPS steps (tiles pos .. pos + STEPS - 1 of the group; a
  // step past the last has +inf norms) or, with a chunked table, one chunk.
  int grp = 0, pos = 0;                 // the pass's group and its place in the group
  int base = (int)(seg_lo + l0);        // row of the first step's first column
  for (int m = 0; m < nsteps; m += STEPS, base += STEPS * L) {
    for (int ch = 0; ch < nch; ++ch) {
      const int slot = (grp & 1) * GP + pos;   // the first step's codes and norms
      if (nch > 1) {   // GP = 1: the last tile's mmas are done (barrier below)
        load_lut(ch * KC);
        __syncthreads();
      }
      if (ch == 0) {
#pragma unroll
        for (int st = 0; st < STEPS; ++st)
#pragma unroll
          for (int u = 0; u < MT; ++u)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[st][u][j][e] = MAGIC;
      }
      const uint32_t* cs = code_s + slot * BL * SW + crow;
#pragma unroll 2
      for (int w = 0; w < NW; ++w) {   // four k32 steps per code word
        words(cs, w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[MT][4];
#pragma unroll
          for (int u = 0; u < MT; ++u)
            ldmatrix_x4(a[u], a_addr + u * 16 * LROW + (w * 4 + i) * 32);
#pragma unroll
          for (int st = 0; st < STEPS; ++st)
#pragma unroll
            for (int j = 0; j < NT; ++j) {   // B fragments built once, used by MT mmas
              const uint32_t blo = onehot(__byte_perm(lo[st][j], 0u, 0x4440 + i));
              const uint32_t bhi = onehot(__byte_perm(hi[st][j], 0u, 0x4440 + i));
#pragma unroll
              for (int u = 0; u < MT; ++u) mma_s8(acc[st][u][j], a[u], blo, bhi);
            }
        }
      }

      if (ch == nch - 1) {   // fold the steps in order, in the plain version's float steps
#pragma unroll
        for (int st = 0; st < STEPS; ++st)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int lc = wb * 8 * NT + j * 8 + 2 * t;
            const float2 nrm =
                *reinterpret_cast<const float2*>(nrm_s + (slot + st) * BL + lc);
            const int c = base + st * L + lc;
#pragma unroll
            for (int u = 0; u < MT; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float sum = __fsub_rn(__int_as_float(acc[st][u][j][e]), 12582912.f);
                const float dots = __fmul_rn(sum, scale[u][e >> 1]);
                const float s = __fmaf_rn(-factor, dots, (e & 1) ? nrm.y : nrm.x);
                fold_row<PER_BIN>(s, c + (e & 1), s1[u][j][e], i1[u][j][e], s2[u][j][e],
                                  i2[u][j][e]);
              }
          }
      }
      pos += STEPS;
      if (pos == GP || (m + STEPS >= nsteps && ch == nch - 1)) {   // the group's end
        if (grp + 1 < ngroups) stash((grp + 1) & 1);   // the other buffer: read by group grp - 1
        __syncthreads();
        if (grp + 2 < ngroups) fetch(grp + 2);         // in flight under group grp + 1
        ++grp;
        pos = 0;
      }
    }
  }

  const int lw = PER_BIN * L;
  const long long width = (long long)gridDim.z * lw;
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = q0 + 16 * u + (e >> 1) * 8;
        const int l = l0 + wb * 8 * NT + j * 8 + 2 * t + (e & 1);
        if (b < B && l < L) {
          const long long o = (long long)b * width + (long long)blockIdx.z * lw + l;
          out_s[o] = s1[u][j][e];
          out_i[o] = i1[u][j][e];
          if constexpr (PER_BIN == 2) {
            out_s[o + L] = s2[u][j][e];
            out_i[o + L] = i2[u][j][e];
          }
        }
      }
}

template <int PER_BIN, int STEPS, int NWC>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const int8_t* lut, const float* scales,
           const uint8_t* codes_t, const float* norms, float* out_s, int* out_i, int B, int N,
           int n_sub, int L, long long seg_len, int KC, int nch, int gp, float factor) {
  auto kernel = pq_scan_mma_kernel<PER_BIN, STEPS, NWC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, stream>>>(lut, scales, codes_t, norms, out_s, out_i, B, N,
                                          n_sub, L, seg_len, KC, nch, gp, factor);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches kernel B's int8 route on the tensor cores on `stream`; returns a
// CUDA error code (0 on success). The arguments are those of
// zvdb_pq_scan_bins (csrc/pq_scan.cu): lut [B, S, 16] int8 (16-byte
// aligned); scales [B] f32; codes_t [S/2, N] uint8; norms [N] f32; out_s
// [B, n_seg*per_bin*L] f32, out_i the same int32; every array contiguous on
// the device. Segment z covers rows [z*seg_len, (z+1)*seg_len). precision
// must be 2 (int8); S a multiple of 8 up to 256. Allocates nothing, does
// not sync.
extern "C" int zvdb_pq_scan_bins_mma(const void* lut, const void* scales, const void* codes_t,
                                     const void* norms, void* out_s, void* out_i, int B, int N,
                                     int n_sub, int L, long long seg_len, int n_seg,
                                     float factor, int precision, int per_bin, void* stream) {
  if (B <= 0 || N < 0 || L <= 0 || n_sub <= 0 || n_sub % 8 != 0 || n_sub > 256 ||
      seg_len <= 0 || n_seg <= 0 || n_seg > 65535 || precision != kInt8 || per_bin < 1 ||
      per_bin > 2 || reinterpret_cast<uintptr_t>(lut) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + BQ - 1) / BQ, (L + BL - 1) / BL, n_seg);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int K = n_sub * 16;
  const int nch = (K + KMAX - 1) / KMAX;
  const int kc = ((K + nch - 1) / nch + 127) / 128 * 128;
  const int sw = (kc / 128) | 1;
  // tiles per group: as many as MAX_ITEMS words a thread can carry, at most MAX_GROUP
  const int words = BL * (kc / 128);
  int gp = nch > 1 ? 1 : MAX_ITEMS * THREADS / words;
  gp = gp < 1 ? 1 : (gp > MAX_GROUP ? MAX_GROUP : gp);
  // steps per pass: STEPS_MAX where a group holds a multiple of them
  const bool multi = nch == 1 && gp >= STEPS_MAX;
  if (multi) gp = gp / STEPS_MAX * STEPS_MAX;
  const size_t smem =
      (size_t)BQ * (kc + LPAD) + (size_t)2 * gp * BL * sw * 4 + (size_t)2 * gp * BL * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* l8 = static_cast<const int8_t*>(lut);
  const float* scl = static_cast<const float*>(scales);
  const uint8_t* c = static_cast<const uint8_t*>(codes_t);
  const float* nr = static_cast<const float*>(norms);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
#define ZVDB_LAUNCH(PB, ST, NWC)                                                        \
  launch<PB, ST, NWC>(grid, smem, s, l8, scl, c, nr, os, oi, B, N, n_sub, L, seg_len, kc, \
                      nch, gp, factor)
  const bool nw2 = multi && kc == 256;
  if (per_bin == 1)
    return nw2 ? ZVDB_LAUNCH(1, STEPS_MAX, 2)
               : multi ? ZVDB_LAUNCH(1, STEPS_MAX, 0) : ZVDB_LAUNCH(1, 1, 0);
  return nw2 ? ZVDB_LAUNCH(2, STEPS_MAX, 2)
             : multi ? ZVDB_LAUNCH(2, STEPS_MAX, 0) : ZVDB_LAUNCH(2, 1, 0);
#undef ZVDB_LAUNCH
}
