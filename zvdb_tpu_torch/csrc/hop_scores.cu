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
// What bounds it on this card: bytes. Each candidate row is read once and
// used for D multiply-adds (0.25 operations per byte), so the floor is the
// gathered rows over the memory rate: B*K*D*4 bytes, 0.2 ms at the
// experiment's B=4992, K=256, D=128. The TPU version issued one DMA per row
// (~430 ns each) and lost 31x to XLA's hardware gather. A GPU gathers rows
// with ordinary loads, so the design is the plainest one that keeps the
// loads coalesced and enough of them in flight: one warp per (query, run of
// 32 candidates); eight lanes per candidate row and four rows per warp step,
// each lane loading 16 bytes at a time, so every load instruction reads 128
// contiguous bytes of each of four rows (a 128-d row in four such loads);
// the dot is a per-lane FMA sum, then three shuffles over the eight lanes.
// The query row is re-read through L1 for each candidate. At 48 registers
// a thread and no shared memory, 40 warps stay resident per SM, which keeps
// thousands of row loads in flight. D % 4 != 0 or unaligned rows take a
// scalar path with the same order of work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 32;            // candidates per warp
constexpr unsigned FULL = 0xffffffffu;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hop_scores_kernel(const int* __restrict__ idx, const float* __restrict__ q,
                  const float* __restrict__ x, float* __restrict__ out, int B, int K, int N,
                  int D) {
  const int lane = threadIdx.x & 31;
  const int runs = (K + RUN - 1) / RUN;
  const long long warp = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (warp >= (long long)B * runs) return;   // warp-uniform
  const int b = (int)(warp / runs);
  const int j0 = (int)(warp % runs) * RUN;
  const int g = lane >> 3, s = lane & 7;     // row within the step, lane within the row
  const float* qb = q + (long long)b * D;
#pragma unroll 2
  for (int step = 0; step < RUN / 4; ++step) {
    const int j = j0 + 4 * step + g;
    const int id = (j < K) ? __ldg(idx + (long long)b * K + j) : 0;
    const bool ok = id >= 0 && id < N;
    float acc = 0.f;
    if (j < K && ok) {
      const float* xr = x + (long long)id * D;
      if constexpr (VEC) {
        const float4* q4 = reinterpret_cast<const float4*>(qb);
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        for (int f = s; f < D / 4; f += 8) {
          const float4 a = __ldg(q4 + f);
          const float4 v = __ldg(x4 + f);
          acc = fmaf(a.x, v.x, acc);
          acc = fmaf(a.y, v.y, acc);
          acc = fmaf(a.z, v.z, acc);
          acc = fmaf(a.w, v.w, acc);
        }
      } else {
        for (int d = s; d < D; d += 8) acc = fmaf(__ldg(qb + d), __ldg(xr + d), acc);
      }
    }
    acc += __shfl_xor_sync(FULL, acc, 4);
    acc += __shfl_xor_sync(FULL, acc, 2);
    acc += __shfl_xor_sync(FULL, acc, 1);
    if (s == 0 && j < K) out[(long long)b * K + j] = ok ? acc : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// Kernel G on `stream`; returns a CUDA error code (0 on success).
// idx [B, K] int32, q [B, D] f32, x [N, D] f32, out [B, K] f32, all contiguous
// on the device. Allocates nothing, does not sync.
extern "C" int zvdb_hop_scores(const void* idx, const void* q, const void* x, void* out, int B,
                               int K, int N, int D, void* stream) {
  if (B < 0 || K < 0 || N < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  const long long warps = (long long)B * ((K + RUN - 1) / RUN);
  const long long blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (vec)
    hop_scores_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(ip, qf, xf, o, B, K, N, D);
  else
    hop_scores_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(ip, qf, xf, o, B, K, N, D);
  return (int)cudaGetLastError();
}
