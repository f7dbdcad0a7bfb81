// Fused ELL relax (gather + mask + row min) for sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel relax_ell (src/repro/kernels/relax.py)
// together with the gather and mask that ops.relax_ell did around it:
//
//     out[b, i] = min_j  (s < n && src_mask[b, s]) ? x[b, s] + in_w[i, j]
//                                                  : +inf,
//     s = in_src[i, j],   for rows i < n and lanes b < B.
//
// The TPU kernel takes pre-gathered d_src/mask operands [n_pad, deg_pad]
// and carries the running row minimum across ordered column blocks in
// VMEM.  Here one warp owns a row: its 32 threads stride over the row's
// deg_pad cells, gather x and src_mask themselves, and a warp-shuffle
// min ends the row, so nothing carries across blocks and the [B, n_pad,
// deg_pad] operands are never written to device memory (at B = 8,
// n = 2^20, deg_pad = 128 they would be about 5.4 GB a call).  Lanes go
// in groups of kGroup so one load of a row's in_src/in_w serves
// kGroup lanes.
//
// Exactness: each candidate is one IEEE add (__fadd_rn, never contracted)
// and min is exact, so the result is bitwise the plain version's.
//
// Bound on an H100: bytes.  in_src and in_w are 8 B per cell and are read
// once a call; at the gnp n = 2^20 shape (deg_pad 128, mean in-degree 8)
// 15/16 of those cells are padding, which this simple kernel still reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps, 8 rows per block
constexpr int kGroup = 8;                // lanes per pass over a row

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void relax_ell_kernel(const float* __restrict__ x,
                                 const bool* __restrict__ src_mask,
                                 const int* __restrict__ in_src,
                                 const float* __restrict__ in_w,
                                 float* __restrict__ out, int lanes, int n,
                                 int deg) {
  const int lane_id = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float inf = __int_as_float(0x7f800000);
  for (long long row = warp; row < n; row += warps) {
    const int* srow = in_src + row * deg;
    const float* wrow = in_w + row * deg;
    for (int b0 = 0; b0 < lanes; b0 += kGroup) {
      float acc[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) acc[g] = inf;
      for (int j = lane_id; j < deg; j += 32) {
        const int s = srow[j];
        if (s < 0 || s >= n) continue;       // padding cell
        const float w = wrow[j];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int b = b0 + g;
          if (b < lanes) {
            const long long at = (long long)b * n + s;
            if (src_mask[at]) acc[g] = fminf(acc[g], __fadd_rn(x[at], w));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float m = warp_min(acc[g]);
        const int b = b0 + g;
        if (lane_id == 0 && b < lanes) out[(long long)b * n + row] = m;
      }
    }
  }
}

}  // namespace

extern "C" int relax_ell(const float* x, const bool* src_mask,
                         const int* in_src, const float* in_w, float* out,
                         int lanes, int n, int deg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes > 0 && n > 0) {
    const int rows_per_block = kThreads / 32;
    long long blocks = ((long long)n + rows_per_block - 1) / rows_per_block;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
    relax_ell_kernel<<<(int)blocks, kThreads, 0, s>>>(
        x, src_mask, in_src, in_w, out, lanes, n, deg);
  }
  return (int)cudaGetLastError();
}
