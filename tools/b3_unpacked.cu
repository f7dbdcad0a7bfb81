// The unpacked variant of the port's ELL relax (B3), for timing only:
// src/repro_torch/kernels/csrc/relax.cu with its lane pre-pass left out,
// so each live cell reads x[b, s] and src_mask[b, s] in place, in the
// [B, n] layout.  Same function, same row extent (row_len), same groups
// of 8 threads a row and the same exact arithmetic (__fadd_rn, fminf).
// Built and timed against the port's kernel by tools/b3_lane_variants.py;
// no code path of the port uses it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr int kRowsPerWarp = 32 / kGroup;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

template <int W>
__device__ __forceinline__ void group_min(float (&acc)[W], int g) {
  if constexpr (W == 1) {
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
      acc[0] = fminf(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], off));
    }
  } else {
#pragma unroll
    for (int half = W / 2; half >= 1; half >>= 1) {
      const bool upper = (g & half) != 0;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float keep = upper ? acc[k + half] : acc[k];
        const float send = upper ? acc[k] : acc[k + half];
        acc[k] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, half));
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, W == 1 ? 8 : 5)
relax_unpacked(const float* __restrict__ x, const bool* __restrict__ src_mask,
               const int* __restrict__ in_src, const float* __restrict__ in_w,
               const int* __restrict__ row_len, float* __restrict__ out,
               int lanes, int n, int deg) {
  const int lane_id = threadIdx.x & 31;
  const int g = lane_id & (kGroup - 1);
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r0 = warp * kRowsPerWarp; r0 < n;
       r0 += warps * kRowsPerWarp) {
    const long long row = r0 + lane_id / kGroup;
    const bool live_row = row < n;
    const int* srow = in_src + row * deg;
    const float* wrow = in_w + row * deg;
    int len = 0, s0 = -1;
    float w0 = 0.0f;
    if (live_row) {
      len = min(row_len[row], deg);
      if (g < deg) {
        s0 = srow[g];
        w0 = wrow[g];
      }
    }
    for (int c0 = 0; c0 < lanes; c0 += W) {
      float acc[W];
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = inf_f();
      for (int j = g; j < len; j += kGroup) {
        const int s = j == g ? s0 : srow[j];
        if (s < 0 || s >= n) continue;
        const float w = j == g ? w0 : wrow[j];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int b = c0 + k;
          if (b < lanes) {
            const long long at = (long long)b * n + s;
            if (src_mask[at]) acc[k] = fminf(acc[k], __fadd_rn(x[at], w));
          }
        }
      }
      group_min<W>(acc, g);
      const int b = c0 + g;
      if (live_row && g < W && b < lanes) out[(long long)b * n + row] = acc[0];
    }
  }
}

int blocks_for(long long threads) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" int relax_ell_unpacked(const float* x, const bool* src_mask,
                                  const int* in_src, const float* in_w,
                                  const int* row_len, float* out, int lanes,
                                  int n, int deg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for((long long)n * kGroup);
  if (lanes == 1) {
    relax_unpacked<1><<<blocks, kThreads, 0, s>>>(x, src_mask, in_src, in_w,
                                                   row_len, out, lanes, n,
                                                   deg);
  } else if (lanes > 1) {
    relax_unpacked<kGroup><<<blocks, kThreads, 0, s>>>(
        x, src_mask, in_src, in_w, row_len, out, lanes, n, deg);
  }
  return (int)cudaGetLastError();
}
