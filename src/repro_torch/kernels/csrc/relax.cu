// Fused ELL relax (gather + mask + row min) for sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel relax_ell (src/repro/kernels/relax.py:44)
// together with the gather and mask that ops.relax_ell did around it:
//
//     out[b, i] = min_j  (s < n && src_mask[b, s]) ? x[b, s] + in_w[i, j]
//                                                  : +inf,
//     s = in_src[i, j],   for rows i < n and lanes b < B (x = 0 if x_zero).
//
// The TPU kernel streams whole [n_pad, deg_pad] blocks through VMEM and
// carries the running row minimum across ordered column blocks.  On an
// H100 the bound is bytes, and read that way most of them are padding: at
// gnp n = 2^20 (deg_pad 128, mean in-degree 8) 15/16 of the cells, at a
// grid (in-degree <= 4) 31/32.  So:
//
//  * Row extent.  Row i is read only over [0, row_len[i]) (EllGraph.
//    row_len: one past its last cell with in_src < n), and s >= n is
//    still masked inside that range, so any cell order is right.
//  * Thread groups sized to the degree.  kGroup = 8 threads serve a row,
//    4 rows a warp: at gnp that is one live cell a thread on average and
//    a row's first 8 cells are one 32-byte sector of in_src and one of
//    in_w.  Longer rows loop in steps of 8; a 3-step xor-shuffle ends the
//    row (a reduce-scatter when 8 lanes are in flight: 7 shuffles, and
//    thread g ends holding lane g's minimum, which it stores).
//  * Lane packing.  A pre-pass writes xm[v, b] = src_mask[b, v] ? x[b, v]
//    : +inf vertex-major, the lanes padded to a multiple of 8 (1 at
//    B = 1), so a live cell gathers its lanes from one 32-byte sector
//    instead of 2 B scattered reads of x and src_mask in the [B, n]
//    layout, and the gather does not wait on the mask.  Folding the mask
//    into +inf is exact: w > 0 on every live cell, so +inf + w = +inf,
//    the masked candidate.  At B = 1 the pre-pass (4 MB written at
//    n = 2^20) also measured faster than reading x and src_mask in place.
//  * x_zero (inWeight_nf): x is not read, the pack is mask ? 0 : +inf.
//  * Latency.  A thread's first cell is loaded beside the row's extent,
//    and the B = 1 relax is held to 32 registers (8 blocks an SM), since
//    the dependent loads (extent or cell, then xm) bound it, not bytes.
//
// Exactness: each candidate is one IEEE add (__fadd_rn, never contracted)
// and min is exact and order-free, so the result is bitwise the plain
// version's (ref.relax_ell_ref).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                  // threads a row
constexpr int kRowsPerWarp = 32 / kGroup;  // 4

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Min over the 8 threads of a group, W values a thread.  W == 1: every
// thread ends with the minimum.  W == 8: a reduce-scatter; thread g of the
// group ends with the minimum of value g in acc[0].
template <int W>
__device__ __forceinline__ void group_min(float (&acc)[W], int g) {
  if constexpr (W == 1) {
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
      acc[0] = fminf(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], off));
    }
  } else {
    static_assert(W == kGroup, "the reduce-scatter pairs lanes with threads");
#pragma unroll
    for (int half = W / 2; half >= 1; half >>= 1) {
      const bool upper = (g & half) != 0;  // keep values [half, 2 half)
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float keep = upper ? acc[k + half] : acc[k];
        const float send = upper ? acc[k] : acc[k + half];
        acc[k] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, half));
      }
    }
  }
}

// xm[v * stride + b] = (b < lanes && src_mask[b, v]) ? x[b, v] : +inf for
// the W-lane chunk c of vertex v; one thread a (chunk, vertex), vertices
// fastest so the reads of each lane are coalesced.
template <int W>
__global__ void pack_lanes(const float* __restrict__ x,
                           const bool* __restrict__ src_mask,
                           float* __restrict__ xm, int lanes, int n,
                           int stride, bool x_zero) {
  const long long total = (long long)(stride / W) * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i / n);
    const long long v = i - (long long)c * n;
    float val[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int b = c * W + k;
      val[k] = inf_f();
      if (b < lanes) {
        const long long at = (long long)b * n + v;
        if (src_mask[at]) val[k] = x_zero ? 0.0f : x[at];
      }
    }
    float* dst = xm + v * stride + c * W;
    if constexpr (W == 1) {
      dst[0] = val[0];
    } else {
#pragma unroll
      for (int k = 0; k < W; k += 4) {
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(val[k], val[k + 1], val[k + 2], val[k + 3]);
      }
    }
  }
}

// One group of kGroup threads a row, W lanes of xm (stride floats a
// vertex) at a time.
template <int W>
__global__ void __launch_bounds__(kThreads, W == 1 ? 8 : 5)
relax_ell_kernel(const float* __restrict__ xm, const int* __restrict__ in_src,
                 const float* __restrict__ in_w,
                 const int* __restrict__ row_len, float* __restrict__ out,
                 int lanes, int n, int deg, int stride) {
  const int lane_id = threadIdx.x & 31;
  const int g = lane_id & (kGroup - 1);
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // the loop runs alike for the whole warp, so the shuffles see all 32
  for (long long r0 = warp * kRowsPerWarp; r0 < n;
       r0 += warps * kRowsPerWarp) {
    const long long row = r0 + lane_id / kGroup;
    const bool live_row = row < n;
    const int* srow = in_src + row * deg;
    const float* wrow = in_w + row * deg;
    // the thread's first cell is loaded beside the extent, not after it
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
        if (s < 0 || s >= n) continue;       // padding cell
        const float w = j == g ? w0 : wrow[j];
        const float* p = xm + (long long)s * stride + c0;
        if constexpr (W == 1) {
          acc[0] = fminf(acc[0], __fadd_rn(p[0], w));
        } else {
#pragma unroll
          for (int k = 0; k < W; k += 4) {
            const float4 q = *reinterpret_cast<const float4*>(p + k);
            acc[k] = fminf(acc[k], __fadd_rn(q.x, w));
            acc[k + 1] = fminf(acc[k + 1], __fadd_rn(q.y, w));
            acc[k + 2] = fminf(acc[k + 2], __fadd_rn(q.z, w));
            acc[k + 3] = fminf(acc[k + 3], __fadd_rn(q.w, w));
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
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  return blocks < 1 ? 1 : (int)blocks;
}

template <int W>
void launch(const float* x, const bool* src_mask, const int* in_src,
            const float* in_w, const int* row_len, float* xm, float* out,
            int lanes, int n, int deg, bool x_zero, int stride,
            cudaStream_t s) {
  pack_lanes<W><<<blocks_for((long long)(stride / W) * n), kThreads, 0, s>>>(
      x, src_mask, xm, lanes, n, stride, x_zero);
  relax_ell_kernel<W><<<blocks_for((long long)n * kGroup), kThreads, 0, s>>>(
      xm, in_src, in_w, row_len, out, lanes, n, deg, stride);
}

}  // namespace

// x may be null when x_zero; row_len is required (deg_pad reads a whole
// row); xm is float32[n * xm_stride] scratch for the packed lanes,
// xm_stride 1 at lanes == 1, else a multiple of 8 that is >= lanes.
extern "C" int relax_ell(const float* x, const bool* src_mask,
                         const int* in_src, const float* in_w,
                         const int* row_len, float* xm, float* out,
                         int lanes, int n, int deg, int x_zero,
                         int xm_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok_stride =
      lanes == 1 ? xm_stride == 1
                 : xm_stride % kGroup == 0 && xm_stride >= lanes;
  if (!ok_stride || (x == nullptr && !x_zero) || row_len == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (lanes > 0 && n > 0) {
    if (lanes == 1) {
      launch<1>(x, src_mask, in_src, in_w, row_len, xm, out, lanes, n, deg,
                x_zero != 0, xm_stride, s);
    } else {
      launch<kGroup>(x, src_mask, in_src, in_w, row_len, xm, out, lanes, n,
                     deg, x_zero != 0, xm_stride, s);
    }
  }
  return (int)cudaGetLastError();
}
