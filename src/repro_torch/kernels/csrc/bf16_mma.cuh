// bf16 helpers shared by the attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): ldmatrix and mma.sync m16n8k16 with f32
// accumulators (the f32 forward), exp2, bf16 packing and hi/lo splitting,
// and the producer warpgroups' fill of a 128-byte swizzled tile where TMA
// does not apply.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr double kLog2e = 1.4426950408889634;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// bf16 pair (x0 in the low half)
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}
// hi = bf16(x), lo = bf16(x - hi), for a pair
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

// 8 values of a row from column c0, 0 past d; 16-byte loads when vec
__device__ __forceinline__ void load8(const float* row, int c0, int d,
                                      int vec, float (&x)[8]) {
  if (vec && c0 + 8 <= d) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + c0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + c0 + 4));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = c0 + e < d ? __ldg(row + c0 + e) : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c0, int d,
                                      int vec, float (&x)[8]) {
  if (vec && c0 + 8 <= d) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c0));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = c0 + e < d ? __bfloat162float(row[c0 + e]) : 0.f;
  }
}

// rows x DMAX of src (row stride d) into the 128-byte swizzled regions of
// a tile (region r holds columns 64 r .. 64 r + 63 of every row), as bf16
// hi and, when SPLIT, lo; the producer warpgroup's 128 threads (tid)
template <int DMAX, bool SPLIT, typename T>
__device__ __forceinline__ void fill_tile(uint8_t* hi, uint8_t* lo,
                                          const T* src, int rows, int d,
                                          int vec, int tid) {
  constexpr int CH = DMAX / 8;             // 16-byte chunks a row
  constexpr int NB = SPLIT ? 4 : 1;        // chunks a thread loads at once
  for (int i0 = tid; i0 < rows * CH; i0 += 128 * NB) {
    float x[NB][8];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + 128 * b;
      if (i < rows * CH)
        load8(src + (long long)(i / CH) * d, (i % CH) * 8, d, vec, x[b]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + 128 * b;
      if (i >= rows * CH) break;
      const int r = i / CH;
      const int ch = i % CH;
      const uint32_t off = (ch / 8) * rows * 128 + hopper::sw128(r, ch % 8);
      uint4 h, l;
      if constexpr (SPLIT) {
        split(x[b][0], x[b][1], h.x, l.x);
        split(x[b][2], x[b][3], h.y, l.y);
        split(x[b][4], x[b][5], h.z, l.z);
        split(x[b][6], x[b][7], h.w, l.w);
        *reinterpret_cast<uint4*>(lo + off) = l;
      } else {
        h = make_uint4(pack(x[b][0], x[b][1]), pack(x[b][2], x[b][3]),
                       pack(x[b][4], x[b][5]), pack(x[b][6], x[b][7]));
      }
      *reinterpret_cast<uint4*>(hi + off) = h;
    }
  }
}

}  // namespace
