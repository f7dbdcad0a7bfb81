// Flash attention (online softmax) for sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attn.py): for each (batch, head) of
// q [BH, Sq, d] and k, v [BH, Sk, d], float32 or bfloat16,
//
//     o = softmax(mask(q k^T / sqrt(d))) v
//
// without building the [Sq, Sk] scores in device memory.  Numerics are
// the TPU kernel's: inputs cast to f32, q scaled by 1/sqrt(d) first,
// masked scores -1e30 (not -inf), the online (m, l, acc) state in f32,
// the output acc / max(l, 1e-30) cast to the input type.
//
// Design.  The TPU kernel held a head's whole K and V in VMEM; here one
// block owns kBq = 128 query rows of one (batch, head) and streams K and
// V through shared memory in tiles of kBk = 16 keys, converted to f32 on
// load.  Each of the block's 64 quads (4 adjacent threads) owns kRows = 2
// query rows, r and r + 64: thread t holds the 16-byte chunks t, t + 4,
// t + 8, ... of both rows' q and acc in registers (d / 4 floats a row,
// 32 at d = 128), so every float4 read of the K or V tile serves two
// rows; shared-memory reads, not FMAs, bound this design.  A score is 4
// partial dot products summed over the quad by two xor shuffles, so all
// four threads hold every score of the tile.
// Causal blocks stop at the last key tile that touches the diagonal,
// as the TPU kernel skipped key blocks above it, and the heaviest query
// tiles are launched first.  This simple kernel uses the f32 FMA units,
// not the tensor cores, for both types.
//
// Bound on an H100: operations, 2 * Sq * Sk * d multiply-adds a head
// (half that when causal) against 4 * S * d * sizeof(T) bytes a head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;                   // query rows a quad
constexpr int kBq = kThreads / 4 * kRows;  // query rows a block
constexpr int kBk = 16;                    // keys a shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int d, int causal, float scale) {
  constexpr int kChunks = DMAX / 16;  // float4 chunks a thread
  __shared__ __align__(16) float ks[kBk][DMAX];
  __shared__ __align__(16) float vs[kBk][DMAX];

  const int n_qtiles = Sq / kBq;
  const int qt = n_qtiles - 1 - (int)(blockIdx.x % n_qtiles);
  const long long bh = blockIdx.x / n_qtiles;
  const int tid = threadIdx.x;
  const int t = tid & 3;
  int q_pos[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    q_pos[r] = qt * kBq + (tid >> 2) + r * (kThreads / 4);

  const T* kh = k + bh * Sk * d;
  const T* vh = v + bh * Sk * d;

  float4 qv[kRows][kChunks], acc[kRows][kChunks];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const T* qrow = q + (bh * Sq + q_pos[r]) * d;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int dd = 4 * (t + 4 * i) + u;
        e[u] = dd < d ? to_f32(qrow[dd]) * scale : 0.f;
      }
      qv[r][i] = make_float4(e[0], e[1], e[2], e[3]);
      acc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  int n_ktiles = Sk / kBk;
  if (causal) {
    const int last = (qt * kBq + kBq + kBk - 1) / kBk;
    n_ktiles = last < n_ktiles ? last : n_ktiles;
  }
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();                 // every thread is done with ks, vs
    for (int i = tid; i < kBk * DMAX; i += kThreads) {
      const int j = i / DMAX;
      const int dd = i % DMAX;
      const long long g = (long long)(k0 + j) * d + dd;
      ks[j][dd] = dd < d ? to_f32(kh[g]) : 0.f;
      vs[j][dd] = dd < d ? to_f32(vh[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kBk];
    float mx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) mx[r] = kNegInf;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = kr[t + 4 * i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          part[r] = fmaf(qv[r][i].x, kk.x, part[r]);
          part[r] = fmaf(qv[r][i].y, kk.y, part[r]);
          part[r] = fmaf(qv[r][i].z, kk.z, part[r]);
          part[r] = fmaf(qv[r][i].w, kk.w, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
        if (causal && k0 + j > q_pos[r]) part[r] = kNegInf;
        s[r][j] = part[r];
        mx[r] = fmaxf(mx[r], part[r]);
      }
    }
    float m_new[kRows], psum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m_new[r] = fmaxf(m[r], mx[r]);
      const float alpha = expf(m[r] - m_new[r]);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        acc[r][i].x *= alpha;
        acc[r][i].y *= alpha;
        acc[r][i].z *= alpha;
        acc[r][i].w *= alpha;
      }
      l[r] *= alpha;
      psum[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r] = expf(s[r][j] - m_new[r]);
        psum[r] += p[r];
      }
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = vr[t + 4 * i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][i].x = fmaf(p[r], vv.x, acc[r][i].x);
          acc[r][i].y = fmaf(p[r], vv.y, acc[r][i].y);
          acc[r][i].z = fmaf(p[r], vv.z, acc[r][i].z);
          acc[r][i].w = fmaf(p[r], vv.w, acc[r][i].w);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      l[r] += psum[r];
      m[r] = m_new[r];
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + (bh * Sq + q_pos[r]) * d;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float e[4] = {acc[r][i].x, acc[r][i].y, acc[r][i].z,
                          acc[r][i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int dd = 4 * (t + 4 * i) + u;
        if (dd < d) store(orow + dd, e[u] * inv);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Sk, int d, int causal,
                   cudaStream_t s) {
  const long long blocks = (long long)BH * (Sq / kBq);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)d));  // as the reference
  flash_kernel<T, DMAX><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, d, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Sk, int d, int causal,
                     cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, BH, Sq, Sk, d, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, BH, Sq, Sk, d, causal, s);
  return launch<T, 128>(q, k, v, o, BH, Sq, Sk, d, causal, s);
}

}  // namespace

// q [BH, Sq, d], k and v [BH, Sk, d], o [BH, Sq, d], all of one type:
// float32 (bf16 = 0) or bfloat16 (bf16 = 1).  Sq % 128 == 0,
// Sk % 16 == 0, 1 <= d <= 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int BH, int Sq, int Sk, int d,
                               int causal, int bf16, void* stream) {
  if (d < 1 || d > 128 || Sq % kBq != 0 || Sk % kBk != 0)
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, d, causal, s)
           : dispatch<float>(q, k, v, o, BH, Sq, Sk, d, causal, s);
  return (int)err;
}
