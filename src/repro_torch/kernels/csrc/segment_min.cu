// Batched masked global min for sm_90a, plain C interface: the TPU
// kernel's own signature (masked_min) and the SSSP round's two minima in
// one launch (masked_min_pair).
//
// Replaces the Pallas TPU kernel masked_min
// (src/repro/kernels/segment_min.py:33):
//
//     out[b] = min { x[b, i] : mask[b, i] },  +inf when the mask is empty,
//
// and beside it, for the round's minD and out-rule threshold on one mask,
//
//     pair[b, 0] = out[b],
//     pair[b, 1] = min { x[b, i] + add[i] : mask[b, i] }  (+inf if no add),
//
// where the add is one round-to-nearest f32 add (__fadd_rn), as x + add
// is in PyTorch, so both columns are bitwise their plain versions.
//
// The TPU kernel carries one running scalar across ordered grid steps in
// VMEM.  CUDA blocks run in no order, so each block of a lane reduces a
// grid-stride slice (warp shuffles, then the warps' minima through shared
// memory), writes its partial to the scratch `partial` and takes a ticket
// on the lane's counter; the block that takes the last ticket reduces the
// lane's partials, writes the result and sets the counter back to 0 for
// the next call.  So a call is one device operation and needs no +inf
// fill.  Partials combine with fminf, which is exact and independent of
// order for every non-NaN input.  Premise: no NaN (the engine's D and
// D + outWeight are >= 0 or +inf); a zero minimum may carry either sign
// where x holds both -0.0 and +0.0 (the engine makes no -0.0).
//
// Scratch, owned by the wrapper: `partial` holds lanes * max_blocks * 2
// floats and `ticket` lanes ints, all 0 before the first call.  Two calls
// in flight at once must not share them.
//
// Bound on an H100: bytes, 4 B of x and 1 B of mask per element (and 4 B
// of add per vertex), each read once.  A thread loads x as float4 and the
// mask as one 32-bit word of 4 bools, kUnroll such groups in flight; a
// scalar head and tail cover n % 4 and a row whose x, mask and add are
// not aligned at the same element (then the whole row is scalar).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // float4 groups in flight
constexpr int kBlockElems = 4 * kThreads * kUnroll;  // elements a block

// Makes `device` current for one call's launch and restores the caller's
// device after, so the wrapper needs no device context.
struct DeviceGuard {
  int prev = -1;
  int dev;
  explicit DeviceGuard(int d) : dev(d) {
    cudaGetDevice(&prev);
    if (prev != dev) cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev != dev) cudaSetDevice(prev);
  }
};

// The block's minima of a0 and a1, valid on thread 0.
template <bool kAdd>
__device__ __forceinline__ void block_min(float& a0, float& a1) {
  __shared__ float s0[kThreads / 32], s1[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a0 = fminf(a0, __shfl_xor_sync(0xffffffffu, a0, off));
    if (kAdd) a1 = fminf(a1, __shfl_xor_sync(0xffffffffu, a1, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s0[warp] = a0;
    if (kAdd) s1[warp] = a1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      a0 = fminf(a0, s0[w]);
      if (kAdd) a1 = fminf(a1, s1[w]);
    }
  }
  __syncthreads();                               // s0/s1 free for reuse
}

// Grid (blocks a lane, lanes).  out[b * out_stride] takes the min of x,
// out[b * 2 + 1] the min of x + add (kAdd) or +inf (no add, pair form).
template <bool kAdd>
__global__ void __launch_bounds__(kThreads)
masked_min_kernel(const float* __restrict__ x,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ add, float* __restrict__ partial,
                  unsigned* __restrict__ ticket, float* __restrict__ out,
                  long long n, int max_blocks, int out_stride) {
  const int b = blockIdx.y;
  const float* xb = x + (long long)b * n;
  const uint8_t* mb = mask + (long long)b * n;
  float a0 = INFINITY, a1 = INFINITY;
  auto take = [&](bool m, float v, float w) {
    a0 = fminf(a0, m ? v : INFINITY);
    if (kAdd) a1 = fminf(a1, m ? __fadd_rn(v, w) : INFINITY);
  };

  // h: the first element at which x and add are 16-byte and the mask
  // 4-byte aligned; a row with no common such element is all scalar.
  long long h = ((16 - ((uintptr_t)xb & 15)) & 15) >> 2;
  bool vec = h == (long long)((4 - ((uintptr_t)mb & 3)) & 3);
  if (kAdd) {
    vec = vec && h == (long long)(((16 - ((uintptr_t)add & 15)) & 15) >> 2);
  }
  if (!vec || h > n) h = n;
  const long long nvec = (n - h) >> 2;
  const long long tail = h + 4 * nvec;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = tid; i < h; i += stride) {
    take(mb[i] != 0, xb[i], kAdd ? add[i] : 0.f);
  }
  for (long long i = tail + tid; i < n; i += stride) {
    take(mb[i] != 0, xb[i], kAdd ? add[i] : 0.f);
  }
  const float4* x4 = reinterpret_cast<const float4*>(xb + h);
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(mb + h);
  const float4* add4 = reinterpret_cast<const float4*>(kAdd ? add + h : add);
  for (long long v = tid; v < nvec; v += stride * kUnroll) {
    float4 xv[kUnroll], av[kUnroll];
    uint32_t mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = v + u * stride;
      mv[u] = 0;
      xv[u] = av[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nvec) {
        xv[u] = x4[j];
        mv[u] = m4[j];
        if (kAdd) av[u] = add4[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      take((mv[u] & 0xffu) != 0, xv[u].x, av[u].x);
      take((mv[u] & 0xff00u) != 0, xv[u].y, av[u].y);
      take((mv[u] & 0xff0000u) != 0, xv[u].z, av[u].z);
      take((mv[u] & 0xff000000u) != 0, xv[u].w, av[u].w);
    }
  }

  block_min<kAdd>(a0, a1);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (gridDim.x == 1) {
      last = true;
    } else {
      float* p = partial + ((long long)b * max_blocks + blockIdx.x) * 2;
      p[0] = a0;
      if (kAdd) p[1] = a1;
      __threadfence();                           // partial before ticket
      last = atomicAdd(ticket + b, 1u) == gridDim.x - 1;
      if (last) __threadfence();                 // every partial visible
    }
  }
  __syncthreads();
  if (!last) return;
  if (gridDim.x > 1) {                           // the lane's last block
    a0 = a1 = INFINITY;
    for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
      const float* p = partial + ((long long)b * max_blocks + k) * 2;
      a0 = fminf(a0, __ldcg(p));
      if (kAdd) a1 = fminf(a1, __ldcg(p + 1));
    }
    block_min<kAdd>(a0, a1);
  }
  if (threadIdx.x == 0) {
    out[(long long)b * out_stride] = a0;
    if (out_stride == 2) out[(long long)b * 2 + 1] = kAdd ? a1 : INFINITY;
    if (gridDim.x > 1) ticket[b] = 0;            // ready for the next call
  }
}

int launch(const float* x, const bool* mask, const float* add,
           float* partial, int* ticket, float* out, int lanes, long long n,
           int max_blocks, int out_stride, int device, void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 65535 || max_blocks < 1 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceGuard guard(device);
  long long bx = (n + kBlockElems - 1) / kBlockElems;
  if (bx > max_blocks) bx = max_blocks;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = reinterpret_cast<const uint8_t*>(mask);
  unsigned* t = reinterpret_cast<unsigned*>(ticket);
  if (add != nullptr) {
    masked_min_kernel<true><<<grid, kThreads, 0, s>>>(
        x, m, add, partial, t, out, n, max_blocks, out_stride);
  } else {
    masked_min_kernel<false><<<grid, kThreads, 0, s>>>(
        x, m, add, partial, t, out, n, max_blocks, out_stride);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out[lanes]: the TPU kernel's function, batched over lanes.
extern "C" int masked_min(const float* x, const bool* mask, float* partial,
                          int* ticket, float* out, int lanes, long long n,
                          int max_blocks, int device, void* stream) {
  return launch(x, mask, nullptr, partial, ticket, out, lanes, n,
                max_blocks, 1, device, stream);
}

// out[lanes, 2]: both minima of a round on one mask; add[n] or null.
extern "C" int masked_min_pair(const float* x, const bool* mask,
                               const float* add, float* partial, int* ticket,
                               float* out, int lanes, long long n,
                               int max_blocks, int device, void* stream) {
  return launch(x, mask, add, partial, ticket, out, lanes, n, max_blocks, 2,
                device, stream);
}
