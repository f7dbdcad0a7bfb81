// Batched masked global min for sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel masked_min
// (src/repro/kernels/segment_min.py):
//
//     out[b] = min { x[b, i] : mask[b, i] },  +inf when the mask is empty.
//
// The TPU kernel accumulates one running scalar across ordered grid steps
// in VMEM.  Here each block reduces a grid-stride slice of one lane: a
// warp-shuffle min, then the warps' minima through shared memory, then
// one atomicMin on the int32 bit pattern into the lane's +inf scalar.
// The result stays on the device (no host read).
//
// Premise: every x is >= +0.0 or +inf (the engine's D and D + outWeight),
// so the int32 bit patterns order like the floats and the atomic min is
// exact and order-free.
//
// Bound on an H100: bytes (4 B of x and 1 B of mask per element, read
// once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInfBits = 0x7f800000;

__global__ void fill_inf_bits(int* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = kInfBits;
}

__global__ void masked_min_kernel(const float* __restrict__ x,
                                  const bool* __restrict__ mask,
                                  int* __restrict__ out_bits, int n) {
  __shared__ float warp_mins[kThreads / 32];
  const int b = blockIdx.y;
  const float* xb = x + (long long)b * n;
  const bool* mb = mask + (long long)b * n;
  float acc = __int_as_float(kInfBits);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (mb[i]) acc = fminf(acc, xb[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = fminf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_mins[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_mins[lane] : __int_as_float(kInfBits);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = fminf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    const int bits = __float_as_int(acc);
    if (lane == 0 && bits != kInfBits) atomicMin(out_bits + b, bits);
  }
}

}  // namespace

extern "C" int masked_min(const float* x, const bool* mask, float* out,
                          int lanes, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out_bits = reinterpret_cast<int*>(out);
  if (lanes > 0) {
    fill_inf_bits<<<(lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        out_bits, lanes);
    if (n > 0) {
      int bx = (n + kThreads * 16 - 1) / (kThreads * 16);  // ~16 per thread
      if (bx > 1024) bx = 1024;
      if (bx < 1) bx = 1;
      dim3 grid(bx, lanes);
      masked_min_kernel<<<grid, kThreads, 0, s>>>(x, mask, out_bits, n);
    }
  }
  return (int)cudaGetLastError();
}
