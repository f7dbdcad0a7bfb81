// Batched frontier scatter-min for sm_90a, with a plain C interface.
//
// Replaces the Pallas TPU kernels frontier_scatter_min_batch and
// frontier_scatter_min (src/repro/kernels/frontier_relax.py):
//
//     out[b, v] = min { cand[b, c] : tgt[c] == v },  +inf where none,
//
// with one target table tgt[cells] shared by the B lanes and cells whose
// target is outside [0, n) dropped.  The TPU kernel walks row blocks in
// grid order and carries each running minimum in VMEM; CUDA blocks have
// no order, so here one thread takes one (lane, cell) and folds it into
// the output with atomicMin on the int32 bit pattern of the float.
//
// Premise: every candidate is >= +0.0 or +inf (edge weights are > 0 and
// the engine's D and C are >= 0).  For such floats the IEEE bit patterns,
// read as int32, order the same way as the values, so the integer min is
// the float min: exact and independent of the order of the atomics.  A
// negative candidate breaks the premise (negative floats order backwards
// as int32); chip_smoke.py shows that on the card.
//
// Bound on an H100: bytes.  Per call the kernel reads tgt (4 B/cell) and
// cand (4 B per lane and cell) once and writes out (4 B per lane and
// vertex) once, so the +inf fill of the [B, n] output is most of the
// traffic at the frontier shapes (cap 4096, 4 cells per row, n = 2^20).
// +inf candidates (padding and lane-masked cells) issue no atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInfBits = 0x7f800000;

__global__ void fill_inf_bits(int* __restrict__ out, long long count) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    out[i] = kInfBits;
  }
}

__global__ void scatter_min_batch(const int* __restrict__ tgt,
                                  const float* __restrict__ cand,
                                  int* __restrict__ out_bits, int lanes,
                                  long long cells, int n) {
  const long long total = (long long)lanes * cells;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / cells;
    const long long c = i - b * cells;
    const int t = tgt[c];
    if (t < 0 || t >= n) continue;          // padding cell: dropped
    const int bits = __float_as_int(cand[i]);
    if (bits == kInfBits) continue;         // +inf: a no-op under min
    atomicMin(out_bits + b * (long long)n + t, bits);
  }
}

int blocks_for(long long count) {
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" int frontier_scatter_min_batch(const int* tgt, const float* cand,
                                          float* out, int lanes,
                                          long long cells, int n,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out_bits = reinterpret_cast<int*>(out);
  const long long out_count = (long long)lanes * n;
  if (out_count > 0) {
    fill_inf_bits<<<blocks_for(out_count), kThreads, 0, s>>>(out_bits,
                                                             out_count);
  }
  const long long total = (long long)lanes * cells;
  if (total > 0 && n > 0) {
    scatter_min_batch<<<blocks_for(total), kThreads, 0, s>>>(
        tgt, cand, out_bits, lanes, cells, n);
  }
  return (int)cudaGetLastError();
}
