// The two-launch form of csrc/frontier_relax.cu, for
// tools/b1_fill_variants.py: a +inf fill kernel (the same int4 stores),
// then the scatter in a second, ordinary launch, in place of one
// cooperative launch with a grid barrier between them.  The device code is
// csrc/frontier_relax.cu's own (included), so the two forms differ only
// in how the fill is ordered before the scatter.  The *_grid entries
// launch csrc's cooperative kernels on a grid of `blocks` blocks, for a
// sweep of the grid size.

#include "../src/repro_torch/kernels/csrc/frontier_relax.cu"

namespace {

constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride beyond this

int blocks_for(long long threads) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(int* __restrict__ out_bits, long long count) {
  fill_inf(out_bits, count, blockIdx.x * (long long)kThreads + threadIdx.x,
           (long long)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ tgt, const float* __restrict__ cand,
               int* __restrict__ out_bits, int lanes, long long cells,
               int n) {
  scatter_cells(tgt, cand, out_bits, lanes, cells, n,
                blockIdx.x * (long long)kThreads + threadIdx.x,
                (long long)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads)
relax_kernel(const int* __restrict__ f_idx, const int* __restrict__ indptr,
             const int* __restrict__ dst, const float* __restrict__ w,
             const float* __restrict__ x, const bool* __restrict__ src_mask,
             int* __restrict__ out_bits, int lanes, int cap, int max_deg,
             int n) {
  relax_cells(f_idx, indptr, dst, w, x, src_mask, out_bits, lanes, cap,
              max_deg, n, blockIdx.x * (long long)kThreads + threadIdx.x,
              (long long)gridDim.x * kThreads);
}

void fill(int* out_bits, long long count, cudaStream_t s) {
  if (count > 0) {
    fill_kernel<<<blocks_for((count + 15) / 16), kThreads, 0, s>>>(
        out_bits, count);
  }
}

}  // namespace

extern "C" int frontier_scatter_min_batch_two(const int* tgt,
                                              const float* cand, float* out,
                                              int lanes, long long cells,
                                              int n, int device,
                                              void* stream) {
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out_bits = reinterpret_cast<int*>(out);
  fill(out_bits, (long long)lanes * n, s);
  const long long total = (long long)lanes * cells;
  if (total > 0 && n > 0) {
    scatter_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        tgt, cand, out_bits, lanes, cells, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int frontier_relax_csr_two(const int* f_idx, const int* indptr,
                                      const int* dst, const float* w,
                                      const float* x, const bool* src_mask,
                                      float* out, int lanes, int cap,
                                      int max_deg, int n, int device,
                                      void* stream) {
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out_bits = reinterpret_cast<int*>(out);
  fill(out_bits, (long long)lanes * n, s);
  const long long total = (long long)cap * max_deg * lanes;
  if (total > 0 && n > 0) {
    relax_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        f_idx, indptr, dst, w, x, src_mask, out_bits, lanes, cap, max_deg,
        n);
  }
  return (int)cudaGetLastError();
}

extern "C" int frontier_scatter_min_batch_grid(const int* tgt,
                                               const float* cand, float* out,
                                               int lanes, long long cells,
                                               int n, int device,
                                               void* stream, int blocks) {
  DeviceGuard guard(device);
  int* out_bits = reinterpret_cast<int*>(out);
  void* args[] = {&tgt, &cand, &out_bits, &lanes, &cells, &n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fill_scatter_min_batch, dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

extern "C" int frontier_relax_csr_grid(const int* f_idx, const int* indptr,
                                       const int* dst, const float* w,
                                       const float* x, const bool* src_mask,
                                       float* out, int lanes, int cap,
                                       int max_deg, int n, int device,
                                       void* stream, int blocks) {
  DeviceGuard guard(device);
  int* out_bits = reinterpret_cast<int*>(out);
  void* args[] = {&f_idx, &indptr, &dst, &w, &x, &src_mask, &out_bits,
                  &lanes, &cap, &max_deg, &n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fill_relax_csr, dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
