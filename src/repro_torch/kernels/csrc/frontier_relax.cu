// Frontier scatter-min for sm_90a, with a plain C interface: the fused
// shared-frontier relax (frontier_relax_csr) and the tgt/cand entry.
//
// Replaces the Pallas TPU kernels frontier_scatter_min_batch and
// frontier_scatter_min (src/repro/kernels/frontier_relax.py:78, :117):
//
//     out[b, v] = min { cand[b, c] : tgt[c] == v },  +inf where none,
//
// with one target table tgt[cells] shared by the B lanes and cells whose
// target is outside [0, n) dropped.  frontier_scatter_min_batch takes
// tgt and cand as the TPU kernel does (B1 is its B = 1).
// frontier_relax_csr also does the CSR gather that ops.frontier_relax_b
// did around it in PyTorch (23 device operations a call): a thread takes
// one (frontier slot, out-edge j, lane b), loads u = f_idx[slot], the
// edge t = dst[indptr[u] + j] and its weight, and folds x[b, u] + w into
// out[b, t] where src_mask[b, u], so the [B, cap, max_out_deg] candidate
// table is never written.
//
// Each entry is one cooperative launch, one device operation: the grid
// fills the dense [B, n] output with +inf (int4 stores), waits at
// cooperative_groups' grid barrier, then scatters.  The grid is at most
// what the card holds at once (occupancy x SMs), as a grid barrier needs,
// and no larger than the work needs (see coop_blocks).
//
// The TPU kernel walks row blocks in grid order and carries each running
// minimum in VMEM; CUDA blocks have no order, so each candidate is folded
// into the output with atomicMin on the int32 bit pattern of the float.
// Premise: every candidate is >= +0.0 or +inf (edge weights are > 0 and
// the engine's D and C are >= 0).  For such floats the IEEE bit patterns,
// read as int32, order the same way as the values, so the integer min is
// the float min: exact and independent of the order of the atomics.  A
// negative candidate breaks the premise (negative floats order backwards
// as int32); chip_smoke.py shows that on the card.  Each candidate is one
// __fadd_rn, so the fused entry is bitwise its plain version
// (ref.frontier_relax_ref).
//
// Bound on an H100: bytes.  At the frontier shapes (cap 4096, 4 cells a
// slot, n = 2^20) the +inf fill of the [B, n] output (4 B per lane and
// vertex, written once) is most of them; the gathers are a few hundred
// KB.  +inf candidates (padding and lane-masked cells) issue no atomic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kInfBits = 0x7f800000;
constexpr long long kFillPerBlock = 32768;  // +inf ints a block, at least
constexpr int kMaxDevices = 64;

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

// +inf into out_bits[0, count): int4 stores over the body (the output is
// the wrapper's own allocation, 16-byte aligned), ints for count % 4.
__device__ __forceinline__ void fill_inf(int* __restrict__ out_bits,
                                         long long count, long long tid,
                                         long long stride) {
  const int4 inf4 = make_int4(kInfBits, kInfBits, kInfBits, kInfBits);
  int4* o4 = reinterpret_cast<int4*>(out_bits);
  const long long n4 = count >> 2;
  for (long long i = tid; i < n4; i += stride) o4[i] = inf4;
  for (long long i = 4 * n4 + tid; i < count; i += stride) {
    out_bits[i] = kInfBits;
  }
}

// The fold both entries share: +inf is a no-op under min and issues
// nothing.
__device__ __forceinline__ void min_into(int* out_bits, float cand) {
  const int bits = __float_as_int(cand);
  if (bits != kInfBits) atomicMin(out_bits, bits);
}

__device__ __forceinline__ void scatter_cells(
    const int* __restrict__ tgt, const float* __restrict__ cand,
    int* __restrict__ out_bits, int lanes, long long cells, int n,
    long long tid, long long stride) {
  const long long total = (long long)lanes * cells;
  for (long long i = tid; i < total; i += stride) {
    const long long b = i / cells;
    const long long c = i - b * cells;
    const int t = tgt[c];
    if (t < 0 || t >= n) continue;          // padding cell: dropped
    min_into(out_bits + b * (long long)n + t, cand[i]);
  }
}

// Lanes fastest, so the threads of one cell share its f_idx, indptr, dst
// and w loads.
__device__ __forceinline__ void relax_cells(
    const int* __restrict__ f_idx, const int* __restrict__ indptr,
    const int* __restrict__ dst, const float* __restrict__ w,
    const float* __restrict__ x, const bool* __restrict__ src_mask,
    int* __restrict__ out_bits, int lanes, int cap, int max_deg, int n,
    long long tid, long long stride) {
  const long long total = (long long)cap * max_deg * lanes;
  for (long long i = tid; i < total; i += stride) {
    const long long cell = i / lanes;
    const int b = (int)(i - cell * lanes);
    const int slot = (int)(cell / max_deg);
    const int j = (int)(cell - (long long)slot * max_deg);
    const int u = f_idx[slot];
    if (u < 0 || u >= n) continue;          // padding slot
    const int base = indptr[u];
    if (j >= indptr[u + 1] - base) continue;  // past u's out-degree
    const long long at = (long long)b * n + u;
    if (!src_mask[at]) continue;
    const int t = dst[base + j];
    if (t < 0 || t >= n) continue;
    min_into(out_bits + (long long)b * n + t, __fadd_rn(x[at], w[base + j]));
  }
}

__global__ void __launch_bounds__(kThreads)
fill_scatter_min_batch(const int* __restrict__ tgt,
                       const float* __restrict__ cand,
                       int* __restrict__ out_bits, int lanes,
                       long long cells, int n) {
  const long long tid = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  fill_inf(out_bits, (long long)lanes * n, tid, stride);
  cg::this_grid().sync();                   // every cell +inf first
  scatter_cells(tgt, cand, out_bits, lanes, cells, n, tid, stride);
}

__global__ void __launch_bounds__(kThreads)
fill_relax_csr(const int* __restrict__ f_idx, const int* __restrict__ indptr,
               const int* __restrict__ dst, const float* __restrict__ w,
               const float* __restrict__ x, const bool* __restrict__ src_mask,
               int* __restrict__ out_bits, int lanes, int cap, int max_deg,
               int n) {
  const long long tid = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  fill_inf(out_bits, (long long)lanes * n, tid, stride);
  cg::this_grid().sync();                   // every cell +inf first
  relax_cells(f_idx, indptr, dst, w, x, src_mask, out_bits, lanes, cap,
              max_deg, n, tid, stride);
}

// What the card holds of one kernel at once (occupancy x SMs, the most a
// grid barrier allows) and its SM count, asked once per kernel and device.
struct Residency {
  int blocks = 0;
  int sms = 0;
};

// Blocks of one cooperative launch over `out_count` output ints and
// `cells` scatter threads: one block an SM, more where the fill has more
// than kFillPerBlock ints a block or the scatter more than a thread a
// cell, at most what the card holds.  The grid barrier's cost grows with
// the blocks (tools/b1_fill_variants.py sweeps it), so the grid is no
// larger than the work needs.
cudaError_t coop_blocks(const void* kernel, Residency* cache, int device,
                        long long out_count, long long cells, int* blocks) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Residency& r = cache[device];
  if (r.blocks == 0) {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    }
    if (e != cudaSuccess) return e;
    r.blocks = per_sm * r.sms;
  }
  long long want = r.sms;
  const long long fill = (out_count + kFillPerBlock - 1) / kFillPerBlock;
  const long long scatter = (cells + kThreads - 1) / kThreads;
  if (fill > want) want = fill;
  if (scatter > want) want = scatter;
  *blocks = (int)(want < r.blocks ? want : r.blocks);
  return cudaSuccess;
}

int coop_launch(const void* kernel, Residency* cache, int device,
                long long out_count, long long cells, void** args,
                void* stream) {
  if (out_count <= 0) return 0;             // an empty output: no work
  DeviceGuard guard(device);
  int blocks = 0;
  cudaError_t e = coop_blocks(kernel, cache, device, out_count, cells,
                              &blocks);
  if (e == cudaSuccess) {
    e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, 0,
                                    static_cast<cudaStream_t>(stream));
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

Residency scatter_residency[kMaxDevices];
Residency relax_residency[kMaxDevices];

}  // namespace

extern "C" int frontier_scatter_min_batch(const int* tgt, const float* cand,
                                          float* out, int lanes,
                                          long long cells, int n, int device,
                                          void* stream) {
  int* out_bits = reinterpret_cast<int*>(out);
  void* args[] = {&tgt, &cand, &out_bits, &lanes, &cells, &n};
  return coop_launch((const void*)fill_scatter_min_batch, scatter_residency,
                     device, (long long)lanes * n, (long long)lanes * cells,
                     args, stream);
}

// out[b, v] over x, src_mask [lanes, n], the frontier buffer f_idx[cap]
// (padding n) and the CSR view indptr[n + 1], dst / w[e_pad].
extern "C" int frontier_relax_csr(const int* f_idx, const int* indptr,
                                  const int* dst, const float* w,
                                  const float* x, const bool* src_mask,
                                  float* out, int lanes, int cap,
                                  int max_deg, int n, int device,
                                  void* stream) {
  int* out_bits = reinterpret_cast<int*>(out);
  void* args[] = {&f_idx, &indptr, &dst, &w, &x, &src_mask, &out_bits,
                  &lanes, &cap, &max_deg, &n};
  return coop_launch((const void*)fill_relax_csr, relax_residency, device,
                     (long long)lanes * n, (long long)cap * max_deg * lanes,
                     args, stream);
}
