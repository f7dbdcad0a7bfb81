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
// tgt and cand as the TPU kernel does.  frontier_relax_csr also does the
// CSR gather that ops.frontier_relax_b did around it in PyTorch (23
// device operations a call before the kernel's own 2): a thread takes
// one (frontier slot, out-edge j, lane b), loads u = f_idx[slot], the
// edge t = dst[indptr[u] + j] and its weight, and folds x[b, u] + w into
// out[b, t] where src_mask[b, u].  So a call is two
// device operations, the +inf fill of the dense [B, n] output the engine
// consumes and the scatter, and the [B, cap, max_out_deg] candidate
// table is never written.
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

// The fold both entries share: +inf is a no-op under min and issues
// nothing.
__device__ __forceinline__ void min_into(int* out_bits, float cand) {
  const int bits = __float_as_int(cand);
  if (bits != kInfBits) atomicMin(out_bits, bits);
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
    min_into(out_bits + b * (long long)n + t, cand[i]);
  }
}

// Lanes fastest, so the threads of one cell share its f_idx, indptr, dst
// and w loads.
__global__ void relax_csr(const int* __restrict__ f_idx,
                          const int* __restrict__ indptr,
                          const int* __restrict__ dst,
                          const float* __restrict__ w,
                          const float* __restrict__ x,
                          const bool* __restrict__ src_mask,
                          int* __restrict__ out_bits, int lanes, int cap,
                          int max_deg, int n) {
  const long long total = (long long)cap * max_deg * lanes;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
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

int blocks_for(long long count) {
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  return blocks < 1 ? 1 : (int)blocks;
}

void fill_inf(int* out_bits, long long count, cudaStream_t s) {
  if (count > 0) {
    fill_inf_bits<<<blocks_for(count), kThreads, 0, s>>>(out_bits, count);
  }
}

}  // namespace

extern "C" int frontier_scatter_min_batch(const int* tgt, const float* cand,
                                          float* out, int lanes,
                                          long long cells, int n,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out_bits = reinterpret_cast<int*>(out);
  fill_inf(out_bits, (long long)lanes * n, s);
  const long long total = (long long)lanes * cells;
  if (total > 0 && n > 0) {
    scatter_min_batch<<<blocks_for(total), kThreads, 0, s>>>(
        tgt, cand, out_bits, lanes, cells, n);
  }
  return (int)cudaGetLastError();
}

// out[b, v] over x, src_mask [lanes, n], the frontier buffer f_idx[cap]
// (padding n) and the CSR view indptr[n + 1], dst / w[e_pad].
extern "C" int frontier_relax_csr(const int* f_idx, const int* indptr,
                                  const int* dst, const float* w,
                                  const float* x, const bool* src_mask,
                                  float* out, int lanes, int cap,
                                  int max_deg, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out_bits = reinterpret_cast<int*>(out);
  fill_inf(out_bits, (long long)lanes * n, s);
  const long long total = (long long)cap * max_deg * lanes;
  if (total > 0 && n > 0) {
    relax_csr<<<blocks_for(total), kThreads, 0, s>>>(
        f_idx, indptr, dst, w, x, src_mask, out_bits, lanes, cap, max_deg,
        n);
  }
  return (int)cudaGetLastError();
}
