// xDeepFM CIN layer for sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel cin_layer (src/repro/kernels/cin.py):
//
//     out[b, k, d] = sum_{h, m} W[k, h, m] * x_k[b, h, d] * x_0[b, m, d]
//
// with x_k [B, H, D], x_0 [B, M, D], W [K, H, M], all float32.  Like the
// TPU kernel it never builds the outer product z[b, h, m, d] in device
// memory (B*H*M*D floats: 81.8 GB at B = 262,144 and the paper widths).
//
// Design.  Per sample the layer is a GEMM out_b[K, D] = W[K, H*M] .
// Z_b[H*M, D].  W is shared by every sample, so the kernel runs it as one
// GEMM over the flattened (sample, d) columns, c = b * D + d, B*D of
// them: out[K, B*D] = W[K, H*M] . Z[H*M, B*D].  Each block owns a tile
// of kKt = 64 output rows k and kNc = 128 columns c; its 256 threads
// form a 16 x 16 grid, each holding kTk = 4 rows (k = k0 + tk + 16 i)
// by kTn = 8 columns (c = c0 + tn + 16 j) in registers.
//
// - D = 10 is narrow, so columns are not aligned to samples: a tile of
//   128 columns spans parts of up to 14 samples, each column carries its
//   own (b, d), and any B and D are taken without padding.
// - W (6.2 MB at H = K = 200, M = 39) cannot stay in shared memory (at
//   most 227 KB a block): it is streamed one h at a time, a [kKt, M]
//   slice into shared memory, and is L2-resident (50 MB) across blocks.
// - x_0 of the block's columns, [M, kNc], is loaded once and stays.
// - M is a runtime argument (the TPU kernel unrolled it at trace time),
//   so shared memory is dynamic: kKt * kNc doubles and (M * kNc + M *
//   (kKt + 1)) floats.
// - The sum is taken in three levels: t = sum_m W[k,h,m] x_0[b,m,d] and
//   acc += x_k[b,h,d] * t over kHc = 8 values of h in f32 registers, then
//   acc is added into a per-thread f64 total kept in shared memory.  A
//   7,800-term f32 sum in one sequence strays by up to ~8e-4 from the
//   exact value at unit-normal inputs (cuBLAS's f32 GEMM on the plain
//   version does, measured on an H100); the f64 level keeps the kernel
//   well inside the reference's 3e-4 tolerance.  The total sits in
//   shared memory, not registers: 64 more registers a thread would leave
//   room for one block an SM instead of two.  tools/cin_sum_ab.py times
//   this level against an f32 total and against one f32 chain over h.
//
// Bound on an H100: operations, 2*K*H*M*D*B FLOPs at 67 TFLOP/s f32
// (31 MFLOP a sample at H = K = 200, M = 39, D = 10) against 4*(H + M +
// K)*D bytes a sample.  This simple kernel uses the f32 FMA units, not
// the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTk = 4;             // rows k a thread
constexpr int kTn = 8;             // columns (b, d) a thread
constexpr int kKt = 16 * kTk;      // rows k a block
constexpr int kNc = 16 * kTn;      // columns a block
constexpr int kWs = kKt + 1;       // padded row of the W slice
constexpr int kHc = 8;             // h values summed in f32 between flushes
constexpr int kMaxSmem = 232448;   // bytes a block can opt into (H100)

__global__ void __launch_bounds__(kThreads)
cin_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
           const float* __restrict__ w, float* __restrict__ out, int B,
           int H, int M, int D, int K, int n_ktiles) {
  extern __shared__ double smem[];
  double* total = smem;            // [kKt][kNc], each thread its own cells
  float* x0s = reinterpret_cast<float*>(smem + kKt * kNc);  // [M][kNc]
  float* ws = x0s + M * kNc;       // [M][kWs], one h at a time

  const int tid = threadIdx.x;
  const int tn = tid & 15;
  const int tk = tid >> 4;
  const int k0 = (blockIdx.x % n_ktiles) * kKt;
  const long long c0 = (long long)(blockIdx.x / n_ktiles) * kNc;
  const long long n_cols = (long long)B * D;

  // x_0 of the block's columns; columns past B*D hold zeros
  for (int i = tid; i < M * kNc; i += kThreads) {
    const int m = i / kNc;
    const long long c = c0 + (i % kNc);
    float v = 0.f;
    if (c < n_cols) {
      const long long b = c / D;
      v = x0[(b * M + m) * D + (c % D)];
    }
    x0s[i] = v;
  }
  // this thread's columns: offset of x_k[b, 0, d], or -1 past the end
  long long xk_off[kTn];
#pragma unroll
  for (int j = 0; j < kTn; ++j) {
    const long long c = c0 + tn + 16 * j;
    xk_off[j] = c < n_cols ? (c / D) * H * D + (c % D) : -1;
  }

  float acc[kTk][kTn];
#pragma unroll
  for (int i = 0; i < kTk; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      acc[i][j] = 0.f;
      total[(tk + 16 * i) * kNc + tn + 16 * j] = 0.0;
    }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int h = 0; h < H; ++h) {
    __syncthreads();               // every thread is done with ws
    // W[k0:k0+kKt, h, :]: a warp a row, lanes along the row's M floats
    for (int r = warp; r < kKt; r += kThreads / 32) {
      const int k = k0 + r;
      if (k < K) {
        const float* wr = w + ((long long)k * H + h) * M;
        for (int m = lane; m < M; m += 32) ws[m * kWs + r] = __ldg(wr + m);
      } else {
        for (int m = lane; m < M; m += 32) ws[m * kWs + r] = 0.f;
      }
    }
    float xkv[kTn];
#pragma unroll
    for (int j = 0; j < kTn; ++j)
      xkv[j] = xk_off[j] >= 0 ? __ldg(xk + xk_off[j] + h * D) : 0.f;
    __syncthreads();

    float t[kTk][kTn];
#pragma unroll
    for (int i = 0; i < kTk; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) t[i][j] = 0.f;
    for (int m = 0; m < M; ++m) {
      float wv[kTk], xv[kTn];
#pragma unroll
      for (int i = 0; i < kTk; ++i) wv[i] = ws[m * kWs + tk + 16 * i];
#pragma unroll
      for (int j = 0; j < kTn; ++j) xv[j] = x0s[m * kNc + tn + 16 * j];
#pragma unroll
      for (int i = 0; i < kTk; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j) t[i][j] = fmaf(wv[i], xv[j], t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTk; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j)
        acc[i][j] = fmaf(xkv[j], t[i][j], acc[i][j]);
    if ((h + 1) % kHc == 0 || h + 1 == H) {
#pragma unroll
      for (int i = 0; i < kTk; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j) {
          total[(tk + 16 * i) * kNc + tn + 16 * j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int j = 0; j < kTn; ++j) {
    const long long c = c0 + tn + 16 * j;
    if (c >= n_cols) continue;
    const long long b = c / D;
    const long long d = c % D;
#pragma unroll
    for (int i = 0; i < kTk; ++i) {
      const int k = k0 + tk + 16 * i;
      if (k < K)
        out[(b * K + k) * D + d] = (float)total[(tk + 16 * i) * kNc + tn +
                                                16 * j];
    }
  }
}

}  // namespace

extern "C" int cin_layer(const float* xk, const float* x0, const float* w,
                         float* out, int B, int H, int M, int D, int K,
                         void* stream) {
  if (B <= 0 || K <= 0 || D <= 0) return (int)cudaSuccess;
  const size_t smem = kKt * kNc * sizeof(double) +
                      (size_t)(M * kNc + M * kWs) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (K + kKt - 1) / kKt;
  const long long n_ctiles = ((long long)B * D + kNc - 1) / kNc;
  const long long blocks = n_ctiles * n_ktiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cin_kernel<<<(unsigned)blocks, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(xk, x0, w, out, B, H, M,
                                                     D, K, n_ktiles);
  return (int)cudaGetLastError();
}
