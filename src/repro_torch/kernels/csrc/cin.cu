// xDeepFM CIN layer on Hopper's tensor cores, sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel cin_layer (src/repro/kernels/cin.py):
//
//     out[b, k, d] = sum_{h, m} W[k, h, m] * x_k[b, h, d] * x_0[b, m, d]
//
// with x_k [B, H, D], x_0 [B, M, D], W [K, H, M], all float32.  Like the
// TPU kernel it never builds the outer product z[b, h, m, d] in device
// memory (B*H*M*D floats: 81.8 GB at B = 262,144 and the paper widths).
//
// The layer as one GEMM.  Over the flattened columns c = b * D + d (N =
// B * D of them, so D = 10 needs no padding) and the flat reduction index
// j = h * M + m (padded only at its end, to a multiple of kJc: 7,800 ->
// 7,808 at H = 200, M = 39), out[k, c] = sum_j W[k, j] Z[j, c] with
// Z[j, c] = x_k[b, h, d] * x_0[b, m, d].  The kernel computes its
// transpose out^T = Z^T W^T on mma.sync.m16n8k8 TF32 tensor cores: Z^T is
// the A operand (16 columns a tile), W^T the B operand (8 rows k a tile),
// so K = 200 is 5 block tiles of 40 rows with no padding rows.
//
// - A block owns kNc = 256 columns and kKt = 40 rows k; each of its 16
//   warps owns 16 columns by the 40 rows.  W is what every column reads,
//   so the tile is wide in columns: a chunk of kJc = 32 values of j costs
//   the block 40 x 32 values of W.  A small first kernel splits W (see
//   Precision) into the order the B fragments read it, so that a warp
//   takes the hi and lo parts of both values of a fragment in one 16-byte
//   shared load.
// - Z is never stored, not even in shared memory: x_0 of the block's
//   columns, [M, 256], stays in shared memory, the chunk's few rows of
//   x_k, [(31 / M) + 2, 256], come in by cp.async with the chunk's W
//   slice and a table of each j's x_0 and x_k rows (all double-buffered),
//   and each A fragment is formed in registers as x_k * x_0.
// - Precision: split f32 as 3xTF32.  Each operand x is split when its
//   fragment is formed into hi = tf32(x) and lo = tf32(x - hi) (11 + 11
//   significant bits) and each product is lo.hi + hi.lo + hi.hi; the
//   dropped lo.lo and the rounding of lo are ~2^-22 of the product.  bf16
//   hi/lo (~16 bits) would be ~60x further off, past the 1e-4 that a
//   7,800-term output of |out| ~ 100-500 allows.
// - Summation: every k-step (8 values of j) the three products of a
//   16 x 8 tile are taken in a fresh f32 fragment, which is added into a
//   compensated (Kahan) f32 pair per output, in registers; the pair's
//   compensation is the fragment's initial value, so the flush costs 3
//   adds.  The tensor cores' accumulation truncates, so longer runs of
//   f32 fragment sums cost accuracy (2 and 4 k-steps a flush were
//   measurably further off); the pair keeps the long sum near f64 (a
//   single f32 chain over 7,800 terms was 3.18e-4 off at B = 65,536).
// - Latency: 16 warps an SM (20 outputs a thread), and no phase in
//   which the warps leave the tensor cores idle to form operands.  A
//   first design with 10 warps, 64 x 200 tiles and Z formed in shared
//   memory kept the tensor cores busy well under half as much.
// - Occupancy at small B: the wrapper splits the chunks of j into S
//   parts (S blocks for each output tile) so that the grid fills the
//   card's waves; each part writes its f32 partial [S, K, N] and a
//   second kernel sums them in a fixed order in f64.  No atomics.
//
// Bound on an H100: operations, 2*K*H*M*D*B FLOPs (31 MFLOP a sample at
// H = K = 200, M = 39, D = 10) at 67 TFLOP/s f32, or three times that at
// 495 TFLOP/s TF32 on the tensor cores; bytes 4*(H + M + K)*D a sample.
//
// The layer's backward (kernels/cin.py) takes its input gradients from
// this kernel with permuted weights, and its weight gradient from
// cin_weight_grad below, which replaces no TPU kernel (the reference's
// CIN has no backward):
//
//     dW[k, h, m] = sum_{b, d} g[b, k, d] * x_k[b, h, d] * x_0[b, m, d]
//
// the GEMM dW^T[j, k] = sum_c Z[c, j] G[c, k] over the B * D columns c =
// b * D + d (655,360 at B = 65,536), with Z = x_k * x_0 formed in
// registers as in the forward and G[c, k] = g[b, k, d].  A block owns
// 128 values of j (8 warps of 16) by 40 rows k and walks chunks of 8
// samples (8 * D columns, D k-steps of mma.sync.m16n8k8 3xTF32, fresh
// fragments added into Kahan pairs as in the forward); the chunk's x_0,
// its few x_k rows and its 40 rows of g come in by cp.async,
// double-buffered.  The chunks split into S parts when the tiles alone
// would not fill the card; the parts' partial sums are added in a fixed
// order in f64 by a second kernel.  Bound: the same operations as the
// forward; bytes 4*(H + M + K)*D a sample plus 4*K*H*M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kNi = 5;                     // 8-row tiles a warp
constexpr int kNc = 16 * kWarps;           // 256 columns a block
constexpr int kKt = 8 * kNi;               // 40 rows k a block
constexpr int kJc = 32;                    // values of j a chunk
constexpr int kXs = kNc + 8;               // x_0, x_k row stride (= 8 mod 32)
constexpr int kWs = 2 * kJc + 16;          // W row stride (80 = 16 mod 32)
constexpr int kWTile = kKt * kWs;          // floats of a W tile
constexpr int kMaxSmem = 232448;           // bytes a block can opt into

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d = a b + c: a 16x8 (row), b 8x8 (col), TF32; c, d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1,
                                    const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// W in the order the B fragments read it: for row k of [Kpad] and j =
// 32 ch + 8 kk + t (t < 4), the float4 at ((k * n_chunks + ch) * 4 + kk)
// * 4 + t holds hi(W[k, j]), hi(W[k, j + 4]), lo(W[k, j]), lo(W[k, j +
// 4]); zero outside [K, H * M].
__global__ void prep_w_kernel(const float* __restrict__ w,
                              float4* __restrict__ wp, int K, int HM,
                              int Kpad, int n_chunks) {
  const long long n = (long long)Kpad * n_chunks * 16;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i / (n_chunks * 16));
    const int r = (int)(i % (n_chunks * 16));
    const int j = (r / 16) * kJc + ((r / 4) % 4) * 8 + r % 4;
    const float x0 = k < K && j < HM ? w[(long long)k * HM + j] : 0.f;
    const float x1 = k < K && j + 4 < HM ? w[(long long)k * HM + j + 4] : 0.f;
    uint32_t h0, l0, h1, l1;
    split(x0, h0, l0);
    split(x1, h1, l1);
    wp[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                        __uint_as_float(l0), __uint_as_float(l1));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cin_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
           const float4* __restrict__ wp, float* __restrict__ out,
           float* __restrict__ part, int B, int H, int M, int D, int K,
           int n_ctiles, int n_ktiles, int cps, int n_chunks, int nh) {
  extern __shared__ __align__(16) float smem[];
  float* wst = smem;                       // [2][kKt][kWs]
  int2* jtab = reinterpret_cast<int2*>(wst + 2 * kWTile);   // [2][kJc]
  float* x0s = reinterpret_cast<float*>(jtab + 2 * kJc);    // [M][kXs]
  float* xks = x0s + M * kXs;              // [2][nh][kXs]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int bid = blockIdx.x;
  const int ct = bid % n_ctiles;
  bid /= n_ctiles;
  const int kt = bid % n_ktiles;
  const int s = bid / n_ktiles;            // part of the reduction
  const long long c0 = (long long)ct * kNc;
  const int k0 = kt * kKt;
  const long long N = (long long)B * D;
  const int ch0 = s * cps;
  const int n_ch = min(cps, n_chunks - ch0);
  const float inv_m = 1.f / M;
  auto hm = [&](int j, int& h, int& m) {   // j = h * M + m, j < 2^22
    h = (int)((float)j * inv_m);
    m = j - h * M;
    if (m < 0) { --h; m += M; } else if (m >= M) { ++h; m -= M; }
  };

  // x_0 of the block's columns; this thread stages column tid % kNc
  const int sc = tid % kNc;
  const long long c_st = c0 + sc;
  const bool col_in = c_st < N;
  const long long b_st = col_in ? c_st / D : 0;
  const long long d_st = col_in ? c_st % D : 0;
  for (int m = tid / kNc; m < M; m += kThreads / kNc)
    cp_async4(x0s + m * kXs + sc, x0 + (b_st * M + m) * D + d_st, col_in);
  cp_commit();
  // chunk ch into stage st: its W slice, x_k rows h0 .. h0 + nh, and
  // for each j of the chunk the offsets of its x_0 and x_k rows
  auto stage = [&](int ch, int st) {
    float* ws = wst + st * kWTile;
    for (int i = tid; i < kKt * (2 * kJc / 4); i += kThreads) {
      const int r = i / (2 * kJc / 4);
      const int q = i % (2 * kJc / 4);
      cp_async16(ws + r * kWs + 4 * q,
                 wp + ((long long)(k0 + r) * n_chunks + ch) * (kJc / 2) + q);
    }
    const int h0 = ch * kJc / M;
    float* xs = xks + st * nh * kXs;
    for (int r = tid / kNc; r < nh; r += kThreads / kNc) {
      const bool in = col_in && h0 + r < H;
      cp_async4(xs + r * kXs + sc,
                xk + (in ? (b_st * H + h0 + r) * D + d_st : 0), in);
    }
    cp_commit();
    if (tid < kJc) {
      int h, m;
      hm(ch * kJc + tid, h, m);
      jtab[st * kJc + tid] = make_int2(m * kXs, (h - h0) * kXs);
    }
  };

  // Kahan pair per output: the sum is tot + ncm (ncm = -compensation)
  float tot[kNi][4], ncm[kNi][4];
#pragma unroll
  for (int b = 0; b < kNi; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[b][e] = ncm[b][e] = 0.f;

  if (n_ch > 0) stage(ch0, 0);
  cp_wait_all();
  __syncthreads();

  const int ca = warp * 16 + g;            // A rows (columns c): ca, ca + 8
  for (int ch = 0; ch < n_ch; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < n_ch) stage(ch0 + ch + 1, st ^ 1);
    const float* ws = wst + st * kWTile;
    const float* xs = xks + st * nh * kXs + ca;
    const float* x0c = x0s + ca;
#pragma unroll
    for (int kk = 0; kk < kJc / 8; ++kk) {
      // A = Z^T: a0 (col ca, j t), a1 (ca + 8, t), a2 (ca, t + 4),
      // a3 (ca + 8, t + 4), Z = x_k * x_0
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int2 o = jtab[st * kJc + kk * 8 + t + 4 * q];
        split(xs[o.y] * x0c[o.x], ah[2 * q], al[2 * q]);
        split(xs[o.y + 8] * x0c[o.x + 8], ah[2 * q + 1], al[2 * q + 1]);
      }
      // B = W^T: b0 (j t, row g), b1 (j t + 4, row g), hi and lo in one
      // float4
      uint32_t bh[kNi][2], bl[kNi][2];
#pragma unroll
      for (int b = 0; b < kNi; ++b) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + (b * 8 + g) * kWs + kk * 16 + t * 4);
        bh[b][0] = __float_as_uint(v.x);
        bh[b][1] = __float_as_uint(v.y);
        bl[b][0] = __float_as_uint(v.z);
        bl[b][1] = __float_as_uint(v.w);
      }
      // the three products of every tile in turn, dependent ones kNi apart
      float f[kNi][4];
#pragma unroll
      for (int b = 0; b < kNi; ++b)
        mma(f[b], al, bh[b][0], bh[b][1], ncm[b]);
#pragma unroll
      for (int b = 0; b < kNi; ++b) mma(f[b], ah, bl[b][0], bl[b][1], f[b]);
#pragma unroll
      for (int b = 0; b < kNi; ++b) mma(f[b], ah, bh[b][0], bh[b][1], f[b]);
#pragma unroll
      for (int b = 0; b < kNi; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {      // Kahan, f = term - compensation
          const float u = tot[b][e] + f[b][e];
          ncm[b][e] = f[b][e] - (u - tot[b][e]);
          tot[b][e] = u;
        }
    }
    cp_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int b = 0; b < kNi; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long c = c0 + ca + (e >> 1) * 8;
      const int k = k0 + b * 8 + 2 * t + (e & 1);
      if (c >= N || k >= K) continue;
      const float x = tot[b][e] + ncm[b][e];
      if (part)
        part[((long long)s * K + k) * N + c] = x;
      else
        out[((c / D) * K + k) * D + c % D] = x;
    }
}

// out[b, k, d] = sum over s of part[s, k, b * D + d], in order, in f64
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int S, int K,
                                 long long N, int D) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= K * N) return;
  const long long k = i / N;
  const long long c = i % N;
  double acc = 0.0;
  for (int s = 0; s < S; ++s) acc += part[(long long)s * K * N + i];
  out[((c / D) * K + k) * D + c % D] = (float)acc;
}

constexpr int kGWarps = 8;
constexpr int kGThreads = 32 * kGWarps;
constexpr int kGJt = 16 * kGWarps;         // 128 values of j a block
constexpr int kGBc = 8;                    // samples a chunk: 8 * D columns

__global__ void __launch_bounds__(kGThreads, 1)
cin_wgrad_kernel(const float* __restrict__ gr, const float* __restrict__ xk,
                 const float* __restrict__ x0, float* __restrict__ dw,
                 float* __restrict__ part, int B, int H, int M, int D,
                 int K, int n_jtiles, int n_ktiles, int cps, int n_chunks,
                 int nh) {
  extern __shared__ __align__(16) float smem[];
  const int st_x0 = kGBc * M * D;          // a stage: x_0 of 8 samples,
  const int st_xk = kGBc * nh * D;         // their x_k rows h0 .. + nh,
  const int st_g = kGBc * kKt * D;         // and their g rows k0 .. + 40
  const int stage_f = st_x0 + st_xk + st_g;
  int* ctab = reinterpret_cast<int*>(smem + 2 * stage_f);   // [8 D][3]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int bid = blockIdx.x;
  const int jt = bid % n_jtiles;
  bid /= n_jtiles;
  const int kt = bid % n_ktiles;
  const int s = bid / n_ktiles;            // part of the reduction
  const int HM = H * M;
  const int j0 = jt * kGJt;
  const int k0 = kt * kKt;
  const int h0 = j0 / M;
  const int ch0 = s * cps;
  const int n_ch = min(cps, n_chunks - ch0);
  const int ncol = kGBc * D;

  // the thread's A rows j and j + 8: offsets of their x_0 and x_k values
  // in a column's sample, and whether they exist
  int o0[2], ok[2];
  float live[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = j0 + warp * 16 + g + 8 * q;
    const int h = j < HM ? j / M : h0;
    o0[q] = j < HM ? (j - h * M) * D : 0;
    ok[q] = (h - h0) * D;
    live[q] = j < HM ? 1.f : 0.f;
  }
  // column c = b * D + d of a chunk: offsets of its sample in the stage
  for (int c = tid; c < ncol; c += kGThreads) {
    const int bl = c / D;
    const int d = c % D;
    ctab[3 * c] = bl * M * D + d;
    ctab[3 * c + 1] = bl * nh * D + d;
    ctab[3 * c + 2] = bl * kKt * D + d;
  }
  auto stage = [&](int ch, int st) {
    const long long b0 = (long long)ch * kGBc;
    const int nb = (int)min((long long)kGBc, B - b0);
    float* xs0 = smem + st * stage_f;
    float* xsk = xs0 + st_x0;
    float* gs = xsk + st_xk;
    for (int i = tid; i < st_x0; i += kGThreads) {
      const bool in = i < nb * M * D;
      cp_async4(xs0 + i, x0 + (in ? b0 * M * D + i : 0), in);
    }
    for (int i = tid; i < st_xk; i += kGThreads) {
      const int bl = i / (nh * D);
      const int r = i % (nh * D);
      const bool in = bl < nb && h0 + r / D < H;
      cp_async4(xsk + i, xk + (in ? ((b0 + bl) * H + h0) * D + r : 0), in);
    }
    for (int i = tid; i < st_g; i += kGThreads) {
      const int bl = i / (kKt * D);
      const int r = i % (kKt * D);
      const bool in = bl < nb && k0 + r / D < K;
      cp_async4(gs + i, gr + (in ? ((b0 + bl) * K + k0) * D + r : 0), in);
    }
    cp_commit();
  };

  float tot[kNi][4], ncm[kNi][4];
#pragma unroll
  for (int b = 0; b < kNi; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[b][e] = ncm[b][e] = 0.f;

  if (n_ch > 0) stage(ch0, 0);
  cp_wait_all();
  __syncthreads();
  for (int ch = 0; ch < n_ch; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < n_ch) stage(ch0 + ch + 1, st ^ 1);
    const float* xs0 = smem + st * stage_f;
    const float* xsk = xs0 + st_x0;
    const float* gs = xsk + st_xk;
    for (int kk = 0; kk < D; ++kk) {       // 8 columns a k-step
      // A = Z^T: a0 (row j, column t), a1 (j + 8, t), a2 (j, t + 4),
      // a3 (j + 8, t + 4); B = G: b0 (column t, row k0 + 8 b + g),
      // b1 (column t + 4, the same k)
      uint32_t ah[4], al[4];
      int cg[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = 8 * kk + t + 4 * q;
        const int c0 = ctab[3 * c];
        const int ck = ctab[3 * c + 1];
        cg[q] = ctab[3 * c + 2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          split(live[r] * xsk[ck + ok[r]] * xs0[c0 + o0[r]], ah[2 * q + r],
                al[2 * q + r]);
      }
      uint32_t bh[kNi][2], bl[kNi][2];
#pragma unroll
      for (int b = 0; b < kNi; ++b)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split(gs[cg[q] + (b * 8 + g) * D], bh[b][q], bl[b][q]);
      float f[kNi][4];
#pragma unroll
      for (int b = 0; b < kNi; ++b)
        mma(f[b], al, bh[b][0], bh[b][1], ncm[b]);
#pragma unroll
      for (int b = 0; b < kNi; ++b) mma(f[b], ah, bl[b][0], bl[b][1], f[b]);
#pragma unroll
      for (int b = 0; b < kNi; ++b) mma(f[b], ah, bh[b][0], bh[b][1], f[b]);
#pragma unroll
      for (int b = 0; b < kNi; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {      // Kahan, f = term - compensation
          const float u = tot[b][e] + f[b][e];
          ncm[b][e] = f[b][e] - (u - tot[b][e]);
          tot[b][e] = u;
        }
    }
    cp_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int b = 0; b < kNi; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + warp * 16 + g + (e >> 1) * 8;
      const int k = k0 + b * 8 + 2 * t + (e & 1);
      if (j >= HM || k >= K) continue;
      const float x = tot[b][e] + ncm[b][e];
      if (part)
        part[((long long)s * K + k) * HM + j] = x;
      else
        dw[(long long)k * HM + j] = x;
    }
}

// out[i] = sum over s of part[s, i], in order, in f64
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int S,
                                  long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  double acc = 0.0;
  for (int s = 0; s < S; ++s) acc += part[(long long)s * n + i];
  out[i] = (float)acc;
}

}  // namespace

// x_k [B, H, D], x_0 [B, M, D], w [K, H, M], out [B, K, D], float32.  The
// ceil(H * M / 32) chunks of j are split into S parts of cps chunks each,
// (S - 1) * cps < chunks <= S * cps.  Scratch from the caller: wprep,
// ceil(K / 40) * 40 * chunks * 64 floats, 16-byte aligned; and when S > 1
// part, S * K * B * D floats (else null).
extern "C" int cin_layer(const float* xk, const float* x0, const float* w,
                         float* out, void* wprep, float* part, int B, int H,
                         int M, int D, int K, int S, int cps, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0) return (int)cudaSuccess;
  if (H < 0 || M <= 0 || (long long)H * M >= (1 << 22))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (H * M + kJc - 1) / kJc;
  if (S < 1 || cps < 1 || (long long)S * cps < n_chunks ||
      (S > 1 && ((long long)(S - 1) * cps >= n_chunks || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  // rows of x_k a chunk of kJc consecutive j can touch
  const int nh = (kJc - 1) / M + 2 < kJc ? (kJc - 1) / M + 2 : kJc;
  const size_t smem = ((size_t)(M + 2 * nh) * kXs + 2 * kWTile) *
                         sizeof(float) + 2 * kJc * sizeof(int2);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int n_ktiles = (K + kKt - 1) / kKt;
  const long long N = (long long)B * D;
  const long long n_ctiles = (N + kNc - 1) / kNc;
  const long long blocks = n_ctiles * n_ktiles * S;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* wp = static_cast<float4*>(wprep);
  const long long n_wp = (long long)n_ktiles * kKt * n_chunks * 16;
  if (n_wp > 0) {
    const long long wb = (n_wp + 255) / 256;
    prep_w_kernel<<<(unsigned)(wb < 8192 ? wb : 8192), 256, 0, st>>>(
        w, wp, K, H * M, n_ktiles * kKt, n_chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cin_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      xk, x0, wp, out, S > 1 ? part : nullptr, B, H, M, D, K, (int)n_ctiles,
      n_ktiles, cps, n_chunks, nh);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const long long n_out = (long long)K * N;
  sum_parts_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      part, out, S, K, N, D);
  return (int)cudaGetLastError();
}

// g [B, K, D], x_k [B, H, D], x_0 [B, M, D] -> dw [K, H, M], float32: the
// weight gradient of cin_layer for the upstream gradient g.  The
// ceil(B / 8) chunks of 8 samples are split into S parts of cps chunks
// each, (S - 1) * cps < chunks <= S * cps; when S > 1 part is S * K * H * M
// floats of scratch from the caller (else null).
extern "C" int cin_weight_grad(const float* g, const float* xk,
                               const float* x0, float* dw, float* part,
                               int B, int H, int M, int D, int K, int S,
                               int cps, void* stream) {
  if (H <= 0 || M <= 0 || K <= 0) return (int)cudaSuccess;
  if (B < 0 || D <= 0 || (long long)H * M >= (1 << 30) ||
      (long long)B * D >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (B + kGBc - 1) / kGBc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)K * H * M;
  if (n_chunks == 0)
    return (int)cudaMemsetAsync(dw, 0, n_out * sizeof(float), st);
  if (S < 1 || cps < 1 || (long long)S * cps < n_chunks ||
      (S > 1 && ((long long)(S - 1) * cps >= n_chunks || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int nh = (kGJt - 1) / M + 2;
  const size_t smem =
      (size_t)2 * kGBc * D * (M + nh + kKt) * sizeof(float) +
      (size_t)3 * kGBc * D * sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int n_jtiles = (H * M + kGJt - 1) / kGJt;
  const int n_ktiles = (K + kKt - 1) / kKt;
  const long long blocks = (long long)n_jtiles * n_ktiles * S;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cin_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cin_wgrad_kernel<<<(unsigned)blocks, kGThreads, smem, st>>>(
      g, xk, x0, dw, S > 1 ? part : nullptr, B, H, M, D, K, n_jtiles,
      n_ktiles, cps, n_chunks, nh);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  sum_splits_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      part, dw, S, n_out);
  return (int)cudaGetLastError();
}
