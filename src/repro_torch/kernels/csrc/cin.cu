// xDeepFM CIN layer on Hopper's tensor cores, sm_90a, plain C interface.
//
// Replaces the Pallas TPU kernel cin_layer (src/repro/kernels/cin.py:42,
// pallas_call at :51):
//
//     out[b, k, d] = sum_{h, m} W[k, h, m] * x_k[b, h, d] * x_0[b, m, d]
//
// with x_k [B, H, D], x_0 [B, M, D], W [K, H, M], all float32.  Like the
// TPU kernel it never builds the outer product z[b, h, m, d] in device
// memory (B*H*M*D floats: 81.8 GB at B = 262,144 and the paper widths).
//
// The layer as one GEMM.  Over the flattened columns c = b * D + d (N =
// B * D of them, so D = 10 needs no padding) and the flat reduction index
// j = h * M + m (padded only at its end, to a multiple of kFJ), out[k, c]
// = sum_j W[k, j] Z[j, c] with Z[j, c] = x_k[b, h, d] * x_0[b, m, d].  The
// kernel computes its transpose out^T[c, k] = sum_j Z^T[c, j] W^T[j, k].
//
// Bound on an H100: operations, 2*K*H*M*D*B FLOPs (31 MFLOP a sample at
// H = K = 200, M = 39, D = 10) at 67 TFLOP/s f32, or three times that at
// 495 TFLOP/s TF32 on the tensor cores; bytes 4*(H + M + K)*D a sample.
// Every output sums H * M products, so the tensor cores, not the bytes,
// are the limit: the design keeps them fed from operands that are formed
// and split once, by warps that do nothing else.
//
// Design (cin_kernel: warp-specialised, wgmma tf32, the machinery of
// cin_weight_grad below with the roles of its operands exchanged):
// - A block owns kFCols = 128 columns by N rows k (N = kFRowsS = 40 when
//   K <= 40, as for dx_0 = cin_layer(g, x_k, w') with K' = M = 39; else
//   kFRowsL = 104, so K = 200 is two row tiles).  Each of its two consumer
//   warpgroups owns 64 of the columns: out^T's [64, N] tile is
//   wgmma.m64nNk8 with Z^T as A and W^T as B, both from shared memory,
//   K-major (j contiguous), 128-byte swizzled.
// - W^T is the same for every block of a row tile, so prep_w_kernel splits
//   w once into TF32 hi and lo, in the byte order of the stage tiles, into
//   scratch from the caller; a stage's W^T (2 * N * 128 bytes) lands in
//   shared memory by one bulk copy on the stage's mbarrier.
// - Two producer warpgroups fill a ring of 3 stages (2 where the third
//   does not fit beside x_0: M past 105 at N = 104), kFJ = 32 values of
//   j a stage: thread p of each owns column p of the block and 16 of the
//   stage's values of j.  They keep the block's x_0 (M values a column) in
//   shared memory for the whole call, which bounds M
//   (kFMaxFields), reads the two x_k values a stage touches (M >= 32) from
//   device memory a stage ahead, forms the stage's 32 values of Z (their
//   x_0 loads independent of each other), splits each once into TF32
//   hi and lo and stores both into the swizzled tile.  So every Z value is
//   formed and split once a row tile, every W value once a call, and the
//   consumers only multiply, keeping one stage's products in flight while
//   they issue the next.  setmaxnreg moves registers from the producers
//   (96 a thread) to the consumers (160: the 52 accumulators of N = 104
//   and their Kahan sums).
// - Precision: split f32 as 3xTF32.  Each operand x is split into hi =
//   tf32(x) and lo = tf32(x - hi) (11 + 11 significant bits) and each
//   product is lo.hi + hi.lo + hi.hi into a f32 accumulator; the dropped
//   lo.lo and the rounding of lo are ~2^-22 of the product.  The
//   accumulator is added into a compensated (Kahan) f32 pair every
//   kFFlush stages (16 k-steps of 8 values of j), in registers; the pair's
//   compensation is the accumulator's next start, so a flush costs 3 adds.
//   The CPU tests emulate this sum at the layer's and the input
//   gradients' lengths of j (tests/test_torch_split_precision.py).
// - Occupancy at small B: the wrapper splits the stages into S parts (S
//   blocks for each output tile) so that the grid fills the card's waves;
//   each part writes its f32 partial [S, K, N] and a second kernel sums
//   them in a fixed order in f64.  No atomics.  Blocks of one part and row
//   tile are adjacent in the grid, so they run together and find W^T's
//   stages in L2.
//
// The layer's backward (kernels/cin.py) takes its input gradients from this
// kernel with permuted weights (dx_0 at H = 200 in one launch), and its
// weight gradient from cin_weight_grad below, which replaces no TPU kernel
// (the reference's CIN has no backward; training xDeepFM on the card needs
// one):
//
//     dW[k, h, m] = sum_{b, d} g[b, k, d] * x_k[b, h, d] * x_0[b, m, d]
//
// the GEMM dW^T[j, k] = sum_c Z[c, j] G[c, k] over the B * D columns c =
// b * D + d (655,360 at B = 65,536), with Z[c, j] = x_k[b, h, d] *
// x_0[b, m, d] never kept in device memory and G[c, k] = g[b, k, d].
// Bound on an H100: operations, 2*K*H*M*D*B FLOPs (as the forward) at
// 67 TFLOP/s f32, or three TF32 products each at 495 TFLOP/s on the
// tensor cores; bytes 4*(H + M + K)*D a sample plus 4*K*H*M.
//
// Design (cin_wgrad_kernel: warp-specialised, wgmma tf32):
// - A block owns kGJt = 64 values of j by kGKt = 208 rows k (K = 200 in
//   one tile; more K in more tiles).  Its two consumer warpgroups share
//   one Z tile and split the rows k, 104 each: dW^T's [64, 104] tile is
//   wgmma.m64n104k8 with Z^T as A and G^T as B, both from shared memory,
//   K-major (the column index c contiguous), 128-byte swizzled.
// - G is the same for every block of a k tile, so prep_g_kernel splits
//   g once into TF32 hi and lo, in the byte order of the stage tiles, into
//   scratch from the caller; a stage's G^T (53,248 bytes) then lands in
//   shared memory by one bulk copy on the stage's mbarrier.
// - Two producer warpgroups fill a 2-stage ring, kGCols = 32 columns a
//   stage: each lane owns one column, forms its Z values x_k * x_0 (8 of
//   the 64 rows j), splits each once into TF32 hi and lo and stores both
//   into the swizzled tile.  So every Z value is formed and split once a
//   call for its block, every g value once a call, and the consumers only
//   multiply, keeping one stage's products in flight while they issue the
//   next.
// - Precision: 3xTF32 as the forward: lo.hi + hi.lo + hi.hi into a f32
//   accumulator, which is added into a Kahan pair every kGFlush stages
//   (F = 32 k-steps).  The pair's compensation is the accumulator's next
//   start, so a flush costs 3 adds; its sum lives in shared memory, which
//   keeps a consumer thread's registers (the 52 accumulators) inside the
//   128 that 512 threads allow.  The CPU tests emulate this sum at
//   B = 65,536 (tests/test_torch_split_precision.py).
// - Occupancy: 122 j tiles at H = 200, M = 39 fill 122 of 132 SMs; the
//   wrapper splits the stages into S parts when the tiles alone would
//   not fill the card, each part writes its f32 partial [S, K, H * M],
//   and sum_splits_kernel adds them in a fixed order in f64.  Blocks of
//   the same part (the same samples) are adjacent in the grid, so they run
//   together and find g's stages and x_k and x_0 in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

// ---- the forward, cin_kernel -------------------------------------------
constexpr int kFCols = 128;                // columns c = b * D + d a block
constexpr int kFJ = 32;                    // values of j a stage
constexpr int kFRowsS = 40;                // rows k a block when K <= 40
constexpr int kFRowsL = 104;               // and when K > 40
constexpr int kFStages = 2;                // stages in the ring, at least
constexpr int kFStagesMax = 3;             // where the shared memory holds them
constexpr int kFFlush = 4;                 // stages a Kahan flush
constexpr int kFProd = 256;                // producer threads (2 warpgroups)
constexpr int kFThreads = kFProd + 256;    // and 2 consumer warpgroups
constexpr int kFProdRegs = 96;             // registers a producer thread keeps
constexpr int kFConsRegs = 160;            // and a consumer thread takes
constexpr int kFZ = kFCols * 128;          // bytes of a Z^T part [128][32]
constexpr int kFStageL = 2 * kFZ + 2 * kFRowsL * 128;  // a stage at N = 104
constexpr int kFFixed = kFStages * kFStageL + 2 * kFStages * 8;
// the fields of x_0 the rest of the shared memory holds: 512 bytes a field
constexpr int kFMaxFields = (kMaxSmem - kFFixed) / (kFCols * 4);

// w split once into TF32 hi and lo in the order of the W^T stage tiles:
// for row tile kt and stage st, the 2 * N * 128 bytes of wp from ((kt *
// n_stages + st) * 2 * N * 128) hold the hi and then the lo part of
// W^T[st * kFJ + c][k0 + r] = w[k0 + r, j] at sw128(r, c / 4) + (c % 4) * 4
// (0 past K or H * M), the bytes a stage's bulk copy lands in shared memory
template <int N>
__global__ void prep_w_kernel(const float* __restrict__ w,
                              float* __restrict__ wp, int K, int HM,
                              int n_stages, int n_ktiles) {
  const long long n = (long long)n_ktiles * n_stages * N * kFJ;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % kFJ);
    const int r = (int)((i / kFJ) % N);
    const long long t = i / ((long long)kFJ * N);        // kt * stages + st
    const long long st = t % n_stages;
    const int k = (int)(t / n_stages) * N + r;
    const long long j = st * kFJ + c;
    const float x = k < K && j < HM ? w[(long long)k * HM + j] : 0.f;
    uint32_t hi, lo;
    split(x, hi, lo);
    float* tile = wp + t * (2 * N * kFJ);
    const uint32_t off = (hopper::sw128(r, c >> 2) + (c & 3) * 4) / 4;
    tile[off] = __uint_as_float(hi);
    tile[N * kFJ + off] = __uint_as_float(lo);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == kFRowsS)
    hopper::wgmma_tf32_n40(d, da, db, 1);
  else
    hopper::wgmma_tf32_n104(d, da, db, 1);
}

template <int N, int STAGES>
__global__ void __launch_bounds__(kFThreads, 1)
cin_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
           const float* __restrict__ wp, float* __restrict__ out,
           float* __restrict__ part, int B, int H, int M, int D, int K,
           int n_ctiles, int n_ktiles, int cps, int n_stages) {
  using namespace hopper;
  constexpr int WT = N * 128;              // bytes of a W^T part [N][32]
  constexpr int STAGE = 2 * kFZ + 2 * WT;  // Z^T hi, lo; W^T hi, lo
  // 1024-byte aligned as declared (a launch that breaks that traps): the
  // third stage at M' = 200 has no room for a slack to align it by hand
  extern __shared__ __align__(1024) uint8_t sm[];
  float* x0s = reinterpret_cast<float*>(sm + STAGES * STAGE);  // [M][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(x0s + M * kFCols);
  uint64_t* empty = full + STAGES;

  int bid = blockIdx.x;
  const int ct = bid % n_ctiles;           // columns fastest: a part's
  bid /= n_ctiles;                         // blocks run together
  const int kt = bid % n_ktiles;
  const int s = bid / n_ktiles;            // part of the reduction
  const long long c0 = (long long)ct * kFCols;
  const int k0 = kt * N;
  const long long NC = (long long)B * D;
  const int st0 = s * cps;
  const int n_part = min(cps, n_stages - st0);   // stages of the part

  if (threadIdx.x == 0) {
    if (saddr(sm) % 1024 != 0) __trap();
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], kFProd);
      mbar_init(&empty[i], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  constexpr int NP = kFProd / 128;
  if (threadIdx.x < kFProd) {
    // ---- producers: thread p of warpgroup pw owns column c0 + p, row p of
    // the Z^T tiles, and the stage's values of j from ZJ pw; thread 0
    // brings the stage's W^T (hi and lo, split by prep_w_kernel) with one
    // bulk copy
    constexpr int ZJ = kFJ / NP;           // values of j a thread a stage
    reg_dealloc<kFProdRegs>();
    const int pw = threadIdx.x / 128;
    const int p = threadIdx.x % 128;
    const long long c = c0 + p;
    const bool live = c < NC;
    const long long b = live ? c / D : 0;
    const int dd = live ? (int)(c - b * D) : 0;
    const float* cxk = xk + b * H * D + dd;
    const float* cx0 = x0 + b * M * D + dd;
    for (int m = pw; m < M; m += NP)       // read back by every producer
      x0s[m * kFCols + p] = live ? __ldg(cx0 + (long long)m * D) : 0.f;
    named_sync(1, kFProd);
    auto xk_at = [&](int h) {
      return live && h < H ? __ldg(cxk + (long long)h * D) : 0.f;
    };
    const long long j0 = (long long)st0 * kFJ + ZJ * pw;
    int h = (int)(j0 / M);                 // (h, m) of the thread's first j
    int m = (int)(j0 - (long long)h * M);
    float xa = xk_at(h), xb = xk_at(h + 1);   // x_k at h and at h + 1
    const float* wsrc = wp + ((long long)kt * n_stages + st0) * (2 * WT / 4);
    for (int n = 0; n < n_part; ++n) {
      const int st = n % STAGES;
      // the next stage's first (h, m) and its x_k, loaded a stage ahead
      int hn = h, mn = m + kFJ;
      while (mn >= M) {
        mn -= M;
        ++hn;
      }
      const float xna = xk_at(hn), xnb = xk_at(hn + 1);
      float z[ZJ];                         // 0 past H * M: x_k is 0 there
      if (M >= ZJ) {                       // at most one new h: loads apart
#pragma unroll
        for (int i = 0; i < ZJ; ++i) {
          const bool next = m + i >= M;
          z[i] = (next ? xb : xa) * x0s[(m + i - (next ? M : 0)) * kFCols + p];
        }
      } else {
        int hh = h, mm = m;
        float xc = xa;
#pragma unroll
        for (int i = 0; i < ZJ; ++i) {
          z[i] = xc * x0s[mm * kFCols + p];
          if (++mm == M) {
            mm = 0;
            xc = xk_at(++hh);
          }
        }
      }
      h = hn;
      m = mn;
      xa = xna;
      xb = xnb;
      if (n >= STAGES) mbar_wait(&empty[st], ((n / STAGES) - 1) & 1);
      uint8_t* zs = sm + st * STAGE;
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[st], 2 * WT);
        bulk_load(zs + 2 * kFZ, wsrc + (long long)n * (2 * WT / 4), 2 * WT,
                  &full[st]);
      }
#pragma unroll
      for (int q = 0; q < ZJ / 4; ++q) {
        uint4 hi, lo;
        split(z[4 * q], hi.x, lo.x);
        split(z[4 * q + 1], hi.y, lo.y);
        split(z[4 * q + 2], hi.z, lo.z);
        split(z[4 * q + 3], hi.w, lo.w);
        const uint32_t off = sw128(p, ZJ / 4 * pw + q);
        *reinterpret_cast<uint4*>(zs + off) = hi;
        *reinterpret_cast<uint4*>(zs + kFZ + off) = lo;
      }
      fence_async_shared();
      mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumers: warpgroup cw takes columns c0 + 64 cw .. + 63; one
  // group of products stays in flight while the next stage is issued
  reg_alloc<kFConsRegs>();
  const int cw = threadIdx.x / 128 - NP;
  const int tw = threadIdx.x % 128;
  const int ww = tw / 32;
  const int lane = tw % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the Kahan pairs: sums in tot, compensations in acc, which the next
  // flush window starts from
  float acc[N / 2], tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = tot[i] = 0.f;
  const uint64_t z_a = desc(sm + cw * 64 * 128, 16, 1024);
  const uint64_t w_b = desc(sm + 2 * kFZ, 16, 1024);
  for (int n0 = 0; n0 < n_part; n0 += kFFlush) {
    const int n1 = min(n0 + kFFlush, n_part);
    for (int n = n0; n < n1; ++n) {
      const int st = n % STAGES;
      mbar_wait(&full[st], (n / STAGES) & 1);
      const uint32_t so = st * STAGE;
      wg_fence();
#pragma unroll
      for (int o = 0; o < kFJ * 4; o += 32) {          // k-steps of 8 j
        wgmma_tf32<N>(acc, at(z_a, so + kFZ + o), at(w_b, so + o));  // lo hi
        wgmma_tf32<N>(acc, at(z_a, so + o), at(w_b, so + WT + o));   // hi lo
        wgmma_tf32<N>(acc, at(z_a, so + o), at(w_b, so + o));        // hi hi
      }
      wg_commit();
      wg_wait<1>();                        // the stage before has been read
      if (n > n0) mbar_arrive(&empty[(n - 1) % STAGES]);
    }
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(n1 - 1) % STAGES]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {      // Kahan; acc keeps the compensation
      const float u = tot[i] + acc[i];
      acc[i] = acc[i] - (u - tot[i]);
      tot[i] = u;
    }
  }

#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long c = c0 + 64 * cw + 16 * ww + g + 8 * (e >> 1);
      const int k = k0 + 8 * i + 2 * t + (e & 1);
      if (c >= NC || k >= K) continue;
      const float x = tot[4 * i + e] + acc[4 * i + e];
      if (part)
        part[((long long)s * K + k) * NC + c] = x;
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

constexpr int kGJt = 64;                   // values of j a block
constexpr int kGN = 104;                   // rows k a consumer warpgroup
constexpr int kGKt = 2 * kGN;              // rows k a block
constexpr int kGCols = 32;                 // columns c = b * D + d a stage
constexpr int kGStages = 2;                // stages in the ring
constexpr int kGFlush = 8;                 // stages a Kahan flush
constexpr int kGProd = 256;                // producer threads (2 groups)
constexpr int kGThreads = kGProd + 256;    // and 2 consumer warpgroups
constexpr int kGZ = kGJt * 128;            // bytes of a Z^T part [64][32]
constexpr int kGG = kGKt * 128;            // bytes of a G^T part [208][32]
constexpr int kGStage = 2 * kGZ + 2 * kGG; // hi and lo of both
constexpr int kGTot = 256 * (kGN / 2) * 4;  // the consumers' Kahan sums
constexpr int kGSmem = kGStages * kGStage + kGTot + 2 * kGStages * 8 + 1024;

// g split once into TF32 hi and lo in the order of the G^T stage tiles:
// for k tile kt and stage st, the 2 * kGG bytes of gp from ((kt * n_stages
// + st) * 2 * kGG) hold the hi and then the lo part of G^T[k0 + r][st *
// kGCols + c] at sw128(r, c / 4) + (c % 4) * 4 (0 past K or B * D), the
// bytes a stage's bulk copy lands in shared memory
__global__ void prep_g_kernel(const float* __restrict__ gr,
                              float* __restrict__ gp, int K, int D,
                              long long N, long long n_stages, int n_ktiles) {
  const long long n = (long long)n_ktiles * n_stages * kGKt * kGCols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % kGCols);
    const int r = (int)((i / kGCols) % kGKt);
    const long long t = i / ((long long)kGCols * kGKt);   // kt * stages + st
    const long long st = t % n_stages;
    const int k = (int)(t / n_stages) * kGKt + r;
    const long long col = st * kGCols + c;
    float x = 0.f;
    if (k < K && col < N) {
      const long long b = col / D;
      x = gr[(b * K + k) * D + (col - b * D)];
    }
    uint32_t hi, lo;
    split(x, hi, lo);
    float* tile = gp + t * (2 * kGG / 4);
    const uint32_t off = (hopper::sw128(r, c >> 2) + (c & 3) * 4) / 4;
    tile[off] = __uint_as_float(hi);
    tile[kGG / 4 + off] = __uint_as_float(lo);
  }
}

__global__ void __launch_bounds__(kGThreads, 1)
cin_wgrad_kernel(const float* __restrict__ gp, const float* __restrict__ xk,
                 const float* __restrict__ x0, float* __restrict__ dw,
                 float* __restrict__ part, int B, int H, int M, int D,
                 int K, int n_jtiles, int n_ktiles, int cps, int n_stages) {
  using namespace hopper;
  extern __shared__ uint8_t gsm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gsm_raw) + 1023) & ~uintptr_t(1023));
  float* tot_s = reinterpret_cast<float*>(sm + kGStages * kGStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kGStages * kGStage +
                                               kGTot);
  uint64_t* empty = full + kGStages;

  int bid = blockIdx.x;
  const int jt = bid % n_jtiles;           // j fastest: a part's blocks
  bid /= n_jtiles;                         // run together
  const int kt = bid % n_ktiles;
  const int s = bid / n_ktiles;            // part of the reduction
  const int HM = H * M;
  const int j0 = jt * kGJt;
  const int k0 = kt * kGKt;
  const int st0 = s * cps;
  const int nst = min(cps, n_stages - st0);
  const long long N = (long long)B * D;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGStages; ++i) {
      mbar_init(&full[i], kGProd);
      mbar_init(&empty[i], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kGProd) {
    // ---- producers: lane cl owns column cl of every stage, warp pw the
    // rows pw + 8 i of Z^T; thread 0 brings the stage's G^T (hi and lo,
    // split by prep_g_kernel) with one bulk copy
    constexpr int PW = kGProd / 32;
    constexpr int ZR = kGJt / PW;          // rows of Z^T a thread
    const int cl = threadIdx.x % 32;
    const int pw = threadIdx.x / 32;
    int hD[ZR], mD[ZR];                    // x_k, x_0 row offsets of j
#pragma unroll
    for (int i = 0; i < ZR; ++i) {
      const int j = j0 + pw + PW * i;
      hD[i] = j < HM ? (j / M) * D : -1;
      mD[i] = j < HM ? (j % M) * D : 0;
    }
    const float* gsrc = gp + ((long long)kt * n_stages + st0) * (2 * kGG / 4);
    for (int n = 0; n < nst; ++n) {
      const int st = n % kGStages;
      const long long c = (long long)(st0 + n) * kGCols + cl;
      const float *cxk = xk, *cx0 = x0;
      bool live = c < N;
      if (live) {
        const long long b = c / D;
        const int dd = (int)(c - b * D);
        cxk = xk + b * H * D + dd;
        cx0 = x0 + b * M * D + dd;
      }
      float z[ZR];
#pragma unroll
      for (int i = 0; i < ZR; ++i)
        z[i] = live && hD[i] >= 0
                   ? __ldg(cxk + hD[i]) * __ldg(cx0 + mD[i]) : 0.f;
      if (n >= kGStages) mbar_wait(&empty[st], ((n / kGStages) - 1) & 1);
      uint8_t* zs = sm + st * kGStage;     // Z^T hi, lo; G^T hi, lo
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[st], 2 * kGG);
        bulk_load(zs + 2 * kGZ, gsrc + (long long)n * (2 * kGG / 4), 2 * kGG,
                  &full[st]);
      }
#pragma unroll
      for (int i = 0; i < ZR; ++i) {
        uint32_t hi, lo;
        split(z[i], hi, lo);
        const uint32_t off = sw128(pw + PW * i, cl >> 2) + (cl & 3) * 4;
        *reinterpret_cast<uint32_t*>(zs + off) = hi;
        *reinterpret_cast<uint32_t*>(zs + kGZ + off) = lo;
      }
      fence_async_shared();
      mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumers: warpgroup cw takes rows k0 + 104 cw .. + 103; one
  // group of products stays in flight while the next stage is issued
  const int cw = (threadIdx.x - kGProd) / 128;
  const int tw = threadIdx.x % 128;
  const int ww = tw / 32;
  const int lane = tw % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the Kahan pairs: sums in shared memory ([kGN / 2][256], the thread's
  // column), compensations in acc, which the next flush window starts from
  float* tot = tot_s + (threadIdx.x - kGProd);
  float acc[kGN / 2];
#pragma unroll
  for (int i = 0; i < kGN / 2; ++i) {
    acc[i] = 0.f;
    tot[i * 256] = 0.f;
  }
  const uint64_t z_a = desc(sm, 16, 1024);
  const uint64_t g_b = desc(sm + 2 * kGZ + cw * kGN * 128, 16, 1024);
  for (int n0 = 0; n0 < nst; n0 += kGFlush) {
    const int n1 = min(n0 + kGFlush, nst);
    for (int n = n0; n < n1; ++n) {
      const int st = n % kGStages;
      mbar_wait(&full[st], (n / kGStages) & 1);
      const uint64_t so = (uint64_t)(st * kGStage) >> 4;
      const uint64_t zd = z_a + so, gd = g_b + so;
      wg_fence();
#pragma unroll
      for (int o = 0; o < kGCols * 4; o += 32) {      // k-steps of 8 columns
        wgmma_tf32_n104(acc, at(zd, kGZ + o), at(gd, o), 1);     // lo hi
        wgmma_tf32_n104(acc, at(zd, o), at(gd, kGG + o), 1);     // hi lo
        wgmma_tf32_n104(acc, at(zd, o), at(gd, o), 1);           // hi hi
      }
      wg_commit();
      wg_wait<1>();                        // the stage before has been read
      if (n > n0) mbar_arrive(&empty[(n - 1) % kGStages]);
    }
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(n1 - 1) % kGStages]);
#pragma unroll
    for (int i = 0; i < kGN / 2; ++i) {    // Kahan; acc keeps the compensation
      const float t0 = tot[i * 256];
      const float u = t0 + acc[i];
      acc[i] = acc[i] - (u - t0);
      tot[i * 256] = u;
    }
  }

#pragma unroll
  for (int i = 0; i < kGN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 16 * ww + g + 8 * (e >> 1);
      const int k = k0 + cw * kGN + 8 * i + 2 * t + (e & 1);
      if (j >= HM || k >= K) continue;
      const float x = tot[(4 * i + e) * 256] + acc[4 * i + e];
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

template <int N, int STAGES>
cudaError_t launch_layer(const float* xk, const float* x0, const float* wp,
                         float* out, float* part, int B, int H, int M, int D,
                         int K, int S, int cps, int n_stages, long long blocks,
                         int n_ctiles, int n_ktiles, cudaStream_t st) {
  constexpr int STAGE = 2 * kFZ + 2 * N * 128;
  const int smem = STAGES * STAGE + M * kFCols * 4 + 2 * STAGES * 8;
  cudaError_t err = cudaFuncSetAttribute(
      cin_kernel<N, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  cin_kernel<N, STAGES><<<(unsigned)blocks, kFThreads, smem, st>>>(
      xk, x0, wp, out, S > 1 ? part : nullptr, B, H, M, D, K, n_ctiles,
      n_ktiles, cps, n_stages);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_layer(const float* xk, const float* x0, const float* w,
                      float* out, float* wp, float* part, int B, int H,
                      int M, int D, int K, int S, int cps, int n_stages,
                      cudaStream_t st) {
  constexpr int STAGE = 2 * kFZ + 2 * N * 128;
  const int n_ktiles = (K + N - 1) / N;
  const long long NC = (long long)B * D;
  const long long n_ctiles = (NC + kFCols - 1) / kFCols;
  const long long blocks = n_ctiles * n_ktiles * S;
  const int deep = kFStagesMax * STAGE + M * kFCols * 4 +
                   2 * kFStagesMax * 8;
  if (blocks > 0x7fffffffLL || M > kFMaxFields ||
      (n_stages > 0 && (wp == nullptr || (uintptr_t)wp % 16 != 0)))
    return cudaErrorInvalidValue;
  const long long n_wp = (long long)n_ktiles * n_stages * N * kFJ;
  if (n_wp > 0) {
    const long long wb = (n_wp + 255) / 256;
    prep_w_kernel<N><<<(unsigned)(wb < 65536 ? wb : 65536), 256, 0, st>>>(
        w, wp, K, H * M, n_stages, n_ktiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err =
      deep <= kMaxSmem
          ? launch_layer<N, kFStagesMax>(xk, x0, wp, out, part, B, H, M, D, K,
                                         S, cps, n_stages, blocks,
                                         (int)n_ctiles, n_ktiles, st)
          : launch_layer<N, kFStages>(xk, x0, wp, out, part, B, H, M, D, K,
                                      S, cps, n_stages, blocks,
                                      (int)n_ctiles, n_ktiles, st);
  if (err != cudaSuccess || S == 1) return err;
  const long long n_out = (long long)K * NC;
  sum_parts_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      part, out, S, K, NC, D);
  return cudaGetLastError();
}

}  // namespace

// x_k [B, H, D], x_0 [B, M, D], w [K, H, M], out [B, K, D], float32, M <=
// kFMaxFields.  The ceil(H * M / 32) stages of j are split into S parts of
// cps stages each, (S - 1) * cps < stages <= S * cps.  Scratch from the
// caller: wprep, ceil(K / N) * stages * 2 * N * 32 floats, 16-byte
// aligned, N = 40 if K <= 40 else 104; and when S > 1 part, S * K * B * D
// floats (else null).
extern "C" int cin_layer(const float* xk, const float* x0, const float* w,
                         float* out, void* wprep, float* part, int B, int H,
                         int M, int D, int K, int S, int cps, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0) return (int)cudaSuccess;
  if (H < 0 || M <= 0 || M > kFMaxFields || (long long)H * M >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int n_stages = (H * M + kFJ - 1) / kFJ;
  if (S < 1 || cps < 1 || (long long)S * cps < n_stages ||
      (S > 1 && ((long long)(S - 1) * cps >= n_stages || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wp = static_cast<float*>(wprep);
  const cudaError_t err =
      K <= kFRowsS
          ? run_layer<kFRowsS>(xk, x0, w, out, wp, part, B, H, M, D, K, S,
                               cps, n_stages, st)
          : run_layer<kFRowsL>(xk, x0, w, out, wp, part, B, H, M, D, K, S,
                               cps, n_stages, st);
  return (int)err;
}

// g [B, K, D], x_k [B, H, D], x_0 [B, M, D] -> dw [K, H, M], float32: the
// weight gradient of cin_layer for the upstream gradient g.  The
// ceil(B * D / 32) stages of 32 columns are split into S parts of cps
// stages each, (S - 1) * cps < stages <= S * cps.  Scratch from the
// caller, float32: gprep, ceil(K / 208) * stages * 13,312 floats (16-byte
// aligned), and when S > 1 part, S * K * H * M floats (else null).
extern "C" int cin_weight_grad(const float* g, const float* xk,
                               const float* x0, float* dw, float* gprep,
                               float* part, int B, int H, int M, int D,
                               int K, int S, int cps, void* stream) {
  if (H <= 0 || M <= 0 || K <= 0) return (int)cudaSuccess;
  if (B < 0 || D <= 0 || (long long)H * M >= (1 << 30) ||
      (long long)B * D >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const long long n_stages = ((long long)B * D + kGCols - 1) / kGCols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)K * H * M;
  if (n_stages == 0)
    return (int)cudaMemsetAsync(dw, 0, n_out * sizeof(float), st);
  if (n_stages > 0x7fffffffLL || S < 1 || cps < 1 ||
      (long long)S * cps < n_stages ||
      (S > 1 && ((long long)(S - 1) * cps >= n_stages || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int n_jtiles = (H * M + kGJt - 1) / kGJt;
  const int n_ktiles = (K + kGKt - 1) / kGKt;
  const long long blocks = (long long)n_jtiles * n_ktiles * S;
  if (blocks > 0x7fffffffLL || gprep == nullptr ||
      (uintptr_t)gprep % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_prep = (long long)n_ktiles * n_stages * kGKt * kGCols;
  const long long pb = (n_prep + 255) / 256;
  prep_g_kernel<<<(unsigned)(pb < 65536 ? pb : 65536), 256, 0, st>>>(
      g, gprep, K, D, (long long)B * D, n_stages, n_ktiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      cin_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return (int)err;
  cin_wgrad_kernel<<<(unsigned)blocks, kGThreads, kGSmem, st>>>(
      gprep, xk, x0, dw, S > 1 ? part : nullptr, B, H, M, D, K, n_jtiles,
      n_ktiles, cps, (int)n_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  sum_splits_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      part, dw, S, n_out);
  return (int)cudaGetLastError();
}
