// Flash attention backward on Hopper, sm_90a, plain C interface.
//
// The reference's Pallas kernel flash_attention
// (src/repro/kernels/flash_attn.py) has no backward: the reference trains
// through its jnp online softmax.  The port's forward is B6
// (flash_attn.cu) on every LM layer, so training on the card needs this
// kernel; it replaces no TPU kernel.  For each (batch, head), with the
// forward's q, k, v, o [S, d], the upstream gradient dO and the forward's
// per-row log-sum-exp L (flash_attention_lse):
//
//     P = exp(q k^T / sqrt(d) - L)        (masked entries 0)
//     dV = P^T dO,   dS = P o (dO v^T - D),   D = rowsum(dO o o)
//     dQ = dS k / sqrt(d),   dK = dS^T q / sqrt(d)
//
// FA2's backward in three launches, deterministic (no atomics): a tiny
// kernel for D (one warp a row), one block a (bh, 64 keys) for dK and dV,
// which recomputes P over the query tiles that reach its keys (under the
// causal mask those at or below the diagonal), and one block a (bh, 64
// queries) for dQ over the key tiles.  Each gradient is summed in
// registers by the block that owns it, so no partial sums leave the block.
//
// - bf16: mma.sync.m16n8k16 with f32 accumulators, as the forward.  Four
//   warps own 16 rows each.  dK/dV: K and V of the block's keys stay in
//   shared memory; Q and dO stream through in tiles of 32 queries
//   (double-buffered cp.async), S^T = K Q^T and dP^T = V dO^T are formed
//   in registers, P^T and dS^T are rounded to bf16 in registers and used
//   directly as the A operands of P^T dO and dS^T Q (the m16n8k16 C layout
//   is its A layout); 32 query columns a tile keep the two f32 [16, d]
//   accumulators and the two score tiles inside 255 registers.  dQ: Q
//   and dO of the block's queries stay in shared memory, K and V stream
//   through in tiles of 64 keys.
// - f32: plain f32 FMA (no tensor cores), 64 x 64 tiles in shared memory,
//   each of 256 threads a 4 x 4 block of scores and 4 rows of the
//   accumulators.  Right first; the f32 path trains the small configs.
//
// Bound on an H100: operations, 5 products of 2 * Sq * Sk * d (S, dP, dV,
// dK, dQ; half when causal) at 989 TFLOP/s dense bf16 or 67 TFLOP/s f32;
// bytes: q, k, v, o, dO, dQ, dK, dV once each and L, D.

#include <math.h>

#include "bf16_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpsB = 4;           // bf16 kernels: warps a block
constexpr int kRows = 16 * kWarpsB;  // keys (dK/dV) or queries (dQ) a block
constexpr int kQt = 32;              // queries a tile of the dK/dV loop
constexpr int kKt = 64;              // keys a tile of the dQ loop
constexpr int kF = 64;               // f32 kernels: rows and columns a tile
constexpr float kLog2eF = 1.4426950408889634f;

// D[r] = sum_c dO[r, c] o[r, c], one warp a row
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, long long rows,
                             int d) {
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += ld(orow + c) * ld(drow + c);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// rows x DMAX bf16 from global (row stride d) into shared (row stride
// DMAX + 8), columns >= d zero; cp.async when vec (d % 8 == 0, aligned)
template <int DMAX>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int rows, int d, int vec) {
  constexpr int DP = DMAX + 8;
  if (vec) {
    for (int i = threadIdx.x; i < rows * DMAX / 8; i += blockDim.x) {
      const int r = i / (DMAX / 8);
      const int c = (i % (DMAX / 8)) * 8;
      const bool in = c < d;
      cp_async16(dst + r * DP + c, src + (long long)r * d + (in ? c : 0),
                 in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DMAX; i += blockDim.x) {
      const int r = i / DMAX;
      const int c = i % DMAX;
      dst[r * DP + c] =
          c < d ? src[(long long)r * d + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(32 * kWarpsB, 1)
dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int Sq,
          int Sk, int d, int causal, int vec, float scale,
          float scale_log2) {
  constexpr int DP = DMAX + 8;
  constexpr int KD = DMAX / 16;      // k-steps over d
  constexpr int ND = DMAX / 8;       // 8-wide column tiles of dK, dV
  constexpr int NS = kQt / 8;        // 8-wide query tiles of S^T
  constexpr int TK = kRows * DP;
  constexpr int TQ = kQt * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [kRows][DP]
  bf16* vs = ks + TK;                             // [kRows][DP]
  bf16* qs = vs + TK;                             // [2][kQt][DP]
  bf16* dos = qs + 2 * TQ;                        // [2][kQt][DP]
  float* ls = reinterpret_cast<float*>(dos + 2 * TQ);   // [2][kQt] L log2e
  float* dls = ls + 2 * kQt;                            // [2][kQt] D

  const int kt = blockIdx.x / BH;        // key tile 0 (most queries) first
  const long long bh = blockIdx.x % BH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int j0 = kt * kRows;
  const int jrow = j0 + 16 * warp + g;   // the thread's keys jrow, + 8

  const bf16* qh = q + bh * Sq * d;
  const bf16* doh = dout + bh * Sq * d;
  const float* lh = lse + bh * Sq;
  const float* dh = delta + bh * Sq;
  load_rows<DMAX>(ks, k + (bh * Sk + j0) * d, kRows, d, vec);
  load_rows<DMAX>(vs, v + (bh * Sk + j0) * d, kRows, d, vec);
  auto load_q = [&](int it, int st) {
    const int i0 = it * kQt;
    load_rows<DMAX>(qs + st * TQ, qh + (long long)i0 * d, kQt, d, vec);
    load_rows<DMAX>(dos + st * TQ, doh + (long long)i0 * d, kQt, d, vec);
    if (threadIdx.x < kQt) {
      ls[st * kQt + threadIdx.x] = lh[i0 + threadIdx.x] * kLog2eF;
      dls[st * kQt + threadIdx.x] = dh[i0 + threadIdx.x];
    }
  };

  // ldmatrix lane offsets (see flash_attn.cu): A from the warp's 16 rows
  // of a row-major [rows, d] tile; B from a row-major [n, k] tile (two
  // 8-wide n-tiles of a 16-deep k-step); B from a row-major [k, n] tile
  // through .trans
  const int a_off = (16 * warp + (lane & 15)) * DP + ((lane >> 4) << 3);
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) << 3;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) << 3;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int it0 = causal ? j0 / kQt : 0;   // queries before j0 see no key
  const int n_it = Sq / kQt;
  load_q(it0, 0);
  cp_commit();                              // with K's and V's copies
  for (int it = it0; it < n_it; ++it) {
    const int st = (it - it0) & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);               // read by no warp since it - 1
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * TQ;
    const bf16* dot = dos + st * TQ;
    const float* lt = ls + st * kQt;
    const float* dt = dls + st * kQt;
    const int i0 = it * kQt;

    // S^T = K Q^T, dP^T = V dO^T: rows the warp's 16 keys, columns the
    // tile's queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + a_off + 16 * kk);
      ldsm_x4(va, vs + a_off + 16 * kk);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int off = (16 * np + b_row) * DP + 16 * kk + b_col;
        uint32_t b[4];
        ldsm_x4(b, qt + off);
        mma(s[2 * np], ka, b[0], b[1]);
        mma(s[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(b, dot + off);
        mma(dp[2 * np], va, b[0], b[1]);
        mma(dp[2 * np + 1], va, b[2], b[3]);
      }
    }
    // P^T into s, dS^T into dp
    const bool diag = causal && i0 < j0 + kRows;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ic = 8 * j + 2 * t + (e & 1);     // query in the tile
        float p = ex2(fmaf(s[j][e], scale_log2, -lt[ic]));
        if (diag && i0 + ic < jrow + 8 * (e >> 1)) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dt[ic]);
      }
    // dV += P^T dO, dK += dS^T Q over the tile's queries
#pragma unroll
    for (int kk = 0; kk < kQt / 16; ++kk) {
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jn = 2 * kk + (r >> 1);
        const int e0 = (r & 1) * 2;
        pa[r] = pack(s[jn][e0], s[jn][e0 + 1]);
        sa[r] = pack(dp[jn][e0], dp[jn][e0 + 1]);
      }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        const int off = (16 * kk + t_row) * DP + 16 * np + t_col;
        uint32_t b[4];
        ldsm_x4_trans(b, dot + off);
        mma(dva[2 * np], pa, b[0], b[1]);
        mma(dva[2 * np + 1], pa, b[2], b[3]);
        ldsm_x4_trans(b, qt + off);
        mma(dka[2 * np], sa, b[0], b[1]);
        mma(dka[2 * np + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();                        // before the next load lands
  }

#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      if (c < d) {
        const long long at = (bh * Sk + jrow + 8 * (e >> 1)) * d + c;
        dk[at] = __float2bfloat16(dka[j][e] * scale);
        dv[at] = __float2bfloat16(dva[j][e]);
      }
    }
}

template <int DMAX>
__global__ void __launch_bounds__(32 * kWarpsB, 1)
dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dq, int BH, int Sq, int Sk, int d, int causal,
        int vec, float scale, float scale_log2) {
  constexpr int DP = DMAX + 8;
  constexpr int KD = DMAX / 16;
  constexpr int ND = DMAX / 8;
  constexpr int NS = kKt / 8;        // 8-wide key tiles of S
  constexpr int TR = kRows * DP;
  constexpr int TK = kKt * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows][DP]
  bf16* dos = qs + TR;                            // [kRows][DP]
  bf16* ks = dos + TR;                            // [2][kKt][DP]
  bf16* vs = ks + 2 * TK;                         // [2][kKt][DP]

  const int n_qt = Sq / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const long long bh = blockIdx.x % BH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kRows;
  const int row0 = q0 + 16 * warp + g;   // the thread's rows row0, + 8

  const bf16* kh = k + bh * Sk * d;
  const bf16* vh = v + bh * Sk * d;
  load_rows<DMAX>(qs, q + (bh * Sq + q0) * d, kRows, d, vec);
  load_rows<DMAX>(dos, dout + (bh * Sq + q0) * d, kRows, d, vec);
  auto load_kv = [&](int kt, int st) {
    const long long base = (long long)kt * kKt * d;
    load_rows<DMAX>(ks + st * TK, kh + base, kKt, d, vec);
    load_rows<DMAX>(vs + st * TK, vh + base, kKt, d, vec);
  };
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l2[r] = lse[bh * Sq + row0 + 8 * r] * kLog2eF;
    dl[r] = delta[bh * Sq + row0 + 8 * r];
  }

  const int a_off = (16 * warp + (lane & 15)) * DP + ((lane >> 4) << 3);
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) << 3;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) << 3;

  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  int n_kt = Sk / kKt;
  if (causal) {
    const int last = (q0 + kRows + kKt - 1) / kKt;
    n_kt = last < n_kt ? last : n_kt;
  }
  load_kv(0, 0);
  cp_commit();                              // with Q's and dO's copies
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = ks + st * TK;
    const bf16* vt_s = vs + st * TK;

    // S = Q K^T, dP = dO V^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, qs + a_off + 16 * kk);
      ldsm_x4(da, dos + a_off + 16 * kk);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int off = (16 * np + b_row) * DP + 16 * kk + b_col;
        uint32_t b[4];
        ldsm_x4(b, kt_s + off);
        mma(s[2 * np], qa, b[0], b[1]);
        mma(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_x4(b, vt_s + off);
        mma(dp[2 * np], da, b[0], b[1]);
        mma(dp[2 * np + 1], da, b[2], b[3]);
      }
    }
    const int k0 = kt * kKt;
    const bool diag = causal && k0 + kKt - 1 > q0;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(s[j][e], scale_log2, -l2[r]));
        if (diag && k0 + 8 * j + 2 * t + (e & 1) > row0 + 8 * r) p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    // dQ += dS K over the tile's keys
#pragma unroll
    for (int kk = 0; kk < kKt / 16; ++kk) {
      uint32_t sa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jn = 2 * kk + (r >> 1);
        const int e0 = (r & 1) * 2;
        sa[r] = pack(dp[jn][e0], dp[jn][e0 + 1]);
      }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, kt_s + (16 * kk + t_row) * DP + 16 * np + t_col);
        mma(dqa[2 * np], sa, b[0], b[1]);
        mma(dqa[2 * np + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      if (c < d)
        dq[(bh * Sq + row0 + 8 * (e >> 1)) * d + c] =
            __float2bfloat16(dqa[j][e] * scale);
    }
}

// rows x DMAX f32 from global (row stride d) into shared (row stride
// DMAX + 1), columns >= d zero
template <int DMAX>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int rows, int d) {
  for (int i = threadIdx.x; i < rows * DMAX; i += blockDim.x) {
    const int r = i / DMAX;
    const int c = i % DMAX;
    dst[r * (DMAX + 1) + c] = c < d ? __ldg(src + (long long)r * d + c) : 0.f;
  }
}

// the 4 x 4 dot products of rows 4 ty + a of x and y with rows 4 tx + b
// of u and w: sxu[a][b] = x . u, syw[a][b] = y . w, over DMAX columns
template <int DMAX>
__device__ __forceinline__ void dots4(const float* x, const float* y,
                                      const float* u, const float* w,
                                      int ty, int tx, float (&sxu)[4][4],
                                      float (&syw)[4][4]) {
  constexpr int DS = DMAX + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sxu[a][b] = syw[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DMAX; ++c) {
    float xa[4], ya[4], ub[4], wb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      xa[a] = x[(4 * ty + a) * DS + c];
      ya[a] = y[(4 * ty + a) * DS + c];
      ub[a] = u[(4 * tx + a) * DS + c];
      wb[a] = w[(4 * tx + a) * DS + c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sxu[a][b] = fmaf(xa[a], ub[b], sxu[a][b]);
        syw[a][b] = fmaf(ya[a], wb[b], syw[a][b]);
      }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(256)
dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dk, float* __restrict__ dv, int BH, int Sq,
         int Sk, int d, int causal, float scale) {
  constexpr int DS = DMAX + 1;
  constexpr int PS = kF + 1;
  constexpr int NC = DMAX / 16;      // accumulator columns a thread
  extern __shared__ float fsm[];
  float* ks = fsm;
  float* vs = ks + kF * DS;
  float* qs = vs + kF * DS;
  float* dos = qs + kF * DS;
  float* ps = dos + kF * DS;         // P^T [key][query]
  float* dss = ps + kF * PS;         // dS^T
  float* ls = dss + kF * PS;
  float* dls = ls + kF;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int kt = blockIdx.x / BH;
  const long long bh = blockIdx.x % BH;
  const int j0 = kt * kF;
  load_rows_f32<DMAX>(ks, k + (bh * Sk + j0) * d, kF, d);
  load_rows_f32<DMAX>(vs, v + (bh * Sk + j0) * d, kF, d);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) dka[a][b] = dva[a][b] = 0.f;

  for (int it = causal ? j0 / kF : 0; it < Sq / kF; ++it) {
    const int i0 = it * kF;
    __syncthreads();                 // every thread is done with the tile
    load_rows_f32<DMAX>(qs, q + (bh * Sq + i0) * d, kF, d);
    load_rows_f32<DMAX>(dos, dout + (bh * Sq + i0) * d, kF, d);
    if (tid < kF) {
      ls[tid] = lse[bh * Sq + i0 + tid];
      dls[tid] = delta[bh * Sq + i0 + tid];
    }
    __syncthreads();
    float s[4][4], dp[4][4];         // keys 4 ty + a, queries 4 tx + b
    dots4<DMAX>(ks, vs, qs, dos, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jj = 4 * ty + a;
        const int ii = 4 * tx + b;
        const float p = causal && i0 + ii < j0 + jj
                            ? 0.f : expf(s[a][b] * scale - ls[ii]);
        ps[jj * PS + ii] = p;
        dss[jj * PS + ii] = p * (dp[a][b] - dls[ii]);
      }
    __syncthreads();
    for (int i = 0; i < kF; ++i) {
      float pj[4], sj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pj[a] = ps[(4 * ty + a) * PS + i];
        sj[a] = dss[(4 * ty + a) * PS + i];
      }
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const float dov = dos[i * DS + tx + 16 * b];
        const float qv = qs[i * DS + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          dva[a][b] = fmaf(pj[a], dov, dva[a][b]);
          dka[a][b] = fmaf(sj[a], qv, dka[a][b]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int c = tx + 16 * b;
      if (c < d) {
        const long long at = (bh * Sk + j0 + 4 * ty + a) * d + c;
        dk[at] = dka[a][b] * scale;
        dv[at] = dva[a][b];
      }
    }
}

template <int DMAX>
__global__ void __launch_bounds__(256)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       float* __restrict__ dq, int BH, int Sq, int Sk, int d, int causal,
       float scale) {
  constexpr int DS = DMAX + 1;
  constexpr int PS = kF + 1;
  constexpr int NC = DMAX / 16;
  extern __shared__ float fsm[];
  float* qs = fsm;
  float* dos = qs + kF * DS;
  float* ks = dos + kF * DS;
  float* vs = ks + kF * DS;
  float* dss = vs + kF * DS;         // dS [query][key]
  float* ls = dss + kF * PS;
  float* dls = ls + kF;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int qt = Sq / kF - 1 - (int)(blockIdx.x / BH);
  const long long bh = blockIdx.x % BH;
  const int q0 = qt * kF;
  load_rows_f32<DMAX>(qs, q + (bh * Sq + q0) * d, kF, d);
  load_rows_f32<DMAX>(dos, dout + (bh * Sq + q0) * d, kF, d);
  if (tid < kF) {
    ls[tid] = lse[bh * Sq + q0 + tid];
    dls[tid] = delta[bh * Sq + q0 + tid];
  }
  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) dqa[a][b] = 0.f;

  const int n_kt = causal ? qt + 1 : Sk / kF;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kF;
    __syncthreads();
    load_rows_f32<DMAX>(ks, k + (bh * Sk + k0) * d, kF, d);
    load_rows_f32<DMAX>(vs, v + (bh * Sk + k0) * d, kF, d);
    __syncthreads();
    float s[4][4], dp[4][4];         // queries 4 ty + a, keys 4 tx + b
    dots4<DMAX>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ii = 4 * ty + a;
        const int jj = 4 * tx + b;
        const float p = causal && k0 + jj > q0 + ii
                            ? 0.f : expf(s[a][b] * scale - ls[ii]);
        dss[ii * PS + jj] = p * (dp[a][b] - dls[ii]);
      }
    __syncthreads();
    for (int j = 0; j < kF; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(4 * ty + a) * PS + j];
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const float kv = ks[j * DS + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) dqa[a][b] = fmaf(sa[a], kv, dqa[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int c = tx + 16 * b;
      if (c < d) dq[(bh * Sq + q0 + 4 * ty + a) * d + c] = dqa[a][b] * scale;
    }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DMAX>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        int BH, int Sq, int Sk, int d, int causal,
                        float scale, float scale_log2, cudaStream_t s) {
  constexpr int DP = DMAX + 8;
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) % 16 == 0;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const int smem_kv = (2 * kRows + 4 * kQt) * DP * (int)sizeof(bf16) +
                      4 * kQt * (int)sizeof(float);
  cudaError_t err = set_smem(dkdv_bf16<DMAX>, smem_kv);
  if (err != cudaSuccess) return err;
  dkdv_bf16<DMAX><<<(unsigned)((long long)BH * (Sk / kRows)),
                    32 * kWarpsB, smem_kv, s>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, Sq, Sk, d, causal, vec, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_q = (2 * kRows + 4 * kKt) * DP * (int)sizeof(bf16);
  err = set_smem(dq_bf16<DMAX>, smem_q);
  if (err != cudaSuccess) return err;
  dq_bf16<DMAX><<<(unsigned)((long long)BH * (Sq / kRows)), 32 * kWarpsB,
                  smem_q, s>>>(qb, kb, vb, db, lse, delta,
                               static_cast<bf16*>(dq), BH, Sq, Sk, d, causal,
                               vec, scale, scale_log2);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int BH, int Sq, int Sk, int d, int causal,
                       float scale, cudaStream_t s) {
  constexpr int DS = DMAX + 1;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  const int smem_kv =
      (4 * kF * DS + 2 * kF * (kF + 1) + 2 * kF) * (int)sizeof(float);
  cudaError_t err = set_smem(dkdv_f32<DMAX>, smem_kv);
  if (err != cudaSuccess) return err;
  dkdv_f32<DMAX><<<(unsigned)((long long)BH * (Sk / kF)), 256, smem_kv,
                   s>>>(qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
                        static_cast<float*>(dv), BH, Sq, Sk, d, causal,
                        scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_q =
      (4 * kF * DS + kF * (kF + 1) + 2 * kF) * (int)sizeof(float);
  err = set_smem(dq_f32<DMAX>, smem_q);
  if (err != cudaSuccess) return err;
  dq_f32<DMAX><<<(unsigned)((long long)BH * (Sq / kF)), 256, smem_q, s>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), BH, Sq, Sk, d,
      causal, scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
                     int d, int causal, int is_bf16, float scale,
                     float scale_log2, cudaStream_t s) {
  return is_bf16 ? launch_bf16<DMAX>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                   Sq, Sk, d, causal, scale, scale_log2, s)
               : launch_f32<DMAX>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                  Sq, Sk, d, causal, scale, s);
}

}  // namespace

// Gradients of o = flash_attention(q, k, v, causal) for the upstream dO:
// q, o, dO, dq [BH, Sq, d]; k, v, dk, dv [BH, Sk, d], all float32 (is_bf16 =
// 0) or bfloat16 (is_bf16 = 1); lse [BH, Sq] float32 from
// flash_attention_lse; delta [BH, Sq] float32 scratch from the caller.
// Sq % 128 == 0, Sk % 64 == 0, 1 <= d <= 128, causal only with Sq == Sk.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int BH, int Sq, int Sk, int d,
                                   int causal, int is_bf16, void* stream) {
  if (d < 1 || d > 128 || Sq % 128 != 0 || Sk % 64 != 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaSuccess;
  const long long blocks = (long long)BH * (Sq > Sk ? Sq : Sk) / 64;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)BH * Sq;
  const unsigned dblocks = (unsigned)((rows + 7) / 8);   // 8 warps a block
  if (is_bf16)
    delta_kernel<<<dblocks, 256, 0, s>>>(static_cast<const bf16*>(o),
                                         static_cast<const bf16*>(dout),
                                         delta, rows, d);
  else
    delta_kernel<<<dblocks, 256, 0, s>>>(static_cast<const float*>(o),
                                         static_cast<const float*>(dout),
                                         delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  const float scale_log2 = (float)(1.0 / sqrt((double)d) * kLog2e);
  if (d <= 32)
    err = dispatch<32>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, d,
                       causal, is_bf16, scale, scale_log2, s);
  else if (d <= 64)
    err = dispatch<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, d,
                       causal, is_bf16, scale, scale_log2, s);
  else
    err = dispatch<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, d,
                        causal, is_bf16, scale, scale_log2, s);
  return (int)err;
}
