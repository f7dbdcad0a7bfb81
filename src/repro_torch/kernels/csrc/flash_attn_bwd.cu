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
// Bound on an H100: operations, the five products S, dP, dV, dK and dQ of
// 2 * Sq * Sk * d each (half when causal) at 989 TFLOP/s dense bf16 (f32:
// the same products at the f32 rate, or three bf16 products each on the
// tensor cores); bytes: q, k, v, o, dO, dQ, dK, dV once each and L, D.
//
// Design: FA2's algorithm on Hopper's machinery, in three launches.
// - delta_kernel: D, one warp a row; it also zeroes dqacc, the f32 dQ
//   accumulator the caller passes as scratch.
// - bwd_kernel: a block owns 64 keys of one (batch, head); their K and V
//   stay in shared memory.  Q, dO, L and D stream through a 3-stage (f32:
//   2-stage) mbarrier ring in tiles of 64 queries.  In bf16 with d = 64
//   or 128 one producer thread fills it by TMA (128-byte swizzle, L and D
//   by bulk copies); else the producer warpgroup's 128 threads load, split
//   (f32) and store the same swizzled layout.
// - bf16: two consumer warpgroups split each tile's products.  The first
//   forms S^T = K Q^T (wgmma from shared memory), P^T in registers, hands
//   f32 P^T to the second through shared memory in accumulator order (each
//   thread reads back its own elements), takes dV += P^T dO with P^T as
//   the register A operand, and dQ's first half of d.  The second forms
//   dP^T = V dO^T and dS^T = P^T (dP^T - D), stores dS^T once in bf16,
//   takes dK += dS^T Q (A from registers) and dQ's second half.  Named
//   barriers order the two hand-offs.  One [64, d] accumulator a
//   warpgroup fits the 168 registers a thread of 384 may hold; two (dK and
//   dV in one warpgroup, 128 keys a block) spilled even under setmaxnreg.
// - dQ_tile = dS K is a wgmma from dS^T and K in shared memory, written to
//   shared memory in the accumulator's own order and added into dqacc by
//   one cp.reduce.async.bulk .add.f32 a half-tile.  So S and dP are formed
//   once: five products, where a separate dQ kernel would recompute both.
// - dq_convert: dQ = dqacc / sqrt(d) in the input type, in [BH, Sq, d]
//   order.
// - f32 on the tensor cores: one consumer warpgroup takes every product,
//   each as lo.hi + hi.lo + hi.hi of bf16 splits hi = bf16(x), lo =
//   bf16(x - hi) (the forward's split, flash_attn.cu).  K, V, Q and dO are
//   split once, by the producer, as their tiles land in shared memory; P^T
//   and dS^T in registers.
// - Causal: a block walks only the query tiles at or after its first key
//   and masks only the diagonal ones.  The key blocks of a head are
//   adjacent in the grid (they share its Q, dO and dQ rows in L2), its
//   first keys (the most query tiles) first.
// - Head widths 1..128, zero-padded to 64 or 128 columns.
// - Determinism: dQ's partial sums from the key blocks are added by the
//   bulk reduce-add in an order that varies from run to run (f32
//   additions in L2); dK and dV are summed in registers, in a fixed order.

#include <dlfcn.h>
#include <math.h>
#include <string.h>

#include <cuda.h>   // CUtensorMap and its enums (types only: no libcuda link)
#include <type_traits>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBq = 64;            // queries a tile
constexpr int kBk = 64;            // keys a block (the wgmma M of its tiles)
constexpr float kLog2eF = 1.4426950408889634f;

// A block: a producer warpgroup and, in bf16, two consumer warpgroups that
// split each tile's products (384 threads, up to 168 registers a thread),
// in f32 one that takes them all (256 threads, up to 255 registers: its
// products take every operand in two parts).  Shared memory in bytes,
// every tile 1024-byte aligned.
template <int DMAX, bool F32>
struct Cfg {
  static constexpr int NWG = F32 ? 1 : 2;        // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int NR = DMAX / 64;           // 128-byte column regions
  static constexpr int NP = F32 ? 2 : 1;         // bf16 parts: hi (and lo)
  static constexpr int STAGES = F32 ? 2 : 3;     // Q / dO / L / D tiles
  static constexpr int KV = NR * kBk * 128;      // a part of K or of V
  static constexpr int QT = NR * kBq * 128;      // a part of a Q or dO tile
  static constexpr int DS = kBk * 128;           // a part of dS^T [64][64]
  static constexpr int PX = 32 * 128 * 4;        // P^T, f32, thread order
  static constexpr int DQ = kBq * DMAX / 2 * 4;  // a half-tile of dQ, f32
  static constexpr int K_OFF = 0;                // [NP] K
  static constexpr int V_OFF = K_OFF + NP * KV;  // [NP] V
  static constexpr int Q_OFF = V_OFF + NP * KV;  // [STAGES][NP] Q
  static constexpr int DO_OFF = Q_OFF + STAGES * NP * QT;    // and dO
  static constexpr int DS_OFF = DO_OFF + STAGES * NP * QT;   // [NWG][NP]
  static constexpr int PX_OFF = DS_OFF + NWG * NP * DS;      // [NWG - 1][2]
  static constexpr int DQ_OFF = PX_OFF + (NWG - 1) * 2 * PX;  // [NWG]
  static constexpr int LD_OFF = DQ_OFF + NWG * DQ;  // [STAGES][2][kBq] L, D
  static constexpr int BAR_OFF = LD_OFF + STAGES * 2 * kBq * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// 8 values of a row from column c0, 0 past d; 16-byte loads when vec
__device__ __forceinline__ void load8(const float* row, int c0, int d,
                                      int vec, float (&x)[8]) {
  if (vec && c0 + 8 <= d) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + c0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + c0 + 4));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = c0 + e < d ? __ldg(row + c0 + e) : 0.f;
  }
}
__device__ __forceinline__ void load8(const bf16* row, int c0, int d,
                                      int vec, float (&x)[8]) {
  if (vec && c0 + 8 <= d) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c0));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = c0 + e < d ? __bfloat162float(row[c0 + e]) : 0.f;
  }
}

// D[r] = sum_c dO[r, c] o[r, c], one warp a row; dqacc's row zeroed.
// 16-byte loads when vec (d a multiple of 16 bytes, o and dO aligned).
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta,
                             float* __restrict__ dqacc, long long rows,
                             int d, int dmax, int vec) {
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  if (vec) {
    for (int c = 8 * lane; c < d; c += 256) {
      float xo[8], xd[8];
      load8(orow, c, d, 1, xo);
      load8(drow, c, d, 1, xd);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += xo[e] * xd[e];
    }
  } else {
    for (int c = lane; c < d; c += 32) acc += ld(orow + c) * ld(drow + c);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
  for (int c = 4 * lane; c < dmax; c += 128)
    *reinterpret_cast<float4*>(dqacc + row * dmax + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows x DMAX of src (row stride d) into the 128-byte swizzled regions of
// a tile (region r holds columns 64 r .. 64 r + 63 of every row), as bf16
// hi and, when SPLIT, lo; the producer warpgroup's 128 threads (tid)
template <int DMAX, bool SPLIT, typename T>
__device__ __forceinline__ void fill_tile(uint8_t* hi, uint8_t* lo,
                                          const T* src, int rows, int d,
                                          int vec, int tid) {
  constexpr int CH = DMAX / 8;             // 16-byte chunks a row
  constexpr int NB = SPLIT ? 4 : 1;        // chunks a thread loads at once
  for (int i0 = tid; i0 < rows * CH; i0 += 128 * NB) {
    float x[NB][8];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + 128 * b;
      if (i < rows * CH)
        load8(src + (long long)(i / CH) * d, (i % CH) * 8, d, vec, x[b]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + 128 * b;
      if (i >= rows * CH) break;
      const int r = i / CH;
      const int ch = i % CH;
      const uint32_t off = (ch / 8) * rows * 128 + sw128(r, ch % 8);
      uint4 h, l;
      if constexpr (SPLIT) {
        split(x[b][0], x[b][1], h.x, l.x);
        split(x[b][2], x[b][3], h.y, l.y);
        split(x[b][4], x[b][5], h.z, l.z);
        split(x[b][6], x[b][7], h.w, l.w);
        *reinterpret_cast<uint4*>(lo + off) = l;
      } else {
        h = make_uint4(pack(x[b][0], x[b][1]), pack(x[b][2], x[b][3]),
                       pack(x[b][4], x[b][5]), pack(x[b][6], x[b][7]));
      }
      *reinterpret_cast<uint4*>(hi + off) = h;
    }
  }
}

// S^T- or dP^T-shaped product, N = 64 queries: d (+)= A B
template <int N, int TA, int TB>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da,
                                   uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss64<TA, TB>(d, da, db, scale_d);
  else
    wgmma_ss32<TA, TB>(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs128<1>(d, a, db, 1);
  else
    wgmma_rs64<1>(d, a, db, 1);
}

// the two floats of a bf16 pair
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// A warpgroup's [64, DMAX] accumulator (times mul) as rows of dst [64, d]:
// into the shared-memory tile stg (rows of DMAX + 16 / sizeof(T), so that
// the accumulator's pairs land on distinct banks), then copied out in 16
// bytes a thread when vec (d a multiple of 16 bytes, dst aligned), else an
// element a thread; named barrier `bar` orders the warpgroup's 128 threads
template <int DMAX, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[DMAX / 2],
                                           float mul, T* stg, T* dst, int d,
                                           int vec, int bar) {
  constexpr int RS = DMAX + 16 / (int)sizeof(T);
  constexpr int CH = 16 / (int)sizeof(T);        // elements a 16-byte chunk
  const int tw = threadIdx.x % 128;
  const int row = 16 * (tw / 32) + (tw % 32) / 4;
  const int col = 2 * (tw % 4);
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* at_ = stg + (row + 8 * h) * RS + 8 * i + col;
      put(at_, acc[4 * i + 2 * h] * mul);
      put(at_ + 1, acc[4 * i + 2 * h + 1] * mul);
    }
  named_sync(bar, 128);
  if (vec) {
    for (int c = tw; c < kBk * (DMAX / CH); c += 128) {
      const int r = c / (DMAX / CH);
      const int k = (c % (DMAX / CH)) * CH;
      if (k < d)
        *reinterpret_cast<uint4*>(dst + (long long)r * d + k) =
            *reinterpret_cast<const uint4*>(stg + r * RS + k);
    }
  } else {
    for (int c = tw; c < kBk * d; c += 128)
      dst[c] = stg[(c / d) * RS + c % d];
  }
  named_sync(bar, 128);                  // before stg is written again
}

// What a consumer warpgroup needs of its block.
struct Block {
  uint8_t* sm;             // the 1024-byte aligned shared memory
  uint64_t* kv_full;       // K and V landed
  uint64_t* full;          // [STAGES] a tile landed
  uint64_t* empty;         // [STAGES] a tile consumed
  const float* lds;        // [STAGES][2][kBq] L, D
  float* dqacc;
  void* dk;
  void* dv;
  long long bh;
  int j0, it0, ntiles, n_qt, Sk, d, causal;
  int vec;                 // d a multiple of 16 bytes, the tensors aligned
  float scale, scale_log2;
};

// A consumer warpgroup's tiles.  ROLE 0 (f32): every product.  In bf16
// two warpgroups share the block's keys: ROLE 1 forms S^T and P^T, takes
// dV += P^T dO and dQ's first half of d; ROLE 2 forms dP^T and, with P^T
// from ROLE 1, dS^T, takes dK += dS^T Q and dQ's second half.  Named
// barriers: 1 P^T stored (ROLE 1 arrives, 2 waits), 2 dS^T stored (2
// arrives, 1 waits), 3 a warpgroup's own dS^T stores, 4 + the warpgroup
// its dQ buffer.  Neither side can arrive twice before the other waits:
// each waits for the other's arrival of the tile before its next one.
template <int DMAX, bool F32, int ROLE>
__device__ __forceinline__ void consume(const Block& b) {
  using C = Cfg<DMAX, F32>;
  constexpr int NP = C::NP;
  constexpr int STAGES = C::STAGES;
  constexpr bool S_SIDE = ROLE != 2;       // S^T, P^T, dV, dQ's first half
  constexpr bool D_SIDE = ROLE != 1;       // dP^T, dS^T, dK, dQ's second
  constexpr bool SPLIT = ROLE != 0;
  constexpr int ND = DMAX / 2;             // accumulators of a [64, DMAX] tile
  constexpr int KL = C::KV;                // offsets of the lo parts
  constexpr int QL = C::QT;
  constexpr int DL = C::DS;
  using T = typename std::conditional<F32, float, bf16>::type;
  uint8_t* sm = b.sm;
  const int cw = ROLE == 2 ? 1 : 0;
  const int tw = threadIdx.x % 128;
  const int ww = tw / 32;
  const int lane = tw % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int jr = b.j0 + 16 * ww + g;       // the thread's keys jr, jr + 8

  float dva[S_SIDE ? ND : 1], dka[D_SIDE ? ND : 1];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    if constexpr (S_SIDE) dva[i] = 0.f;
    if constexpr (D_SIDE) dka[i] = 0.f;
  }
  // descriptor bases: K and V (A of S^T and dP^T, K-major)
  const uint64_t k_a = desc(sm + C::K_OFF, 16, 1024);
  const uint64_t v_a = desc(sm + C::V_OFF, 16, 1024);
  float4* px = reinterpret_cast<float4*>(sm + C::PX_OFF);

  mbar_wait(b.kv_full, 0);
  for (int n = 0; n < b.ntiles; ++n) {
    const int st = n % STAGES;
    const int it = b.it0 + n;
    const int i0 = it * kBq;
    mbar_wait(&b.full[st], (n / STAGES) & 1);
    const uint8_t* qs = sm + C::Q_OFF + st * NP * C::QT;
    const uint8_t* dos = sm + C::DO_OFF + st * NP * C::QT;
    const float* Ls = b.lds + st * 2 * kBq;
    const float* Ds = Ls + kBq;
    uint8_t* dss = sm + C::DS_OFF + (SPLIT ? (n & 1) : 0) * NP * C::DS;
    float sc[32];
    // A fragments (m64 k16, one per 16 queries) of P^T and dS^T, and
    // their lo parts in f32
    uint32_t pa[4][4], sa[4][4];
    uint32_t pl[F32 ? 4 : 1][4], sl[F32 ? 4 : 1][4];

    if constexpr (S_SIDE) {
      // S^T = K Q^T over d: rows the block's keys, columns the queries
      const uint64_t q_b = desc(qs, 16, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const int ka = (kk / 4) * kBk * 128 + (kk % 4) * 32;
        const int qa = (kk / 4) * kBq * 128 + (kk % 4) * 32;
        if constexpr (F32) {
          ss<64, 0, 0>(sc, at(k_a, ka + KL), at(q_b, qa), kk > 0);
          ss<64, 0, 0>(sc, at(k_a, ka), at(q_b, qa + QL), 1);
        }
        ss<64, 0, 0>(sc, at(k_a, ka), at(q_b, qa), F32 || kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      const bool diag = b.causal && i0 < b.j0 + kBk;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * i + 2 * t4 + (e & 1);   // query in the tile
          float p = ex2(fmaf(sc[4 * i + e], b.scale_log2,
                             -Ls[qc] * kLog2eF));
          if (diag && i0 + qc < jr + 8 * (e >> 1)) p = 0.f;
          sc[4 * i + e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 4 * (2 * kk + (r >> 1)) + (r & 1) * 2;
          if constexpr (F32)
            split(sc[x], sc[x + 1], pa[kk][r], pl[kk][r]);
          else
            pa[kk][r] = pack(sc[x], sc[x + 1]);
        }
      if constexpr (SPLIT) {               // f32 P^T for ROLE 2, in its order
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4)
          px[((n & 1) * 8 + c4) * 128 + tw] =
              make_float4(sc[4 * c4], sc[4 * c4 + 1], sc[4 * c4 + 2],
                          sc[4 * c4 + 3]);
        named_arrive(1, 256);
      }
    }
    if constexpr (D_SIDE) {
      // dP^T = V dO^T; dS^T = P^T (dP^T - D) with P^T as packed
      const uint64_t do_b = desc(dos, 16, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const int ka = (kk / 4) * kBk * 128 + (kk % 4) * 32;
        const int qa = (kk / 4) * kBq * 128 + (kk % 4) * 32;
        if constexpr (F32) {
          ss<64, 0, 0>(sc, at(v_a, ka + KL), at(do_b, qa), kk > 0);
          ss<64, 0, 0>(sc, at(v_a, ka), at(do_b, qa + QL), 1);
        }
        ss<64, 0, 0>(sc, at(v_a, ka), at(do_b, qa), F32 || kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      if constexpr (SPLIT) named_sync(1, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 4 * (2 * kk + (r >> 1)) + (r & 1) * 2;
          const int qc = 8 * (2 * kk + (r >> 1)) + 2 * t4;
          float2 p;
          if constexpr (SPLIT) {           // ROLE 1's f32 P^T
            const float4 p4 = px[((n & 1) * 8 + x / 4) * 128 + tw];
            p = x % 4 == 0 ? make_float2(p4.x, p4.y)
                           : make_float2(p4.z, p4.w);
          } else {                         // the packed parts: P^T to 2^-17
            p = unpack(pa[kk][r]);
            const float2 l = unpack(pl[kk][r]);
            p.x += l.x;
            p.y += l.y;
          }
          const float d0 = p.x * (sc[x] - Ds[qc]);
          const float d1 = p.y * (sc[x + 1] - Ds[qc + 1]);
          if constexpr (F32)
            split(d0, d1, sa[kk][r], sl[kk][r]);
          else
            sa[kk][r] = pack(d0, d1);
        }
      // dS^T [keys][queries] into shared memory for dQ
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off = sw128(16 * ww + g + 8 * h, i) + t4 * 4;
          *reinterpret_cast<uint32_t*>(dss + off) =
              sa[i / 2][(i % 2) * 2 + h];
          if constexpr (F32)
            *reinterpret_cast<uint32_t*>(dss + DL + off) =
                sl[i / 2][(i % 2) * 2 + h];
        }
      fence_async_shared();
      if constexpr (SPLIT) named_arrive(2, 256);
    }

    // dV += P^T dO, dK += dS^T Q over the tile's queries (B MN-major)
    const uint64_t q_t = desc(qs, kBq * 128, 1024);
    const uint64_t do_t = desc(dos, kBq * 128, 1024);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (S_SIDE) {
        if constexpr (F32) {
          rs<DMAX>(dva, pa[kk], at(do_t, kk * 2048 + QL));
          rs<DMAX>(dva, pl[kk], at(do_t, kk * 2048));
        }
        rs<DMAX>(dva, pa[kk], at(do_t, kk * 2048));
      }
      if constexpr (D_SIDE) {
        if constexpr (F32) {
          rs<DMAX>(dka, sa[kk], at(q_t, kk * 2048 + QL));
          rs<DMAX>(dka, sl[kk], at(q_t, kk * 2048));
        }
        rs<DMAX>(dka, sa[kk], at(q_t, kk * 2048));
      }
    }
    wg_commit();
    wg_wait<0>();
    if constexpr (S_SIDE) fence_regs(dva);
    if constexpr (D_SIDE) fence_regs(dka);
    mbar_arrive(&b.empty[st]);

    // dQ_tile = dS K over the block's keys, a half of d at a time, each
    // added into dqacc
    if constexpr (ROLE == 1)
      named_sync(2, 256);                  // ROLE 2 has stored dS^T
    else
      named_sync(3, 128);                  // this warpgroup has
    const uint64_t ds_a = desc(dss, 8192, 1024);     // MN-major (queries)
#pragma unroll 1
    for (int h = ROLE == 2 ? 1 : 0; h < (ROLE == 1 ? 1 : 2); ++h) {
      const int col0 = h * (DMAX / 2);
      const uint64_t k_b = desc(sm + C::K_OFF + (col0 / 64) * kBk * 128 +
                                    (col0 % 64) * 2,
                                kBk * 128, 1024);    // MN-major (d)
      float acc[DMAX / 4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        if constexpr (F32) {
          ss<DMAX / 2, 1, 1>(acc, at(ds_a, kk * 2048 + DL),
                             at(k_b, kk * 2048), kk > 0);
          ss<DMAX / 2, 1, 1>(acc, at(ds_a, kk * 2048),
                             at(k_b, kk * 2048 + KL), 1);
        }
        ss<DMAX / 2, 1, 1>(acc, at(ds_a, kk * 2048), at(k_b, kk * 2048),
                           F32 || kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      float* qbuf = reinterpret_cast<float*>(sm + C::DQ_OFF + cw * C::DQ);
      if (tw == 0) bulk_wait_read();       // the last half-tile has left
      named_sync(4 + cw, 128);
#pragma unroll
      for (int c4 = 0; c4 < DMAX / 16; ++c4)
        reinterpret_cast<float4*>(qbuf)[c4 * 128 + tw] =
            make_float4(acc[4 * c4], acc[4 * c4 + 1], acc[4 * c4 + 2],
                        acc[4 * c4 + 3]);
      fence_async_shared();
      named_sync(4 + cw, 128);
      if (tw == 0) {
        bulk_reduce_add(
            b.dqacc + ((b.bh * b.n_qt + it) * 2 + h) * (kBq * DMAX / 2),
            qbuf, C::DQ);
        bulk_commit();
      }
    }
  }
  // dK and dV through shared memory (the tile ring, free once every tile
  // is consumed: with two warpgroups once both are) into whole rows
  if constexpr (SPLIT) named_sync(6, 256);
  T* stg = reinterpret_cast<T*>(sm + C::Q_OFF);
  const long long row0 = (b.bh * b.Sk + b.j0) * b.d;
  if constexpr (S_SIDE)
    store_rows<DMAX>(dva, 1.f, stg, static_cast<T*>(b.dv) + row0, b.d,
                     b.vec, 4 + cw);
  if constexpr (D_SIDE)                    // beside ROLE 1's, or after dV
    store_rows<DMAX>(dka, b.scale,
                     stg + (SPLIT ? kBk * (DMAX + 16 / (int)sizeof(T)) : 0),
                     static_cast<T*>(b.dk) + row0, b.d, b.vec, 4 + cw);
}

template <int DMAX, bool F32, bool TMA>
__global__ void __launch_bounds__(Cfg<DMAX, F32>::THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_do,
           const void* __restrict__ qv, const void* __restrict__ kv,
           const void* __restrict__ vv, const void* __restrict__ dov,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dqacc, void* __restrict__ dkv,
           void* __restrict__ dvv, int Sq, int Sk, int d, int causal,
           int vec, float scale, float scale_log2) {
  using C = Cfg<DMAX, F32>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int NP = C::NP;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Block b;
  b.sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sm = b.sm;
  b.kv_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  b.full = b.kv_full + 1;
  b.empty = b.full + STAGES;
  float* lds = reinterpret_cast<float*>(sm + C::LD_OFF);
  b.lds = lds;

  // the key blocks of a head are adjacent (they share its Q, dO and dQ
  // rows in L2), the first keys' (the most query tiles) first
  const int nkb = Sk / kBk;
  const int kt = blockIdx.x % nkb;
  b.bh = blockIdx.x / nkb;
  b.j0 = kt * kBk;
  b.n_qt = Sq / kBq;
  b.it0 = causal ? b.j0 / kBq : 0;         // queries before j0 see no key
  b.ntiles = b.n_qt - b.it0;
  b.dqacc = dqacc;
  b.dk = dkv;
  b.dv = dvv;
  b.Sk = Sk;
  b.d = d;
  b.causal = causal;
  b.vec = vec;
  b.scale = scale;
  b.scale_log2 = scale_log2;
  const long long qrow0 = b.bh * Sq;       // rows of the [BH * Sq, d] views

  if (threadIdx.x == 0) {
    mbar_init(b.kv_full, TMA ? 1 : 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&b.full[s], TMA ? 1 : 128);
      mbar_init(&b.empty[s], 128 * C::NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == C::NWG) {
    // ---- producer ------------------------------------------------------------
    const int ptid = threadIdx.x - 128 * C::NWG;
    if constexpr (TMA) {
      if (ptid == 0) {
        const int krow = (int)(b.bh * Sk + b.j0);
        mbar_expect(b.kv_full, 2 * C::KV);
        for (int r = 0; r < C::NR; ++r) {
          tma_load_2d(sm + C::K_OFF + r * kBk * 128, &tm_k, 64 * r, krow,
                      b.kv_full);
          tma_load_2d(sm + C::V_OFF + r * kBk * 128, &tm_v, 64 * r, krow,
                      b.kv_full);
        }
        for (int n = 0; n < b.ntiles; ++n) {
          const int st = n % STAGES;
          if (n >= STAGES) mbar_wait(&b.empty[st], ((n / STAGES) - 1) & 1);
          const int row = (int)(qrow0 + (long long)(b.it0 + n) * kBq);
          mbar_expect(&b.full[st], 2 * C::QT + 2 * kBq * 4);
          for (int r = 0; r < C::NR; ++r) {
            tma_load_2d(sm + C::Q_OFF + st * C::QT + r * kBq * 128, &tm_q,
                        64 * r, row, &b.full[st]);
            tma_load_2d(sm + C::DO_OFF + st * C::QT + r * kBq * 128, &tm_do,
                        64 * r, row, &b.full[st]);
          }
          bulk_load(lds + st * 2 * kBq, lse + row, kBq * 4, &b.full[st]);
          bulk_load(lds + st * 2 * kBq + kBq, delta + row, kBq * 4,
                    &b.full[st]);
        }
      }
    } else {
      const T* q = static_cast<const T*>(qv);
      const T* k = static_cast<const T*>(kv);
      const T* v = static_cast<const T*>(vv);
      const T* dout = static_cast<const T*>(dov);
      const long long kbase = (b.bh * Sk + b.j0) * d;
      fill_tile<DMAX, F32>(sm + C::K_OFF, sm + C::K_OFF + C::KV, k + kbase,
                           kBk, d, vec, ptid);
      fill_tile<DMAX, F32>(sm + C::V_OFF, sm + C::V_OFF + C::KV, v + kbase,
                           kBk, d, vec, ptid);
      fence_async_shared();
      mbar_arrive(b.kv_full);
      for (int n = 0; n < b.ntiles; ++n) {
        const int st = n % STAGES;
        if (n >= STAGES) mbar_wait(&b.empty[st], ((n / STAGES) - 1) & 1);
        const long long row = qrow0 + (long long)(b.it0 + n) * kBq;
        uint8_t* qs = sm + C::Q_OFF + st * NP * C::QT;
        uint8_t* dos = sm + C::DO_OFF + st * NP * C::QT;
        fill_tile<DMAX, F32>(qs, qs + C::QT, q + row * d, kBq, d, vec, ptid);
        fill_tile<DMAX, F32>(dos, dos + C::QT, dout + row * d, kBq, d, vec,
                             ptid);
        if (ptid < kBq) {
          lds[st * 2 * kBq + ptid] = lse[row + ptid];
          lds[st * 2 * kBq + kBq + ptid] = delta[row + ptid];
        }
        fence_async_shared();
        mbar_arrive(&b.full[st]);
      }
    }
    return;
  }
  if constexpr (F32) {
    consume<DMAX, F32, 0>(b);
  } else {
    if (wg == 0)
      consume<DMAX, F32, 1>(b);
    else
      consume<DMAX, F32, 2>(b);
  }
  if (threadIdx.x % 128 == 0) bulk_wait();
}

// dq[bh, q, c] = dqacc * scale, from the accumulator order the main
// kernel's half-tiles use: for the half h of query tile q / 64, the thread
// t of the warpgroup wrote its float4 chunk i at (i * 128 + t) * 4.  One
// warp a row of dq.
template <typename T, int DMAX>
__global__ void dq_convert(const float* __restrict__ dqacc, T* __restrict__ dq,
                           long long rows, int d, float scale) {
  const long long rowq =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;   // bh Sq + q
  const int lane = threadIdx.x & 31;
  if (rowq >= rows) return;
  const int r = (int)(rowq % kBq);
  const int rr = r % 16;
  const int tw = (r / 16) * 32 + (rr % 8) * 4;   // + (c % 8) / 2
  const int e = (rr / 8) * 2;                    // + c % 2
  const float* tile = dqacc + (rowq / kBq) * (kBq * DMAX);
  for (int c = lane; c < d; c += 32) {
    const int h = c / (DMAX / 2);
    const int cc = c % (DMAX / 2);
    put(dq + rowq * d + c,
        tile[h * (kBq * DMAX / 2) + ((cc / 8) * 128 + tw + (cc % 8) / 2) * 4 +
             e + (cc & 1)] * scale);
  }
}

// cuTensorMapEncodeTiled from libcuda, which the process has loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiled>(
        dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a [rows, d] bf16 tensor in boxes of 64 columns by box_rows, 128-byte
// swizzled
bool bf16_map(EncodeTiled fn, CUtensorMap* m, const void* base,
              long long rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int DMAX, bool F32, bool TMA>
cudaError_t run(const CUtensorMap (&maps)[4], const void* q, const void* k,
                const void* v, const void* dout, const float* lse,
                const float* delta, float* dqacc, void* dk, void* dv, int BH,
                int Sq, int Sk, int d, int causal, int vec, float scale,
                float scale_log2, cudaStream_t s) {
  using C = Cfg<DMAX, F32>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<DMAX, F32, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  bwd_kernel<DMAX, F32, TMA>
      <<<(unsigned)((long long)BH * (Sk / kBk)), C::THREADS, C::SMEM, s>>>(
          maps[0], maps[1], maps[2], maps[3], q, k, v, dout, lse, delta,
          dqacc, dk, dv, Sq, Sk, d, causal, vec, scale, scale_log2);
  return cudaGetLastError();
}

template <int DMAX, bool F32>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dqacc, void* dq, void* dk, void* dv, int BH, int Sq,
                   int Sk, int d, int causal, float scale, float scale_log2,
                   cudaStream_t s) {
  using T = typename std::conditional<F32, float, bf16>::type;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  const bool al = aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout) && aligned16(dk) && aligned16(dv);
  const int vec = al && d % (F32 ? 4 : 8) == 0;
  cudaError_t err;
  if (!F32 && d == DMAX && al && aligned16(lse)) {
    const EncodeTiled fn = encoder();
    if (!fn) return cudaErrorNotSupported;
    if (!bf16_map(fn, &maps[0], q, (long long)BH * Sq, d, kBq) ||
        !bf16_map(fn, &maps[1], k, (long long)BH * Sk, d, kBk) ||
        !bf16_map(fn, &maps[2], v, (long long)BH * Sk, d, kBk) ||
        !bf16_map(fn, &maps[3], dout, (long long)BH * Sq, d, kBq))
      return cudaErrorInvalidValue;
    err = run<DMAX, F32, !F32>(maps, q, k, v, dout, lse, delta, dqacc, dk,
                               dv, BH, Sq, Sk, d, causal, vec, scale,
                               scale_log2, s);
  } else {
    err = run<DMAX, F32, false>(maps, q, k, v, dout, lse, delta, dqacc, dk,
                                dv, BH, Sq, Sk, d, causal, vec, scale,
                                scale_log2, s);
  }
  if (err != cudaSuccess) return err;
  const long long rows = (long long)BH * Sq;
  dq_convert<T, DMAX><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      dqacc, static_cast<T*>(dq), rows, d, scale);
  return cudaGetLastError();
}

}  // namespace

// Gradients of o = flash_attention(q, k, v, causal) for the upstream dO:
// q, o, dO, dq [BH, Sq, d]; k, v, dk, dv [BH, Sk, d], all float32 (is_bf16 =
// 0) or bfloat16 (is_bf16 = 1); lse [BH, Sq] float32 from
// flash_attention_lse.  Scratch from the caller, float32: delta [BH, Sq]
// and dqacc [BH, Sq, dmax], dmax = 64 if d <= 64 else 128.
// Sq % 64 == 0, Sk % 64 == 0, 1 <= d <= 128, causal only with Sq == Sk.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, float* dqacc, void* dq,
                                   void* dk, void* dv, int BH, int Sq,
                                   int Sk, int d, int causal, int is_bf16,
                                   void* stream) {
  if (d < 1 || d > 128 || Sq % kBq != 0 || Sk % kBk != 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaSuccess;
  if ((long long)BH * (Sq > Sk ? Sq : Sk) >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dmax = d <= 64 ? 64 : 128;
  const long long rows = (long long)BH * Sq;
  const unsigned dblocks = (unsigned)((rows + 7) / 8);   // 8 warps a block
  const int vec = aligned16(o) && aligned16(dout) &&
                  d % (is_bf16 ? 8 : 4) == 0;
  if (is_bf16)
    delta_kernel<<<dblocks, 256, 0, s>>>(static_cast<const bf16*>(o),
                                         static_cast<const bf16*>(dout),
                                         delta, dqacc, rows, d, dmax, vec);
  else
    delta_kernel<<<dblocks, 256, 0, s>>>(static_cast<const float*>(o),
                                         static_cast<const float*>(dout),
                                         delta, dqacc, rows, d, dmax, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  const float scale_log2 = (float)(1.0 / sqrt((double)d) * kLog2e);
  if (is_bf16)
    err = dmax == 64
              ? launch<64, false>(q, k, v, dout, lse, delta, dqacc, dq, dk,
                                  dv, BH, Sq, Sk, d, causal, scale,
                                  scale_log2, s)
              : launch<128, false>(q, k, v, dout, lse, delta, dqacc, dq, dk,
                                   dv, BH, Sq, Sk, d, causal, scale,
                                   scale_log2, s);
  else
    err = dmax == 64
              ? launch<64, true>(q, k, v, dout, lse, delta, dqacc, dq, dk, dv,
                                 BH, Sq, Sk, d, causal, scale, scale_log2, s)
              : launch<128, true>(q, k, v, dout, lse, delta, dqacc, dq, dk,
                                  dv, BH, Sq, Sk, d, causal, scale,
                                  scale_log2, s);
  return (int)err;
}
