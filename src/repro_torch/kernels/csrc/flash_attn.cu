// Flash attention (online softmax) on Hopper's tensor cores, sm_90a, plain
// C interface.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attn.py:72, pallas_call at :88): for each
// (batch, head) of q [BH, Sq, d] and k, v [BH, Sk, d], float32 or bfloat16,
//
//     o = softmax(mask(q k^T / sqrt(d))) v
//
// without building the [Sq, Sk] scores in device memory.  Numerics follow
// the TPU kernel: the online (m, l, acc) state in f32, masked scores
// weigh 0 (the reference's -1e30; every row keeps an unmasked key), the
// output acc / max(l, 1e-30) cast to the input type.  The 1/sqrt(d)
// scale is applied to the f32 scores (times log2(e), fused into the exp2),
// never to a rounded copy of q.  With an lse pointer the kernel also
// writes each row's log-sum-exp of its scaled scores, ln(sum_k exp(q.k /
// sqrt(d))), f32 [BH, Sq]: the training forward keeps it for the backward
// (flash_attn_bwd.cu).
//
// Bound on an H100: bytes, 4 * S * d * sizeof(T) a head, or operations,
// 2 * Sq * Sk * d multiply-adds a head (about half when causal) at 989
// TFLOP/s dense bf16, three times that work in f32.  At the LM prefill's
// layer (d = 128, S = 1,024, causal) the two are close, so the kernel has
// to keep the tensor cores busy through the softmax, not only stream K/V.
// Every query tile reads its head's K and V again, from L2 when the
// head's tiles run together (the grid order below).
//
// bf16 design (fwd_kernel): FA2's algorithm on Hopper's machinery, FA3's
// layout.
// - A block owns kBq = 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each, and a producer warpgroup.  setmaxnreg
//   moves registers from the producer (40 a thread) to the consumers (232),
//   whose S tile, P fragments and O accumulator live in registers.
// - The producer loads Q once, then streams K and V tiles of kBn = 128
//   keys through a kStages-deep ring in shared memory, each stage
//   signalled by an mbarrier for K and one for V and released by the
//   consumers through a third.  With d = 64 or 128 (and 16-byte aligned
//   tensors) one thread fills it by TMA, 128-byte swizzled; at other
//   widths the producer warpgroup's 128 threads load zero-padded tiles
//   into the same swizzled layout (d = 100 runs as 128 columns).
// - S = Q K^T: wgmma.m64n128k16 with Q and K both from shared memory,
//   K-major.  The online softmax runs on the accumulator fragments in f32;
//   the row max takes two quad shuffles, the row sum is kept per thread
//   and reduced once at the end.  O += P V: wgmma with P as the register
//   A operand in bf16 (the accumulator's layout is the A fragment's) and
//   V from shared memory, MN-major.
// - Turns: the two consumer warpgroups take turns to issue their products
//   (P_{n-1} V_{n-1}, then S_n), so that one's softmax runs while the
//   other's products hold the tensor cores.  Within a warpgroup the
//   products run one at a time: issuing S_n beside P_{n-1} V_{n-1} (FA3's
//   intra-warpgroup overlap) keeps S, P and O in flight at once, and at
//   384 threads ptxas spills and serializes every product for want of
//   registers, setmaxnreg or not (PERF.md §6).
// - Order: the blocks of a head are adjacent in the grid, its heaviest
//   query tile first, so that the blocks in flight share a few heads' K
//   and V in L2 (ordered by query tile across heads, every head's K and V
//   came from device memory again: 1.4x the time at the prefill's layer).
// - Causal: key tiles above the diagonal are skipped and only the
//   diagonal tile is masked (kBq = kBn).  O leaves through the
//   warpgroup's own rows of Q in shared memory, in whole rows.
//
// f32 design (flash_f32_kernel, the earlier mma.sync design, kept: it is on
// no model's path, the LM and the trainer run bf16, and it already takes half
// SDPA's time in f32): FA2 on mma.sync.  A block owns 128 query rows, 16 a
// warp, with Q split into bf16 hi = bf16(x) and lo = bf16(x - hi) in
// registers; each K/V tile of 64 keys is split once into four bf16 tiles in
// shared memory (rows padded by 8 so that ldmatrix, .trans for V, is free of
// bank conflicts), and each product is taken as lo.hi + hi.lo + hi.hi (about
// 16 significant bits, far inside the 2e-3 tolerance, at the bf16 rate).

#include <math.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- bf16: wgmma, TMA, a producer warpgroup ------------------------------
constexpr int kBq = 128;           // query rows a block (2 warpgroups of 64)
constexpr int kBn = 128;           // keys a tile
constexpr int kStages = 3;         // K/V tiles in the ring
constexpr int kThreads = 384;      // two consumer warpgroups and a producer
constexpr int kProdRegs = 40;      // registers a producer thread keeps
constexpr int kConsRegs = 232;     // and a consumer thread takes

// Shared memory in bytes, every tile 1024-byte aligned: Q, then the K and
// the V ring (each tile NR regions of rows of 128 bytes: 64 columns of d),
// then the barriers.  O leaves through the warpgroup's own rows of Q,
// which no product reads once its last S has landed.
template <int DMAX>
struct Cfg {
  static constexpr int NR = DMAX / 64;
  static constexpr int QT = NR * kBq * 128;
  static constexpr int KT = NR * kBn * 128;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + QT;
  static constexpr int V_OFF = K_OFF + kStages * KT;
  static constexpr int BAR_OFF = V_OFF + kStages * KT;
  static constexpr int SMEM = BAR_OFF + (1 + 3 * kStages) * 8 + 1024;
};

template <int DMAX>
__device__ __forceinline__ void pv(float (&d)[DMAX / 2],
                                   const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DMAX == 128)
    wgmma_rs128<1>(d, a, db, 1);
  else
    wgmma_rs64<1>(d, a, db, 1);
}

// Block b takes query tile qt of (batch, head) bh: the tiles of a head are
// adjacent in the grid, its heaviest (most key tiles) first, so that the
// blocks in flight share a few heads' K and V in L2.
template <int DMAX, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int Sq, int Sk, int d, int causal,
           int vec, float scale_log2) {
  using C = Cfg<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;           // [kStages] a K tile landed
  uint64_t* v_full = k_full + kStages;     // [kStages] a V tile landed
  uint64_t* empty = v_full + kStages;      // [kStages] both read a stage

  const int n_qt = Sq / kBq;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const long long bh = blockIdx.x / n_qt;
  const int q0 = qt * kBq;
  int n_kt = Sk / kBn;
  if (causal && qt + 1 < n_kt) n_kt = qt + 1;              // kBq == kBn

  if (threadIdx.x == 0) {
    mbar_init(q_full, TMA ? 1 : 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], TMA ? 1 : 128);
      mbar_init(&v_full[s], TMA ? 1 : 128);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: Q once, then the K and V tiles through the ring -------
    reg_dealloc<kProdRegs>();
    const int ptid = threadIdx.x - 256;
    if (TMA && ptid != 0) return;
    const long long qrow = bh * Sq + q0;
    const long long krow = bh * Sk;
    if constexpr (TMA) {
      mbar_expect(q_full, C::QT);
      for (int r = 0; r < C::NR; ++r)
        tma_load_2d(sm + C::Q_OFF + r * kBq * 128, &tm_q, 64 * r, (int)qrow,
                    q_full);
    } else {
      fill_tile<DMAX, false>(sm + C::Q_OFF, nullptr, q + qrow * d, kBq, d,
                             vec, ptid);
      fence_async_shared();
      mbar_arrive(q_full);
    }
    for (int n = 0; n < n_kt; ++n) {
      const int st = n % kStages;
      if (n >= kStages) mbar_wait(&empty[st], ((n / kStages) - 1) & 1);
      const long long row = krow + (long long)n * kBn;
      if constexpr (TMA) {
        mbar_expect(&k_full[st], C::KT);
        for (int r = 0; r < C::NR; ++r)
          tma_load_2d(sm + C::K_OFF + st * C::KT + r * kBn * 128, &tm_k,
                      64 * r, (int)row, &k_full[st]);
        mbar_expect(&v_full[st], C::KT);
        for (int r = 0; r < C::NR; ++r)
          tma_load_2d(sm + C::V_OFF + st * C::KT + r * kBn * 128, &tm_v,
                      64 * r, (int)row, &v_full[st]);
      } else {
        fill_tile<DMAX, false>(sm + C::K_OFF + st * C::KT, nullptr,
                               k + row * d, kBn, d, vec, ptid);
        fence_async_shared();
        mbar_arrive(&k_full[st]);
        fill_tile<DMAX, false>(sm + C::V_OFF + st * C::KT, nullptr,
                               v + row * d, kBn, d, vec, ptid);
        fence_async_shared();
        mbar_arrive(&v_full[st]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows q0 + 64 wg .. + 63 ------------
  reg_alloc<kConsRegs>();
  const int tw = threadIdx.x % 128;
  const int ww = tw / 32;
  const int lane = tw % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * ww + g;    // rows row0, row0 + 8
  // descriptor bases: Q (A, K-major), K (B, K-major), V (B, MN-major)
  const uint64_t q_a = desc(sm + C::Q_OFF + wg * 64 * 128, 16, 1024);
  const uint64_t k_b = desc(sm + C::K_OFF, 16, 1024);
  const uint64_t v_b = desc(sm + C::V_OFF, kBn * 128, 1024);

  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  float s[kBn / 2];                // S of one key tile, accumulator layout
  uint32_t p[kBn / 16][4];         // P in bf16, A fragments of P V
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_ss128<0, 0>(
          s, at(q_a, (kk / 4) * kBq * 128 + (kk % 4) * 32),
          at(k_b, st * C::KT + (kk / 4) * kBn * 128 + (kk % 4) * 32), kk > 0);
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kBn / 16; ++kk)
      pv<DMAX>(acc, p[kk], at(v_b, st * C::KT + kk * 2048));
  };
  // online softmax of key tile n in log2 units, x = s * scale_log2;
  // masked scores count as -inf here (p = 0 either way: every row has an
  // unmasked key in every tile it walks); s becomes P, alpha the factor
  // that rescales the state
  auto softmax = [&](int n, float (&alpha)[2]) {
    const int k0 = n * kBn;
    const bool diag = causal && n == n_kt - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBn / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (diag && k0 + 8 * i + 2 * t4 + (e & 1) > row0 + 8 * (e >> 1))
          s[4 * i + e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
      }
    float nm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      nm[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBn / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ex2(fmaf(s[4 * i + e], scale_log2, nm[e >> 1]));
        l[e >> 1] += x;
        s[4 * i + e] = x;
      }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBn / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 4 * (2 * kk + (r >> 1)) + (r & 1) * 2;
        p[kk][r] = pack(s[x], s[x + 1]);
      }
  };
  // the two warpgroups take turns to issue their products (named
  // barriers 3 and 4), so that one's softmax runs under the other's
  // products: take a turn before a group of products, pass it on after
  // issuing them (the second warpgroup passes the first turn, and skips
  // its last pass, which nothing would take)
  auto take = [&]() { named_sync(3 + wg, 256); };
  auto pass = [&](bool last) {
    if (!(last && wg == 1)) named_arrive(4 - wg, 256);
  };
  if (wg == 1) named_arrive(3, 256);

  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  take();
  wg_fence();
  issue_s(0);
  wg_commit();
  pass(false);
  wg_wait<0>();
  fence_regs(s);
  {
    float alpha[2];                 // O is still 0: nothing to rescale
    softmax(0, alpha);
  }
  pack_p();
  for (int n = 1; n < n_kt; ++n) {
    const int st = n % kStages;
    const int pst = (n - 1) % kStages;
    const int ph = (n / kStages) & 1;
    const int pph = ((n - 1) / kStages) & 1;
    // P_{n-1} V_{n-1}, then S_n, one product at a time
    mbar_wait(&v_full[pst], pph);
    take();
    wg_fence();
    issue_pv(pst);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[pst]);
    mbar_wait(&k_full[st], ph);
    wg_fence();
    issue_s(st);
    wg_commit();
    pass(false);
    wg_wait<0>();
    fence_regs(s);
    float alpha[2];
    softmax(n, alpha);
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  const int lst = (n_kt - 1) % kStages;
  mbar_wait(&v_full[lst], ((n_kt - 1) / kStages) & 1);
  take();
  wg_fence();
  issue_pv(lst);
  wg_commit();
  pass(true);
  wg_wait<0>();
  fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lse != nullptr && t4 == 0)        // m, l in log2 units
      lse[bh * Sq + row0 + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // O through the warpgroup's rows of Q (the same swizzled layout) into
  // whole rows of o
  uint8_t* stg = sm + C::Q_OFF + wg * 64 * 128;
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stg + (i / 8) * kBq * 128 +
                                   sw128(16 * ww + g + 8 * h, i % 8) +
                                   4 * t4) =
          pack(acc[4 * i + 2 * h] * inv[h], acc[4 * i + 2 * h + 1] * inv[h]);
  named_sync(1 + wg, 128);
  bf16* dst = o + (bh * Sq + q0 + 64 * wg) * d;
  if (vec) {
    for (int c = tw; c < 64 * (DMAX / 8); c += 128) {
      const int r = c / (DMAX / 8);
      const int ch = c % (DMAX / 8);
      if (8 * ch < d)
        *reinterpret_cast<uint4*>(dst + (long long)r * d + 8 * ch) =
            *reinterpret_cast<const uint4*>(stg + (ch / 8) * kBq * 128 +
                                            sw128(r, ch % 8));
    }
  } else {
    for (int c = tw; c < 64 * d; c += 128) {
      const int r = c / d;
      const int col = c % d;
      dst[c] = *reinterpret_cast<const bf16*>(
          stg + (col / 64) * kBq * 128 + sw128(r, (col % 64) / 8) +
          2 * (col % 8));
    }
  }
}

template <int DMAX, bool TMA>
cudaError_t run_bf16(const CUtensorMap (&maps)[3], const void* q,
                     const void* k, const void* v, void* o, float* lse,
                     int BH, int Sq, int Sk, int d, int causal, int vec,
                     float scale_log2, cudaStream_t s) {
  using C = Cfg<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DMAX, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  fwd_kernel<DMAX, TMA>
      <<<(unsigned)((long long)BH * (Sq / kBq)), kThreads, C::SMEM, s>>>(
          maps[0], maps[1], maps[2], static_cast<const bf16*>(q),
          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(o), lse, Sq, Sk, d, causal, vec, scale_log2);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int BH, int Sq, int Sk, int d, int causal,
                        float scale_log2, cudaStream_t s) {
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool al = aligned16(q) && aligned16(k) && aligned16(v);
  const int vec = al && aligned16(o) && d % 8 == 0;
  if (d == DMAX && al) {
    const EncodeTiled fn = encoder();
    if (!fn) return cudaErrorNotSupported;
    if (!bf16_map(fn, &maps[0], q, (long long)BH * Sq, d, kBq) ||
        !bf16_map(fn, &maps[1], k, (long long)BH * Sk, d, kBn) ||
        !bf16_map(fn, &maps[2], v, (long long)BH * Sk, d, kBn))
      return cudaErrorInvalidValue;
    return run_bf16<DMAX, true>(maps, q, k, v, o, lse, BH, Sq, Sk, d, causal,
                                vec, scale_log2, s);
  }
  return run_bf16<DMAX, false>(maps, q, k, v, o, lse, BH, Sq, Sk, d, causal,
                               vec, scale_log2, s);
}

// ---- f32: mma.sync on bf16 hi/lo splits ----------------------------------
constexpr int kWarps = 8;          // warps a block, 16 query rows each
constexpr int kBk = 64;            // keys a shared-memory tile

// One block an SM as the floor lets ptxas use up to 255 registers a
// thread, for the split Q fragments and the K/V hi/lo loads.
template <int DMAX>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int Sq, int Sk, int d,
                 int causal, int vec, float scale_log2) {
  constexpr int kThreadsF = 32 * kWarps;
  constexpr int kBqF = 16 * kWarps;  // query rows a block
  constexpr int DP = DMAX + 8;       // padded shared row, bf16 elements
  constexpr int KD = DMAX / 16;      // k-steps of Q K^T
  constexpr int ND = DMAX / 8;       // 8-wide column tiles of O
  constexpr int NS = kBk / 8;        // 8-wide key tiles of S
  constexpr int TILE = kBk * DP;     // one [kBk, DP] bf16 tile
  // K hi, K lo, V hi, V lo
  extern __shared__ __align__(16) __nv_bfloat16 sm[];

  const int n_qt = Sq / kBqF;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const long long bh = blockIdx.x % BH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBqF;
  const int wrow = 16 * warp;             // the warp's first row in the tile
  const int row0 = q0 + wrow + g;         // rows row0, row0 + 8

  const float* qh = q + (bh * Sq + q0) * d;
  const float* kh = k + bh * Sk * d;
  const float* vh = v + bh * Sk * d;

  // Q fragments (A layout) in registers, split into hi and lo: register r
  // holds row (r & 1) * 8, columns 16 kk + (r >> 1) * 8 + 2t, +1
  uint32_t qa[KD][4], ql[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* qrow = qh + (wrow + g + (r & 1) * 8) * d;
      const int c = 16 * kk + (r >> 1) * 8 + 2 * t;
      const float x0 = c < d ? ld(qrow + c) : 0.f;
      const float x1 = c + 1 < d ? ld(qrow + c + 1) : 0.f;
      split(x0, x1, qa[kk][r], ql[kk][r]);
    }
  // one key tile into shared memory, split
  auto load_tile = [&](int kt) {
    const long long base = (long long)kt * kBk * d;
    __nv_bfloat16* dst[4] = {sm, sm + TILE, sm + 2 * TILE, sm + 3 * TILE};
    if (vec) {                                // d % 4 == 0, aligned
      for (int i = threadIdx.x; i < kBk * DMAX / 4; i += kThreadsF) {
        const int r = i / (DMAX / 4);
        const int c = (i % (DMAX / 4)) * 4;
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (c < d) {
          kv = __ldg(reinterpret_cast<const float4*>(kh + base + r * d + c));
          vv = __ldg(reinterpret_cast<const float4*>(vh + base + r * d + c));
        }
        uint32_t* kd_hi = reinterpret_cast<uint32_t*>(dst[0] + r * DP + c);
        uint32_t* kd_lo = reinterpret_cast<uint32_t*>(dst[1] + r * DP + c);
        uint32_t* vd_hi = reinterpret_cast<uint32_t*>(dst[2] + r * DP + c);
        uint32_t* vd_lo = reinterpret_cast<uint32_t*>(dst[3] + r * DP + c);
        split(kv.x, kv.y, kd_hi[0], kd_lo[0]);
        split(kv.z, kv.w, kd_hi[1], kd_lo[1]);
        split(vv.x, vv.y, vd_hi[0], vd_lo[0]);
        split(vv.z, vv.w, vd_hi[1], vd_lo[1]);
      }
    } else {
      for (int i = threadIdx.x; i < kBk * DMAX / 2; i += kThreadsF) {
        const int r = i / (DMAX / 2);
        const int c = (i % (DMAX / 2)) * 2;
        const float* kr = kh + base + r * d;
        const float* vr = vh + base + r * d;
        const float k0 = c < d ? kr[c] : 0.f, k1 = c + 1 < d ? kr[c + 1] : 0.f;
        const float v0 = c < d ? vr[c] : 0.f, v1 = c + 1 < d ? vr[c + 1] : 0.f;
        split(k0, k1, *reinterpret_cast<uint32_t*>(dst[0] + r * DP + c),
              *reinterpret_cast<uint32_t*>(dst[1] + r * DP + c));
        split(v0, v1, *reinterpret_cast<uint32_t*>(dst[2] + r * DP + c),
              *reinterpret_cast<uint32_t*>(dst[3] + r * DP + c));
      }
    }
  };

  int n_kt = Sk / kBk;
  if (causal) {
    const int last = (q0 + kBqF + kBk - 1) / kBk;
    n_kt = last < n_kt ? last : n_kt;
  }

  float acc[ND][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // ldmatrix lane addresses inside a tile.  K (B of Q K^T, 16 keys x 16
  // columns a call): matrices (keys +0, cols +0), (+0, +8), (+8, +0),
  // (+8, +8) give b0b1, b2b3 of key tile 2np and of 2np + 1.
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
  // V (B of P V, .trans, 16 keys x 16 columns): matrices (keys +0, cols
  // +0), (+8, +0), (+0, +8), (+8, +8) give b0b1, b2b3 of column tile 2np
  // and of 2np + 1.
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;

  const __nv_bfloat16* k_hi = sm;
  const __nv_bfloat16* k_lo = sm + TILE;
  const __nv_bfloat16* v_hi = sm + 2 * TILE;
  const __nv_bfloat16* v_lo = sm + 3 * TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();                   // every warp is done with the tiles
    load_tile(kt);
    __syncthreads();

    // S = Q K^T (raw dot products)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int off = (16 * np + k_row) * DP + 16 * kk + k_col;
        uint32_t b[4], bl[4];
        ldsm_x4(b, k_hi + off);
        ldsm_x4(bl, k_lo + off);
        mma(s[2 * np], ql[kk], b[0], b[1]);
        mma(s[2 * np + 1], ql[kk], b[2], b[3]);
        mma(s[2 * np], qa[kk], bl[0], bl[1]);
        mma(s[2 * np + 1], qa[kk], bl[2], bl[3]);
        mma(s[2 * np], qa[kk], b[0], b[1]);
        mma(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax in log2 units: x = s * scale_log2; masked scores
    // count as -inf here (p = 0 either way: every row has an unmasked key)
    const int k0 = kt * kBk;
    const bool diag = causal && k0 + kBk - 1 > q0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (diag && k0 + 8 * j + 2 * t + (e & 1) > row0 + (e >> 1) * 8)
          s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], nm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      nm[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], scale_log2, nm[e >> 1]));
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P V, P from the S fragments in registers
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[2 * kk + (r >> 1)][(r & 1) * 2];
        const float x1 = s[2 * kk + (r >> 1)][(r & 1) * 2 + 1];
        split(x0, x1, pa[r], pl[r]);
      }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        const int off = (16 * kk + v_row) * DP + 16 * np + v_col;
        uint32_t b[4], bl[4];
        ldsm_x4_trans(b, v_hi + off);
        ldsm_x4_trans(bl, v_lo + off);
        mma(acc[2 * np], pl, b[0], b[1]);
        mma(acc[2 * np + 1], pl, b[2], b[3]);
        mma(acc[2 * np], pa, bl[0], bl[1]);
        mma(acc[2 * np + 1], pa, bl[2], bl[3]);
        mma(acc[2 * np], pa, b[0], b[1]);
        mma(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lse != nullptr && t == 0)       // m, l in log2 units
      lse[bh * Sq + row0 + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      if (c < d)
        o[(bh * Sq + row0 + (e >> 1) * 8) * d + c] = acc[j][e] * l[e >> 1];
    }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int BH, int Sq, int Sk, int d, int causal,
                       float scale_log2, cudaStream_t s) {
  const long long blocks = (long long)BH * (Sq / (16 * kWarps));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = 4 * kBk * (DMAX + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  flash_f32_kernel<DMAX><<<(unsigned)blocks, 32 * kWarps, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, BH, Sq, Sk,
      d, causal, vec, scale_log2);
  return cudaGetLastError();
}

int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int BH, int Sq, int Sk, int d, int causal, int is_bf16,
            void* stream) {
  if (d < 1 || d > 128 || Sq % 128 != 0 || Sk % 128 != 0 || Sk <= 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return (int)cudaSuccess;
  if ((long long)BH * (Sq > Sk ? Sq : Sk) >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the reference's scale, then log2(e) for exp2
  const float scale_log2 = (float)(1.0 / sqrt((double)d) * kLog2e);
  if (is_bf16)
    return (int)(d <= 64 ? launch_bf16<64>(q, k, v, o, lse, BH, Sq, Sk, d,
                                           causal, scale_log2, s)
                         : launch_bf16<128>(q, k, v, o, lse, BH, Sq, Sk, d,
                                            causal, scale_log2, s));
  if (d <= 32)
    return (int)launch_f32<32>(q, k, v, o, lse, BH, Sq, Sk, d, causal,
                               scale_log2, s);
  if (d <= 64)
    return (int)launch_f32<64>(q, k, v, o, lse, BH, Sq, Sk, d, causal,
                               scale_log2, s);
  return (int)launch_f32<128>(q, k, v, o, lse, BH, Sq, Sk, d, causal,
                              scale_log2, s);
}

}  // namespace

// q [BH, Sq, d], k and v [BH, Sk, d], o [BH, Sq, d], all of one type:
// float32 (bf16 = 0) or bfloat16 (bf16 = 1).  Sq % 128 == 0, Sk a
// positive multiple of 128, 1 <= d <= 128; causal only with Sq == Sk.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int BH, int Sq, int Sk, int d,
                               int causal, int bf16, void* stream) {
  return forward(q, k, v, o, nullptr, BH, Sq, Sk, d, causal, bf16, stream);
}

// The same, and lse [BH, Sq] float32: each row's log-sum-exp of its
// scaled scores, for the backward.
extern "C" int flash_attention_lse(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int BH, int Sq, int Sk, int d, int causal,
                                   int bf16, void* stream) {
  return forward(q, k, v, o, lse, BH, Sq, Sk, d, causal, bf16, stream);
}
