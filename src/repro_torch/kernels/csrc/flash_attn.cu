// Flash attention (online softmax) on Hopper's tensor cores, sm_90a, plain
// C interface.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attn.py): for each (batch, head) of
// q [BH, Sq, d] and k, v [BH, Sk, d], float32 or bfloat16,
//
//     o = softmax(mask(q k^T / sqrt(d))) v
//
// without building the [Sq, Sk] scores in device memory.  Numerics follow
// the TPU kernel: the online (m, l, acc) state in f32, masked scores
// weigh 0 (the reference's -1e30; every row keeps an unmasked key), the
// output acc / max(l, 1e-30) cast to the input type.  The 1/sqrt(d)
// scale is applied to the f32 scores (times log2(e), fused into the exp2),
// never to a rounded copy of q.
//
// Design (FA2 on mma.sync).  A block owns 128 query rows of one (batch,
// head).  In bf16 each of its 4 warps owns 32 rows, two 16-row m-tiles
// that share every K and V fragment it loads (halving the ldmatrix
// traffic a product, which bounds a 16-row warp); their Q comes from
// shared memory, their [32, d] output accumulators and the scores of one
// key tile stay in registers.  In f32 each of 8 warps owns 16 rows with Q
// split into hi and lo in registers, and each K/V tile is split once for
// the 128 rows.  K and V stream through shared memory in tiles of kBk =
// 64 keys; rows are padded by 8 bf16 so that ldmatrix (.trans for V) is
// free of bank conflicts, and head widths up to 32, 64 or 128 are
// zero-padded there to that width (d = 100 runs as 128 columns).
// - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with f32
//   accumulators.  The online softmax runs on the S fragments in f32; the
//   row max takes two quad shuffles, the row sum is kept per thread and
//   reduced once at the end.  P is rounded to bf16 in registers and used
//   directly as the A operand of P V (the m16n8k16 C layout is its A
//   layout), so it never goes through shared memory.
// - bf16: K/V tiles come in with cp.async, double-buffered.
// - f32: every operand is split into bf16 hi = bf16(x) and lo = bf16(x -
//   hi), and each product is taken as lo.hi + hi.lo + hi.hi (about 16
//   significant bits, far inside the 2e-3 tolerance, at the bf16 rate: 3x
//   TF32 would be 6 bf16-equivalents a product).  K and V are split once,
//   when a tile is loaded (synchronous loads), into four bf16 tiles; Q is
//   split into registers.
// - Causal: key tiles above the diagonal are skipped and only the
//   diagonal tiles are masked; the heaviest query tiles launch first.
//
// - With an lse pointer the kernel also writes each row's log-sum-exp of
//   its scaled scores, ln(sum_k exp(q.k / sqrt(d))), f32 [BH, Sq]: the
//   training forward keeps it for the backward (flash_attn_bwd.cu).
//
// Bound on an H100: operations, 2 * Sq * Sk * d multiply-adds a head
// (half that when causal), at 989 TFLOP/s dense bf16, three times that
// work in f32; bytes 4 * S * d * sizeof(T) a head.

#include <math.h>

#include "bf16_mma.cuh"

namespace {

// Warps a block, and 16-row m-tiles a warp: 128 query rows a block.
template <typename T>
constexpr int kWarps = sizeof(T) == 4 ? 8 : 4;
template <typename T>
constexpr int kMT = sizeof(T) == 4 ? 1 : 2;
constexpr int kBk = 64;            // keys a shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// One block an SM as the floor lets ptxas use up to 255 registers a
// thread, to keep ldmatrix loads ahead of the products; two 128-thread
// blocks still fit an SM.
template <typename T, int DMAX>
__global__ void __launch_bounds__(32 * kWarps<T>, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int BH, int Sq, int Sk, int d,
             int causal, int vec, float scale_log2) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int MT = kMT<T>;
  constexpr int kThreads = 32 * kWarps<T>;
  constexpr int kBq = 16 * MT * kWarps<T>;   // query rows a block
  constexpr int DP = DMAX + 8;       // padded shared row, bf16 elements
  constexpr int KD = DMAX / 16;      // k-steps of Q K^T
  constexpr int ND = DMAX / 8;       // 8-wide column tiles of O
  constexpr int NS = kBk / 8;        // 8-wide key tiles of S
  constexpr int TILE = kBk * DP;     // one [kBk, DP] bf16 tile
  // bf16: K, V of stage 0, then of stage 1, then Q [kBq, DP];
  // f32: K hi, K lo, V hi, V lo
  extern __shared__ __align__(16) __nv_bfloat16 sm[];

  const int n_qt = Sq / kBq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const long long bh = blockIdx.x % BH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBq;
  const int wrow = 16 * MT * warp;        // the warp's first row in the tile
  const int row0 = q0 + wrow + g;         // rows row0 + 16 mt, + 8

  const T* qh = q + (bh * Sq + q0) * d;
  const T* kh = k + bh * Sk * d;
  const T* vh = v + bh * Sk * d;

  // f32: Q fragments (A layout) in registers, split into hi and lo:
  // register r holds row (r & 1) * 8, columns 16 kk + (r >> 1) * 8 + 2t, +1
  uint32_t qa[kF32 ? KD : 1][4];
  uint32_t ql[kF32 ? KD : 1][4];
  __nv_bfloat16* qs = sm + 4 * TILE;      // bf16: Q of the block
  if constexpr (kF32) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const T* qrow = qh + (wrow + g + (r & 1) * 8) * d;
        const int c = 16 * kk + (r >> 1) * 8 + 2 * t;
        const float x0 = c < d ? ld(qrow + c) : 0.f;
        const float x1 = c + 1 < d ? ld(qrow + c + 1) : 0.f;
        split(x0, x1, qa[kk][r], ql[kk][r]);
      }
  } else if (vec) {
    for (int i = threadIdx.x; i < kBq * DMAX / 8; i += kThreads) {
      const int r = i / (DMAX / 8);
      const int c = (i % (DMAX / 8)) * 8;
      cp_async16(qs + r * DP + c, qh + r * d + (c < d ? c : 0), c < d);
    }
  } else {
    for (int i = threadIdx.x; i < kBq * DMAX; i += kThreads) {
      const int r = i / DMAX;
      const int c = i % DMAX;
      qs[r * DP + c] = c < d ? qh[r * d + c] : __float2bfloat16(0.f);
    }
  }
  // one key tile into shared memory
  auto load_tile = [&](int kt, int stage) {
    const long long base = (long long)kt * kBk * d;
    if constexpr (kF32) {
      __nv_bfloat16* dst[4] = {sm, sm + TILE, sm + 2 * TILE, sm + 3 * TILE};
      if (vec) {                                // d % 4 == 0, aligned
        for (int i = threadIdx.x; i < kBk * DMAX / 4; i += kThreads) {
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
        for (int i = threadIdx.x; i < kBk * DMAX / 2; i += kThreads) {
          const int r = i / (DMAX / 2);
          const int c = (i % (DMAX / 2)) * 2;
          const T* kr = kh + base + r * d;
          const T* vr = vh + base + r * d;
          const float k0 = c < d ? kr[c] : 0.f, k1 = c + 1 < d ? kr[c + 1] : 0.f;
          const float v0 = c < d ? vr[c] : 0.f, v1 = c + 1 < d ? vr[c + 1] : 0.f;
          split(k0, k1, *reinterpret_cast<uint32_t*>(dst[0] + r * DP + c),
                *reinterpret_cast<uint32_t*>(dst[1] + r * DP + c));
          split(v0, v1, *reinterpret_cast<uint32_t*>(dst[2] + r * DP + c),
                *reinterpret_cast<uint32_t*>(dst[3] + r * DP + c));
        }
      }
    } else {
      __nv_bfloat16* ks = sm + stage * 2 * TILE;
      __nv_bfloat16* vs = ks + TILE;
      if (vec) {                                // d % 8 == 0, aligned
        for (int i = threadIdx.x; i < kBk * DMAX / 8; i += kThreads) {
          const int r = i / (DMAX / 8);
          const int c = (i % (DMAX / 8)) * 8;
          const bool in = c < d;
          const long long off = base + r * d + (in ? c : 0);
          cp_async16(ks + r * DP + c, kh + off, in);
          cp_async16(vs + r * DP + c, vh + off, in);
        }
      } else {
        for (int i = threadIdx.x; i < kBk * DMAX; i += kThreads) {
          const int r = i / DMAX;
          const int c = i % DMAX;
          const __nv_bfloat16 zero = __float2bfloat16(0.f);
          ks[r * DP + c] = c < d ? kh[base + r * d + c] : zero;
          vs[r * DP + c] = c < d ? vh[base + r * d + c] : zero;
        }
      }
    }
  };

  int n_kt = Sk / kBk;
  if (causal) {
    const int last = (q0 + kBq + kBk - 1) / kBk;
    n_kt = last < n_kt ? last : n_kt;
  }

  float acc[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

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
  // Q (A of Q K^T, 16 rows x 16 columns): matrices (rows +0, cols +0),
  // (+8, +0), (+0, +8), (+8, +8) give a0 .. a3.
  const int q_off = (wrow + (lane & 15)) * DP + ((lane >> 4) << 3);

  if constexpr (!kF32) {
    load_tile(0, 0);
    cp_commit();                        // with Q's copies
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const __nv_bfloat16 *k_hi, *k_lo, *v_hi, *v_lo;
    if constexpr (kF32) {
      __syncthreads();                 // every warp is done with the tiles
      load_tile(kt, 0);
      __syncthreads();
      k_hi = sm;
      k_lo = sm + TILE;
      v_hi = sm + 2 * TILE;
      v_lo = sm + 3 * TILE;
    } else {
      if (kt + 1 < n_kt) {
        load_tile(kt + 1, (kt + 1) & 1);   // read by no warp since kt - 1
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      k_hi = k_lo = sm + (kt & 1) * 2 * TILE;
      v_hi = v_lo = k_hi + TILE;
    }

    // S = Q K^T (raw dot products)
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[MT][4];
      if constexpr (kF32) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qf[0][r] = qa[kk][r];
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(qf[mt], qs + q_off + 16 * mt * DP + 16 * kk);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int off = (16 * np + k_row) * DP + 16 * kk + k_col;
        uint32_t b[4];
        ldsm_x4(b, k_hi + off);
        if constexpr (kF32) {
          uint32_t bl[4];
          ldsm_x4(bl, k_lo + off);
          mma(s[0][2 * np], ql[kk], b[0], b[1]);
          mma(s[0][2 * np + 1], ql[kk], b[2], b[3]);
          mma(s[0][2 * np], qf[0], bl[0], bl[1]);
          mma(s[0][2 * np + 1], qf[0], bl[2], bl[3]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt], b[0], b[1]);
          mma(s[mt][2 * np + 1], qf[mt], b[2], b[3]);
        }
      }
    }

    // online softmax in log2 units: x = s * scale_log2; masked scores
    // count as -inf here (p = 0 either way: every row has an unmasked key)
    const int k0 = kt * kBk;
    const bool diag = causal && k0 + kBk - 1 > q0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (diag &&
              k0 + 8 * j + 2 * t + (e & 1) > row0 + 16 * mt + (e >> 1) * 8)
            s[mt][j][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        }
      float alpha[2], nm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r] * scale_log2);
        alpha[r] = ex2(m[mt][r] - m_new);
        m[mt][r] = m_new;
        nm[r] = -m_new;
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] *= alpha[e >> 1];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], scale_log2, nm[e >> 1]));
          l[mt][e >> 1] += p;
          s[mt][j][e] = p;
        }
    }

    // O += P V, P from the S fragments in registers
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t pa[MT][4], pl[4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = s[mt][2 * kk + (r >> 1)][(r & 1) * 2];
          const float x1 = s[mt][2 * kk + (r >> 1)][(r & 1) * 2 + 1];
          if constexpr (kF32) split(x0, x1, pa[mt][r], pl[r]);
          else pa[mt][r] = pack(x0, x1);
        }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        const int off = (16 * kk + v_row) * DP + 16 * np + v_col;
        uint32_t b[4];
        ldsm_x4_trans(b, v_hi + off);
        if constexpr (kF32) {
          uint32_t bl[4];
          ldsm_x4_trans(bl, v_lo + off);
          mma(acc[0][2 * np], pl, b[0], b[1]);
          mma(acc[0][2 * np + 1], pl, b[2], b[3]);
          mma(acc[0][2 * np], pa[0], bl[0], bl[1]);
          mma(acc[0][2 * np + 1], pa[0], bl[2], bl[3]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * np], pa[mt], b[0], b[1]);
          mma(acc[mt][2 * np + 1], pa[mt], b[2], b[3]);
        }
      }
    }
    if constexpr (!kF32) __syncthreads();   // before the next load lands
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      if (lse != nullptr && t == 0)       // m, l in log2 units
        lse[bh * Sq + row0 + 16 * mt + 8 * r] =
            (m[mt][r] + log2f(l[mt][r])) * kLn2;
      l[mt][r] = 1.f / fmaxf(l[mt][r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        if (c < d) {
          T* orow = o + (bh * Sq + row0 + 16 * mt + (e >> 1) * 8) * d;
          const float x = acc[mt][j][e] * l[mt][e >> 1];
          if constexpr (kF32) orow[c] = x;
          else orow[c] = __float2bfloat16(x);
        }
      }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Sq, int Sk, int d, int causal,
                   cudaStream_t s) {
  const long long blocks = (long long)BH * (Sq / (16 * kMT<T> * kWarps<T>));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int q_rows = sizeof(T) == 4 ? 0 : 16 * kMT<T> * kWarps<T>;
  const int smem = (4 * kBk + q_rows) * (DMAX + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int lanes = sizeof(T) == 4 ? 4 : 8;   // elements a vector load
  const int vec = d % lanes == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  // the reference's scale, then log2(e) for exp2
  const float scale_log2 = (float)(1.0 / sqrt((double)d) * kLog2e);
  flash_kernel<T, DMAX><<<(unsigned)blocks, 32 * kWarps<T>, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, BH, Sq, Sk, d,
      causal, vec, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int BH, int Sq, int Sk, int d, int causal,
                     cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, BH, Sq, Sk, d, causal, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, BH, Sq, Sk, d, causal, s);
  return launch<T, 128>(q, k, v, o, lse, BH, Sq, Sk, d, causal, s);
}

int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int BH, int Sq, int Sk, int d, int causal, int bf16,
            void* stream) {
  if (d < 1 || d > 128 || Sq % 128 != 0 || Sk % kBk != 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, BH, Sq, Sk, d, causal,
                                     s)
           : dispatch<float>(q, k, v, o, lse, BH, Sq, Sk, d, causal, s);
  return (int)err;
}

}  // namespace

// q [BH, Sq, d], k and v [BH, Sk, d], o [BH, Sq, d], all of one type:
// float32 (bf16 = 0) or bfloat16 (bf16 = 1).  Sq % 128 == 0,
// Sk % 64 == 0, 1 <= d <= 128; causal only with Sq == Sk.
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
