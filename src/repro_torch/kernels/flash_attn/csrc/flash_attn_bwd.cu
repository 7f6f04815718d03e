// Causal flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// the forward in flash_attn.cu, from its float32 output o and log-sum-exp
// lse.
//
// Serves the TPU kernel ``flash_attention`` of the reference package
// (src/repro/kernels/flash_attn/flash_attn.py, ``_kernel``).  The reference
// has no backward kernel: its Pallas kernel has no custom_vjp, and JAX
// differentiates its plain attention (src/repro/kernels/flash_attn/ref.py).
// Per head, scale = 1/sqrt(D), masked pairs P = 0 (set, never computed as
// exp(-1e30 - lse)):
//   delta_i = sum_d dO_id O_id
//   P_ij    = exp(scale q_i . k_j - lse_i)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
// The S x S matrices never reach device memory.
//
// Bound on this card: operations.  10 * D flops per unmasked (q, k) pair and
// head (five products) against a row each of q, k, v, o (float32), dO, dq,
// dk, dv per position: at qwen2-0.5b's training shape (BH 28, S 4,096,
// D 64, bf16) 150 GFLOP, 0.152 ms at the tensor cores' 989 TFLOP/s, against
// 133 MB, 0.040 ms at 3.35 TB/s.
//
// Design: three kernels on one stream, no atomics, so the gradients are the
// same bit for bit from run to run (a one-rank sharded step must give the
// unsharded step's weights exactly).
//   1. delta: one warp per row, float32 sum of dO * O.  O is the
//      forward's float32 output: delta cancels against rowsum(P dP) in dS,
//      so O rounded to bf16 would move dq and dk by far more than P's and
//      dS's rounding do.
//   2. dK/dV: one CTA per key tile, looping over the query tiles that see
//      it (tiles past the causal frontier or the window are never visited,
//      as the forward skips its tiles); it recomputes S, P from lse, dP and
//      dS, and keeps dK and dV of its keys in registers.
//   3. dQ: one CTA per query tile, looping over its key tiles; it
//      recomputes S, P, dP and dS and keeps dQ of its rows in registers.
// Two passes recompute S and dP twice: 7 products against the bound's 5,
// the price of deterministic sums without atomics.  Both take their tiles
// longest first: early key tiles, late query tiles.
//
// bf16: wgmma and TMA (hopper.cuh).  A CTA of 384 threads owns 128 keys
//   (dK/dV) or 128 queries (dQ): two consumer warpgroups of 64 rows each
//   and a producer warpgroup, of which one warp works; setmaxnreg hands the
//   producer's registers to the consumers (40 against 232).  The producer
//   loads the CTA's own rows (K and V, or Q and dO) once by TMA, then keeps
//   the other side's tiles (Q, dO, and lse * log2(e) and delta by plain
//   loads, or K and V) in a ring of two stages guarded by full and empty
//   mbarriers; 128 rows a tile at D <= 64 and 64 at D = 96 / 128, where
//   dK and dV take 128 registers a thread.  dK/dV forms S^T and dP^T of
//   a tile in chunks of 64 queries (32 at D = 96 / 128): with both chunks
//   and dK, dV in registers, a whole tile would not fit beside them and
//   ptxas would spill and serialize the wgmma.  At D = 128 it serializes
//   them all the same ("insufficient register resources"), though it
//   spills only 84 bytes.  The grid is (head, tile), so every head's
//   longest tile starts before any shorter one.  Tensor maps are 3D
//   [bh, s, d] with boxes of 32 columns (64-byte rows, 64-byte swizzle: one
//   layout for every head dim), so rows past S read zeros of their own
//   head.  dK/dV: S^T = K Q^T and dP^T = V dO^T as wgmma with both operands
//   in shared memory (K-major); P^T = 2^(s scale log2(e) - lse log2(e)),
//   masked to 0, is formed in place in S^T's accumulators while dP^T
//   runs, then P^T and dS^T = P^T (dP^T - delta) are rounded to bf16 in
//   registers as the A operands of dV += P^T dO and dK += dS^T Q, whose B
//   (dO, Q) is read MN-major.  dQ: S = Q K^T and dP = dO V^T from shared
//   memory, dS in registers as the A of dQ += dS K, K read MN-major.  P
//   and dS are rounded to bf16 before their products, as every
//   tensor-core attention does (``attention_bwd_bf16`` in ref.py emulates
//   it; ``BWD_BF16_RMS_LIMIT``).  A warpgroup that sees none of a tile
//   skips it; a warp whose rows cross the diagonal, the window's edge or S
//   masks element by element.
// float32: the CUDA cores in true float32, so ``attention_bwd_limit``'s
//   2e-5 of the spread holds.  A CTA of 256 threads owns 32 keys (dK/dV) or
//   32 queries (dQ) and stages 32-row tiles of the other side in float32,
//   rows padded by 4 floats; thread (tr, tc) = (t / 16, t % 16) computes
//   the scores of its rows 2tr, 2tr + 1 against columns tc, tc + 16, writes
//   P and dS to shared memory, then accumulates columns tc + 16 c of its two
//   rows.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// key kpos is hidden from query qpos (causal, window, or a row past S)
__device__ __forceinline__ bool hidden(int kpos, int qpos, int window,
                                       int s_len) {
  return kpos > qpos || (window > 0 && kpos <= qpos - window) || qpos >= s_len;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), one warp a row
// ---------------------------------------------------------------------------

constexpr int kDeltaRows = 8;  // rows per 256-thread CTA

template <typename T, int D>
__global__ void __launch_bounds__(32 * kDeltaRows)
    flash_bwd_delta(const float* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * kDeltaRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    acc = fmaf(o[row * D + c], to_float(dout[row * D + c]), acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA, one producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kRows = 128;    // keys (dK/dV) or queries (dQ) of a CTA
constexpr int kGroups = 2;    // consumer warpgroups, 64 of those rows each
constexpr int kThreadsTc = 128 * (kGroups + 1);  // and a producer warpgroup
constexpr int kStages = 2;    // ring of the other side's tiles
constexpr int kBox = 32;      // columns of a TMA box: 64-byte rows
constexpr int kBoxRow = 2 * kBox;  // bytes of a box row
constexpr int kProducerRegs = 40;  // registers a producer thread keeps
constexpr int kConsumerRegs = 232;  // and a consumer thread takes

// rows of the other side per staged tile
template <int D>
__host__ __device__ constexpr int other_rows() { return D <= 64 ? 128 : 64; }

// Shared memory of a pass, from a 1,024-byte boundary: the CTA's own rows
// (K, V in dK/dV; Q, dO in dQ), kStages of the other side's two tiles,
// with ``vals`` the tile rows' lse * log2(e) and delta (dK/dV), then the
// barriers: one for the own rows, full and empty of each stage.
template <int D, bool vals>
struct Smem {
  static constexpr int B = other_rows<D>();
  static constexpr int OWN = kRows * D * 2;  // bytes of one own tensor
  static constexpr int TILE = B * D * 2;     // bytes of one staged tile
  static constexpr int VALS = 2 * OWN + 2 * kStages * TILE;
  static constexpr int BARS = VALS + (vals ? 2 * kStages * B * 4 : 0);
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * kStages) + 1024;
  __host__ __device__ static constexpr int own(int i) { return i * OWN; }
  __host__ __device__ static constexpr int tile(int st, int i) {
    return 2 * OWN + (2 * st + i) * TILE;
  }
  __host__ __device__ static constexpr int val(int st, int i) {
    return VALS + (2 * st + i) * B * 4;
  }
  __host__ __device__ static constexpr int own_full() { return BARS; }
  __host__ __device__ static constexpr int full(int st) { return BARS + 8 * (1 + st); }
  __host__ __device__ static constexpr int empty(int st) {
    return BARS + 8 * (1 + kStages + st);
  }
};

// rows [row, row + ROWS) of one head of a [bh, s, D] tensor map, all D / 32
// boxes, into the tile at ``dst``
template <int D, int ROWS>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
#pragma unroll
  for (int b = 0; b < D / kBox; ++b) {
    tma_load_3d(dst + b * ROWS * kBoxRow, map, bar, b * kBox, row, head);
  }
}

// k-step kk (columns 16 kk .. 16 kk + 15) of rows [r0, r0 + 64) of a
// [ROWS, D] tile read K-major: the A of a product over D, or its B
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return desc_sw64(tile + (kk / 2) * ROWS * kBoxRow + r0 * kBoxRow + (kk % 2) * 32,
                   16, 8 * kBoxRow);
}

// k-step kk (rows 16 kk .. 16 kk + 15) of a [ROWS, D] tile read MN-major:
// the B (16 x D) of a product over the tile's rows
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw64(tile + kk * 16 * kBoxRow, ROWS * kBoxRow, 8 * kBoxRow);
}

// the 1,024-byte-aligned start of dynamic shared memory (``bytes`` leaves
// room for the shift)
__device__ __forceinline__ uint32_t smem_base(uint8_t*& p) {
  const uint32_t raw = smem_addr(p);
  const uint32_t base = (raw + 1023) & ~1023u;
  p += base - raw;
  return base;
}

// Round float accumulators to bf16 A fragments: k-step kk of a 64 x N
// accumulator is its n-tiles 2 kk and 2 kk + 1.
template <int M, int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[M][4], const float (&x)[N], int kk) {
  a[kk][0] = bf16_pair(x[8 * kk], x[8 * kk + 1]);
  a[kk][1] = bf16_pair(x[8 * kk + 2], x[8 * kk + 3]);
  a[kk][2] = bf16_pair(x[8 * kk + 4], x[8 * kk + 5]);
  a[kk][3] = bf16_pair(x[8 * kk + 6], x[8 * kk + 7]);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTc, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int s_len, int window,
                        float scale, float scale_log2) {
  static_assert(D % kBox == 0, "whole TMA boxes");
  using L = Smem<D, true>;
  constexpr int BQ = L::B;               // queries per staged tile
  constexpr int NC = D <= 64 ? 64 : 32;  // and per chunk: S^T and dP^T fit
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sp = smem_raw;
  const uint32_t base = smem_base(sp);

  const int head = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // early keys see the most queries: first
  // the query tiles that see a key of this CTA
  const int k_last = min(k0 + kRows, s_len) - 1;
  const int q_end = window > 0 ? min(s_len, k_last + window) : s_len;
  const int qt_begin = k0 / BQ;
  const int qt_end = (q_end + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(base + L::own_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(base + L::full(st), 32);            // the producer warp
      mbar_init(base + L::empty(st), 4 * kGroups);  // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kGroups) {
    // producer: K and V of the CTA's keys once, then Q, dO, lse * log2(e)
    // and delta of each query tile into the ring
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x - 128 * kGroups;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_arrive_tx(base + L::own_full(), 2 * L::OWN);
      tma_rows<D, kRows>(base + L::own(0), &tm_k, base + L::own_full(), k0, head);
      tma_rows<D, kRows>(base + L::own(1), &tm_v, base + L::own_full(), k0, head);
    }
    const int64_t rows = (int64_t)head * s_len;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int i = qt - qt_begin, st = i % kStages;
      const uint32_t full = base + L::full(st);
      mbar_wait(base + L::empty(st), ((i / kStages) & 1) ^ 1);
      float* l2 = reinterpret_cast<float*>(sp + L::val(st, 0));
      float* dl = reinterpret_cast<float*>(sp + L::val(st, 1));
      for (int r = lane; r < BQ; r += 32) {
        const int row = qt * BQ + r;
        const bool in = row < s_len;
        l2[r] = in ? lse[rows + row] * kLog2e : 0.f;
        dl[r] = in ? delta[rows + row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * L::TILE);
        tma_rows<D, BQ>(base + L::tile(st, 0), &tm_q, full, qt * BQ, head);
        tma_rows<D, BQ>(base + L::tile(st, 1), &tm_do, full, qt * BQ, head);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys kw0 .. kw0 + 63, its warp 16 of them
  setmaxnreg_inc<kConsumerRegs>();
  // the warpgroup, known to be warp-uniform: its descriptors live in
  // uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 64 * wg;
  const int kwarp = kw0 + 16 * warp;
  float dva[D / 2], dka[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dva[n] = dka[n] = 0.f;
  mbar_wait(base + L::own_full(), 0);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int i = qt - qt_begin, st = i % kStages;
    mbar_wait(base + L::full(st), (i / kStages) & 1);
    const uint32_t qs = base + L::tile(st, 0), dos = base + L::tile(st, 1);
    const float* l2 = reinterpret_cast<const float*>(sp + L::val(st, 0));
    const float* dl = reinterpret_cast<const float*>(sp + L::val(st, 1));
#pragma unroll 1
    for (int c = 0; c < BQ; c += NC) {
      const int q0 = qt * BQ + c;  // the chunk's first query
      // a query of the chunk sees a key of the warpgroup
      if (kw0 >= s_len || kw0 > q0 + NC - 1 || (window > 0 && kw0 + 63 <= q0 - window)) {
        continue;
      }

      // S^T = K Q^T and dP^T = V dO^T, both operands from shared memory
      float s[NC / 2], dp[NC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s, desc_k<kRows>(base + L::own(0), 64 * wg, kk),
                 desc_k<BQ>(qs, c, kk), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dp, desc_k<kRows>(base + L::own(1), 64 * wg, kk),
                 desc_k<BQ>(dos, c, kk), kk);
      }
      wgmma_commit();

      // P^T in place of S^T while dP^T runs: rows (keys) g and g + 8 of the
      // warp's 16, columns (queries) 8j + 2t4 + {0, 1}; a warp whose keys
      // cross the diagonal, the window's edge or S is masked element by
      // element
      wgmma_wait<1>();
      pin(s);
      const bool edge = kwarp + 15 > q0 ||
                        (window > 0 && kwarp <= q0 + NC - 1 - window) ||
                        q0 + NC > s_len;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(l2 + c + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[4 * j + e], scale_log2, -((e & 1) ? l.y : l.x)));
          if (edge && hidden(kwarp + g + 8 * (e >> 1), q0 + 8 * j + 2 * t4 + (e & 1),
                             window, s_len)) {
            p = 0.f;
          }
          s[4 * j + e] = p;
        }
      }

      // dS^T = P^T (dP^T - delta); P^T and dS^T rounded to bf16 as the A
      // operands of dV += P^T dO and dK += dS^T Q
      wgmma_wait<0>();
      pin(dp);
      uint32_t pa[NC / 16][4], dsa[NC / 16][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dl + c + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        to_a(pa, s, kk);
        to_a(dsa, dp, kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        wgmma_rs_t(dva, pa[kk], desc_mn<BQ>(dos, c / 16 + kk));
      }
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        wgmma_rs_t(dka, dsa[kk], desc_mn<BQ>(qs, c / 16 + kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(dva);
      pin(dka);
      pin(pa);
      pin(dsa);
    }
    if (lane == 0) mbar_arrive(base + L::empty(st));  // the tile is consumed
  }

  // rows (keys) g and g + 8 of the warp's 16, columns 8n + 2t4 + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kwarp + g + 8 * r;
    if (key >= s_len) continue;
    const int64_t off = ((int64_t)head * s_len + key) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          bf16_pair(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          bf16_pair(dka[4 * n + 2 * r] * scale, dka[4 * n + 2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTc, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int s_len, int window,
                      float scale, float scale_log2) {
  static_assert(D % kBox == 0, "whole TMA boxes");
  using L = Smem<D, false>;
  constexpr int BK = L::B;  // keys per staged tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sp = smem_raw;
  const uint32_t base = smem_base(sp);

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // late queries first
  // key tiles at or below the frontier that the window leaves visible
  const int q_last = min(q0 + kRows, s_len) - 1;
  const int kt_end = q_last / BK + 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(base + L::own_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(base + L::full(st), 1);
      mbar_init(base + L::empty(st), 4 * kGroups);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kGroups) {
    // producer: Q and dO of the CTA's queries once, then K and V of each
    // key tile into the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 128 * kGroups) return;
    mbar_arrive_tx(base + L::own_full(), 2 * L::OWN);
    tma_rows<D, kRows>(base + L::own(0), &tm_q, base + L::own_full(), q0, head);
    tma_rows<D, kRows>(base + L::own(1), &tm_do, base + L::own_full(), q0, head);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int i = kt - kt_begin, st = i % kStages;
      const uint32_t full = base + L::full(st);
      mbar_wait(base + L::empty(st), ((i / kStages) & 1) ^ 1);
      mbar_arrive_tx(full, 2 * L::TILE);
      tma_rows<D, BK>(base + L::tile(st, 0), &tm_k, full, kt * BK, head);
      tma_rows<D, BK>(base + L::tile(st, 1), &tm_v, full, kt * BK, head);
    }
    return;
  }

  // consumers: warpgroup wg owns queries qw0 .. qw0 + 63, its warp 16 of them
  setmaxnreg_inc<kConsumerRegs>();
  // the warpgroup, known to be warp-uniform: its descriptors live in
  // uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int qwarp = qw0 + 16 * warp;
  const int64_t rows = (int64_t)head * s_len;
  // rows g and g + 8: lse in log2 units and delta (0 past S: not stored)
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qwarp + g + 8 * r;
    lse2[r] = row < s_len ? lse[rows + row] * kLog2e : 0.f;
    del[r] = row < s_len ? delta[rows + row] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dqa[n] = 0.f;
  mbar_wait(base + L::own_full(), 0);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int i = kt - kt_begin, st = i % kStages;
    mbar_wait(base + L::full(st), (i / kStages) & 1);
    const int k0 = kt * BK;
    // a query of the warpgroup sees a key of the tile
    if (qw0 < s_len && k0 <= qw0 + 63 &&
        !(window > 0 && k0 + BK - 1 <= qw0 - window)) {
      const uint32_t ks = base + L::tile(st, 0), vs = base + L::tile(st, 1);

      // S = Q K^T and dP = dO V^T, both operands from shared memory
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s, desc_k<kRows>(base + L::own(0), 64 * wg, kk),
                 desc_k<BK>(ks, 0, kk), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dp, desc_k<kRows>(base + L::own(1), 64 * wg, kk),
                 desc_k<BK>(vs, 0, kk), kk);
      }
      wgmma_commit();

      // P in place of S: rows (queries) g and g + 8, columns (keys)
      // 8j + 2t4 + {0, 1}; keys past S lie past every real query, so the
      // causal test masks them
      wgmma_wait<1>();
      pin(s);
      const bool edge = k0 + BK - 1 > qwarp || (window > 0 && k0 <= qwarp + 15 - window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = ex2(fmaf(s[4 * j + e], scale_log2, -lse2[r]));
          if (edge && hidden(k0 + 8 * j + 2 * t4 + (e & 1), qwarp + g + 8 * r, window,
                             s_len)) {
            p = 0.f;
          }
          s[4 * j + e] = p;
        }
      }

      // dS = P (dP - delta), rounded to bf16 as the A operand of dQ += dS K
      wgmma_wait<0>();
      pin(dp);
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - del[e >> 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a(dsa, dp, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_t(dqa, dsa[kk], desc_mn<BK>(ks, kk));
      wgmma_commit();
      wgmma_wait<0>();
      pin(dqa);
      pin(dsa);
    }
    if (lane == 0) mbar_arrive(base + L::empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qwarp + g + 8 * r;
    if (row >= s_len) continue;
    __nv_bfloat16* out = dq + (rows + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          bf16_pair(dqa[4 * n + 2 * r] * scale, dqa[4 * n + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF = 32;         // rows per CTA and per staged tile
constexpr int kThreads = 256;  // 16 row pairs x 16 columns
constexpr int kPad = 4;        // floats of padding per shared row

template <int D>
constexpr size_t smem_f32() {
  // four [kF][D + kPad] tiles, two [kF][kF + kPad] (P, dS), lse and delta
  return sizeof(float) * (4 * kF * (D + kPad) + 2 * kF * (kF + kPad) + 2 * kF);
}

// rows [row0, row0 + kF) of x (a head's [s_len, D]) into ``dst``, zeros
// past S
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* x,
                                              int row0, int s_len) {
  constexpr int LD = D + kPad, V4 = D / 4;
  for (int e = threadIdx.x; e < kF * V4; e += kThreads) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s_len) {
      val = __ldg(reinterpret_cast<const float4*>(x + (int64_t)(row0 + r) * D + c));
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// a[i] . b[j] and c[i] . e[j] over D for the thread's rows 2tr + i of
// (a, c) and rows tc + 16j of (b, e)
template <int D>
__device__ __forceinline__ void dots_f32(const float* a, const float* b,
                                         const float* c, const float* e,
                                         int tr, int tc, float (&ab)[2][2],
                                         float (&ce)[2][2]) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = 0; i < 2; ++i) ab[i][0] = ab[i][1] = ce[i][0] = ce[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[2], cv[2], bv[2], ev[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (2 * tr + i) * LD + d);
      cv[i] = *reinterpret_cast<const float4*>(c + (2 * tr + i) * LD + d);
      bv[i] = *reinterpret_cast<const float4*>(b + (tc + 16 * i) * LD + d);
      ev[i] = *reinterpret_cast<const float4*>(e + (tc + 16 * i) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = ab[i][j], y = ce[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        y = fmaf(cv[i].x, ev[j].x, y);
        y = fmaf(cv[i].y, ev[j].y, y);
        y = fmaf(cv[i].z, ev[j].z, y);
        y = fmaf(cv[i].w, ev[j].w, y);
        ab[i][j] = x;
        ce[i][j] = y;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, int s_len, int window,
                       float scale) {
  static_assert(D % 16 == 0, "16 threads share a row: D / 16 columns each");
  constexpr int LD = D + kPad, LP = kF + kPad, C = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kF][LD], the CTA's keys
  float* vs = ks + kF * LD;
  float* qs = vs + kF * LD;                       // [kF][LD], a query tile
  float* dos = qs + kF * LD;
  float* ps = dos + kF * LD;                      // [kF keys][LP] P^T
  float* dss = ps + kF * LP;                      // [kF keys][LP] dS^T
  float* lses = dss + kF * LP;
  float* dels = lses + kF;

  const int k0 = blockIdx.x * kF;
  const int64_t head = (int64_t)blockIdx.y * s_len * D;
  const int64_t rows = (int64_t)blockIdx.y * s_len;
  const int t = threadIdx.x, tr = t >> 4, tc = t & 15;

  load_rows_f32<D>(ks, k + head, k0, s_len);
  load_rows_f32<D>(vs, v + head, k0, s_len);
  float dka[2][C], dva[2][C];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) dka[i][c] = dva[i][c] = 0.f;
  }

  const int k_last = min(k0 + kF, s_len) - 1;
  const int q_end = window > 0 ? min(s_len, k_last + window) : s_len;
  for (int q0 = k0; q0 < q_end; q0 += kF) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    load_rows_f32<D>(qs, q + head, q0, s_len);
    load_rows_f32<D>(dos, dout + head, q0, s_len);
    if (t < kF) {
      const bool in = q0 + t < s_len;
      lses[t] = in ? lse[rows + q0 + t] : 0.f;
      dels[t] = in ? delta[rows + q0 + t] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T of keys 2tr + i against queries tc + 16j
    float sc[2][2], dp[2][2];
    dots_f32<D>(ks, qs, vs, dos, tr, tc, sc, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = tc + 16 * j;
        const float p = hidden(k0 + 2 * tr + i, q0 + qi, window, s_len)
                            ? 0.f
                            : expf(sc[i][j] * scale - lses[qi]);
        ps[(2 * tr + i) * LP + qi] = p;
        dss[(2 * tr + i) * LP + qi] = p * (dp[i][j] - dels[qi]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's queries, columns
    // tc + 16c of the thread's two keys
#pragma unroll 4
    for (int qq = 0; qq < kF; ++qq) {
      float p[2], ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p[i] = ps[(2 * tr + i) * LP + qq];
        ds[i] = dss[(2 * tr + i) * LP + qq];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float o = dos[qq * LD + tc + 16 * c];
        const float x = qs[qq * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dva[i][c] = fmaf(p[i], o, dva[i][c]);
          dka[i][c] = fmaf(ds[i], x, dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * tr + i;
    if (key >= s_len) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dv[head + (int64_t)key * D + tc + 16 * c] = dva[i][c];
      dk[head + (int64_t)key * D + tc + 16 * c] = dka[i][c] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int s_len, int window, float scale) {
  static_assert(D % 16 == 0, "16 threads share a row: D / 16 columns each");
  constexpr int LD = D + kPad, LP = kF + kPad, C = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kF][LD], the CTA's queries
  float* dos = qs + kF * LD;
  float* ks = dos + kF * LD;                      // [kF][LD], a key tile
  float* vs = ks + kF * LD;
  float* dss = vs + kF * LD;                      // [kF queries][LP] dS
  float* lses = dss + 2 * kF * LP;                // (P's space unused here)
  float* dels = lses + kF;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF;  // late queries first
  const int64_t head = (int64_t)blockIdx.y * s_len * D;
  const int64_t rows = (int64_t)blockIdx.y * s_len;
  const int t = threadIdx.x, tr = t >> 4, tc = t & 15;

  load_rows_f32<D>(qs, q + head, q0, s_len);
  load_rows_f32<D>(dos, dout + head, q0, s_len);
  if (t < kF) {
    const bool in = q0 + t < s_len;
    lses[t] = in ? lse[rows + q0 + t] : 0.f;
    dels[t] = in ? delta[rows + q0 + t] : 0.f;
  }
  float dqa[2][C];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) dqa[i][c] = 0.f;
  }

  const int q_last = min(q0 + kF, s_len) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kF * kF : 0;
  for (int k0 = k_begin; k0 <= q_last; k0 += kF) {
    __syncthreads();  // Q and dO stored; the previous tile's dS consumed
    load_rows_f32<D>(ks, k + head, k0, s_len);
    load_rows_f32<D>(vs, v + head, k0, s_len);
    __syncthreads();

    // S and dP of queries 2tr + i against keys tc + 16j
    float sc[2][2], dp[2][2];
    dots_f32<D>(qs, ks, dos, vs, tr, tc, sc, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = 2 * tr + i;
        const float p = hidden(k0 + tc + 16 * j, q0 + qi, window, s_len)
                            ? 0.f
                            : expf(sc[i][j] * scale - lses[qi]);
        dss[qi * LP + tc + 16 * j] = p * (dp[i][j] - dels[qi]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys, columns tc + 16c of the two rows
#pragma unroll 4
    for (int kk = 0; kk < kF; ++kk) {
      float ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ds[i] = dss[(2 * tr + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float x = ks[kk * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) dqa[i][c] = fmaf(ds[i], x, dqa[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * tr + i;
    if (row >= s_len) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dq[head + (int64_t)row * D + tc + 16 * c] = dqa[i][c] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int64_t rows, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kDeltaRows - 1) / kDeltaRows);
  flash_bwd_delta<T, D><<<blocks, 32 * kDeltaRows, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta, int bh,
                       int s, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<D>();
  cudaError_t e = allow_smem(flash_bwd_dkdv_f32<D>, smem);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_f32<D>, smem);
  if (e == cudaSuccess) e = launch_delta<float, D>(o, dout, delta, (int64_t)bh * s, stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((s + kF - 1) / kF), static_cast<unsigned>(bh));
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  flash_bwd_dkdv_f32<D><<<grid, kThreads, smem, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      s, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_f32<D><<<grid, kThreads, smem, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), s, window, scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); null if the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// x [bh, s, d] bf16 as a 3D tensor map whose box is 32 columns by ``rows``
// rows of one head, 64-byte swizzle; rows past s read as zeros, so a tile
// past S never reads the next head's rows
cudaError_t tensor_map(CUtensorMap* map, const void* x, int bh, int s, int d,
                       int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta, int bh,
                        int s, int window, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int B = other_rows<D>();
  constexpr size_t smem_kv = Smem<D, true>::bytes, smem_q = Smem<D, false>::bytes;
  // each tensor with boxes of the CTA's own rows and of the staged tiles'
  CUtensorMap own[4], tile[4];
  const void* x[4] = {q, k, v, dout};
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
    e = tensor_map(&own[i], x[i], bh, s, D, kRows);
    if (e == cudaSuccess) e = tensor_map(&tile[i], x[i], bh, s, D, B);
  }
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkdv_bf16<D>, smem_kv);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_bf16<D>, smem_q);
  if (e == cudaSuccess) e = launch_delta<bf, D>(o, dout, delta, (int64_t)bh * s, stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((s + kRows - 1) / kRows));
  flash_bwd_dkdv_bf16<D><<<grid, kThreadsTc, smem_kv, stream>>>(
      tile[0], own[1], own[2], tile[3], lse, delta, static_cast<bf*>(dk),
      static_cast<bf*>(dv), s, window, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_bf16<D><<<grid, kThreadsTc, smem_q, stream>>>(
      own[0], tile[1], tile[2], own[3], lse, delta, static_cast<bf*>(dq), s, window,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int bh, int s, int window, float scale, int bf16,
           cudaStream_t st) {
  return static_cast<int>(
      bf16 ? launch_bf16<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, s,
                            window, scale, st)
           : launch_f32<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, s,
                           window, scale, st));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Dynamic shared memory in bytes of the bf16 dK/dV (dq_pass 0) or dQ
// (dq_pass 1) kernel at head dim d; -1 for another head dim.
extern "C" int flash_attention_bwd_bf16_smem(int d, int dq_pass) {
  switch (d) {
    case 32: return static_cast<int>(dq_pass ? Smem<32, false>::bytes : Smem<32, true>::bytes);
    case 64: return static_cast<int>(dq_pass ? Smem<64, false>::bytes : Smem<64, true>::bytes);
    case 96: return static_cast<int>(dq_pass ? Smem<96, false>::bytes : Smem<96, true>::bytes);
    case 128: return static_cast<int>(dq_pass ? Smem<128, false>::bytes : Smem<128, true>::bytes);
    default: return -1;
  }
}

// Launches one backward pass on ``stream``: the delta pass, then dK/dV,
// then dQ.  Device pointers q, k, v, do (the output's gradient) and dq,
// dk, dv [bh, s, d], contiguous, 16-byte aligned, float32 (bf16 = 0) or
// bf16 (bf16 = 1); o [bh, s, d] float32 and lse [bh, s] float32 (natural
// log) as the forward wrote them; delta_scratch [bh, s] float32, overwritten; d 32, 64, 96 or 128;
// bh at most 65535; window 0 means none, else keys with kpos <= qpos -
// window are masked; scale is the forward's (1/sqrt(d)).  Returns the
// cudaError_t of the first launch that failed (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv,
                                          void* delta_scratch, int bh, int s,
                                          int d, int window, float scale,
                                          int bf16, void* stream) {
  if (bh < 0 || bh > 65535 || s < 0 || window < 0 ||
      (d != 32 && d != 64 && d != 96 && d != 128) || !q || !k || !v || !o ||
      !dout || !lse || !dq || !dk || !dv || !delta_scratch || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta_scratch);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, st);
    case 64: return launch<64>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, st);
    case 96: return launch<96>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, st);
    default: return launch<128>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, st);
  }
}
