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
// 133 MB, 0.040 ms at 3.35 TB/s.  In float32 each product is three TF32
// products (split_tf32.cuh): 30 * D flops a pair at 495 TFLOP/s.
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
// float32: split TF32 on wgmma, fed by TMA (split_tf32.cuh): every product
//   as hi hi + hi lo + lo hi of TF32 halves, within about 2^-21 of the
//   float32 product, so ``attention_bwd_limit``'s 2e-5 of the spread holds
//   with 12x of margin on unit-variance draws
//   (``ref.attention_bwd_split_tf32``; one TF32 product,
//   ``ref.attention_bwd_tf32``, exceeds it 18x or more).  The CTA shape is
//   the bf16 kernels' with a ring of single operand tiles: a producer warp
//   loads them by TMA, three helper warps split each (hi rounded in place,
//   lo beside it), consumer warpgroups of 64 rows wait for the split.  Own
//   rows and tiles take 8 bytes an element as hi and lo, so a CTA owns 128
//   keys (queries) at D <= 64, two consumer warpgroups, and 64 at D = 96 /
//   128, one; the other side is streamed in 32-row tiles.  dK/dV: per query
//   tile Q and dO as rows (S^T = K Q^T, dP^T = V dO^T, both operands in
//   shared memory, the scores' hi hi terms summed in chunks on the CUDA
//   cores as in the forward; the Q tile carries its rows' lse and delta),
//   then dO and
//   Q as K-major copies [bh, d, s8] (``kmajor_copy``, before the launch:
//   TF32 wgmma reads shared operands K-major only) for dV += P^T dO and
//   dK += dS^T Q, P^T and dS^T split in registers as the A operands as the
//   accumulators hold them (the copies permute their positions to match).
//   dQ: per key tile K and V as rows (S = Q K^T, dP = dO V^T), then K's
//   K-major copy for dQ += dS K.  Each tile's dV, dK or dQ product goes into
//   a fresh accumulator and is added on the CUDA cores: the tensor cores'
//   float32 accumulation truncates, so a dV summed on them over all of S
//   drifts by up to an ulp per wgmma, a share of the limit that grows with
//   S.  Exponents, lse and delta stay in float32 on the CUDA cores.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "split_tf32.cuh"
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
// float32: split TF32 on wgmma, fed by TMA (split_tf32.cuh)
// ---------------------------------------------------------------------------

// consumer warpgroups: two (128 own rows) where their own K, V (or Q, dO)
// as hi and lo fit beside the ring, one (64 rows) at D = 96 / 128
template <int D>
__host__ __device__ constexpr int bwd_groups() { return D <= 64 ? 2 : 1; }

constexpr int kOther = 32;  // rows of the other side per staged tile

// columns of dK and dV per product (rs_tile): what the registers allow,
// 168 a thread with two consumer warpgroups, 255 with one
template <int D>
__host__ __device__ constexpr int dkdv_cols() { return D == 128 ? 64 : D; }

template <int D>
using DkdvRing = Ring<2, 64 * bwd_groups<D>(), D, kOther, true>;
template <int D>
using DqRing = Ring<2, 64 * bwd_groups<D>(), D, kOther, false>;

// dK/dV.  Slot uses per query tile, in order: Q (rows, with the tile's lse
// and delta), dO (rows), dO and Q (K-major copies).
template <int D>
__global__ void __launch_bounds__(128 * (bwd_groups<D>() + 1), 1)
    flash_bwd_dkdv_f32(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_qt,
                       const __grid_constant__ CUtensorMap tm_dot,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int s_len,
                       int window, float scale) {
  static_assert(D % kBoxF == 0, "whole TMA boxes");
  constexpr int G = bwd_groups<D>(), OWN = 64 * G, BQ = kOther;
  using L = DkdvRing<D>;
  constexpr int NS = L::NS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sp = smem_raw;
  const uint32_t base = smem_base(sp);

  const int head = blockIdx.x;
  const int k0 = blockIdx.y * OWN;  // early keys see the most queries: first
  // the query tiles that see a key of this CTA
  const int k_last = min(k0 + OWN, s_len) - 1;
  const int q_end = window > 0 ? min(s_len, k_last + window) : s_len;
  const int qt_begin = k0 / BQ;
  const int uses = 4 * ((q_end + BQ - 1) / BQ - qt_begin);
  const int64_t rows = (int64_t)head * s_len;

  if (threadIdx.x == 0) L::init(base, 4 * G);
  __syncthreads();

  if (threadIdx.x >= 128 * G) {
    regs_producer<G>();
    const int pt = threadIdx.x - 128 * G;
    if (pt == 0) {  // TMA: K and V once, then each query tile's four operands
      mbar_arrive_tx(base + L::own_full(), 2 * L::OWN_T);
      tma_rows_f32<D, OWN>(base + L::own(0), &tm_k, base + L::own_full(), k0, head);
      tma_rows_f32<D, OWN>(base + L::own(1), &tm_v, base + L::own_full(), k0, head);
      for (int u = 0; u < uses; ++u) {
        const int st = u % NS;
        const uint32_t full = base + L::full(st), dst = base + L::slot(st);
        const int q0 = (qt_begin + u / 4) * BQ;
        mbar_wait(base + L::empty(st), ((u / NS) & 1) ^ 1);
        mbar_arrive_tx(full, L::TILE);
        switch (u % 4) {
          case 0: tma_rows_f32<D, BQ>(dst, &tm_q, full, q0, head); break;
          case 1: tma_rows_f32<D, BQ>(dst, &tm_do, full, q0, head); break;
          case 2: tma_cols_f32<D, BQ>(dst, &tm_dot, full, q0, head); break;
          default: tma_cols_f32<D, BQ>(dst, &tm_qt, full, q0, head);
        }
      }
    } else if (pt >= 32) {  // split each tile that lands
      const int i = pt - 32;
      mbar_wait(base + L::own_full(), 0);
      split_tile(sp + L::own(0), OWN * D, i);
      split_tile(sp + L::own(1), OWN * D, i);
      fence_proxy_async();
      mbar_arrive(base + L::own_ready());
      for (int u = 0; u < uses; ++u) {
        const int st = u % NS;
        mbar_wait(base + L::full(st), (u / NS) & 1);
        split_tile(sp + L::slot(st), BQ * D, i);
        if (u % 4 == 0) {  // the Q tile carries its rows' lse and delta
          float* vals = reinterpret_cast<float*>(sp + L::vals(st));
          const int q0 = (qt_begin + u / 4) * BQ;
          for (int r = i; r < BQ; r += kSplitters) {
            const bool in = q0 + r < s_len;
            vals[r] = in ? lse[rows + q0 + r] : 0.f;
            vals[BQ + r] = in ? delta[rows + q0 + r] : 0.f;
          }
        }
        fence_proxy_async();
        mbar_arrive(base + L::ready(st));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys kw0 .. kw0 + 63, its warp 16 of them
  regs_consumer<G>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 64 * wg;
  const int kwarp = kw0 + 16 * warp;
  const uint32_t kh = base + L::own(0), kl = kh + L::OWN_T;
  const uint32_t vh = base + L::own(1), vl = vh + L::OWN_T;
  float dva[D / 2], dka[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dva[n] = dka[n] = 0.f;
  mbar_wait(base + L::own_ready(), 0);

  const float one[2] = {1.f, 1.f};
  for (int u = 0; u < uses; u += 4) {
    const int q0 = (qt_begin + u / 4) * BQ;
    int st[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) st[x] = (u + x) % NS;
    // a query of the tile sees a key of the warpgroup
    const bool vis = kw0 < s_len && kw0 <= q0 + BQ - 1 &&
                     !(window > 0 && kw0 + 63 <= q0 - window);
    float s[BQ / 2], dp[BQ / 2];
    uint32_t fh[BQ / 8][4], fl[BQ / 8][4];

    // S^T = K Q^T and dP^T = V dO^T as split TF32
    mbar_wait(base + L::ready(st[0]), (u / NS) & 1);
    mbar_wait(base + L::ready(st[1]), ((u + 1) / NS) & 1);
    if (vis) {
      const uint32_t qs = base + L::slot(st[0]), dos = base + L::slot(st[1]);
      split_scores<OWN, BQ, D / 8>(s, kh, kl, 64 * wg, qs, qs + L::TILE);
      wgmma_fence();
      split_ss<OWN, BQ, D / 8>(dp, vh, vl, 64 * wg, dos, dos + L::TILE);
      wgmma_commit();

      // P^T = exp(s scale - lse), masked to 0, while dP^T runs: rows (keys)
      // g and g + 8 of the warp's 16, columns (queries) 8j + 2t4 + {0, 1}
      const float* lv = reinterpret_cast<const float*>(sp + L::vals(st[0]));
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t4 + (e & 1);
          s[4 * j + e] = hidden(kwarp + g + 8 * (e >> 1), q0 + qi, window, s_len)
                             ? 0.f
                             : expf(fmaf(s[4 * j + e], scale, -lv[qi]));
        }
      }
      // dS^T = P^T (dP^T - delta)
      wgmma_wait<0>();
      pin(dp);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - lv[BQ + 8 * j + 2 * t4 + (e & 1)]);
        }
      }
    }
    if (lane == 0) {
      mbar_arrive(base + L::empty(st[0]));
      mbar_arrive(base + L::empty(st[1]));
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries: P^T and dS^T
    // split as A operands, B from the K-major copies
    mbar_wait(base + L::ready(st[2]), ((u + 2) / NS) & 1);
    mbar_wait(base + L::ready(st[3]), ((u + 3) / NS) & 1);
    if (vis) {
      const uint32_t dot = base + L::slot(st[2]), qt = base + L::slot(st[3]);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) split_a(fh[j], fl[j], s, j);
      rs_tile<D, dkdv_cols<D>(), BQ / 8>(dva, fh, fl, dot, dot + L::TILE, one);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) split_a(fh[j], fl[j], dp, j);
      rs_tile<D, dkdv_cols<D>(), BQ / 8>(dka, fh, fl, qt, qt + L::TILE, one);
    }
    if (lane == 0) {
      mbar_arrive(base + L::empty(st[2]));
      mbar_arrive(base + L::empty(st[3]));
    }
  }

  // rows (keys) g and g + 8 of the warp's 16, columns 8n + 2t4 + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kwarp + g + 8 * r;
    if (key >= s_len) continue;
    const int64_t off = (rows + key) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dka[4 * n + 2 * r] * scale, dka[4 * n + 2 * r + 1] * scale);
    }
  }
}

// dQ.  Slot uses per key tile, in order: K (rows), V (rows), K (K-major
// copy).
template <int D>
__global__ void __launch_bounds__(128 * (bwd_groups<D>() + 1), 1)
    flash_bwd_dq_f32(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_kt,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int s_len, int window, float scale) {
  static_assert(D % kBoxF == 0, "whole TMA boxes");
  constexpr int G = bwd_groups<D>(), OWN = 64 * G, BK = kOther;
  using L = DqRing<D>;
  constexpr int NS = L::NS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sp = smem_raw;
  const uint32_t base = smem_base(sp);

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;  // late queries first
  // key tiles at or below the frontier that the window leaves visible
  const int q_last = min(q0 + OWN, s_len) - 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int uses = 3 * (q_last / BK + 1 - kt_begin);
  const int64_t rows = (int64_t)head * s_len;

  if (threadIdx.x == 0) L::init(base, 4 * G);
  __syncthreads();

  if (threadIdx.x >= 128 * G) {
    regs_producer<G>();
    const int pt = threadIdx.x - 128 * G;
    if (pt == 0) {  // TMA: Q and dO once, then each key tile's three operands
      mbar_arrive_tx(base + L::own_full(), 2 * L::OWN_T);
      tma_rows_f32<D, OWN>(base + L::own(0), &tm_q, base + L::own_full(), q0, head);
      tma_rows_f32<D, OWN>(base + L::own(1), &tm_do, base + L::own_full(), q0, head);
      for (int u = 0; u < uses; ++u) {
        const int st = u % NS;
        const uint32_t full = base + L::full(st), dst = base + L::slot(st);
        const int k0 = (kt_begin + u / 3) * BK;
        mbar_wait(base + L::empty(st), ((u / NS) & 1) ^ 1);
        mbar_arrive_tx(full, L::TILE);
        switch (u % 3) {
          case 0: tma_rows_f32<D, BK>(dst, &tm_k, full, k0, head); break;
          case 1: tma_rows_f32<D, BK>(dst, &tm_v, full, k0, head); break;
          default: tma_cols_f32<D, BK>(dst, &tm_kt, full, k0, head);
        }
      }
    } else if (pt >= 32) {  // split each tile that lands
      const int i = pt - 32;
      mbar_wait(base + L::own_full(), 0);
      split_tile(sp + L::own(0), OWN * D, i);
      split_tile(sp + L::own(1), OWN * D, i);
      fence_proxy_async();
      mbar_arrive(base + L::own_ready());
      for (int u = 0; u < uses; ++u) {
        const int st = u % NS;
        mbar_wait(base + L::full(st), (u / NS) & 1);
        split_tile(sp + L::slot(st), BK * D, i);
        fence_proxy_async();
        mbar_arrive(base + L::ready(st));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries qw0 .. qw0 + 63, its warp 16 of them
  regs_consumer<G>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int qwarp = qw0 + 16 * warp;
  const uint32_t qh = base + L::own(0), ql = qh + L::OWN_T;
  const uint32_t oh = base + L::own(1), ol = oh + L::OWN_T;
  // rows g and g + 8: lse and delta (0 past S: not stored)
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qwarp + g + 8 * r;
    lse_r[r] = row < s_len ? lse[rows + row] : 0.f;
    del_r[r] = row < s_len ? delta[rows + row] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dqa[n] = 0.f;
  mbar_wait(base + L::own_ready(), 0);

  const float one[2] = {1.f, 1.f};
  for (int u = 0; u < uses; u += 3) {
    const int k0 = (kt_begin + u / 3) * BK;
    const int s0 = u % NS, s1 = (u + 1) % NS, s2 = (u + 2) % NS;
    // a query of the warpgroup sees a key of the tile
    const bool vis = qw0 < s_len && k0 <= qw0 + 63 &&
                     !(window > 0 && k0 + BK - 1 <= qw0 - window);
    float s[BK / 2], dp[BK / 2];
    uint32_t dh[BK / 8][4], dl[BK / 8][4];

    // S = Q K^T and dP = dO V^T as split TF32
    mbar_wait(base + L::ready(s0), (u / NS) & 1);
    mbar_wait(base + L::ready(s1), ((u + 1) / NS) & 1);
    if (vis) {
      const uint32_t ks = base + L::slot(s0), vs = base + L::slot(s1);
      split_scores<OWN, BK, D / 8>(s, qh, ql, 64 * wg, ks, ks + L::TILE);
      wgmma_fence();
      split_ss<OWN, BK, D / 8>(dp, oh, ol, 64 * wg, vs, vs + L::TILE);
      wgmma_commit();

      // P in place of S while dP runs: rows (queries) g and g + 8, columns
      // (keys) 8j + 2t4 + {0, 1}; keys past S lie past every real query, so
      // the causal test masks them
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[4 * j + e] = hidden(k0 + 8 * j + 2 * t4 + (e & 1), qwarp + g + 8 * r, window,
                                s_len)
                             ? 0.f
                             : expf(fmaf(s[4 * j + e], scale, -lse_r[r]));
        }
      }
      // dS = P (dP - delta), split as the A operand of dQ += dS K
      wgmma_wait<0>();
      pin(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - del_r[e >> 1]);
        }
        split_a(dh[j], dl[j], dp, j);
      }
    }
    if (lane == 0) {
      mbar_arrive(base + L::empty(s0));
      mbar_arrive(base + L::empty(s1));
    }

    mbar_wait(base + L::ready(s2), ((u + 2) / NS) & 1);
    if (vis) {
      const uint32_t kt = base + L::slot(s2);
      rs_tile<D, D, BK / 8>(dqa, dh, dl, kt, kt + L::TILE, one);
    }
    if (lane == 0) mbar_arrive(base + L::empty(s2));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qwarp + g + 8 * r;
    if (row >= s_len) continue;
    float* out = dq + (rows + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(dqa[4 * n + 2 * r] * scale, dqa[4 * n + 2 * r + 1] * scale);
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
                       int s, int window, float scale, float* qt, cudaStream_t stream) {
  constexpr int OWN = 64 * bwd_groups<D>(), B = kOther;
  constexpr size_t smem_kv = DkdvRing<D>::bytes, smem_q = DqRing<D>::bytes;
  const size_t copy = static_cast<size_t>(bh) * D * round8(s);  // floats a copy
  cudaError_t e = allow_smem(flash_bwd_dkdv_f32<D>, smem_kv);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_f32<D>, smem_q);
  if (e == cudaSuccess) e = launch_delta<float, D>(o, dout, delta, (int64_t)bh * s, stream);
  if (e != cudaSuccess) return e;
  // the K-major copies of Q, dO and K
  float* dot = qt + copy;
  float* kt = dot + copy;
  e = launch_kmajor(q, qt, bh, s, D, stream);
  if (e == cudaSuccess) e = launch_kmajor(dout, dot, bh, s, D, stream);
  if (e == cudaSuccess) e = launch_kmajor(k, kt, bh, s, D, stream);
  // each tensor with boxes of a CTA's own rows and of the staged tiles'
  const void* x[4] = {q, k, v, dout};
  CUtensorMap own[4], tile[4], cols[3];
  for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
    e = rows_map_f32(&own[i], x[i], bh, s, D, OWN);
    if (e == cudaSuccess) e = rows_map_f32(&tile[i], x[i], bh, s, D, B);
  }
  if (e == cudaSuccess) e = cols_map_f32(&cols[0], qt, bh, s, D);
  if (e == cudaSuccess) e = cols_map_f32(&cols[1], dot, bh, s, D);
  if (e == cudaSuccess) e = cols_map_f32(&cols[2], kt, bh, s, D);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((s + OWN - 1) / OWN));
  constexpr int threads = 128 * (bwd_groups<D>() + 1);
  if (e == cudaSuccess) {
    flash_bwd_dkdv_f32<D><<<grid, threads, smem_kv, stream>>>(
        tile[0], own[1], own[2], tile[3], cols[0], cols[1], lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), s, window, scale);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    flash_bwd_dq_f32<D><<<grid, threads, smem_q, stream>>>(
        own[0], own[3], tile[1], tile[2], cols[2], lse, delta, static_cast<float*>(dq),
        s, window, scale);
    e = cudaGetLastError();
  }
  return e;
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
    e = tensor_map(&own[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x[i], bh, s, D, kRows);
    if (e == cudaSuccess) {
      e = tensor_map(&tile[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x[i], bh, s, D, B);
    }
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
           float* kmajor, cudaStream_t st) {
  return static_cast<int>(
      bf16 ? launch_bf16<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, s,
                            window, scale, st)
           : launch_f32<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, s,
                           window, scale, kmajor, st));
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

// Dynamic shared memory in bytes of the float32 dK/dV (dq_pass 0) or dQ
// (dq_pass 1) kernel at head dim d; -1 for another head dim.
extern "C" int flash_attention_bwd_f32_smem(int d, int dq_pass) {
  switch (d) {
    case 32: return static_cast<int>(dq_pass ? DqRing<32>::bytes : DkdvRing<32>::bytes);
    case 64: return static_cast<int>(dq_pass ? DqRing<64>::bytes : DkdvRing<64>::bytes);
    case 96: return static_cast<int>(dq_pass ? DqRing<96>::bytes : DkdvRing<96>::bytes);
    case 128: return static_cast<int>(dq_pass ? DqRing<128>::bytes : DkdvRing<128>::bytes);
    default: return -1;
  }
}

// Launches one backward pass on ``stream``: the delta pass, then dK/dV,
// then dQ.  Device pointers q, k, v, do (the output's gradient) and dq,
// dk, dv [bh, s, d], contiguous, 16-byte aligned, float32 (bf16 = 0) or
// bf16 (bf16 = 1); o [bh, s, d] float32 and lse [bh, s] float32 (natural
// log) as the forward wrote them; delta_scratch [bh, s] float32, overwritten; d 32, 64, 96 or 128;
// bh at most 65535; window 0 means none, else keys with kpos <= qpos -
// window are masked; scale is the forward's (1/sqrt(d)); kmajor, float32
// only, scratch of 3 * bh * d * round8(s) floats, 16-byte aligned, for the
// K-major copies of Q, dO and K (null with bf16).  Returns the cudaError_t
// of the first launch that failed (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv,
                                          void* delta_scratch, int bh, int s,
                                          int d, int window, float scale,
                                          int bf16, void* kmajor, void* stream) {
  if (bh < 0 || bh > 65535 || s < 0 || window < 0 ||
      (d != 32 && d != 64 && d != 96 && d != 128) || !q || !k || !v || !o ||
      !dout || !lse || !dq || !dk || !dv || !delta_scratch || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv) ||
      (!bf16 && (!kmajor || !aligned16(kmajor)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta_scratch);
  float* km = static_cast<float*>(kmajor);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, km, st);
    case 64: return launch<64>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, km, st);
    case 96: return launch<96>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, km, st);
    default: return launch<128>(q, k, v, o, dout, l, dq, dk, dv, dl, bh, s, window, scale, bf16, km, st);
  }
}
