// Causal flash-attention forward for Hopper (sm_90a), blocked online
// softmax with an optional sliding window.
//
// Replaces the TPU kernel ``flash_attention`` of the reference package
// (src/repro/kernels/flash_attn/flash_attn.py, ``_kernel``), the kernel
// behind its ``mha_flash``: q, k, v ``[BH, S, D]`` (float32 or bf16) ->
// o ``[BH, S, D]`` in q's dtype, scale 1/sqrt(D), masked scores -1e30,
// o = acc / max(l, 1e-30).  The S x S scores never reach device memory.
// Under autograd it also writes each query's log-sum-exp, lse = m + log(l)
// in natural log of the scaled scores (float32 ``[BH, S]``), from which the
// backward kernel (flash_attn_bwd.cu) recomputes P, and writes o in
// float32 also from bf16 inputs: the backward's delta = rowsum(dO o) cancels
// against rowsum(P dP), so o rounded to bf16 would move dq and dk by more
// than the backward's own roundings (tests/test_torch_flash_backward.py::
// test_bwd_bf16_needs_float32_o).
// Prefill passes no lse pointer and takes o in its input type.
//
// Bound on this card: operations.  4 * D flops per unmasked (q, k) pair
// against 4 * D * 2-4 bytes per row of q, k, v and o: in bf16 the 989
// TFLOP/s of the tensor cores; in float32 three TF32 products per product
// (the split below), 12 * D flops at the tensor cores' 495 TFLOP/s, a
// third of the time that 4 * D flops take at the CUDA cores' 67 TFLOP/s.
// There are two kernels, one per input type.
//
// bf16: the tensor cores, FlashAttention-2 style (flash_attention_bf16).
//   * A CTA of 4 warps owns 64 query rows, 16 a warp: one m16 tile; three
//     CTAs share an SM (70 KB of shared memory and at most 168 registers a
//     thread each).  64-key K and V tiles are staged in bf16 in shared
//     memory, two stages: cp.async.cg 16-byte copies bring tile i + 1 while
//     tile i is computed, rows past S zero-filled (src-size 0).  Shared rows
//     are padded by 8 bf16, so the 8 row addresses of an ldmatrix phase fall
//     on distinct banks.  The Q tile is staged once in stage 1's space and
//     read into registers as mma A fragments (ldmatrix.x4) before stage 1 is
//     loaded.
//   * S = Q K^T by mma.sync.m16n8k16 (bf16 in, float32 accumulate), the B
//     fragments from row-major K by ldmatrix.x4.  The scale, with log2(e)
//     folded in for ex2, is applied in float32 to the accumulators, never to
//     q before rounding: on a tile that crosses the diagonal, the window's
//     edge or S, to every score before the element-wise mask; on an interior
//     tile (nothing masked) to the row max and, in the exponent's FMA, to
//     each score.
//   * Online softmax in registers: row max and sum over the C fragment and
//     two __shfl_xor_sync within each quad.
//   * O += P V: P is rounded to bf16 in registers, where the C fragment of
//     S is already laid out as the A fragment of the next product, so P never
//     touches shared memory; V's B fragments come from row-major V by
//     ldmatrix.x4.trans.  l is summed from the float32 P.  Rounding P adds at
//     most 2^-8 * (A |V|) to an output, A the exact softmax (the limit
//     ``attention_limit`` in ref.py states).
// float32: split TF32 on wgmma, fed by TMA (flash_attention_f32;
//   split_tf32.cuh).  One TF32 product (10 mantissa bits) misses the
//   reference's 2e-5 many times over; each operand split as x = hi + lo,
//   hi = tf32(x), lo = x - hi, and each product run as hi hi + hi lo + lo hi
//   (three wgmma TF32 products into one float32 accumulator) is within
//   about 2^-21 of the float32 product, inside ``attention_limit`` with 12x
//   of margin on unit-variance draws (``ref.attention_split_tf32``
//   emulates it; one TF32 product, ``ref.attention_tf32``, exceeds the
//   limit 20x or more).
//   * A CTA of 384 threads owns 128 query rows: two consumer warpgroups of
//     64 rows and a producer warpgroup (setmaxnreg: 40 registers against
//     232).  Its warp 0 loads Q once and then, for each key tile, K (rows)
//     and V (a K-major copy [bh, d, s8] written by ``kmajor_copy`` before
//     the launch: TF32 wgmma reads shared operands K-major only) by TMA
//     into a ring of 2-4 slots (full / empty mbarriers; 3D [bh, s, d] maps,
//     so rows past S read zeros of their own head); its warps 1-3 split each
//     tile that lands, hi rounded in place and lo beside it (ready
//     mbarriers).  Q, K and V take 8 bytes an element as hi and lo, so key
//     tiles are 64 keys at D <= 64 and 32 above (128 KB of Q at D = 128).
//   * S = Q K^T with both operands in shared memory, its hi hi terms
//     summed in chunks of 32 columns of D on the CUDA cores (split_scores:
//     the tensor cores' float32 accumulation truncates, and an error of a
//     score is a relative error of its P); the scale is applied to the
//     float32 scores, the mask element by element, the online softmax in
//     float32 with expf and the row max and sum over each quad.
//   * O = alpha O + P V: P, split in registers, is the A operand as the
//     accumulator holds it (V's copy permutes its keys to match); each
//     tile's product goes into a fresh accumulator, 32 columns at a time,
//     and is added to O on the CUDA cores, since the tensor cores' float32
//     accumulation truncates and over all of S would drift past the limit.
//
// Both kernels launch heavy tiles (late queries, most keys) first and skip
// tiles entirely outside the window, as the TPU kernel skips its blocks.  A
// row whose first visited tile is fully masked computes exp(-1e30 - -1e30)
// = 1 there; the next real score wipes that out through alpha = exp(m -
// m_new) = 0, as on the TPU.  (-INFINITY would give NaN.)  Every row visits
// the tile of its own diagonal, so its final m is a real score's and the
// stored lse is exact.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_tf32.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, float32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kTileK = 64;    // keys per staged K / V tile
constexpr int kPadH = 8;      // bf16 of padding per shared row (16 bytes)
constexpr int kWarps = 4;     // warps per CTA, 16 query rows each
constexpr float kLn2 = 0.6931471805599453f;

// max / sum over the 4 threads of a quad (the threads that share a row of
// an mma fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr size_t smem_bytes_bf16() {
  // two stages of (K tile, V tile); the Q tile borrows stage 1 at the start
  return sizeof(__nv_bfloat16) * 2 * 2 * kTileK * (D + kPadH);
}

// three CTAs an SM: 168 registers a thread at most; o in bf16 or float32
template <int D, typename Out>
__global__ void __launch_bounds__(32 * kWarps, 3)
    flash_attention_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         Out* __restrict__ o,
                         float* __restrict__ lse, int s_len, int window,
                         float scale_log2) {
  static_assert(D % 16 == 0, "k-steps of 16 and pairs of 8-column n-tiles");
  constexpr int BQ = 16 * kWarps;  // query rows per CTA
  constexpr int T = 32 * kWarps;
  constexpr int LD = D + kPadH;    // bf16 per shared row
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NT = kTileK / 8;   // 8-key n-tiles of S
  constexpr int DT = D / 8;        // 8-column n-tiles of O
  constexpr int STAGE = 2 * kTileK * LD;  // bf16 per stage: K tile, V tile
  static_assert(BQ <= 2 * kTileK, "the Q tile must fit in one stage");
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* qs = smem + STAGE;  // [BQ][LD], stage 1 until tile 2 lands

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t head = (int64_t)blockIdx.y * s_len * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int qw = q0 + 16 * warp;           // the warp's first query row

  // rows [row0, row0 + nrows) of x into shared rows of ``dst``, async
  auto stage_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* x, int row0,
                        int nrows) {
    for (int e = tid; e < nrows * CH; e += T) {
      const int r = e / CH, c = (e % CH) * 8;
      const int row = row0 + r;
      const bool in = row < s_len;
      cp_async16(smem_addr(dst + r * LD + c),
                 x + head + (int64_t)(in ? row : 0) * D + c, in ? 16 : 0);
    }
  };
  auto stage_tile = [&](int kt, int st) {
    stage_rows(smem + st * STAGE, k, kt * kTileK, kTileK);
    stage_rows(smem + st * STAGE + kTileK * LD, v, kt * kTileK, kTileK);
  };

  // tiles at or below the frontier that the window leaves visible
  const int q_last = min(q0 + BQ, s_len) - 1;
  const int kt_end = q_last / kTileK + 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kTileK : 0;

  stage_rows(qs, q, q0, BQ);
  stage_tile(kt_begin, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // Q as A fragments: rows lane & 15, columns (lane >> 4) * 8 of each k-step
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], smem_addr(qs + (16 * warp + (lane & 15)) * LD +
                                  kk * 16 + (lane >> 4) * 8));
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMasked, kMasked};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's columns only

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait_all();  // tile kt has landed
    __syncthreads();      // ... for every thread; stage st ^ 1 (and Q) is free
    if (kt + 1 < kt_end) stage_tile(kt + 1, st ^ 1);
    cp_async_commit();
    const int k0 = kt * kTileK;
    // none of the warp's 16 rows sees a key of this tile
    if (k0 > qw + 15 || (window > 0 && k0 + kTileK - 1 <= qw - window)) continue;
    const __nv_bfloat16* ks = smem + st * STAGE;
    const __nv_bfloat16* vs = ks + kTileK * LD;

    // S = Q K^T: per k-step, K's B fragments for 16 keys by one ldmatrix.x4
    // (matrices: keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7,
    // keys 8-15 | d 8-15)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax in log2 units.  A tile that crosses the diagonal, the
    // window's edge or S is scaled and masked element by element; an
    // interior tile has no masked score, so its scale rides the exponent's
    // FMA and only its row max is scaled
    const bool edge = k0 + kTileK - 1 > qw ||
                      (window > 0 && k0 <= qw + 15 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = qw + g + 8 * (e >> 1);
          const bool masked = kpos > qpos || (window > 0 && kpos <= qpos - window);
          s[j][e] = masked ? kMasked : s[j][e] * scale_log2;
        }
      }
    }
    const float sc = edge ? 1.f : scale_log2;  // what scores still need
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(m[r], quad_max(mx[r]) * sc);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    // P in bf16 as A fragments, one per 16-key k-step: n-tile 2kk gives
    // a0 (row g) and a1 (row g + 8), n-tile 2kk + 1 gives a2 and a3
    uint32_t pf[NT / 2][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = ex2(fmaf(s[j][0], sc, -mx[0]));
      const float p1 = ex2(fmaf(s[j][1], sc, -mx[0]));
      const float p2 = ex2(fmaf(s[j][2], sc, -mx[1]));
      const float p3 = ex2(fmaf(s[j][3], sc, -mx[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = bf16_pair(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = bf16_pair(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: per 16-key k-step, V's B fragments for 16 columns by one
    // ldmatrix.x4.trans (matrices: keys 0-7 | d 0-7, keys 8-15 | d 0-7,
    // keys 0-7 | d 8-15, keys 8-15 | d 8-15)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                       dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30), rows g and g + 8, columns 8n + 2t4 + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= s_len) continue;
    // m is in log2 units of the scaled scores: natural log is (m + log2 l) ln 2
    if (lse != nullptr && t4 == 0) {
      lse[(int64_t)blockIdx.y * s_len + row] = (m[r] + log2f(den)) * kLn2;
    }
    Out* out = o + head + (int64_t)row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      if constexpr (std::is_same_v<Out, float>) {
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
      } else {
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            bf16_pair(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on wgmma, fed by TMA (split_tf32.cuh)
// ---------------------------------------------------------------------------

constexpr int kFwdGroups = 2;                       // consumer warpgroups
constexpr int kFwdRows = 64 * kFwdGroups;           // query rows of a CTA
constexpr int kFwdThreads = 128 * (kFwdGroups + 1);  // and a producer warpgroup

// keys of a staged K (or V) tile: what the registers (168 a thread with
// two consumer warpgroups) and, at D = 128, shared memory (128 query rows
// take 128 KB as hi and lo) allow
template <int D>
__host__ __device__ constexpr int fwd_keys() { return D <= 64 ? 64 : 32; }
// columns of O per product (rs_tile): wider ones spill at D = 96 and 128
constexpr int kFwdCols = 32;

template <int D>
using FwdRing = Ring<1, kFwdRows, D, fwd_keys<D>(), false>;

// Slot uses, in order: K of key tile kt (rows), then V of it (K-major copy).
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_attention_f32(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_vt,
                        float* __restrict__ o, float* __restrict__ lse, int s_len,
                        int window, float scale) {
  static_assert(D % kBoxF == 0, "whole TMA boxes");
  using L = FwdRing<D>;
  constexpr int BK = fwd_keys<D>();
  constexpr int NS = L::NS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sp = smem_raw;
  const uint32_t base = smem_base(sp);

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;  // late queries first
  // key tiles at or below the frontier that the window leaves visible
  const int q_last = min(q0 + kFwdRows, s_len) - 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int uses = 2 * (q_last / BK + 1 - kt_begin);

  if (threadIdx.x == 0) L::init(base, 4 * kFwdGroups);
  __syncthreads();

  if (threadIdx.x >= 128 * kFwdGroups) {
    regs_producer<kFwdGroups>();
    const int pt = threadIdx.x - 128 * kFwdGroups;
    if (pt == 0) {  // TMA: Q once, then K and V of each key tile
      mbar_arrive_tx(base + L::own_full(), L::OWN_T);
      tma_rows_f32<D, kFwdRows>(base + L::own(0), &tm_q, base + L::own_full(), q0, head);
      for (int u = 0; u < uses; ++u) {
        const int st = u % NS;
        const uint32_t full = base + L::full(st);
        const int k0 = (kt_begin + u / 2) * BK;
        mbar_wait(base + L::empty(st), ((u / NS) & 1) ^ 1);
        mbar_arrive_tx(full, L::TILE);
        if (u % 2 == 0) {
          tma_rows_f32<D, BK>(base + L::slot(st), &tm_k, full, k0, head);
        } else {
          tma_cols_f32<D, BK>(base + L::slot(st), &tm_vt, full, k0, head);
        }
      }
    } else if (pt >= 32) {  // split each tile that lands
      const int i = pt - 32;
      mbar_wait(base + L::own_full(), 0);
      split_tile(sp + L::own(0), kFwdRows * D, i);
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
  regs_consumer<kFwdGroups>();
  // the warpgroup, known to be warp-uniform: its descriptors live in
  // uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int qwarp = qw0 + 16 * warp;
  const uint32_t qh = base + L::own(0), ql = qh + L::OWN_T;
  float acc[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  float m[2] = {kMasked, kMasked};  // rows g and g + 8, natural log units
  float l[2] = {0.f, 0.f};          // this thread's columns only
  mbar_wait(base + L::own_ready(), 0);

  for (int u = 0; u < uses; u += 2) {
    const int k0 = (kt_begin + u / 2) * BK;
    const int sk = u % NS, sv = (u + 1) % NS;
    // a query of the warpgroup sees a key of the tile
    const bool vis = qw0 < s_len && k0 <= qw0 + 63 &&
                     !(window > 0 && k0 + BK - 1 <= qw0 - window);
    float s[BK / 2], alpha[2];
    uint32_t ph[BK / 8][4], pl[BK / 8][4];

    // S = Q K^T as split TF32
    mbar_wait(base + L::ready(sk), (u / NS) & 1);
    if (vis) {
      const uint32_t kh = base + L::slot(sk);
      split_scores<kFwdRows, BK, D / 8>(s, qh, ql, 64 * wg, kh, kh + L::TILE);
    }
    if (lane == 0) mbar_arrive(base + L::empty(sk));

    // scaled, masked scores and the online softmax in float32: rows g and
    // g + 8 of the warp's 16, columns 8j + 2t4 + {0, 1}
    if (vis) {
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = qwarp + g + 8 * (e >> 1);
          const bool masked = kpos > qpos || (window > 0 && kpos <= qpos - window);
          s[4 * j + e] = masked ? kMasked : s[4 * j + e] * scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[4 * j + e] - mx[e >> 1]);
          rs[e >> 1] += p;
          s[4 * j + e] = p;
        }
        split_a(ph[j], pl[j], s, j);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    }

    // O = alpha O + P V: P from registers, V's K-major copy from shared
    // memory
    mbar_wait(base + L::ready(sv), ((u + 1) / NS) & 1);
    if (vis) {
      const uint32_t vh = base + L::slot(sv);
      rs_tile<D, kFwdCols, BK / 8>(acc, ph, pl, vh, vh + L::TILE, alpha);
    }
    if (lane == 0) mbar_arrive(base + L::empty(sv));
  }

  // o = acc / max(l, 1e-30), rows g and g + 8, columns 8n + 2t4 + {0, 1}
  const int64_t rows = (int64_t)head * s_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qwarp + g + 8 * r;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= s_len) continue;
    // m is the natural-log max of the scaled scores
    if (lse != nullptr && t4 == 0) lse[rows + row] = m[r] + logf(den);
    float* out = o + (rows + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[4 * n + 2 * r] / den, acc[4 * n + 2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               int bh, int s, int window, float scale, float* vtf, cudaStream_t stream) {
  using L = FwdRing<D>;
  constexpr int BK = fwd_keys<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_f32<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap mq, mk, mvt;
  e = launch_kmajor(v, vtf, bh, s, D, stream);
  if (e == cudaSuccess) e = rows_map_f32(&mq, q, bh, s, D, kFwdRows);
  if (e == cudaSuccess) e = rows_map_f32(&mk, k, bh, s, D, BK);
  if (e == cudaSuccess) e = cols_map_f32(&mvt, vtf, bh, s, D);
  if (e == cudaSuccess) {
    const dim3 grid(static_cast<unsigned>(bh),
                    static_cast<unsigned>((s + kFwdRows - 1) / kFwdRows));
    flash_attention_f32<D><<<grid, kFwdThreads, L::bytes, stream>>>(
        mq, mk, mvt, static_cast<float*>(o), lse, s, window, scale);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

template <int D, typename Out>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int s, int window, float scale,
                cudaStream_t stream) {
  auto kern = flash_attention_bf16<D, Out>;
  constexpr size_t smem = smem_bytes_bf16<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int BQ = 16 * kWarps;
  const dim3 grid(static_cast<unsigned>((s + BQ - 1) / BQ),
                  static_cast<unsigned>(bh));
  kern<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<Out*>(o), lse, s, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int s, int window, float scale, int bf16, int o_f32,
           float* kmajor, cudaStream_t stream) {
  if (!bf16) return launch_f32<D>(q, k, v, o, lse, bh, s, window, scale, kmajor, stream);
  return o_f32 ? launch_bf16<D, float>(q, k, v, o, lse, bh, s, window, scale, stream)
               : launch_bf16<D, __nv_bfloat16>(q, k, v, o, lse, bh, s, window,
                                               scale, stream);
}

}  // namespace

// Launches one forward pass on ``stream``.  Device pointers q, k, v, o
// [bh, s, d], contiguous, 16-byte aligned, float32 (bf16 = 0) or bf16
// (bf16 = 1); o in the inputs' type, or float32 with o_f32 = 1; d is 32,
// 64, 96 or 128 (the head dims of the repo's configurations: 32 in every
// smoke configuration, 96 in phi-3-vision-4.2b); lse float32 [bh, s] or
// null (not written); bh at most 65535; window 0 means none, else keys
// with kpos <= qpos - window are masked; kmajor, float32 only, scratch of
// bh * d * round8(s) floats, 16-byte aligned, for V's K-major copy (null
// with bf16).  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh, int s, int d, int window,
                                      float scale, int bf16, int o_f32,
                                      void* kmajor, void* stream) {
  if (bh < 0 || bh > 65535 || s < 0 || window < 0 ||
      (d != 32 && d != 64 && d != 96 && d != 128) || !q || !k || !v || !o ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (!bf16 && (!kmajor || !aligned16(kmajor)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* km = static_cast<float*>(kmajor);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, l, bh, s, window, scale, bf16, o_f32, km, st);
    case 64: return launch<64>(q, k, v, o, l, bh, s, window, scale, bf16, o_f32, km, st);
    case 96: return launch<96>(q, k, v, o, l, bh, s, window, scale, bf16, o_f32, km, st);
    default: return launch<128>(q, k, v, o, l, bh, s, window, scale, bf16, o_f32, km, st);
  }
}

// Dynamic shared memory in bytes of the float32 kernel at head dim d; -1
// for another head dim.
extern "C" int flash_attention_f32_smem(int d) {
  switch (d) {
    case 32: return static_cast<int>(FwdRing<32>::bytes);
    case 64: return static_cast<int>(FwdRing<64>::bytes);
    case 96: return static_cast<int>(FwdRing<96>::bytes);
    case 128: return static_cast<int>(FwdRing<128>::bytes);
    default: return -1;
  }
}
