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
// TFLOP/s of the tensor cores, which only wgmma reaches; in float32 three
// TF32 products per product (the split below), 12 * D flops at the tensor
// cores' 495 TFLOP/s, a third of the time that 4 * D flops take at the
// CUDA cores' 67 TFLOP/s.  At head dims of 64 and less the exponentials
// weigh as much as the products: one ex2 a pair at 16 a clock on each SM's
// special-function units is about 4 * 64 flops of tensor-core time.
// There are two kernels, one per input type.  Both put 128 query rows in
// a CTA of 384 threads: two consumer warpgroups of 64 rows and a producer
// warpgroup that keeps the operands coming by TMA (setmaxnreg: 40
// registers against 232).
//
// bf16: wgmma fed by TMA, FlashAttention-3 style (flash_attention_bf16).
//   * One producer thread loads the CTA's Q once and then streams K and V
//     tiles through a ring of three stages, each tile behind its own full
//     and empty mbarriers, so a K slot frees as soon as its scores are taken
//     and a V slot when its P V is done.  Tiles are 128 keys, 64 above D =
//     64: ptxas gives a consumer thread about 168 registers whatever
//     setmaxnreg asks, and S at 128 keys beside O and P would spill and
//     serialize the wgmma.  Tensor maps are 3D [bh, s, d] with boxes of 32
//     columns (64-byte swizzle), so rows past S read zeros of their own
//     head.
//   * S = Q K^T as wgmma with both operands in shared memory, read K-major
//     as they lie.  The scale, with log2(e) folded in for ex2, is applied in
//     float32 to the accumulators, never to q before rounding: on a tile that
//     crosses a warp's diagonal, the window's edge or S, to every score
//     before the element-wise mask; on an interior tile (nothing masked) to
//     the row max and, in the exponent's FMA, to each score.  The online
//     softmax runs in registers, the row max and sum over each quad.
//   * O = alpha O + P V: P is rounded to bf16 in registers, where the
//     accumulator of S is already laid out as the A operand of the next
//     product, so P never touches shared memory; V is read MN-major as it
//     lies.  l is summed from the float32 P.  Rounding P adds at most 2^-8
//     * (A |V|) to an output, A the exact softmax (``attention_limit`` in
//     ref.py).  O stays in registers across all key tiles.
//   * Overlap: the two consumer warpgroups take turns at the tensor cores
//     (two named barriers), each turn issuing S of this tile and P V of the
//     last, so one warpgroup's softmax runs while the other's products do,
//     and within a warpgroup the softmax of tile j runs while P V of tile
//     j - 1 is still in flight.  No wgmma sits behind a branch (ptxas
//     serializes them all if one does): both warpgroups take every tile of
//     the CTA, one that none of a warpgroup's queries sees is masked whole,
//     and the first turn's P V adds 0 x V.
//   * The epilogue divides by max(l, 1e-30) and stores 16 bytes a thread:
//     the quad's threads trade their column pairs by shuffles first.
// float32: split TF32 on wgmma, fed by TMA (flash_attention_f32;
//   split_tf32.cuh).  One TF32 product (10 mantissa bits) misses the
//   reference's 2e-5 many times over; each operand split as x = hi + lo,
//   hi = tf32(x), lo = x - hi, and each product run as hi hi + hi lo + lo hi
//   (three wgmma TF32 products into one float32 accumulator) is within
//   about 2^-21 of the float32 product, inside ``attention_limit`` with 12x
//   of margin on unit-variance draws (``ref.attention_split_tf32``
//   emulates it; one TF32 product, ``ref.attention_tf32``, exceeds the
//   limit 20x or more).
//   * The producer warpgroup's warp 0 loads Q once and then, for each key
//     tile, K (rows) and V (a K-major copy [bh, d, s8] written by
//     ``kmajor_copy`` before the launch: TF32 wgmma reads shared operands
//     K-major only) by TMA into a ring of 2-4 slots (full / empty
//     mbarriers); its warps 1-3 split each tile that lands, hi rounded in
//     place and lo beside it (ready mbarriers).  Q, K and V take 8 bytes an
//     element as hi and lo, so key tiles are 64 keys at D <= 64 and 32 above
//     (128 KB of Q at D = 128).
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
// stored lse is exact.  No atomics, and sums in a fixed order: reruns are
// equal bit for bit.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_tf32.cuh"

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kFwdGroups = 2;                        // consumer warpgroups
constexpr int kFwdRows = 64 * kFwdGroups;            // query rows of a CTA
constexpr int kFwdThreads = 128 * (kFwdGroups + 1);  // and a producer warpgroup

// max / sum over the 4 threads of a quad (the threads that share a row of
// an accumulator)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, the consumer warpgroups taking turns
// ---------------------------------------------------------------------------

constexpr int kStagesH = 3;  // stages of the ring
constexpr int kTurn = 1;     // named barrier kTurn + wg: warpgroup wg's turn

// keys of a staged K (or V) tile: 128, or 64 above D = 64, where S's
// accumulator at 128 keys (64 registers a thread) beside O's (D / 2) and P
// (32) would pass what ptxas gives a consumer thread; it then spills and
// serializes the wgmma
template <int D>
__host__ __device__ constexpr int keys_bf16() { return D <= 64 ? 128 : 64; }

// Shared memory of the bf16 forward, from a 1,024-byte boundary: the CTA's
// Q, kStagesH stages of a K tile and a V tile, then the barriers: Q's, and
// full and empty of each K and V slot.
template <int D>
struct FwdSmem {
  static constexpr int Q = kFwdRows * D * 2;             // bytes of the CTA's Q
  static constexpr int TILE = keys_bf16<D>() * D * 2;  // bytes of a K or V tile
  static constexpr int BARS = Q + 2 * kStagesH * TILE;
  static constexpr size_t bytes = BARS + 8 * (1 + 4 * kStagesH) + 1024;
  static_assert(bytes <= kSmemOptin, "Q and the ring must fit");
  // K (i = 0) or V (i = 1) of stage st
  __host__ __device__ static constexpr int slot(int st, int i) {
    return Q + (2 * st + i) * TILE;
  }
  __host__ __device__ static constexpr int q_full() { return BARS; }
  __host__ __device__ static constexpr int full(int st, int i) {
    return BARS + 8 * (1 + 2 * st + i);
  }
  __host__ __device__ static constexpr int empty(int st, int i) {
    return BARS + 8 * (1 + 2 * kStagesH + 2 * st + i);
  }
};

// x[i], this thread's two bf16 columns (2 t4, 2 t4 + 1) of n-tile 4c + i of
// a row, becomes the row's 8 columns of n-tile 4c + t4, the quad's pairs in
// order: a 4 x 4 transpose over the quad by two rounds of shuffles
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t4) {
  // lanes t4 ^ 1 trade: keep the n-tiles b and b + 2, b = bit 0 of t4
  const bool b = t4 & 1;
  const uint32_t k0 = b ? x[1] : x[0], k1 = b ? x[3] : x[2];
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b ? x[0] : x[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b ? x[2] : x[3], 1);
  // u[p][h]: n-tile b + 2 h from the quad thread of bit 0 p (and t4's bit 1)
  const uint32_t u00 = b ? r0 : k0, u10 = b ? k0 : r0;
  const uint32_t u01 = b ? r1 : k1, u11 = b ? k1 : r1;
  // lanes t4 ^ 2 trade: keep n-tile t4 (h = c, c = bit 1 of t4)
  const bool c = t4 & 2;
  const uint32_t keep0 = c ? u01 : u00, keep1 = c ? u11 : u10;
  const uint32_t g0 = __shfl_xor_sync(0xffffffffu, c ? u00 : u01, 2);
  const uint32_t g1 = __shfl_xor_sync(0xffffffffu, c ? u10 : u11, 2);
  x[0] = c ? g0 : keep0;
  x[1] = c ? g1 : keep1;
  x[2] = c ? keep0 : g0;
  x[3] = c ? keep1 : g1;
}

template <int D, typename Out>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_attention_bf16(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         Out* __restrict__ o, float* __restrict__ lse, int s_len,
                         int window, float scale_log2) {
  static_assert(D % kBox == 0 && D % 32 == 0, "whole TMA boxes and quad transposes");
  using L = FwdSmem<D>;
  constexpr int BK = keys_bf16<D>(), NS = kStagesH;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sp = smem_raw;
  const uint32_t base = smem_base(sp);

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;  // late queries first
  // key tiles at or below the frontier that the window leaves visible
  const int q_last = min(q0 + kFwdRows, s_len) - 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int tiles = q_last / BK + 1 - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(base + L::q_full(), 1);
    for (int st = 0; st < NS; ++st) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(base + L::full(st, i), 1);
        mbar_init(base + L::empty(st, i), 4 * kFwdGroups);  // each consumer warp
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kFwdGroups) {
    // producer: Q once, then K and V of each key tile into the ring
    regs_producer<kFwdGroups>();
    if (threadIdx.x != 128 * kFwdGroups) return;
    mbar_arrive_tx(base + L::q_full(), L::Q);
    tma_rows<D, kFwdRows>(base, &tm_q, base + L::q_full(), q0, head);
    for (int j = 0; j < tiles; ++j) {
      const int st = j % NS, k0 = (kt_begin + j) * BK;
      const uint32_t parity = ((j / NS) & 1) ^ 1;
      mbar_wait(base + L::empty(st, 0), parity);
      mbar_arrive_tx(base + L::full(st, 0), L::TILE);
      tma_rows<D, BK>(base + L::slot(st, 0), &tm_k, base + L::full(st, 0), k0, head);
      mbar_wait(base + L::empty(st, 1), parity);
      mbar_arrive_tx(base + L::full(st, 1), L::TILE);
      tma_rows<D, BK>(base + L::slot(st, 1), &tm_v, base + L::full(st, 1), k0, head);
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
  float acc[D / 2];  // O: rows g and g + 8, columns 8n + 2t4 + {0, 1}
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  float m[2] = {kMasked, kMasked};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's columns only
  float s[BK / 2];                  // S, then P, of the tile in hand
  uint32_t pa[BK / 16][4];          // P in bf16: the A of P V
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0;
  mbar_wait(base + L::q_full(), 0);
  if (wg == 0) bar_arrive(kTurn, 256);  // warpgroup 0 takes the first turn

  // Every wgmma is issued unconditionally (a branch around one makes ptxas
  // serialize them all): a tile that none of the warpgroup's queries sees
  // is masked like any other, and the first turn's P V multiplies tile 0's
  // V by P = 0.
  for (int j = 0; j < tiles; ++j) {
    const int st = j % NS;
    const int pj = j > 0 ? j - 1 : 0;  // the tile whose P V is owed
    const int k0 = (kt_begin + j) * BK;
    mbar_wait(base + L::full(st, 0), (j / NS) & 1);
    mbar_wait(base + L::full(pj % NS, 1), (pj / NS) & 1);

    // this warpgroup's turn at the tensor cores: S = Q K^T of this tile,
    // then O += P V of the last; then the other warpgroup's turn (whose
    // last turn nobody waits for)
    bar_sync(kTurn + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, desc_k<kFwdRows>(base, 64 * wg, kk),
               desc_k<BK>(base + L::slot(st, 0), 0, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_t(acc, pa[kk], desc_mn<BK>(base + L::slot(pj % NS, 1), kk));
    }
    wgmma_commit();
    if (wg == 0 || j + 1 < tiles) bar_arrive(kTurn + (wg ^ 1), 256);

    // online softmax in log2 units while P V runs: rows g and g + 8 of the
    // warp's 16, columns 8i + 2t4 + {0, 1}.  A tile that crosses the warp's
    // diagonal, the window's edge or S is scaled and masked element by
    // element; an interior tile has no masked score, so its scale rides the
    // exponent's FMA and only its row max is scaled
    wgmma_wait<1>();
    pin(s);
    if (lane == 0) mbar_arrive(base + L::empty(st, 0));  // K is read
    float alpha[2];
    const bool edge = k0 + BK - 1 > qwarp || (window > 0 && k0 <= qwarp + 15 - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * t4 + (e & 1);
          const int qpos = qwarp + g + 8 * (e >> 1);
          const bool masked = kpos > qpos || (window > 0 && kpos <= qpos - window);
          s[4 * i + e] = masked ? kMasked : s[4 * i + e] * scale_log2;
        }
      }
    }
    const float sc = edge ? 1.f : scale_log2;  // what scores still need
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(m[r], quad_max(mx[r]) * sc);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * i + e], sc, -mx[e >> 1]));
        rs[e >> 1] += p;
        s[4 * i + e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

    // the last tile's P V is done: rescale O and round this tile's P
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
    if (j > 0 && lane == 0) mbar_arrive(base + L::empty(pj % NS, 1));  // V is read
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a(pa, s, kk);
  }

  // P V of the last tile
  const int last = (tiles - 1) % NS;
  mbar_wait(base + L::full(last, 1), ((tiles - 1) / NS) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs_t(acc, pa[kk], desc_mn<BK>(base + L::slot(last, 1), kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  pin(pa);

  // o = acc / max(l, 1e-30), 16 bytes a thread: rows g and g + 8
  const int64_t rows = (int64_t)head * s_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qwarp + g + 8 * r;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    const bool in = row < s_len;
    // m is in log2 units of the scaled scores: natural log is (m + log2 l) ln 2
    if (lse != nullptr && t4 == 0 && in) lse[rows + row] = (m[r] + log2f(den)) * kLn2;
    Out* out = o + (rows + row) * D;
    if constexpr (std::is_same_v<Out, float>) {
      // n-tiles 2c and 2c + 1: a thread of even t4 takes columns 2t4 ..
      // 2t4 + 3 of the first, one of odd t4 columns 2t4 - 2 .. 2t4 + 1 of
      // the second, trading pairs with lane t4 ^ 1
      const bool odd = t4 & 1;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float a0 = acc[8 * c + 2 * r] / den, a1 = acc[8 * c + 2 * r + 1] / den;
        const float b0 = acc[8 * c + 4 + 2 * r] / den, b1 = acc[8 * c + 5 + 2 * r] / den;
        const float gx = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float gy = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        if (in) {
          *reinterpret_cast<float4*>(out + 8 * (2 * c + odd) + 2 * (t4 & 2)) =
              odd ? make_float4(gx, gy, b0, b1) : make_float4(a0, a1, gx, gy);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        uint32_t x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * c + i;
          x[i] = bf16_pair(acc[4 * n + 2 * r] / den, acc[4 * n + 2 * r + 1] / den);
        }
        quad_transpose(x, t4);
        if (in) {
          *reinterpret_cast<uint4*>(out + 8 * (4 * c + t4)) = make_uint4(x[0], x[1], x[2], x[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on wgmma, fed by TMA (split_tf32.cuh)
// ---------------------------------------------------------------------------

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
  constexpr size_t smem = FwdSmem<D>::bytes;
  const auto kern = flash_attention_bf16<D, Out>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  CUtensorMap mq, mk, mv;
  if (e == cudaSuccess) {
    e = tensor_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, bh, s, D, kFwdRows);
  }
  constexpr int BK = keys_bf16<D>();
  if (e == cudaSuccess) e = tensor_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, bh, s, D, BK);
  if (e == cudaSuccess) e = tensor_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, bh, s, D, BK);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + kFwdRows - 1) / kFwdRows));
  kern<<<grid, kFwdThreads, smem, stream>>>(mq, mk, mv, static_cast<Out*>(o), lse, s,
                                            window, scale * kLog2e);
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

// Dynamic shared memory in bytes of the bf16 kernel (either output type)
// at head dim d; -1 for another head dim.
extern "C" int flash_attention_bf16_smem(int d) {
  switch (d) {
    case 32: return static_cast<int>(FwdSmem<32>::bytes);
    case 64: return static_cast<int>(FwdSmem<64>::bytes);
    case 96: return static_cast<int>(FwdSmem<96>::bytes);
    case 128: return static_cast<int>(FwdSmem<128>::bytes);
    default: return -1;
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
