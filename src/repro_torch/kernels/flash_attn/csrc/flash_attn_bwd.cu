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
// the price of deterministic sums without atomics.
//
// bf16: the tensor cores (mma.sync.m16n8k16, float32 accumulators), as in
//   the forward.  A CTA of 4 warps owns 64 keys (dK/dV) or 64 queries (dQ),
//   16 a warp: one m16 tile.  The other side is staged in tiles of 64 rows
//   at D <= 64 and 32 at D = 96 / 128 (the dK/dV CTA holds two float32
//   accumulators of its 16 x D rows a warp: 128 registers at D = 128),
//   bf16 in shared memory, two stages by cp.async (rows past S
//   zero-filled), rows padded by 8 bf16 so ldmatrix phases fall on distinct
//   banks.  dK/dV computes S^T = K Q^T and dP^T = V dO^T (A fragments from
//   the warp's K and V rows by ldmatrix.x4, B from row-major Q and dO), so
//   P^T and dS^T come out of the accumulators already laid out as the A
//   fragments of dV += P^T dO and dK += dS^T Q, whose B fragments come from
//   row-major dO and Q by ldmatrix.x4.trans.  dQ keeps its Q and dO rows as
//   A fragments in registers; dS's accumulators are dQ += dS K's A
//   fragments (K by ldmatrix.x4.trans).  P and dS are rounded to bf16
//   before their products, as every tensor-core attention does
//   (``attention_bwd_bf16`` in ref.py emulates it; ``BWD_BF16_RMS_LIMIT``).
//   P = 2^(s * scale * log2(e) - lse * log2(e)) on ex2.approx.
// float32: the CUDA cores in true float32, so ``attention_bwd_limit``'s
//   2e-5 of the spread holds.  A CTA of 256 threads owns 32 keys (dK/dV) or
//   32 queries (dQ) and stages 32-row tiles of the other side in float32,
//   rows padded by 4 floats; thread (tr, tc) = (t / 16, t % 16) computes
//   the scores of its rows 2tr, 2tr + 1 against columns tc, tc + 16, writes
//   P and dS to shared memory, then accumulates columns tc + 16 c of its two
//   rows.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

// 4-byte global -> shared copy; ``bytes`` 0 zero-fills the destination
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // keys (dK/dV) or queries (dQ) per CTA
constexpr int kPadH = 8;            // bf16 of padding per shared row

// rows of the other side per staged tile
template <int D>
__host__ __device__ constexpr int other_rows() { return D <= 64 ? 64 : 32; }

// rows [row0, row0 + nrows) of x into shared rows of ``dst``, async
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x, int row0,
                                           int nrows, int s_len) {
  constexpr int LD = D + kPadH, CH = D / 8;
  for (int e = threadIdx.x; e < nrows * CH; e += 32 * kWarps) {
    const int r = e / CH, c = (e % CH) * 8;
    const int row = row0 + r;
    const bool in = row < s_len;
    cp_async16(smem_addr(dst + r * LD + c), x + (int64_t)(in ? row : 0) * D + c,
               in ? 16 : 0);
  }
}

template <int D>
constexpr size_t smem_dkdv_bf16() {
  // K and V of the CTA's keys; two stages of (Q, dO) rows and (lse, delta)
  return sizeof(__nv_bfloat16) * (2 * kTile + 2 * 2 * other_rows<D>()) * (D + kPadH) +
         sizeof(float) * 2 * 2 * other_rows<D>();
}

template <int D>
constexpr size_t smem_dq_bf16() {
  // Q and dO of the CTA's queries; two stages of (K, V) rows
  return sizeof(__nv_bfloat16) * (2 * kTile + 2 * 2 * other_rows<D>()) * (D + kPadH);
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps, 2)
    flash_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int s_len, int window,
                        float scale, float scale_log2) {
  static_assert(D % 16 == 0, "k-steps of 16 and pairs of 8-column n-tiles");
  constexpr int BQ = other_rows<D>();  // queries per staged tile
  constexpr int LD = D + kPadH;
  constexpr int KS = D / 16;           // k-steps over d
  constexpr int NT = BQ / 8;           // 8-query n-tiles of S^T
  constexpr int DT = D / 8;            // 8-column n-tiles of dK, dV
  constexpr int QSTAGE = 2 * BQ * LD;  // bf16 per stage: Q rows, dO rows
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * LD;
  __nv_bfloat16* stages = vs + kTile * LD;
  float* rowv = reinterpret_cast<float*>(stages + 2 * QSTAGE);  // [2][lse | delta]

  const int k0 = blockIdx.x * kTile;  // early keys see the most queries: first
  const int64_t head = (int64_t)blockIdx.y * s_len * D;
  const int64_t rows = (int64_t)blockIdx.y * s_len;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = k0 + 16 * warp;  // the warp's first key

  auto stage_q = [&](int qt, int st) {
    __nv_bfloat16* base = stages + st * QSTAGE;
    stage_rows<D>(base, q + head, qt * BQ, BQ, s_len);
    stage_rows<D>(base + BQ * LD, dout + head, qt * BQ, BQ, s_len);
    float* rv = rowv + st * 2 * BQ;
    for (int e = tid; e < 2 * BQ; e += 32 * kWarps) {
      const int row = qt * BQ + e % BQ;
      const bool in = row < s_len;
      cp_async4(smem_addr(rv + e), (e < BQ ? lse : delta) + rows + (in ? row : 0),
                in ? 4 : 0);
    }
  };

  // the query tiles that see a key of this tile
  const int k_last = min(k0 + kTile, s_len) - 1;
  const int q_end = window > 0 ? min(s_len, k_last + window) : s_len;
  const int qt_begin = k0 / BQ;
  const int qt_end = (q_end + BQ - 1) / BQ;

  stage_rows<D>(ks, k + head, k0, kTile, s_len);
  stage_rows<D>(vs, v + head, k0, kTile, s_len);
  stage_q(qt_begin, 0);
  cp_async_commit();

  float dva[DT][4], dka[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int st = (qt - qt_begin) & 1;
    cp_async_wait_all();  // tile qt has landed
    __syncthreads();      // ... for every thread; stage st ^ 1 is free
    if (qt + 1 < qt_end) stage_q(qt + 1, st ^ 1);
    cp_async_commit();
    const int q0 = qt * BQ;
    // none of the warp's 16 keys is seen by a query of this tile
    if (kw >= s_len || kw > q0 + BQ - 1 ||
        (window > 0 && kw + 15 <= q0 - window)) {
      continue;
    }
    const __nv_bfloat16* qs = stages + st * QSTAGE;
    const __nv_bfloat16* dos = qs + BQ * LD;
    const float* lses = rowv + st * 2 * BQ;
    const float* dels = lses + BQ;

    // S^T = K Q^T and dP^T = V dO^T: A fragments of the warp's K and V rows
    // (rows lane & 15, columns (lane >> 4) * 8 of each k-step), B fragments
    // of 16 queries by one ldmatrix.x4 (matrices: queries 0-7 | d 0-7,
    // queries 0-7 | d 8-15, queries 8-15 | d 0-7, queries 8-15 | d 8-15)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(ka, smem_addr(ks + a_off));
      ldmatrix_x4(va, smem_addr(vs + a_off));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int b_off = (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(qs + b_off));
        mma_bf16(s[2 * jp], ka, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, smem_addr(dos + b_off));
        mma_bf16(dp[2 * jp], va, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T, rows (keys) g and g + 8, columns (queries) 8j + 2t4 +
    // {0, 1}; a tile that crosses the diagonal, the window's edge or S is
    // masked element by element.  Rounded to bf16 as A fragments: n-tile
    // 2kk gives a0 (row g) and a1 (row g + 8), n-tile 2kk + 1 a2 and a3
    const bool edge = kw + 15 > q0 || (window > 0 && kw <= q0 + BQ - 1 - window) ||
                      q0 + BQ > s_len;
    uint32_t pa[NT / 2][4], dsa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t4 + (e & 1);
        float p = ex2(fmaf(s[j][e], scale_log2, -lses[qi] * kLog2e));
        if (edge && hidden(kw + g + 8 * (e >> 1), q0 + qi, window, s_len)) p = 0.f;
        pv[e] = p;
        dsv[e] = p * (dp[j][e] - dels[qi]);
      }
      pa[j / 2][(j & 1) * 2] = bf16_pair(pv[0], pv[1]);
      pa[j / 2][(j & 1) * 2 + 1] = bf16_pair(pv[2], pv[3]);
      dsa[j / 2][(j & 1) * 2] = bf16_pair(dsv[0], dsv[1]);
      dsa[j / 2][(j & 1) * 2 + 1] = bf16_pair(dsv[2], dsv[3]);
    }

    // dV += P^T dO and dK += dS^T Q: per 16-query k-step, B fragments for
    // 16 columns by one ldmatrix.x4.trans (matrices: queries 0-7 | d 0-7,
    // queries 8-15 | d 0-7, queries 0-7 | d 8-15, queries 8-15 | d 8-15)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dpr = 0; dpr < DT / 2; ++dpr) {
        const int b_off = (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                          dpr * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(dos + b_off));
        mma_bf16(dva[2 * dpr], pa[kk], b[0], b[1]);
        mma_bf16(dva[2 * dpr + 1], pa[kk], b[2], b[3]);
        ldmatrix_x4_trans(b, smem_addr(qs + b_off));
        mma_bf16(dka[2 * dpr], dsa[kk], b[0], b[1]);
        mma_bf16(dka[2 * dpr + 1], dsa[kk], b[2], b[3]);
      }
    }
  }

  // rows (keys) g and g + 8, columns 8n + 2t4 + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= s_len) continue;
    const int64_t off = head + (int64_t)key * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          bf16_pair(dva[n][2 * r], dva[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          bf16_pair(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps, 2)
    flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int s_len, int window,
                      float scale, float scale_log2) {
  static_assert(D % 16 == 0, "k-steps of 16 and pairs of 8-column n-tiles");
  constexpr int BK = other_rows<D>();  // keys per staged tile
  constexpr int LD = D + kPadH;
  constexpr int KS = D / 16;
  constexpr int NT = BK / 8;           // 8-key n-tiles of S
  constexpr int DT = D / 8;            // 8-column n-tiles of dQ
  constexpr int KSTAGE = 2 * BK * LD;  // bf16 per stage: K rows, V rows
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * LD;
  __nv_bfloat16* stages = dos + kTile * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // late queries first
  const int64_t head = (int64_t)blockIdx.y * s_len * D;
  const int64_t rows = (int64_t)blockIdx.y * s_len;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw = q0 + 16 * warp;  // the warp's first query

  auto stage_kv = [&](int kt, int st) {
    stage_rows<D>(stages + st * KSTAGE, k + head, kt * BK, BK, s_len);
    stage_rows<D>(stages + st * KSTAGE + BK * LD, v + head, kt * BK, BK, s_len);
  };

  // key tiles at or below the frontier that the window leaves visible
  const int q_last = min(q0 + kTile, s_len) - 1;
  const int kt_end = q_last / BK + 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  stage_rows<D>(qs, q + head, q0, kTile, s_len);
  stage_rows<D>(dos, dout + head, q0, kTile, s_len);
  stage_kv(kt_begin, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // Q and dO as A fragments, rows lane & 15, columns (lane >> 4) * 8
  uint32_t qf[KS][4], dof[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int a_off = (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kk], smem_addr(qs + a_off));
    ldmatrix_x4(dof[kk], smem_addr(dos + a_off));
  }
  // rows g and g + 8: lse in log2 units and delta (0 past S: not stored)
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    lse2[r] = row < s_len ? lse[rows + row] * kLog2e : 0.f;
    del[r] = row < s_len ? delta[rows + row] : 0.f;
  }

  float dqa[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < kt_end) stage_kv(kt + 1, st ^ 1);
    cp_async_commit();
    const int k0 = kt * BK;
    // none of the warp's 16 rows sees a key of this tile
    if (qw >= s_len || k0 > qw + 15 ||
        (window > 0 && k0 + BK - 1 <= qw - window)) {
      continue;
    }
    const __nv_bfloat16* ks = stages + st * KSTAGE;
    const __nv_bfloat16* vs = ks + BK * LD;

    // S = Q K^T and dP = dO V^T, B fragments from row-major K and V
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int b_off = (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(ks + b_off));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
        ldmatrix_x4(b, smem_addr(vs + b_off));
        mma_bf16(dp[2 * jp], dof[kk], b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], dof[kk], b[2], b[3]);
      }
    }

    // dS, rows (queries) g and g + 8, columns (keys) 8j + 2t4 + {0, 1};
    // keys past S lie past every real query, so the causal test masks them
    const bool edge = k0 + BK - 1 > qw || (window > 0 && k0 <= qw + 15 - window);
    uint32_t dsa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(s[j][e], scale_log2, -lse2[r]));
        if (edge && hidden(k0 + 8 * j + 2 * t4 + (e & 1), qw + g + 8 * r, window,
                           s_len)) {
          p = 0.f;
        }
        dsv[e] = p * (dp[j][e] - del[r]);
      }
      dsa[j / 2][(j & 1) * 2] = bf16_pair(dsv[0], dsv[1]);
      dsa[j / 2][(j & 1) * 2 + 1] = bf16_pair(dsv[2], dsv[3]);
    }

    // dQ += dS K: K's B fragments by ldmatrix.x4.trans, as V's in the forward
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dpr = 0; dpr < DT / 2; ++dpr) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(ks + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                       dpr * 16 + (lane >> 4) * 8));
        mma_bf16(dqa[2 * dpr], dsa[kk], b[0], b[1]);
        mma_bf16(dqa[2 * dpr + 1], dsa[kk], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= s_len) continue;
    __nv_bfloat16* out = dq + head + (int64_t)row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          bf16_pair(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
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

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta, int bh,
                        int s, int window, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t smem_kv = smem_dkdv_bf16<D>(), smem_q = smem_dq_bf16<D>();
  cudaError_t e = allow_smem(flash_bwd_dkdv_bf16<D>, smem_kv);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_bf16<D>, smem_q);
  if (e == cudaSuccess) e = launch_delta<bf, D>(o, dout, delta, (int64_t)bh * s, stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((s + kTile - 1) / kTile), static_cast<unsigned>(bh));
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* db = static_cast<const bf*>(dout);
  flash_bwd_dkdv_bf16<D><<<grid, 32 * kWarps, smem_kv, stream>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), s,
      window, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_bf16<D><<<grid, 32 * kWarps, smem_q, stream>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf*>(dq), s, window, scale,
      scale * kLog2e);
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
