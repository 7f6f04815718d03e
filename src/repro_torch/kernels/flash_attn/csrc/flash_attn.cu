// Causal flash-attention forward for Hopper (sm_90a), blocked online
// softmax with an optional sliding window.
//
// Replaces the TPU kernel ``flash_attention`` of the reference package
// (src/repro/kernels/flash_attn/flash_attn.py, ``_kernel``), the kernel
// behind its ``mha_flash``: q, k, v ``[BH, S, D]`` (float32 or bf16) ->
// o ``[BH, S, D]`` in q's dtype, scale 1/sqrt(D), masked scores -1e30,
// o = acc / max(l, 1e-30).  The S x S scores never reach device memory.
//
// Bound on this card: operations.  4 * D flops per unmasked (q, k) pair
// against 4 * D * 2-4 bytes per row of q, k, v and o: in bf16 the 989
// TFLOP/s of the tensor cores, in float32 the 67 TFLOP/s of the CUDA cores.
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
// float32: the CUDA cores in true float32 (flash_attention_f32), so the
//   reference's 2e-5 holds; TF32 tensor cores would not meet it.  One CTA
//   of 256 threads per 64-row query tile, 32-key K and V tiles in float32 in
//   shared memory; thread (tr, tc) = (t / 16, t % 16) owns query rows
//   4tr..4tr+3, the scores of keys tc and tc + 16, its rows' running max m
//   and sum l (kept alike in all 16 threads of a row group by shuffles), and
//   D / 16 of each row's output columns: float4 chunks g * 64 + 4tc..4tc+3
//   while 64 columns remain for them, then a float2 chunk of the next 32
//   columns (2tc, 2tc + 1) and a single column of the last 16, as D needs
//   (D = 32: one float2; 64: one float4; 96: a float4 and a float2; 128: two
//   float4).  Shared rows are padded by 4 floats, so the float4 reads of a
//   quarter-warp fall on distinct banks.
//
// Both kernels launch heavy tiles (late queries, most keys) first and skip
// tiles entirely outside the window, as the TPU kernel skips its blocks.  A
// row whose first visited tile is fully masked computes exp(-1e30 - -1e30)
// = 1 there; the next real score wipes that out through alpha = exp(m -
// m_new) = 0, as on the TPU.  (-INFINITY would give NaN.)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 32;       // keys per staged tile
constexpr int kThreads = 256;
constexpr int kPad = 4;       // floats of padding per shared row

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// sum / max over the 16 threads of one row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) *
         (kBQ * (D + kPad) + 2 * kBK * (D + kPad) + kBQ * (kBK + kPad));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int s_len, int window, float scale) {
  static_assert(D % 16 == 0, "16 threads share a row: D / 16 columns each");
  constexpr int LD = D + kPad;   // row stride of the Q, K and V tiles
  constexpr int LP = kBK + kPad; // row stride of the P tile
  constexpr int C = D / 16;      // output columns per thread
  constexpr int G = C / 4;       // its float4 chunks: columns g * 64 + 4tc
  constexpr int H2 = C % 4 / 2;  // a float2 chunk: columns B2 + 2tc
  constexpr int H1 = C % 2;      // a single column: B1 + tc
  constexpr int B2 = 64 * G, B1 = B2 + 32 * H2;
  static_assert(B1 + 16 * H1 == D, "the chunks cover the row exactly");
  constexpr int V4 = D / 4;      // float4s per row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* ks = qs + kBQ * LD;                     // [kBK][LD]
  float* vs = ks + kBK * LD;                     // [kBK][LD]
  float* ps = vs + kBK * LD;                     // [kBQ][LP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t head = (int64_t)blockIdx.y * s_len * D;
  const int t = threadIdx.x;
  const int tr = t >> 4;
  const int tc = t & 15;

  for (int e = t; e < kBQ * V4; e += kThreads) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < s_len) {
      x = load4(q + head + (int64_t)(q0 + r) * D + c);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    store4(qs + r * LD + c, x);
  }

  // acc[i]: the float4 chunks' columns, then the float2's, then the single
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int n_tiles = q_last / kBK + 1;  // tiles at or below the frontier
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    // no row of this CTA sees any key of the tile (uniform over the CTA)
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = t; e < kBK * V4; e += kThreads) {
      const int r = e / V4, c = (e % V4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < s_len) {
        const int64_t off = head + (int64_t)(k0 + r) * D + c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(ks + r * LD + c, kx);
      store4(vs + r * LD + c, vx);
    }
    __syncthreads();

    // scores of rows 4tr+i against keys tc and tc+16
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * tr + i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
      }
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool keep =
            kpos <= qpos && (window <= 0 || kpos > qpos - window);
        if (!keep) sc[i][j] = kMasked;
      }
      const float m_new = fmaxf(m[i], group_max(fmaxf(sc[i][0], sc[i][1])));
      const float p0 = expf(sc[i][0] - m_new);
      const float p1 = expf(sc[i][1] - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      ps[(4 * tr + i) * LP + tc] = p0;
      ps[(4 * tr + i) * LP + tc + 16] = p1;
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * tr + i) * LP + kk];
      const float* vrow = vs + kk * LD;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + g * 64 + 4 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
      if constexpr (H2 > 0) {
        const float2 vv = *reinterpret_cast<const float2*>(vrow + B2 + 2 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * G + 0] = fmaf(p[i], vv.x, acc[i][4 * G + 0]);
          acc[i][4 * G + 1] = fmaf(p[i], vv.y, acc[i][4 * G + 1]);
        }
      }
      if constexpr (H1 > 0) {
        const float vv = vrow[B1 + tc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][C - 1] = fmaf(p[i], vv, acc[i][C - 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* out = o + head + (int64_t)row * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      store4(out + g * 64 + 4 * tc,
             make_float4(acc[i][4 * g + 0] / den, acc[i][4 * g + 1] / den,
                         acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den));
    }
    if constexpr (H2 > 0) {
      *reinterpret_cast<float2*>(out + B2 + 2 * tc) =
          make_float2(acc[i][4 * G + 0] / den, acc[i][4 * G + 1] / den);
    }
    if constexpr (H1 > 0) out[B1 + tc] = acc[i][C - 1] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, float32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kTileK = 64;    // keys per staged K / V tile
constexpr int kPadH = 8;      // bf16 of padding per shared row (16 bytes)
constexpr int kWarps = 4;     // warps per CTA, 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; ``bytes`` 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, ``lo`` in the low half (the lower column)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

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

// three CTAs an SM: 168 registers a thread at most
template <int D>
__global__ void __launch_bounds__(32 * kWarps, 3)
    flash_attention_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int s_len, int window,
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
    __nv_bfloat16* out = o + head + (int64_t)row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          bf16_pair(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int s, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_f32<D>;
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                int s, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_bf16<D>;
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
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), s,
      window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int window, float scale, int bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(q, k, v, o, bh, s, window, scale, stream)
              : launch_f32<D>(q, k, v, o, bh, s, window, scale, stream);
}

}  // namespace

// Launches one forward pass on ``stream``.  Device pointers q, k, v, o
// [bh, s, d], contiguous, 16-byte aligned, float32 (bf16 = 0) or bf16
// (bf16 = 1); d is 32, 64, 96 or 128 (the head dims of the repo's
// configurations: 32 in every smoke configuration, 96 in phi-3-vision-4.2b);
// bh at most 65535; window 0 means none, else keys with kpos <= qpos -
// window are masked.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int d, int window, float scale, int bf16,
                                      void* stream) {
  if (bh < 0 || bh > 65535 || s < 0 || window < 0 ||
      (d != 32 && d != 64 && d != 96 && d != 128) || !q || !k || !v || !o ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, bh, s, window, scale, bf16, st);
    case 64: return launch<64>(q, k, v, o, bh, s, window, scale, bf16, st);
    case 96: return launch<96>(q, k, v, o, bh, s, window, scale, bf16, st);
    default: return launch<128>(q, k, v, o, bh, s, window, scale, bf16, st);
  }
}
