// Split-TF32 float32 products of K5's float32 kernels (the forward in
// flash_attn.cu, the backward in flash_attn_bwd.cu): the shared-memory ring
// that a producer warp fills by TMA and helper warps split, the register
// split of an accumulator into the next product's A operand, and the
// K-major copies (with their row permutation) that TF32 wgmma needs.
//
// The split.  A float32 x is hi + lo, hi = tf32(x) (cvt.rna: float32 bits
// whose low 13 mantissa bits are 0) and lo = x - hi, exact in float32, of
// which the cores read the top 19 bits; a product a b is then hi_a hi_b +
// hi_a lo_b + lo_a hi_b, three wgmma TF32 products into one float32
// accumulator (CUTLASS's OpMultiplyAddFastF32), the small two first
// (split_ss).  The dropped lo_a lo_b and lo's truncation are about 2^-21
// of a b, against 2^-11 for a single TF32 product: ``ref.attention_split_tf32``
// and ``ref.attention_bwd_split_tf32`` emulate it on the CPU, within
// ``attention_limit`` and ``attention_bwd_limit`` with 12x of margin on
// unit-variance draws where
// one TF32 product (``ref.attention_tf32``) exceeds them 18x or more.  hi is rounded
// explicitly, so the result does not depend on how the tensor cores treat
// the low 13 bits of a float32 operand.  The tensor cores also truncate as
// they accumulate, about an ulp of the running sum a k-step.  In the
// scores that error grows with their size and exp turns it into a relative
// error of P, so their hi hi terms are summed in chunks of kChunk k-steps,
// added on the CUDA cores (split_scores); at draws of std 3 a sum over all
// of D took the backward past ``attention_bwd_limit`` of the float64
// answer (tests/test_torch_flash_backward.py, the float64 card cases).
//
// The ring.  A CTA holds its own rows of OWN tensors (hi, then lo) and a
// ring of NS slots, each one staged operand tile (hi, then lo; in the dK/dV
// pass also the tile rows' lse and delta).  Threads: 128 G consumers (G
// warpgroups of 64 rows) and a producer warpgroup whose warp 0 issues the
// TMA loads (lane 0) and whose warps 1-3 split each tile that lands: hi
// rounded in place, lo written beside it, then fence.proxy.async so that
// wgmma (the async proxy) reads what the threads wrote.  Barriers: own_full
// / own_ready for the own rows, and per slot full (TMA bytes landed), ready
// (split) and empty (every consumer warp done with it).
//
// The K-major copies.  TF32 wgmma reads a shared operand K-major only, so
// a product over the sequence (O += P V, dV += P^T dO, dK += dS^T Q,
// dQ += dS K) reads a [bh, d, s8] copy of V, dO, Q or K written once a
// call by ``kmajor_copy`` (s8: S rounded up to 8, zeros past S).  Its A
// operand, P or dS, is the previous product's accumulator in registers: a
// thread holds columns 2c and 2c + 1 (c = lane % 4) of each 8-column block,
// where a k8 A fragment wants columns c and c + 4.  So the accumulator is
// used as it lies and the copy permutes its positions within each group of
// 8 to match: copy position 8g + i holds row 8g + kperm(i), kperm = [0, 2,
// 4, 6, 1, 3, 5, 7] (``ref.KMAJOR_PERM``).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBoxF = kSwRow / 4;   // float32 columns of a TMA box: 16
constexpr int kSplitters = 96;      // the producer warpgroup's warps 1-3
constexpr int kSmemOptin = 232448;  // dynamic shared memory a CTA may have

// Shared memory of a float32 pass, from a 1,024-byte boundary: OWN tensors
// of ROWS x D (hi, lo), NS slots of R x D (hi, lo), per slot 2 R floats of
// values (VALS), then the barriers.  NS is as many slots as fit, at most 4.
template <int OWN, int ROWS, int D, int R, bool VALS>
struct Ring {
  static constexpr int OWN_T = ROWS * D * 4;  // bytes of an own tensor's hi
  static constexpr int TILE = R * D * 4;      // bytes of a staged tile's hi
  static constexpr int VAL = VALS ? 2 * R * 4 : 0;
  static constexpr int SLOTS = OWN * 2 * OWN_T;
  static constexpr int fit(int n) {
    return SLOTS + n * (2 * TILE + VAL) + 8 * (2 + 3 * n) + 1024;
  }
  static constexpr int NS = fit(4) <= kSmemOptin ? 4 : fit(3) <= kSmemOptin ? 3 : 2;
  static_assert(fit(NS) <= kSmemOptin, "the own rows and two slots must fit");
  static constexpr size_t bytes = fit(NS);
  static constexpr int BARS = SLOTS + NS * (2 * TILE + VAL);
  __host__ __device__ static constexpr int own(int i) { return i * 2 * OWN_T; }
  __host__ __device__ static constexpr int slot(int st) { return SLOTS + st * 2 * TILE; }
  __host__ __device__ static constexpr int vals(int st) {
    return SLOTS + NS * 2 * TILE + st * VAL;
  }
  __host__ __device__ static constexpr int own_full() { return BARS; }
  __host__ __device__ static constexpr int own_ready() { return BARS + 8; }
  __host__ __device__ static constexpr int full(int st) { return BARS + 16 + 8 * st; }
  __host__ __device__ static constexpr int ready(int st) {
    return BARS + 16 + 8 * (NS + st);
  }
  __host__ __device__ static constexpr int empty(int st) {
    return BARS + 16 + 8 * (2 * NS + st);
  }

  // by one thread, before a __syncthreads; ``consumer_warps`` arrive on empty
  __device__ static void init(uint32_t base, int consumer_warps) {
    mbar_init(base + own_full(), 1);
    mbar_init(base + own_ready(), kSplitters);
    for (int st = 0; st < NS; ++st) {
      mbar_init(base + full(st), 1);
      mbar_init(base + ready(st), kSplitters);
      mbar_init(base + empty(st), consumer_warps);
    }
    mbar_init_fence();
  }
};

// setmaxnreg moves registers from the producer warpgroup to G = 2 consumer
// warpgroups (40 against 232 a thread); with one consumer warpgroup every
// thread may have 255 already
template <int G>
__device__ __forceinline__ void regs_producer() {
  if constexpr (G == 2) setmaxnreg_dec<40>();
}

template <int G>
__device__ __forceinline__ void regs_consumer() {
  if constexpr (G == 2) setmaxnreg_inc<232>();
}

// rows [row, row + ROWS) of one head of a [bh, s, D] float32 tensor map,
// all D / 16 boxes, into the tile at ``dst``
template <int D, int ROWS>
__device__ __forceinline__ void tma_rows_f32(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int row, int head) {
#pragma unroll
  for (int b = 0; b < D / kBoxF; ++b) {
    tma_load_3d(dst + b * ROWS * kSwRow, map, bar, b * kBoxF, row, head);
  }
}

// positions [pos, pos + R) of one head of a [bh, D, s8] K-major copy, all
// D rows, as R / 16 boxes, into the tile at ``dst``
template <int D, int R>
__device__ __forceinline__ void tma_cols_f32(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int pos, int head) {
#pragma unroll
  for (int b = 0; b < R / kBoxF; ++b) {
    tma_load_3d(dst + b * D * kSwRow, map, bar, pos + b * kBoxF, 0, head);
  }
}

// The n floats at ``p`` (shared memory) split in place: hi rounded, lo
// written n floats further; splitter ``i`` of kSplitters
__device__ __forceinline__ void split_tile(uint8_t* p, int n, int i) {
  float4* hi = reinterpret_cast<float4*>(p);
  float4* lo = reinterpret_cast<float4*>(p + 4 * n);
  for (int e = i; e < n / 4; e += kSplitters) {
    const float4 x = hi[e];
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    hi[e] = h;
    lo[e] = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
}

// k-step j (columns 8j .. 8j + 7) of a 64 x N accumulator as the hi and lo
// TF32 A fragments of the next product: accumulator columns 2c, 2c + 1
// stand for fragment columns c, c + 4 (the B copy is permuted to match)
template <int N>
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&x)[N], int j) {
  const float v[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = tf32_hi(v[i]);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(v[i] - h);
  }
}

// d (64 x N) = A B over KS k-steps, A (hi at ah, lo at al) and B (hi at bh,
// lo at bl) K-major tiles of 64-byte boxes, A's rows from r0 of a
// [AROWS, *] tile, B a [BROWS = N, *] tile.  The cores truncate as they
// accumulate, an ulp of the running sum per step, so the small terms (hi
// lo, lo hi) go first and the hi hi terms, which set the sum's size, last:
// a third of the steps at its full size.  The caller fences and commits.
template <int AROWS, int BROWS, int KS, int N>
__device__ __forceinline__ void split_ss(float (&d)[N], uint32_t ah, uint32_t al, int r0,
                                         uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_ss_tf32(d, desc_k<AROWS>(ah, r0, kk), desc_k<BROWS>(bl, 0, kk), kk);
    wgmma_ss_tf32(d, desc_k<AROWS>(al, r0, kk), desc_k<BROWS>(bh, 0, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_ss_tf32(d, desc_k<AROWS>(ah, r0, kk), desc_k<BROWS>(bh, 0, kk), 1);
  }
}

// k-steps of one hi hi chunk of split_scores
constexpr int kChunk = 4;

// hi hi of k-steps [k0, k0 + kChunk) into a fresh accumulator t
template <int AROWS, int BROWS, int N>
__device__ __forceinline__ void hihi_chunk(float (&t)[N], uint32_t ah, int r0, uint32_t bh,
                                           int k0) {
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {
    wgmma_ss_tf32(t, desc_k<AROWS>(ah, r0, k0 + kk), desc_k<BROWS>(bh, 0, k0 + kk), kk);
  }
}

// d (64 x N) = A B as split_ss, for the scores, whose error exp turns into
// a relative error of P: a sum over all of D at full size would drift by
// an ulp per truncating step, so the hi hi terms go in chunks of kChunk
// k-steps.  The small terms and the last chunk go into d, every other chunk
// into one fresh accumulator t (the first in flight with d), added to d on
// the CUDA cores, rounded to nearest, before the next chunk reuses t.  (A
// second t, to keep a chunk in flight while one is added, made the forward
// spill at D = 96 and 128 and run 5% slower at 128.)  Issues its own
// fences, commits and waits, and returns with d complete.
template <int AROWS, int BROWS, int KS, int N>
__device__ __forceinline__ void split_scores(float (&d)[N], uint32_t ah, uint32_t al, int r0,
                                             uint32_t bh, uint32_t bl) {
  static_assert(KS % kChunk == 0, "whole chunks");
  constexpr int NC = KS / kChunk;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_ss_tf32(d, desc_k<AROWS>(ah, r0, kk), desc_k<BROWS>(bl, 0, kk), kk);
    wgmma_ss_tf32(d, desc_k<AROWS>(al, r0, kk), desc_k<BROWS>(bh, 0, kk), 1);
  }
#pragma unroll
  for (int kk = KS - kChunk; kk < KS; ++kk) {
    wgmma_ss_tf32(d, desc_k<AROWS>(ah, r0, kk), desc_k<BROWS>(bh, 0, kk), 1);
  }
  wgmma_commit();
  float t[N];
  if constexpr (NC > 1) {
    hihi_chunk<AROWS, BROWS>(t, ah, r0, bh, 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin(d);
#pragma unroll
  for (int c = 0; c < NC - 1; ++c) {  // one fresh accumulator, chunk by chunk
    if (c > 0) {
      wgmma_fence();
      hihi_chunk<AROWS, BROWS>(t, ah, r0, bh, c * kChunk);
      wgmma_commit();
      wgmma_wait<0>();
    }
    pin(t);
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] += t[i];
  }
  pin(d);
}

// acc (64 x D) = alpha acc + A B for the A fragments (hi, lo) of KS k-steps
// and B, a [D, 8 KS] K-major tile (hi at bh, lo at bl), alpha per row (g,
// g + 8).  The tensor cores' float32 accumulation truncates, so a sum that
// ran over all of S would drift by up to an ulp per wgmma; here each
// tile's product goes into a fresh accumulator, NT columns at a time, and
// is added to acc on the CUDA cores, rounded to nearest.
template <int D, int NT, int KS>
__device__ __forceinline__ void rs_tile(float (&acc)[D / 2], uint32_t (&ah)[KS][4],
                                        uint32_t (&al)[KS][4], uint32_t bh, uint32_t bl,
                                        const float (&alpha)[2]) {
  static_assert(D % NT == 0, "whole column chunks");
#pragma unroll
  for (int c = 0; c < D / NT; ++c) {
    float tmp[NT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {  // the small terms first (split_ss)
      wgmma_rs_tf32(tmp, ah[kk], desc_k<D>(bl, c * NT, kk), kk);
      wgmma_rs_tf32(tmp, al[kk], desc_k<D>(bh, c * NT, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs_tf32(tmp, ah[kk], desc_k<D>(bh, c * NT, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(tmp);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      acc[c * NT / 2 + i] = fmaf(acc[c * NT / 2 + i], alpha[(i >> 1) & 1], tmp[i]);
    }
  }
  pin(ah);
  pin(al);
}

// ---------------------------------------------------------------------------
// the K-major copies
// ---------------------------------------------------------------------------

// xt[h, c, p] = x[h, (p & ~7) | kperm(p & 7), c] for p < s8, 0 past S; a
// 32 x 32 tile a CTA of 32 x 8 threads, through shared memory
__global__ void __launch_bounds__(256)
    kmajor_copy(const float* __restrict__ x, float* __restrict__ xt, int s, int s8,
                int d) {
  __shared__ float tile[32][33];
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int64_t head = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int row = p0 + r;
    tile[r][tx] = row < s && c0 + tx < d ? x[(head * s + row) * d + c0 + tx] : 0.f;
  }
  __syncthreads();
  const int src = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);  // kperm
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, p = p0 + tx;
    if (c < d && p < s8) xt[(head * d + c) * s8 + p] = tile[src][r];
  }
}

inline int round8(int s) { return (s + 7) / 8 * 8; }

// the K-major copy of x [bh, s, d] into xt [bh, d, round8(s)]
inline cudaError_t launch_kmajor(const void* x, float* xt, int bh, int s, int d,
                                 cudaStream_t stream) {
  const int s8 = round8(s);
  const dim3 grid(static_cast<unsigned>((s8 + 31) / 32), static_cast<unsigned>((d + 31) / 32),
                  static_cast<unsigned>(bh));
  kmajor_copy<<<grid, dim3(32, 8), 0, stream>>>(static_cast<const float*>(x), xt, s, s8, d);
  return cudaGetLastError();
}

// float32 [bh, s, d] as a tensor map of ``rows``-row boxes
inline cudaError_t rows_map_f32(CUtensorMap* map, const void* x, int bh, int s, int d,
                                int rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, bh, s, d, rows);
}

// a K-major copy [bh, d, round8(s)] as a tensor map of 16-position boxes
// of all d rows
inline cudaError_t cols_map_f32(CUtensorMap* map, const float* xt, int bh, int s, int d) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xt, bh, d, round8(s), d);
}

}  // namespace
