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
// against 4 * D * 2-4 bytes per row of q, k, v and o.  This first version
// does every product on the CUDA cores in true float32 (no tensor cores, no
// TF32), so a float32 input meets the reference's 2e-5; bf16 is converted
// with __bfloat162float on load and __float2bfloat16 on store.  Moving the
// two products to tensor cores (mma.sync / wgmma) is later work.
//
// Design: one CTA of 256 threads per (bh, 64-row query tile); heavy tiles
// (late queries, most keys) are launched first.  The scaled query tile stays
// in shared memory; 32-key K and V tiles are staged in shared memory in
// float32, tile after tile up to the causal frontier, and tiles entirely
// outside the window are skipped, as the TPU kernel skips its blocks.
// Thread (tr, tc) = (t / 16, t % 16) owns query rows 4tr..4tr+3: the scores
// of keys tc and tc + 16, its rows' running max m and sum l (kept alike in
// all 16 threads of a row group by shuffles), and the output columns
// g * 64 + 4tc..4tc+3.  Shared rows are padded by 4 floats, so the float4
// reads of a quarter-warp fall on distinct banks.
//
// A row whose first visited tile is fully masked computes exp(-1e30 -
// -1e30) = 1 there; the next real score wipes that out through
// alpha = exp(m - m_new) = 0, as on the TPU.  (-INFINITY would give NaN.)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 32;       // keys per staged tile
constexpr int kThreads = 256;
constexpr int kPad = 4;       // floats of padding per shared row
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu)));
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(x.x, x.y),
                                            bf16_pair(x.z, x.w));
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
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + kPad) + 2 * kBK * (D + kPad) + kBQ * (kBK + kPad));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int s_len, int window, float scale) {
  constexpr int LD = D + kPad;   // row stride of the Q, K and V tiles
  constexpr int LP = kBK + kPad; // row stride of the P tile
  constexpr int G = D / 64;      // float4 column groups per thread
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

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
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
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
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
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + kk * LD + g * 64 + 4 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      store4(o + head + (int64_t)row * D + g * 64 + 4 * tc,
             make_float4(acc[i][4 * g + 0] / den, acc[i][4 * g + 1] / den,
                         acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, window, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

// Launches one forward pass on ``stream``.  Device pointers q, k, v, o
// [bh, s, d], contiguous, float32 (bf16 = 0) or bf16 (bf16 = 1); d is 64 or
// 128; bh at most 65535; window 0 means none, else keys with
// kpos <= qpos - window are masked.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int d, int window, float scale, int bf16,
                                      void* stream) {
  const uintptr_t a = bf16 ? 8 : 16;
  if (bh < 0 || bh > 65535 || s < 0 || window < 0 ||
      (d != 64 && d != 128) || !q || !k || !v || !o || !aligned(q, a) ||
      !aligned(k, a) || !aligned(v, a) || !aligned(o, a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return d == 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, bh, s, window, scale, st)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, bh, s, window, scale, st);
  }
  return d == 64 ? launch<float, 64>(q, k, v, o, bh, s, window, scale, st)
                 : launch<float, 128>(q, k, v, o, bh, s, window, scale, st);
}
