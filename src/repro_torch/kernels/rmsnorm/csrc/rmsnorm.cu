// RMSNorm forward and backward for Hopper (sm_90a): the norm of the port's
// models (``models/layers.py`` ``rmsnorm``), y = bf16(bf16(x r) w~) with
// r = 1 / sqrt(mean(x^2) + eps) over the last dim and w~ = w in x's type.
//
// No TPU kernel: the JAX package's ``rmsnorm`` is plain ``jnp``, which XLA
// fuses into a pass or two over the rows.  Run eagerly, the same arithmetic
// is about 9 launches forward and 15 backward a call, each one a pass over
// the whole [N, d] tensor, most of them in float32.  These kernels do the
// work in one pass each way.
//
// Bound on this card: bytes.  A row is d values and a few flops each, far
// below the card's 295 flops a byte.  The floor is reading x and writing y
// forward, and reading x and dy and writing dx backward (plus 4 bytes a row
// of r, and the dw partials below).  What the design does about it:
//   * one warp a row, 8 rows a CTA; each lane moves 16-byte vectors of its
//     row (8 bf16 or 4 float32), neighbouring lanes on neighbouring
//     addresses.  Rows whose length or base is not a whole number of
//     16-byte vectors take the same code one value at a time;
//   * a row is read from device memory once: the second pass over it (the
//     output, after the row's sum) reads it again from L1, where the first
//     pass left it;
//   * the sum of squares is float32, a lane's share summed in order and the
//     lanes by a butterfly of shuffles; every lane ends with the same bits;
//   * the rounding points are the eager op's: x^2 rounded to float32 before
//     the sum, the mean as sum times 1/d, then + eps, ``rsqrtf``,
//     t = round(x r) to x's type, y = round(t w~).  No product is fused
//     into an add where the eager op rounds between them.  Only the sum's
//     order differs;
//   * the forward writes r (float32, a row) for the backward, which
//     recomputes t from x and r bit for bit instead of reading it;
//   * backward, dx = r (dy w~) - x r^3 / d sum(dy w~ x), all float32, is
//     written in x's type; dw = sum over rows of dy t needs a sum across
//     rows, so each CTA takes a fixed run of ``rows`` rows, each warp keeps
//     its own float32 sum of dy t for every column in shared memory (a lane
//     owns the same columns in every row: no two lanes touch one word), the
//     CTA adds its warps in order into one partial row, and ``rmsnorm_dw``
//     adds the partials in a fixed order.  No atomics: reruns are bit-equal.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows in flight a CTA, one warp each
constexpr int kThreads = kWarps * 32;
// the widest row: the backward's per-warp sums of a row fill 8 * d * 4 bytes
// of shared memory, at most the 227 KB a block may opt into
constexpr int kMaxD = 7168;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ``v`` rounded to T, as a float: the value a T holds
template <typename T> __device__ __forceinline__ float in_t(float v) {
  return to_f(from_f<T>(v));
}

// N consecutive values, loaded and stored whole (16 bytes at most at once)
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
            float* __restrict__ rstd, int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  using P = Pack<T, V>;
  using W = Pack<float, V>;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  P* yr = reinterpret_cast<P*>(y + row * d);
  const W* wp = reinterpret_cast<const W*>(w);
  const int packs = d / V;
  float ss = 0.f;
#pragma unroll 4
  for (int i = lane; i < packs; i += 32) {
    const P p = xr[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f(p.v[k]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / static_cast<float>(d)), eps));
#pragma unroll 4
  for (int i = lane; i < packs; i += 32) {
    const P p = xr[i];
    const W q = wp[i];
    P o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float t = in_t<T>(__fmul_rn(to_f(p.v[k]), r));
      o.v[k] = from_f<T>(__fmul_rn(t, in_t<T>(q.v[k])));
    }
    yr[i] = o;
  }
  if (lane == 0) rstd[row] = r;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ rstd, const T* __restrict__ g, T* __restrict__ dx,
            float* __restrict__ part, int n, int d, int rows) {
  // each warp's sum of g t over its rows, column k * packs + i holding
  // value k of pack i, so that the lanes of a warp hit distinct banks
  extern __shared__ float acc[];
  using P = Pack<T, V>;
  using W = Pack<float, V>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int packs = d / V;
  float* mine = acc + warp * d;
  for (int j = lane; j < d; j += 32) mine[j] = 0.f;
  __syncwarp();
  const W* wp = reinterpret_cast<const W*>(w);
  const float inv_d = 1.0f / static_cast<float>(d);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t row_end = row0 + rows < n ? row0 + rows : static_cast<int64_t>(n);
  for (int64_t row = row0 + warp; row < row_end; row += kWarps) {
    const P* xr = reinterpret_cast<const P*>(x + row * d);
    const P* gr = reinterpret_cast<const P*>(g + row * d);
    P* dxr = reinterpret_cast<P*>(dx + row * d);
    const float r = rstd[row];
    float s = 0.f;  // sum of g w~ x
#pragma unroll 4
    for (int i = lane; i < packs; i += 32) {
      const P xp = xr[i], gp = gr[i];
      const W q = wp[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s += to_f(gp.v[k]) * in_t<T>(q.v[k]) * to_f(xp.v[k]);
      }
    }
    s = warp_sum(s);
    const float c = s * r * r * r * inv_d;
#pragma unroll 4
    for (int i = lane; i < packs; i += 32) {
      const P xp = xr[i], gp = gr[i];
      const W q = wp[i];
      P o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xv = to_f(xp.v[k]), gv = to_f(gp.v[k]);
        o.v[k] = from_f<T>(r * (gv * in_t<T>(q.v[k])) - xv * c);
        // the forward's t, from the same x and r
        mine[k * packs + i] += gv * in_t<T>(__fmul_rn(xv, r));
      }
      dxr[i] = o;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const int i = j / V, k = j - i * V;
    float s = 0.f;
    for (int v = 0; v < kWarps; ++v) s += acc[v * d + k * packs + i];
    part[static_cast<int64_t>(blockIdx.x) * d + j] = s;
  }
}

// dw[j] = the partials' column j summed: warp v adds partials v, v + 8, ...
// in order, then the warps are added in order
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw(const float* __restrict__ part, float* __restrict__ dw, int parts, int d) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (j < d) {
    for (int p = warp; p < parts; p += kWarps) a += part[static_cast<int64_t>(p) * d + j];
  }
  sums[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && j < d) {
    float s = 0.f;
    for (int v = 0; v < kWarps; ++v) s += sums[v][lane];
    dw[j] = s;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte packs where every row and the weight start on a 16-byte boundary
template <typename T>
bool whole_packs(int d, const void* const* ptrs, int count) {
  if (d % (16 / sizeof(T)) != 0) return false;
  for (int i = 0; i < count; ++i) {
    if (!aligned16(ptrs[i])) return false;
  }
  return true;
}

template <typename T, int V>
cudaError_t fwd(const void* x, const float* w, void* y, float* rstd, int n, int d,
                float eps, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  rmsnorm_fwd<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), rstd, n, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_typed(const void* x, const float* w, void* y, float* rstd, int n, int d,
                      float eps, cudaStream_t stream) {
  const void* ptrs[] = {x, w, y};
  if (whole_packs<T>(d, ptrs, 3)) {
    return fwd<T, static_cast<int>(16 / sizeof(T))>(x, w, y, rstd, n, d, eps, stream);
  }
  return fwd<T, 1>(x, w, y, rstd, n, d, eps, stream);
}

template <typename T, int V>
cudaError_t bwd(const void* x, const float* w, const float* rstd, const void* g, void* dx,
                float* part, float* dw, int n, int d, int rows, cudaStream_t stream) {
  const int parts = (n + rows - 1) / rows;
  const size_t smem = sizeof(float) * kWarps * d;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rmsnorm_bwd<T, V><<<parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, rstd, static_cast<const T*>(g), static_cast<T*>(dx),
      part, n, d, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dw<<<(d + 31) / 32, kThreads, 0, stream>>>(part, dw, parts, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_typed(const void* x, const float* w, const float* rstd, const void* g,
                      void* dx, float* part, float* dw, int n, int d, int rows,
                      cudaStream_t stream) {
  const void* ptrs[] = {x, w, g, dx};
  if (whole_packs<T>(d, ptrs, 4)) {
    return bwd<T, static_cast<int>(16 / sizeof(T))>(x, w, rstd, g, dx, part, dw, n, d, rows,
                                                     stream);
  }
  return bwd<T, 1>(x, w, rstd, g, dx, part, dw, n, d, rows, stream);
}

}  // namespace

// y = rmsnorm(x, w) and rstd[n] = r of each row: x, y [n, d] of float32
// (bf16 = 0) or bf16 (bf16 = 1), w [d] float32, every tensor contiguous.
extern "C" int rmsnorm_fwd_launch(const void* x, const float* w, void* y, float* rstd,
                                  int n, int d, float eps, int bf16, void* stream) {
  if (n < 0 || d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16 ? fwd_typed<__nv_bfloat16>(x, w, y, rstd, n, d, eps, s)
                             : fwd_typed<float>(x, w, y, rstd, n, d, eps, s);
  return static_cast<int>(e);
}

// dx [n, d] in x's type and dw [d] float32 from x, w, the forward's rstd and
// g = dy; ``part`` is scratch for ceil(n / rows) partial rows of d floats.
extern "C" int rmsnorm_bwd_launch(const void* x, const float* w, const float* rstd,
                                  const void* g, void* dx, float* part, float* dw, int n,
                                  int d, int rows, int bf16, void* stream) {
  if (n < 0 || d < 1 || d > kMaxD || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(dw, 0, sizeof(float) * d, s));
  const cudaError_t e =
      bf16 ? bwd_typed<__nv_bfloat16>(x, w, rstd, g, dx, part, dw, n, d, rows, s)
           : bwd_typed<float>(x, w, rstd, g, dx, part, dw, n, d, rows, s);
  return static_cast<int>(e);
}
