// Set-membership probe for Hopper (sm_90a): ``out[i] = values[i] in set``.
//
// Replaces the TPU kernel ``membership`` of the reference package
// (src/repro/kernels/membership/membership.py, ``_kernel``), the kernel
// behind its ``probe``.  The result equals ``isin`` bit for bit: int32 0/1.
//
// The TPU kernel compares every 1024-row block densely against every
// 256-key tile of the whole set, O(N x M) compares, because a TPU has no
// cheap gather and its VMEM holds the set.  That design is not carried over.
// Here each value runs a lower-bound binary search over the set sorted
// ascending (the wrapper sorts it on the device first), O(N log M) steps.
//
// Bound on this card: the N x 8 bytes of values and mask are the floor; the
// search is what keeps a kernel above it.  The first design searched the
// whole set in global memory: a chain of bit_length(M) dependent L1/L2
// reads per value (13 at 5,000 keys, 20 at 729,395), 4 values in flight a
// thread, and over random values the top of the tree was scattered reads.
// This design puts the search in shared memory and cuts the instructions a
// step takes (on 6 M values, issue and scattered L2 sectors, not latency,
// are what the search costs on this card):
//   * a persistent grid (as many CTAs of 1,024 threads as fit the card at
//     once), so each CTA stages what it searches once and then walks many
//     tiles of 4,096 values in a grid stride, loading the next tile's
//     values while it searches the current one;
//   * a set of at most kSmemKeys keys (224 KB, within the 227 KB a block may
//     opt into, one CTA an SM) is staged whole, and the whole search runs
//     in shared memory;
//   * a larger set is cut into aligned ranges of ``step`` keys (a power of
//     two, at least 8, so that at most kFenceKeys ranges cover it) and the
//     last key of each range is staged: the top steps run in shared
//     memory, then the range is halved in the L2-resident set down to an
//     aligned block of 8 keys, one 32-byte sector, compared whole with two
//     16-byte loads (at 65,536 keys a range is one block: one sector a
//     value, where the first design read about 17 scattered words);
//   * the search is branch-free with one halving length for every value
//     (``b = arr[b + half] < key ? b + half : b``), so a step is a load, a
//     compare and a select, about half the instructions of a lo/hi search;
//   * each thread runs 4 values in lock step, so 4 independent loads are in
//     flight a step; values are 1,024 rows apart, so every value load and
//     mask store of a warp is coalesced, and the kernel needs no order of
//     the values.
// kRowsPerThread and kFenceKeys were set from a sweep on an H100 (2, 4 or 8
// values; 4,096 to 32,768 fences) over grouped and random values.
// A set's duplicates change nothing (a lower bound finds the first copy).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRowsPerThread = 4;
// the largest set staged whole: 224 KB of shared memory
constexpr int kSmemKeys = 57344;
// the most fences of a larger set
constexpr int kFenceKeys = 16384;
static_assert(kFenceKeys <= kSmemKeys, "the fences fit where the set would");
// the keys level 2 ends on: one 32-byte sector, read as two int4
constexpr int kBlockKeys = 8;

// Whether ``key`` is one of the 8 keys set[b, b + 8) (b a multiple of 8),
// those past the set's end excluded: two 16-byte loads, one 32-byte sector.
__device__ __forceinline__ bool in_block(const int32_t* __restrict__ set,
                                         int m, int b, int key) {
  if (b + kBlockKeys <= m) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(set + b));
    const int4 y = __ldg(reinterpret_cast<const int4*>(set + b + 4));
    return (x.x == key) | (x.y == key) | (x.z == key) | (x.w == key) |
           (y.x == key) | (y.y == key) | (y.z == key) | (y.w == key);
  }
  bool hit = false;
  for (int j = b; j < m && j < b + kBlockKeys; ++j) {
    hit |= __ldg(set + j) == key;
  }
  return hit;
}

// With step == 1 the staged keys are the set (f == m).  Otherwise step is a
// power of two, at least kBlockKeys, and fence[i] = set[min((i + 1) step,
// m) - 1], the last key of the i-th aligned range of step keys.
__global__ void __launch_bounds__(kThreads, 1)
membership_kernel(const int32_t* __restrict__ values, int64_t n,
                  const int32_t* __restrict__ set, int m, int f, int step,
                  int32_t* __restrict__ out) {
  extern __shared__ int32_t fence[];  // [f]
  for (int i = threadIdx.x; i < f; i += kThreads) {
    fence[i] = __ldg(set + (step == 1 ? i : min((i + 1) * step, m) - 1));
  }
  __syncthreads();
  constexpr int64_t kTile = (int64_t)kThreads * kRowsPerThread;
  const int64_t stride = (int64_t)gridDim.x * kTile;
  // the next tile's values are loaded while this tile is searched
  int next[kRowsPerThread];
  int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = base + (int64_t)i * kThreads;
    next[i] = row < n ? __ldg(values + row) : 0;
  }
  for (; base < n; base += stride) {
    int key[kRowsPerThread], b[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      key[i] = next[i];
      b[i] = 0;
      const int64_t row = base + stride + (int64_t)i * kThreads;
      next[i] = row < n ? __ldg(values + row) : 0;
    }
    bool hit[kRowsPerThread];
    if (f == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) hit[i] = false;
    } else {
      // level 1, in shared memory: the lower bound among the staged keys
      // lies in [b, b + len]; every value halves the same len, so no read
      // needs a clamp (b + half < b + len <= f) and no step a branch
      for (int len = f; len > 1;) {
        const int half = len >> 1;
        int v[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) v[i] = fence[b[i] + half];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          b[i] = v[i] < key[i] ? b[i] + half : b[i];
        }
        len -= half;
      }
      if (step == 1) {  // the staged keys are the set: b or b + 1
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int v0 = fence[b[i]], v1 = fence[min(b[i] + 1, f - 1)];
          hit[i] = (v0 == key[i]) | (b[i] + 1 < f && v0 < key[i] && v1 == key[i]);
        }
      } else {
        // level 2, in the set: range q is the first whose last key is >=
        // key, so the key's lower bound lies in [q step, (q + 1) step);
        // halve it (on each half's last key) down to an aligned block of
        // 8 keys, then compare the block.  Reads past the set are clamped
        // to its last key, which is < key whenever they happen (q == f),
        // and in_block never reads past the set.
        const int cap = m - 1;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          b[i] = (b[i] + (fence[b[i]] < key[i])) * step;
        }
        for (int len = step; len > kBlockKeys; len >>= 1) {
          const int half = len >> 1;
          int v[kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            v[i] = __ldg(set + min(b[i] + half - 1, cap));
          }
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            b[i] = v[i] < key[i] ? b[i] + half : b[i];
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          hit[i] = in_block(set, m, b[i], key[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t row = base + (int64_t)i * kThreads;
      if (row < n) out[row] = hit[i];
    }
  }
}

}  // namespace

// Launches one probe on ``stream``.  Device pointers: values [n], set [m]
// sorted ascending (duplicates allowed; may be null when m == 0; at most
// 2^30 keys, so no index overflows; 16-byte aligned when m > kSmemKeys),
// out [n] int32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int membership_launch(const int32_t* values, int64_t n,
                                 const int32_t* set, int64_t m, int32_t* out,
                                 void* stream) {
  if (n < 0 || m < 0 || m > (1 << 30) || (m > 0 && set == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  // the set whole, or the last key of every aligned range of step keys:
  // step a power of two, at least one block, at most kFenceKeys ranges
  int step = 1;
  if (m > kSmemKeys) {
    step = kBlockKeys;
    while ((int64_t)step * kFenceKeys < m) step <<= 1;
    if (reinterpret_cast<uintptr_t>(set) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int f = static_cast<int>((m + step - 1) / step);
  const size_t smem = sizeof(int32_t) * f;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(membership_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(int32_t) * kSmemKeys));
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      membership_kernel,
                                                      kThreads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int64_t kTile = (int64_t)kThreads * kRowsPerThread;
  const int64_t need = (n + kTile - 1) / kTile;
  const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  membership_kernel<<<static_cast<unsigned>(need < fit ? need : fit),
                      kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      values, n, set, static_cast<int>(m), f, step, out);
  return static_cast<int>(cudaGetLastError());
}
