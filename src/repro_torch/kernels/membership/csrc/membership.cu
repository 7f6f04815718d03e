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
// ascending (the wrapper sorts it on the device first), O(N log M) loads.
// The set is at most a few MB and stays in the 50 MB L2; it is read with
// __ldg.
//
// Bound on this card: the search is a chain of log2(M) dependent loads from
// L2 per value, so its latency, not the N x 8 bytes of values and mask, sets
// the time.  Each thread runs the searches of 4 values in lock step (a fixed
// ``bit_length(M)`` halvings with clamped reads, as the batched kernel's
// set search does), so 4 independent loads are in flight per step; the 4
// values are 256 rows apart, so every load and store of a warp is
// coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__global__ void membership_kernel(const int32_t* __restrict__ values,
                                  int64_t n, const int32_t* __restrict__ set,
                                  int m, int iters,
                                  int32_t* __restrict__ out) {
  const int64_t base =
      (int64_t)blockIdx.x * kThreads * kRowsPerThread + threadIdx.x;
  const int cap = m - 1;
  int key[kRowsPerThread], lo[kRowsPerThread], hi[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = base + (int64_t)i * kThreads;
    key[i] = row < n ? __ldg(values + row) : 0;
    lo[i] = 0;
    hi[i] = m;
  }
  for (int it = 0; it < iters; ++it) {
    int v[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      v[i] = __ldg(set + min((lo[i] + hi[i]) >> 1, cap));
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const bool go = lo[i] < hi[i];
      const int mid = (lo[i] + hi[i]) >> 1;
      const bool below = go && v[i] < key[i];
      lo[i] = below ? mid + 1 : lo[i];
      hi[i] = (go && !below) ? mid : hi[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = base + (int64_t)i * kThreads;
    if (row < n) {
      out[row] = lo[i] < m && __ldg(set + min(lo[i], cap)) == key[i];
    }
  }
}

}  // namespace

// Launches one probe on ``stream``.  Device pointers: values [n], set [m]
// sorted ascending (duplicates allowed; may be null when m == 0; at most
// 2^30 keys, so lo + hi never overflows), out [n] int32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int membership_launch(const int32_t* values, int64_t n,
                                 const int32_t* set, int64_t m, int32_t* out,
                                 void* stream) {
  if (n < 0 || m < 0 || m > (1 << 30) || (m > 0 && set == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int iters = 0;  // bit_length(m): enough halvings to collapse [0, m)
  for (int64_t x = m; x > 0; x >>= 1) ++iters;
  constexpr int64_t kRowsPerBlock = kThreads * kRowsPerThread;
  const unsigned blocks =
      static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  membership_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, n, set, static_cast<int>(m), iters, out);
  return static_cast<int>(cudaGetLastError());
}
