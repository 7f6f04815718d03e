// Fused conjunctive-predicate scan for Hopper (sm_90a): the lineage-query
// hot path of PredTrace.
//
// Replaces the TPU kernel ``pred_filter_batch`` of the reference package
// (src/repro/kernels/pred_filter/pred_filter.py), both of its variants:
// ``_kernel_batch`` (comparison atoms) and ``_kernel_batch_sets`` (comparison
// atoms plus ``IN`` atoms searched in sorted per-binding set segments).
// It computes what the TPU kernel computes, bit for bit.  The file also holds
// the single-binding ``pred_filter`` (``_kernel`` there), at the end.
//
// What it computes: for K bindings (rows of ``thr [K, A]``), the
// conjunction of A atoms ``col[atom_col[j]] <op[j]> thr[k, j]`` and M set
// atoms ``col[set_col[m]] IN slab[off[k, m] : off[k, m] + len[k, m]]`` over
// an int32 column slab ``cols [C, N]``; the result is a ``[K, N]`` byte mask
// (0/1, read as torch.bool).
//
// Bound on this card: memory.  Every referenced column is read once
// (4 bytes a row each) and K bytes a row are written; the compares and the
// log2(|set|) probes of a row are far fewer operations than its bytes take
// to move at the card's memory rate.  The comparison variant runs near that
// bound; the set variant is held above it by its searches (below).  The
// design:
//   * one CTA per zone block of ``block_rows`` rows (1024 on the main path),
//     4 consecutive rows per thread, so column loads are 16-byte vector
//     loads and mask stores are 4-byte vector stores, both coalesced;
//   * phase 1 evaluates, from the block's [lo, hi] bounds alone, which
//     bindings can match (``alive[k]`` in shared memory); a block no binding
//     can match writes zeros and never reads its columns
//     (``__syncthreads_or``), as the TPU kernel's ``pl.when`` early-out does;
//   * phase 2 loops over the K bindings, ANDing the A compares and the M
//     segment searches, and stores one byte per (binding, row); the column
//     values of 4 compare atoms at a time are loaded together with __ldg
//     (independent loads, so their latencies overlap), the first binding's
//     reads come from memory and the later bindings' repeat reads hit L1;
//   * the output is bytes, not the TPU kernel's int32: a quarter of the
//     device-to-host readback.
// The IN atoms are where the time goes: a row's lower-bound search is a
// chain of scattered reads, and over random keys those reads, not the
// columns' bytes, set the time (K4's lock-step search takes as long on the
// same keys, and half as long on sorted ones).  The set slab (at most 65,536
// keys on the main path, more than a block's shared memory) stays in global
// memory and L2.  The 4 rows of a thread are searched in lock step: a fixed
// number of halvings, bit_length(len) of the segment (not the reference's
// ``iters``), so 4 independent loads are in flight at each step; a row that
// a compare atom killed searches an empty range at the segment's start, so
// its probes merge with every other dead row's into one broadcast read.
// The search ends at the exact lower bound of the key in its sorted
// segment, which is also where the reference's ``iters`` halvings end when
// ``iters`` = search_iters(longest segment), as its callers pass it; so the
// masks are bit-identical.  ``iters`` bounds only the zone phase's search.
// No index of the set is staged in shared memory: each CTA would stage it
// for its one zone block, and on the main path's launches (q12: K = 1, a
// 2-key set) that staging cost more than the steps it saved (PERF.md).
// The atom program (atom columns, atom ops, set columns) is a runtime int32
// array in device memory, uploaded with the thresholds, so a new predicate
// structure needs no rebuild and a program may hold any number of atoms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 4;
// compare atoms whose column loads are issued together
constexpr int kAtomChunk = 4;
// bindings per launch: alive[] (one byte each) fits the default 48 KB of
// shared memory; the launcher covers larger K with several launches
constexpr int kMaxBindingsPerLaunch = 32768;

// op codes shared with the host: 0:== 1:!= 2:< 3:<= 4:> 5:>=
__device__ __forceinline__ bool cmp(int op, int v, int t) {
  switch (op) {
    case 0: return v == t;
    case 1: return v != t;
    case 2: return v < t;
    case 3: return v <= t;
    case 4: return v > t;
    default: return v >= t;
  }
}

// Can any value in [lo, hi] satisfy ``value <op> t``?  Exact for
// ==, <, <=, >, >=; != prunes only a block whose lo == hi == t.
__device__ __forceinline__ bool zone_alive(int op, int lo, int hi, int t) {
  switch (op) {
    case 0: return lo <= t && t <= hi;
    case 1: return !(lo == hi && lo == t);
    case 2: return lo < t;
    case 3: return lo <= t;
    case 4: return hi > t;
    default: return hi >= t;
  }
}

// Lower bound of ``key`` in slab[seg_lo, seg_hi): exactly ``iters``
// halvings, every gather clamped to ``cap`` = S - 1 — the same steps as the
// reference's ``_lower_bound``, so empty segments stay in bounds and miss.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ slab,
                                           int cap, int key, int lo, int hi,
                                           int iters) {
  for (int it = 0; it < iters; ++it) {
    const bool go = lo < hi;
    const int mid = (lo + hi) >> 1;
    const int v = __ldg(slab + min(mid, cap));
    const bool below = go && v < key;
    lo = below ? mid + 1 : lo;
    hi = (go && !below) ? mid : hi;
  }
  return lo;
}

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

// prog = [atom_col[a], atom_op[a], set_col[m]]
__global__ void pred_filter_batch_kernel(
    const int32_t* __restrict__ cols, int64_t n,
    const int32_t* __restrict__ thr, int k_bind, int a, int m,
    const int32_t* __restrict__ prog,
    const int32_t* __restrict__ blk_lo, const int32_t* __restrict__ blk_hi,
    int64_t g, const int32_t* __restrict__ slab, int s,
    const int32_t* __restrict__ set_off, const int32_t* __restrict__ set_len,
    int iters, uint8_t* __restrict__ out) {
  extern __shared__ uint8_t alive[];  // [k_bind]
  const int32_t* atom_col = prog;
  const int32_t* atom_op = prog + a;
  const int32_t* set_col = prog + 2 * a;
  const int block_rows = blockDim.x * kRowsPerThread;
  const int64_t blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int cap = s - 1;

  // phase 1: which bindings can this block's bounds satisfy?
  int any = 0;
  for (int k = tid; k < k_bind; k += blockDim.x) {
    bool ok = true;
    for (int j = 0; j < a && ok; ++j) {
      ok = zone_alive(__ldg(atom_op + j), blk_lo[j * g + blk],
                      blk_hi[j * g + blk], thr[(int64_t)k * a + j]);
    }
    for (int mm = 0; mm < m && ok; ++mm) {
      const int lo = blk_lo[(a + mm) * g + blk];
      const int hi = blk_hi[(a + mm) * g + blk];
      const int seg_lo = set_off[(int64_t)k * m + mm];
      const int seg_hi = seg_lo + set_len[(int64_t)k * m + mm];
      const int pos = lower_bound(slab, cap, lo, seg_lo, seg_hi, iters);
      ok = pos < seg_hi && __ldg(slab + min(pos, cap)) <= hi;
    }
    alive[k] = ok ? 1 : 0;
    any |= ok ? 1 : 0;
  }
  any = __syncthreads_or(any);

  const int64_t row0 = blk * block_rows + (int64_t)tid * kRowsPerThread;
  if (!any) {
    for (int k = 0; k < k_bind; ++k) {
      *reinterpret_cast<uchar4*>(out + (int64_t)k * n + row0) =
          make_uchar4(0, 0, 0, 0);
    }
    return;
  }

  // phase 2: every binding over the thread's 4 rows
  for (int k = 0; k < k_bind; ++k) {
    bool r[kRowsPerThread];
    bool live = alive[k] != 0;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) r[i] = live;
    const int32_t* t = thr + (int64_t)k * a;
    for (int j0 = 0; j0 < a && live; j0 += kAtomChunk) {
      // issue the chunk's loads together; past the end, the last atom
      // repeats (ANDing an atom twice changes nothing)
      int op[kAtomChunk], tj[kAtomChunk];
      int4 v4[kAtomChunk];
#pragma unroll
      for (int u = 0; u < kAtomChunk; ++u) {
        const int j = min(j0 + u, a - 1);
        op[u] = __ldg(atom_op + j);
        tj[u] = t[j];
        v4[u] = __ldg(reinterpret_cast<const int4*>(
            cols + (int64_t)__ldg(atom_col + j) * n + row0));
      }
#pragma unroll
      for (int u = 0; u < kAtomChunk; ++u) {
        const int v[kRowsPerThread] = {v4[u].x, v4[u].y, v4[u].z, v4[u].w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          r[i] = r[i] && cmp(op[u], v[i], tj[u]);
        }
      }
      live = r[0] || r[1] || r[2] || r[3];
    }
    for (int mm = 0; mm < m && live; ++mm) {
      const int seg = k * m + mm;
      const int seg_lo = set_off[seg];
      const int len = set_len[seg];
      const int seg_hi = seg_lo + len;
      const int4 v4 = __ldg(reinterpret_cast<const int4*>(
          cols + (int64_t)__ldg(set_col + mm) * n + row0));
      const int x[kRowsPerThread] = {v4.x, v4.y, v4.z, v4.w};
      // a dead row searches an empty range at seg_lo: its probes all read
      // the same slab word as every other dead row's, one broadcast read
      int lo[kRowsPerThread], hi[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        lo[i] = seg_lo;
        hi[i] = r[i] ? seg_hi : seg_lo;
      }
      const int steps = bit_length(len);
      // lower bound in the slab, the 4 rows in lock step, every read clamped
      // to the slab (an empty segment may sit at its end)
      for (int it = 0; it < steps; ++it) {
        int sv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          sv[i] = __ldg(slab + min((lo[i] + hi[i]) >> 1, cap));
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const bool go = lo[i] < hi[i];
          const int mid = (lo[i] + hi[i]) >> 1;
          const bool below = go && sv[i] < x[i];
          lo[i] = below ? mid + 1 : lo[i];
          hi[i] = (go && !below) ? mid : hi[i];
        }
      }
      live = false;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        r[i] = r[i] && lo[i] < seg_hi && __ldg(slab + min(lo[i], cap)) == x[i];
        live = live || r[i];
      }
    }
    *reinterpret_cast<uchar4*>(out + (int64_t)k * n + row0) =
        make_uchar4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace

// Launches one fused scan on ``stream`` (several launches when k_bind
// exceeds kMaxBindingsPerLaunch).  Device pointers: cols [c, n], thr [k, a],
// prog [2a + m] (atom columns, atom ops, set columns), blk_lo/blk_hi
// [a + m, n / block_rows], slab [s], set_off/set_len [k, m], out [k, n].
// Requires n a multiple of block_rows, block_rows a multiple of 128 and at
// most 4096, cols 16-byte and out 4-byte aligned, and s >= 1 when m > 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pred_filter_batch_launch(
    const int32_t* cols, int64_t n, int block_rows, const int32_t* thr,
    int k_bind, int a, int m, const int32_t* prog, const int32_t* blk_lo,
    const int32_t* blk_hi, const int32_t* slab, int s, const int32_t* set_off,
    const int32_t* set_len, int iters, uint8_t* out, void* stream) {
  if (a < 0 || m < 0 || k_bind < 0 || block_rows <= 0 ||
      block_rows % (32 * kRowsPerThread) != 0 || block_rows > 4096 ||
      n < 0 || n % block_rows != 0 || (m > 0 && s < 1) ||
      (a + m > 0 && prog == nullptr) ||
      reinterpret_cast<uintptr_t>(cols) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = block_rows / kRowsPerThread;
  const int64_t g = n / block_rows;
  if (g == 0) return 0;
  for (int k0 = 0; k0 < k_bind; k0 += kMaxBindingsPerLaunch) {
    const int kc = min(k_bind - k0, kMaxBindingsPerLaunch);
    pred_filter_batch_kernel<<<static_cast<unsigned>(g), threads, kc,
                               static_cast<cudaStream_t>(stream)>>>(
        cols, n, thr + (int64_t)k0 * a, kc, a, m, prog, blk_lo, blk_hi, g,
        slab, s, m ? set_off + (int64_t)k0 * m : nullptr,
        m ? set_len + (int64_t)k0 * m : nullptr, iters, out + (int64_t)k0 * n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// --------------------------------------------------------------------------
// Single-binding scan: replaces the TPU kernel ``pred_filter`` (``_kernel``
// in src/repro/kernels/pred_filter/pred_filter.py), the kernel behind the
// reference's ``scan_mask``.  One binding: the AND of A compares
// ``col[atom_col[j]] <op[j]> thr[j]`` over ``cols [C, N]``, written as an
// int32 0/1 mask ``[N]``, with no zone phase (the TPU kernel has none).
//
// Bound on this card: memory.  Each referenced column is read once (4 bytes
// a row) and 4 bytes a row are written; A compares a row cost far less than
// those bytes.  Each thread takes 4 consecutive rows, so column loads are
// 16-byte __ldg loads and the mask store one 16-byte store, all coalesced;
// the loads of 4 atoms are issued together so their latencies overlap.
// The program (atom columns, atom ops) is a device array, as for the batched
// kernel, so a new predicate needs no rebuild.
// --------------------------------------------------------------------------

namespace {

template <bool kVec>
__global__ void pred_filter_kernel(const int32_t* __restrict__ cols,
                                   int64_t n, const int32_t* __restrict__ thr,
                                   int a, const int32_t* __restrict__ prog,
                                   int32_t* __restrict__ out) {
  const int32_t* atom_col = prog;
  const int32_t* atom_op = prog + a;
  const int64_t row0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kRowsPerThread;
  if (row0 >= n) return;
  bool r[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) r[i] = true;
  for (int j0 = 0; j0 < a; j0 += kAtomChunk) {
    // past the end the last atom repeats (ANDing an atom twice changes
    // nothing)
    int op[kAtomChunk], tj[kAtomChunk], v[kAtomChunk][kRowsPerThread];
#pragma unroll
    for (int u = 0; u < kAtomChunk; ++u) {
      const int j = min(j0 + u, a - 1);
      op[u] = __ldg(atom_op + j);
      tj[u] = __ldg(thr + j);
      const int32_t* c = cols + (int64_t)__ldg(atom_col + j) * n + row0;
      if (kVec) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(c));
        v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          v[u][i] = row0 + i < n ? __ldg(c + i) : 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAtomChunk; ++u) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        r[i] = r[i] && cmp(op[u], v[u][i], tj[u]);
      }
    }
  }
  if (kVec) {
    *reinterpret_cast<int4*>(out + row0) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (row0 + i < n) out[row0 + i] = r[i];
    }
  }
}

}  // namespace

// Launches one single-binding scan on ``stream``.  Device pointers: cols
// [c, n], thr [a], prog [2a] (atom columns, then atom ops), out [n] int32.
// Any n; the 16-byte path is taken when n % 4 == 0 and cols and out are
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pred_filter_launch(const int32_t* cols, int64_t n,
                                  const int32_t* thr, int a,
                                  const int32_t* prog, int32_t* out,
                                  void* stream) {
  if (n < 0 || a < 0 || (a > 0 && (prog == nullptr || thr == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t groups = (n + kRowsPerThread - 1) / kRowsPerThread;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  const bool vec = n % kRowsPerThread == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    pred_filter_kernel<true><<<blocks, kThreads, 0, st>>>(cols, n, thr, a,
                                                           prog, out);
  } else {
    pred_filter_kernel<false><<<blocks, kThreads, 0, st>>>(cols, n, thr, a,
                                                            prog, out);
  }
  return static_cast<int>(cudaGetLastError());
}
