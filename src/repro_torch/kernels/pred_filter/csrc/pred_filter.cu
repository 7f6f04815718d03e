// Fused conjunctive-predicate scan for Hopper (sm_90a): the lineage-query
// hot path of PredTrace.
//
// Replaces the TPU kernel ``pred_filter_batch`` of the reference package
// (src/repro/kernels/pred_filter/pred_filter.py), both of its variants:
// ``_kernel_batch`` (comparison atoms; ``pred_filter_cmp_kernel`` here) and
// ``_kernel_batch_sets`` (comparison atoms plus ``IN`` atoms searched in
// sorted per-binding set segments; ``pred_filter_batch_kernel`` here).
// Both compute what the TPU kernel computes, bit for bit.  The file also
// holds the single-binding ``pred_filter`` (``_kernel`` there), at the end.
//
// What it computes: for K bindings (rows of ``thr [K, A]``), the
// conjunction of A atoms ``col[atom_col[j]] <op[j]> thr[k, j]`` and M set
// atoms ``col[set_col[m]] IN slab[off[k, m] : off[k, m] + len[k, m]]`` over
// an int32 column slab ``cols [C, N]``; the result is a ``[K, N]`` byte mask
// (0/1, read as torch.bool).  The output is bytes, not the TPU kernel's
// int32: a quarter of the device-to-host readback.
//
// Bound on this card: memory.  Every referenced column is read once
// (4 bytes a row each) and K bytes a row are written; the compares and the
// log2(|set|) probes of a row are far fewer operations than its bytes take
// to move at the card's memory rate.
//
// Comparison variant (M = 0, the main path's largest launches).  What held
// the first design (one CTA per 1024-row zone block) to a third of the
// bound: each CTA read its block's bounds and thresholds, waited at a
// CTA-wide barrier, and only then loaded its 4 KB of column; two dependent
// DRAM round trips per 4 KB, with at most 8 such CTAs on an SM, kept too
// few bytes in flight.  For K > 1 it reloaded every column through L1 once
// per binding.  ``pred_filter_cmp_kernel`` instead:
//   * runs a persistent grid: a few CTAs an SM, each warp owning whole zone
//     blocks in a grid stride, so there is no CTA-wide barrier at all;
//   * decides a block's live bindings with a warp vote (``__ballot_sync``;
//     for K = 1 the lanes split the atoms and vote with ``__all_sync``) into
//     an alive bitmap in shared memory, and decides the *next* block's
//     bitmap while the current block's column loads are in flight (two
//     bitmaps a warp, used in turn);
//   * keeps 8 (one atom) or 16 (more atoms) 16-byte column loads in flight
//     a lane: a pass covers 8 or 4 chunks of 128 rows, one int4 a lane a
//     chunk, so every load and every mask store of a warp is coalesced;
//   * reads each held column of a pass (the first 1 or 4 atoms) once into
//     registers and reuses it for all K bindings; atoms past those are read
//     per binding through L1;
//   * writes a dead block's zero tile with 16-byte stores and never reads
//     its columns, as the TPU kernel's ``pl.when`` early-out does.
// Set variant (M > 0): the IN atoms are where the time goes: a row's
// lower-bound search is a chain of scattered reads, and over random keys
// those reads, not the columns' bytes, set the time.  It keeps its own
// kernel, one CTA per zone block (block decision in ``alive[]`` shared
// memory, ``__syncthreads_or`` early-out), because its time is the search
// and not the schedule.  The set slab (at most 65,536 keys on the main path,
// more than a block's shared memory) stays in global memory and L2.  The 4
// rows of a thread are searched in lock step: a fixed number of halvings,
// bit_length(len) of the segment (not the reference's ``iters``), so 4
// independent loads are in flight at each step; a row that a compare atom
// killed searches an empty range at the segment's start, so its probes
// merge with every other dead row's into one broadcast read.  The search
// ends at the exact lower bound of the key in its sorted segment, which is
// also where the reference's ``iters`` halvings end when ``iters`` =
// search_iters(longest segment), as its callers pass it; so the masks are
// bit-identical.  ``iters`` bounds only the zone phase's search.  No index
// of the set is staged in shared memory: each CTA would stage it for its
// one zone block, and on the main path's launches (q12: K = 1, a 2-key set)
// that staging cost more than the steps it saved (PERF.md).
// The atom program (atom columns, atom ops, set columns) is a runtime int32
// array in device memory, uploaded with the thresholds, so a new predicate
// structure needs no rebuild and a program may hold any number of atoms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 4;
// compare atoms whose column loads are issued together
constexpr int kAtomChunk = 4;
// bindings per launch of the set kernel: alive[] (one byte each) fits the
// default 48 KB of shared memory; the launcher covers larger K with several
// launches
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

// ---- comparison variant (M = 0) -----------------------------------------

constexpr int kCmpThreads = 256;
constexpr int kCmpWarps = kCmpThreads / 32;
// rows of a chunk: 32 lanes x one int4 (4 rows) each
constexpr int kChunkRows = 128;
// bindings per launch of the comparison kernel: a warp keeps two alive
// bitmaps of ceil(K / 32) words, 16 KB of shared memory a CTA at 8,192
constexpr int kMaxCmpBindingsPerLaunch = 8192;

__device__ __forceinline__ uint32_t pack4(bool x, bool y, bool z, bool w) {
  return static_cast<uint32_t>(x) | (static_cast<uint32_t>(y) << 8) |
         (static_cast<uint32_t>(z) << 16) | (static_cast<uint32_t>(w) << 24);
}

// 4 rows against one threshold, as 4 mask bytes (0/1) in one word: a
// binding's words are ANDed atom by atom and stored as they are (packing
// each compare at once measured faster than chaining predicates across
// atoms, which run out of predicate registers at 32 rows a lane)
__device__ __forceinline__ uint32_t cmp4(int op, int4 v, int t) {
  switch (op) {
    case 0: return pack4(v.x == t, v.y == t, v.z == t, v.w == t);
    case 1: return pack4(v.x != t, v.y != t, v.z != t, v.w != t);
    case 2: return pack4(v.x < t, v.y < t, v.z < t, v.w < t);
    case 3: return pack4(v.x <= t, v.y <= t, v.z <= t, v.w <= t);
    case 4: return pack4(v.x > t, v.y > t, v.z > t, v.w > t);
    default: return pack4(v.x >= t, v.y >= t, v.z >= t, v.w >= t);
  }
}

// The warp's alive bitmap of zone block ``blk``: bit k % 32 of words[k / 32]
// says whether binding k can match, from the block's bounds alone.  Returns
// whether any binding can.  Every lane of the warp calls it.
__device__ __forceinline__ bool cmp_zone(
    int64_t blk, int kc, int a, const int32_t* __restrict__ thr,
    const int32_t* __restrict__ atom_op, const int32_t* __restrict__ blk_lo,
    const int32_t* __restrict__ blk_hi, int64_t g, uint32_t* words,
    int lane) {
  uint32_t any = 0;
  if (kc == 1) {  // one binding: the lanes split its atoms
    bool ok = true;
    for (int j = lane; j < a; j += 32) {
      ok = ok & zone_alive(__ldg(atom_op + j), __ldg(blk_lo + j * g + blk),
                           __ldg(blk_hi + j * g + blk), __ldg(thr + j));
    }
    any = __all_sync(0xffffffffu, ok) ? 1u : 0u;
    if (lane == 0) words[0] = any;
  } else {  // a lane a binding, 32 bindings a vote
    for (int w = 0; w * 32 < kc; ++w) {
      const int k = w * 32 + lane;
      bool ok = k < kc;
      if (ok) {
        const int32_t* t = thr + (int64_t)k * a;
#pragma unroll 4
        for (int j = 0; j < a; ++j) {
          ok = ok & zone_alive(__ldg(atom_op + j), __ldg(blk_lo + j * g + blk),
                               __ldg(blk_hi + j * g + blk), __ldg(t + j));
        }
      }
      const uint32_t word = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) words[w] = word;
      any |= word;
    }
  }
  __syncwarp();
  return any != 0;
}

// P chunks of 128 rows a pass (P int4 loads a lane per held atom); the
// first H atoms of a pass are held in registers for all K bindings; kMore:
// the program may have atoms past those.
// prog = [atom_col[a], atom_op[a]]
template <int P, int H, int kMinBlocks, bool kMore>
__global__ void __launch_bounds__(kCmpThreads, kMinBlocks)
pred_filter_cmp_kernel(const int32_t* __restrict__ cols, int64_t n,
                       int block_rows, const int32_t* __restrict__ thr,
                       int kc, int a, const int32_t* __restrict__ prog,
                       const int32_t* __restrict__ blk_lo,
                       const int32_t* __restrict__ blk_hi, int64_t g,
                       uint8_t* __restrict__ out) {
  extern __shared__ uint32_t alive_bits[];  // [warps][2][ceil(kc / 32)]
  const int32_t* atom_col = prog;
  const int32_t* atom_op = prog + a;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = (kc + 31) >> 5;
  uint32_t* const bits = alive_bits + warp * 2 * words;
  const int chunks = block_rows / kChunkRows;
  const int held = min(a, H);
  const int64_t stride = (int64_t)gridDim.x * kCmpWarps;
  int64_t blk = (int64_t)blockIdx.x * kCmpWarps + warp;
  if (blk >= g) return;
  int cur = 0;  // which of the warp's two bitmaps is this block's
  bool any = cmp_zone(blk, kc, a, thr, atom_op, blk_lo, blk_hi, g, bits,
                      lane);
  for (; blk < g; blk += stride) {
    const int64_t next = blk + stride;
    const int64_t row_blk = blk * block_rows;
    const uint32_t* alive = bits + cur * words;
    uint32_t* alive_next = bits + (cur ^ 1) * words;
    bool any_next = false;
    if (!any) {
      // no binding can match: a zero tile, 16-byte stores, no column read
      for (int k = 0; k < kc; ++k) {
        uint4* o = reinterpret_cast<uint4*>(out + (int64_t)k * n + row_blk);
        for (int i = lane; i < block_rows / 16; i += 32) {
          o[i] = make_uint4(0, 0, 0, 0);
        }
      }
      if (next < g) {
        any_next = cmp_zone(next, kc, a, thr, atom_op, blk_lo, blk_hi, g,
                            alive_next, lane);
      }
    } else {
      for (int c0 = 0; c0 < chunks; c0 += P) {
        // the pass's values of the held atoms, loaded once for all bindings
        int op[H];
        int4 v[H][P];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          op[h] = 0;
#pragma unroll
          for (int p = 0; p < P; ++p) v[h][p] = make_int4(0, 0, 0, 0);
          if (h < held) {
            op[h] = __ldg(atom_op + h);
            const int32_t* c = cols + (int64_t)__ldg(atom_col + h) * n +
                               row_blk + c0 * kChunkRows + lane * 4;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              if (c0 + p < chunks) {
                v[h][p] = __ldg(reinterpret_cast<const int4*>(c + p * kChunkRows));
              }
            }
          }
        }
        // the next block's zone decision, while these loads are in flight
        if (c0 == 0 && next < g) {
          any_next = cmp_zone(next, kc, a, thr, atom_op, blk_lo, blk_hi, g,
                              alive_next, lane);
        }
        for (int k = 0; k < kc; ++k) {
          const bool live = (alive[k >> 5] >> (k & 31)) & 1u;
          uint32_t r[P];
#pragma unroll
          for (int p = 0; p < P; ++p) r[p] = live ? 0x01010101u : 0u;
          if (live) {
            const int32_t* t = thr + (int64_t)k * a;
#pragma unroll
            for (int h = 0; h < H; ++h) {
              if (h < held) {
                const int th = __ldg(t + h);
#pragma unroll
                for (int p = 0; p < P; ++p) r[p] &= cmp4(op[h], v[h][p], th);
              }
            }
            // atoms past the held ones, one at a time, read through L1 for
            // each binding, until the lane's rows are all dead
            if constexpr (kMore) {
              for (int j = H; j < a; ++j) {
                uint32_t rows_live = 0;
#pragma unroll
                for (int p = 0; p < P; ++p) rows_live |= r[p];
                if (!rows_live) break;
                const int opj = __ldg(atom_op + j);
                const int tj = __ldg(t + j);
                const int32_t* c = cols + (int64_t)__ldg(atom_col + j) * n +
                                   row_blk + c0 * kChunkRows + lane * 4;
#pragma unroll
                for (int p = 0; p < P; ++p) {
                  if (c0 + p < chunks) {
                    r[p] &= cmp4(opj, __ldg(reinterpret_cast<const int4*>(
                                          c + p * kChunkRows)),
                                 tj);
                  }
                }
              }
            }
          }
          uint8_t* o = out + (int64_t)k * n + row_blk + c0 * kChunkRows + lane * 4;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (c0 + p < chunks) {
              *reinterpret_cast<uint32_t*>(o + p * kChunkRows) = r[p];
            }
          }
        }
      }
    }
    any = any_next;
    cur ^= 1;
  }
}

// One launch of the comparison kernel per binding slice, on a persistent
// grid: as many CTAs as fit the card at once (occupancy at this shared
// memory), never more than the zone blocks need.
template <int P, int H, int kMinBlocks, bool kMore>
int launch_cmp(const int32_t* cols, int64_t n, int block_rows,
               const int32_t* thr, int k_bind, int a, const int32_t* prog,
               const int32_t* blk_lo, const int32_t* blk_hi, int64_t g,
               uint8_t* out, cudaStream_t stream) {
  const auto kernel = pred_filter_cmp_kernel<P, H, kMinBlocks, kMore>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k0 = 0; k0 < k_bind; k0 += kMaxCmpBindingsPerLaunch) {
    const int kc = min(k_bind - k0, kMaxCmpBindingsPerLaunch);
    const size_t smem = sizeof(uint32_t) * kCmpWarps * 2 * ((kc + 31) / 32);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kCmpThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t need = (g + kCmpWarps - 1) / kCmpWarps;
    const int64_t fit = (int64_t)sms * max(per_sm, 1);
    kernel<<<static_cast<unsigned>(min(need, fit)), kCmpThreads, smem,
             stream>>>(cols, n, block_rows, thr + (int64_t)k0 * a, kc, a,
                       prog, blk_lo, blk_hi, g, out + (int64_t)k0 * n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// Launches one fused scan on ``stream`` (several launches when k_bind
// exceeds a kernel's bindings per launch): the comparison kernel when m is
// 0, the set kernel otherwise.  Device pointers: cols [c, n], thr [k, a],
// prog [2a + m] (atom columns, atom ops, set columns), blk_lo/blk_hi
// [a + m, n / block_rows], slab [s], set_off/set_len [k, m], out [k, n].
// Requires n a multiple of block_rows, block_rows a multiple of 128 and at
// most 4096, cols and out 16-byte aligned, and s >= 1 when m > 0.
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
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t g = n / block_rows;
  if (g == 0 || k_bind == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    // one atom: 8 chunks (1,024 rows) a pass; more: 4 chunks, 4 atoms held
    if (a <= 1) {
      return launch_cmp<8, 1, 3, false>(cols, n, block_rows, thr, k_bind, a, prog,
                                 blk_lo, blk_hi, g, out, st);
    }
    return launch_cmp<4, 4, 2, true>(cols, n, block_rows, thr, k_bind, a, prog,
                               blk_lo, blk_hi, g, out, st);
  }
  const int threads = block_rows / kRowsPerThread;
  for (int k0 = 0; k0 < k_bind; k0 += kMaxBindingsPerLaunch) {
    const int kc = min(k_bind - k0, kMaxBindingsPerLaunch);
    pred_filter_batch_kernel<<<static_cast<unsigned>(g), threads, kc, st>>>(
        cols, n, thr + (int64_t)k0 * a, kc, a, m, prog, blk_lo, blk_hi, g,
        slab, s, set_off + (int64_t)k0 * m, set_len + (int64_t)k0 * m, iters,
        out + (int64_t)k0 * n);
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
