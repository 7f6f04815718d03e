"""Compressed columnar intermediate store with in-situ predicate scans.

PredTrace's precise-lineage path (Algorithm 1) hinges on saving intermediate
results, which is exactly the cost the paper calls out as making
materialization "not viable" at scale.  This module makes that cost small:
materialized stages are stored as *encoded* columns — picked per column by a
stats pass — and the lineage-query scans run **in situ** on the encoded form,
decoding a column only when an atom genuinely needs the raw values.

Encodings (one :class:`EncodedColumn` subclass each):

* **dict**    — low-cardinality columns: small-int codes into the *sorted*
                unique values.  Because the code order equals the value order,
                every comparison atom ``col <op> v`` rewrites to a code-space
                comparison against ``searchsorted(values, v)`` — no decode.
* **rle**     — run-heavy columns: (run value, run length) pairs.  Atoms are
                evaluated once per *run* and the run mask expanded, so a scan
                touches ``n_runs`` elements instead of ``n`` rows.
* **for**     — frame-of-reference: integers re-based at their minimum and
                bit-packed into the smallest unsigned dtype that holds the
                range.  Atoms compare the packed lanes against the shifted
                threshold ``v - base``.
* **delta**   — sorted integer ids: per-block anchors + intra-block deltas in
                a small dtype.  A comparison atom becomes an O(block + log
                n_blocks) binary search over the anchors (decode exactly one
                block), producing a contiguous row range — the compressed
                analogue of pruning RLE runs by run value.
* **bitpack** — booleans / validity masks at one bit per row (``packbits``).
* **plain**   — the identity fallback; never worse than the raw column.

The stats pass (:func:`analyze_column` + :func:`choose_encoding`) estimates
the encoded size of every applicable encoding *without encoding* — that is
what picks each column's encoding, and :func:`estimate_table_nbytes` exposes
it for pre-run sizing.  The budget-aware materialization planner
(``plan.plan_materialization``) then decides which stages to keep from the
store's *actual* encoded sizes after the pipeline-execution phase.

:class:`InSituBackend` consumes the ScanEngine's compiled
:class:`~repro_torch.core.scan.AtomProgram` representation unchanged: comparison
and membership atoms take the encoded path above when the column's encoding
supports them and fall back **per atom** to the NumPy oracle over a lazily
decoded column cache, so in-situ answers are bit-identical to scanning the
decoded table.

:class:`IntermediateStore` is the executor-facing container: stages are
``put()`` during the pipeline-execution phase, queried through ``scan()``
(in situ) or ``table()`` (decoded, cached), and ``evict()``-ed by the budget
planner.  This is the RAM tier; the reference's disk tier and checkpoint
spill are not part of this package yet.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from .expr import eval_np
from .scan import (
    EQ, OPS, _NP_CMP, AtomProgram, LRUCache, NumpyBackend, ScanEngine,
    _is_setlike, partition_safe, prune_zone_maps,
)
from .table import (
    RID, Table, ZoneMaps, build_zone_maps, next_table_uid, resolve_part_rows,
    rows_of_alive,
)

_EQ, _NE = OPS["=="], OPS["!="]
_LT, _LE, _GT, _GE = OPS["<"], OPS["<="], OPS[">"], OPS[">="]

_MISSING = object()

DELTA_BLOCK = 1024  # rows per delta-encoding block (one anchor each)


def _is_nan(v) -> bool:
    if type(v) is int:  # the overwhelmingly common binding type
        return False
    try:
        return bool(v != v)
    except (TypeError, ValueError):
        return False


def _const_mask(op: int, n: int, true_ops: Tuple[int, ...]) -> np.ndarray:
    return np.ones(n, bool) if op in true_ops else np.zeros(n, bool)


# --------------------------------------------------------------------------- #
# encoded columns
# --------------------------------------------------------------------------- #


class EncodedColumn:
    """One encoded column: decode / gather plus optional in-situ atom masks.

    ``cmp_mask`` / ``isin_mask`` return ``None`` when the encoding cannot
    answer the atom without decoding — the caller falls back to the oracle.
    """

    kind = "plain"
    n: int
    dtype: np.dtype

    def decode(self) -> np.ndarray:
        raise NotImplementedError

    def gather(self, idx: np.ndarray) -> np.ndarray:
        return self.decode()[idx]

    def nbytes(self) -> int:
        raise NotImplementedError

    def cmp_mask(self, op: int, v) -> Optional[np.ndarray]:
        return None

    def isin_mask(self, vals: np.ndarray) -> Optional[np.ndarray]:
        return None

class PlainColumn(EncodedColumn):
    kind = "plain"

    def __init__(self, values: np.ndarray):
        self.values = values
        self.n = len(values)
        self.dtype = values.dtype

    def decode(self):
        return self.values

    def gather(self, idx):
        return self.values[idx]

    def nbytes(self):
        return int(self.values.nbytes)

    def cmp_mask(self, op, v):
        return _NP_CMP[op](self.values, v)

    def isin_mask(self, vals):
        return np.isin(self.values, vals)

class DictColumn(EncodedColumn):
    """Codes into the sorted unique values; comparisons stay in code space."""

    kind = "dict"

    def __init__(self, codes: np.ndarray, values: np.ndarray):
        self.codes = codes
        self.values = values
        self.n = len(codes)
        self.dtype = values.dtype

    @staticmethod
    def encode(arr: np.ndarray) -> "DictColumn":
        values, codes = np.unique(arr, return_inverse=True)
        return DictColumn(codes.astype(_code_dtype(len(values))), values)

    def decode(self):
        return self.values[self.codes]

    def gather(self, idx):
        return self.values[self.codes[idx]]

    def nbytes(self):
        return int(self.codes.nbytes + self.values.nbytes)

    def cmp_mask(self, op, v):
        if _is_nan(v):  # IEEE: NaN compares False everywhere except !=
            return _const_mask(op, self.n, (_NE,))
        codes = self.codes
        if op == _EQ or op == _NE:
            # values are unique, so one search + one scalar probe suffices
            lo = int(self.values.searchsorted(v, side="left"))
            present = lo < len(self.values) and self.values[lo] == v
            if op == _EQ:
                return codes == lo if present else np.zeros(self.n, bool)
            return codes != lo if present else np.ones(self.n, bool)
        if op == _LT or op == _GE:
            lo = int(self.values.searchsorted(v, side="left"))
            return codes < lo if op == _LT else codes >= lo
        hi = int(self.values.searchsorted(v, side="right"))
        return codes < hi if op == _LE else codes >= hi  # _LE / _GT

    def isin_mask(self, vals):
        arr = np.asarray(vals)
        if arr.size == 0:
            return np.zeros(self.n, bool)
        nu = len(self.values)
        pos = np.minimum(np.searchsorted(self.values, arr), nu - 1)
        hit = self.values[pos] == arr  # NaN never matches (np.isin semantics)
        lut = np.zeros(nu, bool)
        lut[pos[hit]] = True
        return lut[self.codes]

class RLEColumn(EncodedColumn):
    """Run-length encoding; atoms evaluate per run and expand the run mask."""

    kind = "rle"

    def __init__(self, run_values: np.ndarray, run_lengths: np.ndarray):
        self.run_values = run_values
        self.run_lengths = run_lengths
        self.n = int(run_lengths.sum())
        self.dtype = run_values.dtype
        self._ends: Optional[np.ndarray] = None

    @staticmethod
    def encode(arr: np.ndarray) -> "RLEColumn":
        n = len(arr)
        starts = np.concatenate([[0], np.flatnonzero(arr[1:] != arr[:-1]) + 1])
        lengths = np.diff(np.concatenate([starts, [n]])).astype(np.int32)
        return RLEColumn(arr[starts], lengths)

    def _run_ends(self) -> np.ndarray:
        if self._ends is None:
            self._ends = np.cumsum(self.run_lengths)
        return self._ends

    def decode(self):
        return np.repeat(self.run_values, self.run_lengths)

    def gather(self, idx):
        ri = np.searchsorted(self._run_ends(), np.asarray(idx), side="right")
        return self.run_values[ri]

    def nbytes(self):
        return int(self.run_values.nbytes + self.run_lengths.nbytes)

    def cmp_mask(self, op, v):
        return np.repeat(_NP_CMP[op](self.run_values, v), self.run_lengths)

    def isin_mask(self, vals):
        return np.repeat(np.isin(self.run_values, vals), self.run_lengths)

class FORColumn(EncodedColumn):
    """Frame-of-reference: ``value = packed + base`` with packed unsigned."""

    kind = "for"

    def __init__(self, packed: np.ndarray, base: int, dtype: np.dtype):
        self.packed = packed
        self.base = int(base)
        self.n = len(packed)
        self.dtype = np.dtype(dtype)

    @staticmethod
    def encode(arr: np.ndarray, pack_dtype: np.dtype) -> "FORColumn":
        base = int(arr.min())
        packed = (arr.astype(np.int64) - base).astype(pack_dtype)
        return FORColumn(packed, base, arr.dtype)

    def decode(self):
        return (self.packed.astype(np.int64) + self.base).astype(self.dtype)

    def gather(self, idx):
        return (self.packed[idx].astype(np.int64) + self.base).astype(self.dtype)

    def nbytes(self):
        return int(self.packed.nbytes)

    def cmp_mask(self, op, v):
        if _is_nan(v):
            return _const_mask(op, self.n, (_NE,))
        # shift the threshold into frame space; numpy compares python scalars
        # outside the packed dtype's range exactly (no wraparound)
        t = (int(v) if isinstance(v, (int, np.integer)) else float(v)) - self.base
        return _NP_CMP[op](self.packed, t)

    def isin_mask(self, vals):
        arr = np.asarray(vals)
        if arr.size == 0:
            return np.zeros(self.n, bool)
        if arr.dtype.kind == "f":
            t = arr - float(self.base)
        else:
            t = arr.astype(np.int64) - self.base
        return np.isin(self.packed.astype(np.int64), t)

class DeltaColumn(EncodedColumn):
    """Sorted integers as per-block anchors + small intra-block deltas.

    Comparison atoms binary-search the anchors, decode exactly one block, and
    return a contiguous index range — O(block + log n_blocks) per atom
    instead of an O(n) scan."""

    kind = "delta"

    def __init__(self, anchors: np.ndarray, deltas: np.ndarray, n: int,
                 dtype: np.dtype, block: int = DELTA_BLOCK):
        self.anchors = anchors  # value at each block start, original dtype
        self.deltas = deltas    # 1-D length n, small unsigned; block starts 0
        self.n = n
        self.dtype = np.dtype(dtype)
        self.block = block
        # touched-block cache: comparisons and gathers revisit the same few
        # blocks; worst case (every block touched) it holds the decoded
        # column, i.e. it degrades to the lazy decode the fallback path pays
        self._bcache: Dict[int, np.ndarray] = {}

    @staticmethod
    def encode(arr: np.ndarray, delta_dtype: np.dtype,
               block: int = DELTA_BLOCK) -> "DeltaColumn":
        n = len(arr)
        d = np.zeros(n, dtype=np.int64)
        d[1:] = arr.astype(np.int64)[1:] - arr.astype(np.int64)[:-1]
        d[::block] = 0  # the anchor carries each block's absolute value
        return DeltaColumn(arr[::block].copy(), d.astype(delta_dtype), n, arr.dtype, block)

    def decode(self):
        nb = len(self.anchors)
        d = np.zeros(nb * self.block, dtype=np.int64)
        d[: self.n] = self.deltas
        out = self.anchors.astype(np.int64)[:, None] + np.cumsum(
            d.reshape(nb, self.block), axis=1
        )
        return out.reshape(-1)[: self.n].astype(self.dtype)

    def _block_vals(self, b: int) -> np.ndarray:
        vals = self._bcache.get(b)
        if vals is None:
            lo = b * self.block
            hi = min(lo + self.block, self.n)
            vals = np.cumsum(self.deltas[lo:hi], dtype=np.int64)
            vals += int(self.anchors[b])
            self._bcache[b] = vals
        return vals

    def gather(self, idx):
        idx = np.asarray(idx)
        if len(idx) == 0:
            return np.empty(0, self.dtype)
        bi = idx // self.block
        off = idx % self.block
        blocks = np.unique(bi)
        if len(blocks) == 1:  # common: selected rows cluster in one block
            return self._block_vals(int(blocks[0]))[off].astype(self.dtype)
        out = np.empty(len(idx), dtype=np.int64)
        for b in blocks:  # touched blocks only
            sel = bi == b
            out[sel] = self._block_vals(int(b))[off[sel]]
        return out.astype(self.dtype)

    def nbytes(self):
        return int(self.anchors.nbytes + self.deltas.nbytes)

    def _boundary(self, v, side: str) -> int:
        b = int(self.anchors.searchsorted(v, side=side)) - 1
        if b < 0:
            return 0
        pos = int(self._block_vals(b).searchsorted(v, side=side))
        return min(b * self.block + pos, self.n)

    def _eq_range(self, v) -> Tuple[int, int]:
        """[lo, hi) of rows equal to ``v``.  Fast path: unless a run of ``v``
        crosses a block boundary (the next anchor equals ``v``), the whole
        range lives in one block — one anchor search, one cached block."""
        ar = self.anchors
        bl = int(ar.searchsorted(v, side="left")) - 1
        nxt = bl + 1
        if nxt < len(ar) and ar[nxt] == v:
            return self._boundary(v, "left"), self._boundary(v, "right")
        if bl < 0:
            return 0, 0
        vals = self._block_vals(bl)
        base = bl * self.block
        lo = base + int(vals.searchsorted(v, side="left"))
        hi = base + int(vals.searchsorted(v, side="right"))
        return min(lo, self.n), min(hi, self.n)

    def cmp_mask(self, op, v):
        if _is_nan(v):
            return _const_mask(op, self.n, (_NE,))
        if op in (_LT, _GE):
            lo = hi = self._boundary(v, "left")
        elif op in (_LE, _GT):
            lo = hi = self._boundary(v, "right")
        else:
            lo, hi = self._eq_range(v)
        m = np.zeros(self.n, bool)
        if op == _LT or op == _LE:
            m[:lo] = True
        elif op == _GE or op == _GT:
            m[hi if op == _GT else lo:] = True
        elif op == _EQ:
            m[lo:hi] = True
        else:  # _NE
            m[:] = True
            m[lo:hi] = False
        return m

class BitPackColumn(EncodedColumn):
    """Booleans / validity masks at one bit per row."""

    kind = "bitpack"

    def __init__(self, bits: np.ndarray, n: int):
        self.bits = bits
        self.n = n
        self.dtype = np.dtype(bool)

    @staticmethod
    def encode(arr: np.ndarray) -> "BitPackColumn":
        return BitPackColumn(np.packbits(arr.astype(bool)), len(arr))

    def decode(self):
        return np.unpackbits(self.bits, count=self.n).astype(bool)

    def gather(self, idx):
        idx = np.asarray(idx)
        return ((self.bits[idx >> 3] >> (7 - (idx & 7))) & 1).astype(bool)

    def nbytes(self):
        return int(self.bits.nbytes)

class ScaledColumn(EncodedColumn):
    """Floats that are exactly ``k / scale`` (integral floats, money with two
    decimals) stored as an encoded *integer* column.  Encode verifies bitwise
    round-tripping (``decode() == original`` elementwise), so the encoding is
    lossless by construction; comparison atoms defer to the decoded oracle —
    re-scaling a float threshold exactly is not generally possible."""

    kind = "scaled"

    def __init__(self, inner: EncodedColumn, scale: int, dtype: np.dtype):
        self.inner = inner
        self.scale = int(scale)
        self.n = inner.n
        self.dtype = np.dtype(dtype)

    def decode(self):
        return (self.inner.decode().astype(np.float64) / self.scale).astype(self.dtype)

    def gather(self, idx):
        return (self.inner.gather(idx).astype(np.float64) / self.scale).astype(self.dtype)

    def nbytes(self):
        return self.inner.nbytes() + 8

# --------------------------------------------------------------------------- #
# stats pass + encoding choice
# --------------------------------------------------------------------------- #


@dataclass
class ColumnStats:
    n: int
    dtype: np.dtype
    nbytes_raw: int
    n_unique: int = 0
    n_runs: int = 0
    is_sorted: bool = False
    has_nan: bool = False
    vmin: Optional[int] = None
    vmax: Optional[int] = None
    max_delta: Optional[int] = None
    # decimal scale for floats exactly representable as k/scale; vmin/vmax/
    # max_delta then describe the scaled integer image (a monotone map, so
    # n_unique/n_runs/is_sorted carry over unchanged)
    scale: Optional[int] = None


_SCALES = (1, 100)  # integral floats, money with two decimals


def _int_span(arr: np.ndarray) -> Tuple[int, int, Optional[int]]:
    vmin, vmax = int(arr.min()), int(arr.max())
    d = arr.astype(np.int64)[1:] - arr.astype(np.int64)[:-1]
    max_delta = int(d.max()) if len(d) and bool((d >= 0).all()) else None
    return vmin, vmax, max_delta


def analyze_column(arr: np.ndarray) -> ColumnStats:
    """One pass of per-column statistics driving both the encoding choice and
    the planner's compressed-size estimate."""
    n = len(arr)
    st = ColumnStats(n=n, dtype=arr.dtype, nbytes_raw=int(arr.nbytes))
    if n == 0:
        return st
    k = arr.dtype.kind
    st.has_nan = bool(np.isnan(arr).any()) if k == "f" else False
    st.n_runs = int(np.count_nonzero(arr[1:] != arr[:-1])) + 1
    st.is_sorted = bool((arr[1:] >= arr[:-1]).all()) if n > 1 else True
    st.n_unique = int(len(np.unique(arr)))
    if k in "iu":
        st.vmin, st.vmax, st.max_delta = _int_span(arr)
        if not st.is_sorted:
            st.max_delta = None
    elif k == "f" and not st.has_nan and bool(np.isfinite(arr).all()):
        for scale in _SCALES:
            scaled = np.round(arr * scale)
            if (
                float(np.abs(scaled).max(initial=0)) < 2**31
                and np.array_equal(scaled / scale, arr)
            ):
                st.scale = scale
                st.vmin, st.vmax, st.max_delta = _int_span(scaled)
                if not st.is_sorted:
                    st.max_delta = None
                break
    return st


def _code_dtype(nu: int) -> np.dtype:
    # searchsorted positions go up to nu inclusive; keep them representable
    if nu <= 0xFF:
        return np.dtype(np.uint8)
    if nu <= 0xFFFF:
        return np.dtype(np.uint16)
    return np.dtype(np.uint32)


def _pack_dtype(rng: int) -> Optional[np.dtype]:
    if rng < 2**8:
        return np.dtype(np.uint8)
    if rng < 2**16:
        return np.dtype(np.uint16)
    if rng < 2**32:
        return np.dtype(np.uint32)
    return None


def _int_encoding_ests(n: int, item: int, vmin: int, vmax: int,
                       is_sorted: bool, max_delta: Optional[int]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    pd = _pack_dtype(vmax - vmin)
    if pd is not None and pd.itemsize < item:
        out["for"] = n * pd.itemsize
    if is_sorted and max_delta is not None:
        dd = _pack_dtype(max_delta)
        if dd is not None:
            nb = -(-n // DELTA_BLOCK)
            out["delta"] = n * dd.itemsize + nb * item
    return out


def estimate_encodings(st: ColumnStats) -> Dict[str, int]:
    """Estimated encoded bytes per applicable encoding (stats only)."""
    out: Dict[str, int] = {"plain": st.nbytes_raw}
    if st.n == 0:
        return out
    item = st.dtype.itemsize
    if st.dtype.kind == "b":
        out["bitpack"] = (st.n + 7) // 8
        return out
    if st.dtype.kind in "iuf" and not st.has_nan and st.n_unique <= 0xFFFF:
        out["dict"] = st.n * _code_dtype(st.n_unique).itemsize + st.n_unique * item
    out["rle"] = st.n_runs * (item + 4)
    if st.dtype.kind in "iu" and st.vmin is not None:
        out.update(_int_encoding_ests(st.n, item, st.vmin, st.vmax,
                                      st.is_sorted, st.max_delta))
    elif st.scale is not None:
        # the scaled int32 image shares n_unique/n_runs/sortedness with the
        # float original; its candidate encodings compete as one entry
        sitem = 4
        ints = dict(_int_encoding_ests(st.n, sitem, st.vmin, st.vmax,
                                       st.is_sorted, st.max_delta))
        ints["plain"] = st.n * sitem
        ints["rle"] = st.n_runs * (sitem + 4)
        if st.n_unique <= 0xFFFF:
            ints["dict"] = st.n * _code_dtype(st.n_unique).itemsize + st.n_unique * sitem
        out["scaled"] = min(ints.values()) + 8
    return out


def choose_encoding(st: ColumnStats) -> Tuple[str, int]:
    """(kind, estimated bytes) minimizing the stats-pass size estimate."""
    ests = estimate_encodings(st)
    kind = min(ests, key=lambda k: (ests[k], k != "plain"))
    return kind, ests[kind]


def estimate_encoded_nbytes(arr: np.ndarray) -> int:
    """Compressed-size estimate for one column without encoding it."""
    return choose_encoding(analyze_column(arr))[1]


def encode_column(arr: np.ndarray) -> EncodedColumn:
    arr = np.asarray(arr)
    st = analyze_column(arr)
    kind, _ = choose_encoding(st)
    if kind == "bitpack":
        return BitPackColumn.encode(arr)
    if kind == "dict":
        return DictColumn.encode(arr)
    if kind == "rle":
        return RLEColumn.encode(arr)
    if kind == "for":
        return FORColumn.encode(arr, _pack_dtype(st.vmax - st.vmin))
    if kind == "delta":
        return DeltaColumn.encode(arr, _pack_dtype(st.max_delta))
    if kind == "scaled":
        ints = np.round(arr * st.scale).astype(np.int32)
        enc = ScaledColumn(encode_column(ints), st.scale, arr.dtype)
        # lossless by verification, not by construction: keep only if the
        # round trip is exact elementwise
        if np.array_equal(enc.decode(), arr):
            return enc
    return PlainColumn(arr)



# --------------------------------------------------------------------------- #
# stored tables
# --------------------------------------------------------------------------- #


class _LazyCols(Mapping):
    """Mapping view decoding columns on first access (ScanEngine/eval_np
    compatible), so oracle fallbacks touch only the columns they reference."""

    def __init__(self, st: "StoredTable"):
        self._st = st
        self._cache: Dict[str, np.ndarray] = {}

    def __getitem__(self, k: str) -> np.ndarray:
        v = self._cache.get(k)
        if v is None:
            # decode under the table lock: concurrent readers then share one
            # decoded array, keeping identity-keyed engine caches (sorted
            # indexes, slabs) warm instead of churning per racing decode
            with self._st._lock:
                v = self._cache.get(k)
                if v is None:
                    v = self._st.enc[k].decode()
                    self._cache[k] = v
        return v

    def __contains__(self, k) -> bool:
        return k in self._st.enc

    def __iter__(self) -> Iterator[str]:
        return iter(self._st.enc)

    def __len__(self) -> int:
        return len(self._st.enc)

    def get(self, k, default=None):
        return self[k] if k in self._st.enc else default


class StoredTable:
    """An encoded materialized stage.  Presents the ``nrows`` / ``cols`` /
    ``columns`` surface of :class:`~repro_torch.core.table.Table` (columns decode
    lazily), plus ``take``/``gather`` for binding extraction at selected rows
    without a full decode."""

    def __init__(self, enc: Dict[str, EncodedColumn], dicts: Dict[str, List[str]],
                 name: Optional[str], nrows: int, raw_nbytes: int,
                 zone_maps: Optional[ZoneMaps] = None):
        self.enc = enc
        self.dicts = dicts
        self.name = name
        self._nrows = nrows
        self.raw_nbytes = raw_nbytes
        # non-aliasing identity token for uid-keyed engine/backend caches
        # (shared counter with Table; never recycled, unlike id())
        self.uid = next_table_uid()
        # per-partition min/max/null stats built on the raw columns before
        # encoding; in-situ scans prune whole partitions against them
        self.zone_maps = zone_maps
        # reentrant: to_table() reads self.cols[k], which re-takes the lock
        self._lock = threading.RLock()
        self.cols = _LazyCols(self)
        self._table: Optional[Table] = None
        # per-program atom evaluation order (InSituBackend), keyed by the
        # program's structural signature — stable across engine-cache
        # evictions/recompiles, and LRU-bounded so a stage queried by many
        # distinct predicates can't grow it without limit
        self._work_cache: LRUCache = LRUCache(64)

    @property
    def part_rows(self) -> Optional[int]:
        return self.zone_maps.part_rows if self.zone_maps is not None else None

    @property
    def num_partitions(self) -> int:
        return self.zone_maps.n_partitions if self.zone_maps is not None else 1

    def partition_nbytes(self) -> List[int]:
        """Per-partition encoded size estimate: whole-column encodings don't
        split exactly, so bytes are apportioned by partition row count."""
        if self.zone_maps is None or self.num_partitions <= 1:
            return [self.nbytes()]
        total = self.nbytes()
        rows = self.zone_maps.part_sizes().astype(np.float64)
        # cumulative rounding: per-partition estimates sum exactly to total,
        # so partition-granular budget accounting never drifts from nbytes()
        cum = np.round(np.cumsum(rows) / max(rows.sum(), 1.0) * total)
        return np.diff(np.concatenate([[0], cum])).astype(np.int64).tolist()

    def prune_estimate(self) -> float:
        """Estimated fraction of partitions a selective (point) predicate
        skips — the planner's prune-aware scan-cost signal.  Uses the most
        pruning-friendly zone-mapped column."""
        if self.zone_maps is None or self.num_partitions <= 1:
            return 0.0
        best = 1.0
        for c in self.zone_maps.lo:
            if c == RID:
                continue
            best = min(best, self.zone_maps.point_hit_fraction(c))
        return 1.0 - best

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def columns(self) -> List[str]:
        return [c for c in self.enc if c != RID]

    def has(self, col: str) -> bool:
        return col in self.enc

    def nbytes(self) -> int:
        return int(sum(e.nbytes() for e in self.enc.values()))

    def compression_ratio(self) -> float:
        return self.raw_nbytes / max(self.nbytes(), 1)

    def encodings(self) -> Dict[str, str]:
        return {c: e.kind for c, e in self.enc.items()}

    def to_table(self, cache: bool = True) -> Table:
        """Fully decoded :class:`Table`.  Cached by default so identity-keyed
        engine caches (sorted-column indexes, slabs) stay warm across calls;
        ``cache=False`` decodes fresh (the decode-then-scan baseline)."""
        if not cache:
            return Table({k: e.decode() for k, e in self.enc.items()},
                         dict(self.dicts), self.name)
        with self._lock:
            if self._table is None:
                self._table = Table({k: self.cols[k] for k in self.enc},
                                    dict(self.dicts), self.name)
            return self._table

    def take(self, idx: np.ndarray) -> Table:
        """Rows at ``idx`` as a (small) decoded Table via per-encoding gather."""
        return Table({k: e.gather(idx) for k, e in self.enc.items()},
                     dict(self.dicts), self.name)

    def gather(self, col: str, idx: np.ndarray) -> np.ndarray:
        return self.enc[col].gather(idx)


def encode_table(table: Table, part_rows: Optional[int] = None) -> StoredTable:
    enc = {k: encode_column(np.asarray(v)) for k, v in table.cols.items()}
    dicts = {k: v for k, v in table.dicts.items() if k in table.cols}
    zm = None
    if part_rows is not None and table.nrows > part_rows:
        zm = build_zone_maps(table.cols, part_rows, table.nrows)
    return StoredTable(enc, dicts, table.name, table.nrows, table.nbytes(), zm)


def estimate_table_nbytes(table: Table, keep: Optional[List[str]] = None) -> int:
    """Stats-pass compressed-size estimate of a (column-projected) table."""
    t = table if keep is None else table.project([c for c in keep if table.has(c)])
    return int(sum(estimate_encoded_nbytes(np.asarray(v)) for v in t.cols.values()))


# --------------------------------------------------------------------------- #
# in-situ scan backend
# --------------------------------------------------------------------------- #


# full-scan cost classes per encoding: cheap lane compares first, then
# delta's binary searches, then the decoded-cache fallbacks.  A conjunction
# commutes, so evaluation order is free — the sort is stable within a class.
_SCAN_COST = {"for": 0, "dict": 0, "rle": 0, "delta": 1, "plain": 1,
              "bitpack": 1, "scaled": 2}

# switch to candidate filtering once the surviving fraction drops below 1/16
# — but only on stages big enough that O(n) masks dominate the per-gather
# fixed cost; small stages finish faster with straight-line full masks
_CAND_FRACTION = 16
_CAND_MIN_ROWS = 8192

# below this row count a delta/scaled atom is answered faster by a vectorized
# compare over the (lazily cached) decoded column than by binary searches —
# and a small stage's decoded cache is negligible by definition
_SMALL_STAGE_ROWS = 4096


class InSituBackend(NumpyBackend):
    """Evaluates a compiled :class:`AtomProgram` directly on encoded columns.

    Per-atom dispatch: the encoding answers the atom when it can (dict code
    compare, RLE run prune, FOR frame shift, delta anchor search); anything
    else — column-vs-column atoms, residual expressions, array bindings on
    non-equality atoms — falls back to the inherited NumPy oracle over the
    StoredTable's lazily decoded column cache.  Atoms run cheapest encoding
    first, and once the running mask is selective the remaining atoms are
    evaluated only on the surviving rows via ``gather``.  Answers are always
    identical to scanning the decoded table: every atom is elementwise, so
    reordering and restriction commute with the conjunction."""

    name = "insitu"

    def _work(self, prog: AtomProgram, st: StoredTable) -> List:
        """Atom evaluation order for one (program, stage) pair, cached by the
        program's structural signature (atoms of structurally-equal programs
        are interchangeable frozen values)."""
        work = st._work_cache.get(prog.signature)
        if work is None:
            work = [("cmp", a) for a in prog.cmp_atoms]
            work += [("isin", a) for a in prog.isin_atoms]
            if len(work) > 1:
                work.sort(key=lambda w: _SCAN_COST.get(
                    st.enc[w[1].col].kind if w[1].col in st.enc else "plain", 1
                ))
            st._work_cache[prog.signature] = work
        return work

    def scan(self, prog: AtomProgram, st: StoredTable,
             binding: Dict[str, object]) -> np.ndarray:
        n = st.nrows
        work = self._work(prog, st)
        has_residual = (
            prog.residual_static is not None or prog.residual_dynamic is not None
        )
        mask: Optional[np.ndarray] = None
        idx: Optional[np.ndarray] = None
        rest: List[Tuple[str, object]] = []
        for i, (what, a) in enumerate(work):
            if what == "cmp":
                m = self._cmp_insitu(a, st, binding, n)
                if m is None:
                    m = self._cmp_mask(a, st, binding, n)
            else:
                m = self._isin_insitu(a, st, binding)
                if m is None:
                    m = self._isin_mask(a, st, binding, n)
            # every mask producer returns a fresh array, so the first one can
            # be adopted and updated in place
            mask = m if mask is None else mask.__iand__(m)
            if n >= _CAND_MIN_ROWS and (i + 1 < len(work) or has_residual):
                cnt = int(np.count_nonzero(mask))
                if cnt * _CAND_FRACTION <= n:
                    idx = np.flatnonzero(mask)
                    rest = work[i + 1:]
                    break
        if idx is None:
            if mask is None:
                mask = np.ones(n, dtype=bool)
            for r in (prog.residual_static, prog.residual_dynamic):
                if r is not None:
                    mask &= np.asarray(eval_np(r, st.cols, binding, n=n), bool)
            return mask
        return self._finish_candidates(prog, st, binding, idx, rest)

    def scan_ranges(self, prog: AtomProgram, st: StoredTable,
                    binding: Dict[str, object], idx: np.ndarray) -> np.ndarray:
        """Full-length mask with evaluation restricted to candidate rows
        ``idx`` (the rows of zone-map-surviving partitions): every atom runs
        in candidate mode via per-encoding ``gather``, so pruned partitions
        never touch their encoded payloads."""
        return self._finish_candidates(prog, st, binding, idx,
                                       self._work(prog, st))

    def _finish_candidates(self, prog: AtomProgram, st: StoredTable,
                           binding: Dict[str, object], idx: np.ndarray,
                           rest: List) -> np.ndarray:
        n = st.nrows
        # candidate mode: every remaining atom sees only the survivors
        for what, a in rest:
            if not len(idx):
                break
            keep = (self._cmp_cand(a, st, binding, idx) if what == "cmp"
                    else self._isin_cand(a, st, binding, idx))
            idx = idx[keep]
        # residuals: the static one is paramless (restriction commutes, so
        # gather the survivors); the dynamic one may hold row-aligned array
        # bindings whose broadcast semantics need the full column length
        if prog.residual_static is not None and len(idx):
            env = {c: st.enc[c].gather(idx)
                   for c in prog.residual_static_cols if c in st.enc}
            idx = idx[np.asarray(
                eval_np(prog.residual_static, env, {}, n=len(idx)), bool
            )]
        if prog.residual_dynamic is not None and len(idx):
            if any(isinstance(v, np.ndarray) and v.ndim == 1
                   for v in binding.values()):
                env = {c: st.cols[c]
                       for c in prog.residual_dynamic_cols if c in st.enc}
                m = np.asarray(
                    eval_np(prog.residual_dynamic, env, binding, n=n), bool
                )
                idx = idx[m[idx]]
            else:
                env = {c: st.enc[c].gather(idx)
                       for c in prog.residual_dynamic_cols if c in st.enc}
                idx = idx[np.asarray(
                    eval_np(prog.residual_dynamic, env, binding, n=len(idx)), bool
                )]
        out = np.zeros(n, dtype=bool)
        out[idx] = True
        return out

    # -- full-column in-situ masks (None => decoded-oracle fallback) -------- #
    def _cmp_insitu(self, a, st: StoredTable, binding, n) -> Optional[np.ndarray]:
        enc = st.enc.get(a.col)
        if enc is None or a.kind == "col":
            return None  # oracle path (raises the same KeyError when missing)
        if n <= _SMALL_STAGE_ROWS and enc.kind in ("delta", "scaled"):
            return None  # decoded-cache compare wins below the block scale
        v = a.rhs if a.kind == "lit" else binding.get(a.rhs, _MISSING)
        if v is _MISSING:
            return None
        if _is_setlike(v):
            # membership semantics apply to *param* bindings only; a literal
            # array rhs broadcasts elementwise in the oracle — defer to it
            if a.kind != "param" or a.op != EQ:
                return None
            arr = np.asarray(v)
            if arr.size == 0:
                return np.zeros(n, dtype=bool)
            return enc.isin_mask(arr)
        if isinstance(v, np.generic):
            v = v.item()
        return enc.cmp_mask(a.op, v)

    def _isin_insitu(self, a, st: StoredTable, binding) -> Optional[np.ndarray]:
        enc = st.enc.get(a.col)
        if enc is None:
            return None
        vals = a.rhs if a.kind == "lit" else binding.get(a.rhs, _MISSING)
        if vals is _MISSING:
            return None
        arr = np.asarray(vals)
        if arr.size == 0:
            return np.zeros(st.nrows, dtype=bool)
        return enc.isin_mask(arr)

    # -- candidate filters: the same atom semantics on gathered rows -------- #
    def _col_at(self, st: StoredTable, col: str, idx: np.ndarray) -> np.ndarray:
        enc = st.enc.get(col)
        if enc is not None:
            return enc.gather(idx)
        return st.cols[col][idx]  # KeyError matches the oracle path

    def _cmp_cand(self, a, st: StoredTable, binding, idx) -> np.ndarray:
        colv = self._col_at(st, a.col, idx)
        if a.kind == "col":
            return _NP_CMP[a.op](colv, self._col_at(st, a.rhs, idx))
        if a.kind == "lit":
            v = a.rhs
        elif a.rhs not in binding:
            raise KeyError(f"unbound parameter {a.rhs}")
        else:
            v = binding[a.rhs]
        if _is_setlike(v):
            # mirror NumpyBackend._cmp_mask: membership for param bindings,
            # elementwise broadcast for literal arrays (restricted to the
            # surviving rows when row-aligned)
            if a.kind != "param":
                arr = np.asarray(v)
                if arr.ndim == 1 and len(arr) == st.nrows:
                    arr = arr[idx]
                return _NP_CMP[a.op](colv, arr)
            if a.op == EQ:
                arr = np.asarray(v)
                if arr.size == 0:
                    return np.zeros(len(idx), dtype=bool)
                return np.isin(colv, arr)
            # array bound to a non-equality atom: the oracle's broadcast /
            # error semantics depend on the full column length, so evaluate
            # full-table and restrict — restriction of the inputs would
            # misalign row-aligned binding arrays
            m = np.asarray(
                eval_np(a.expr, {a.col: st.cols[a.col]}, binding, n=st.nrows), bool
            )
            return m[idx]
        return _NP_CMP[a.op](colv, v)

    def _isin_cand(self, a, st: StoredTable, binding, idx) -> np.ndarray:
        if a.kind == "lit":
            vals = a.rhs
        elif a.rhs not in binding:
            raise KeyError(f"unbound parameter {a.rhs}")
        else:
            vals = binding[a.rhs]
        arr = np.asarray(vals)
        colv = self._col_at(st, a.col, idx)
        if arr.size == 0:
            return np.zeros(len(idx), dtype=bool)
        return np.isin(colv, arr)


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #


# store generations come from one process-wide monotone counter, so two
# distinct store objects (e.g. a spill/reload swap via attach_store) can
# never present the same (generation) token.  itertools.count is C-level
# atomic under the GIL.
_STORE_GENERATIONS = itertools.count(1)


class IntermediateStore:
    """Encoded materialized stages, keyed by plan-node id.

    The executor ``put()``s each stage as the pipeline-execution phase
    produces it; the budget planner (``plan.plan_materialization``) then
    ``evict()``s stages that don't fit ``budget_bytes``, and the lineage
    query phase reads through ``scan()`` (in situ) / ``table()`` (decoded,
    cached) / ``StoredTable.take`` (gather at selected rows).

    ``generation`` is a monotone token that changes whenever the stored
    stages change (``put``/``evict`` — i.e. any re-run or budget pass); the
    LineageService's answer cache stamps entries with it so answers computed
    against an older store version are never served again."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 num_partitions: Optional[int] = None,
                 part_rows: Optional[int] = None):
        self.budget_bytes = budget_bytes
        # partition layout for encoded stages: fixed-size row chunks with
        # zone maps, pruned by ``scan()`` before any row-level work
        self.num_partitions = num_partitions
        self.part_rows = part_rows
        self.stages: Dict[int, StoredTable] = {}
        self.backend = InSituBackend()
        self.generation: int = next(_STORE_GENERATIONS)

    # ------------------------------------------------------------------ #
    def put(self, node_id: int, table: Table) -> StoredTable:
        """Encode and store one materialized stage.

        Args:
            node_id: plan-node id of the stage.
            table: decoded stage rows.
        Returns:
            StoredTable: the encoded (and, with a partition layout,
            zone-mapped) stage now held by the store.
        """
        pr = resolve_part_rows(table.nrows, self.num_partitions, self.part_rows)
        st = encode_table(table, part_rows=pr)
        self.stages[node_id] = st
        self.generation = next(_STORE_GENERATIONS)
        return st

    def __contains__(self, node_id: int) -> bool:
        return node_id in self.stages

    def get(self, node_id: int) -> StoredTable:
        """The encoded stage for ``node_id`` (KeyError if absent)."""
        return self.stages[node_id]

    def table(self, node_id: int) -> Table:
        """Decoded view of one stage (cached on the StoredTable)."""
        return self.stages[node_id].to_table()

    def evict(self, node_ids) -> None:
        """Drop stages (budget planner / invalidation); bumps
        ``generation`` when anything was actually held."""
        evicted = False
        for nid in list(node_ids):
            evicted = self.stages.pop(nid, None) is not None or evicted
        if evicted:
            self.generation = next(_STORE_GENERATIONS)

    # ------------------------------------------------------------------ #
    def scan(self, node_id: int, pred, binding: Optional[Dict[str, object]],
             engine: ScanEngine) -> np.ndarray:
        """In-situ boolean mask of ``pred`` over a stored stage, using the
        engine's compiled (and cached) atom program.

        Partitioned stages run the zone-map pruning pass first; the
        surviving work then goes to the engine's cost model, which ranks
        every viable route — candidate-mode gather over alive partitions,
        the device in-situ kernel, decode-then-scan, or the encoded host
        path — and the cheapest one executes (falling down the ranking when
        a route proves inviable, e.g. the program leaves the encoded-int32
        device fragment)."""
        from .cost import prog_atoms

        prog = engine.compile(pred)
        st = self.stages[node_id]
        binding = binding or {}
        cm = engine.cost_model
        n = st.nrows
        A = prog_atoms(prog)
        w_full = float(n) * A
        zm = st.zone_maps
        alive = None
        ns = P = 0
        cands = []
        if zm is not None and zm.n_partitions > 1 and partition_safe(prog, binding):
            alive = prune_zone_maps(prog, zm, binding)
            ns = int(np.count_nonzero(alive))
            P = len(alive)
            if ns == 0:
                engine.stats.bump(scans=1, insitu_scans=1, prune_calls=1)
                engine.record_prune(0, P)
                return np.zeros(n, dtype=bool)
            kept = n - int(zm.part_sizes()[~alive].sum())
            # candidate-mode gather pays per-row index work plus up to one
            # partition of slack; the PRUNED_RATIO seed reproduces the old
            # MIN_SKIP_FRACTION rule against the vectorized full scan
            cands.append(("pruned", float(kept + zm.part_rows) * A))
        # device carrier: encoded columns scan in situ on device as int32
        # code slabs with code-space thresholds (no decode, zone pruning
        # in-grid); only programs fully inside the encoded-int32 fragment
        # qualify, so answers stay bit-identical to the host paths.  When
        # the predicate touches rle columns the same carrier evaluates
        # those atoms in *run space* (O(runs) touched, one expansion), so
        # the candidate is offered with run-aware work and its own seeded
        # slope (``insitu_rle``) instead of the flat rows x atoms product
        dev = getattr(engine.backend, "scan_stored", None)
        if dev is not None:
            rle_cols = {a.col for a in prog.cmp_atoms
                        if a.col in st.enc and st.enc[a.col].kind == "rle"}
            if rle_cols and not prog.isin_atoms:
                seed_fn = getattr(engine.backend, "_rle_seed", None)
                w_rle = float(sum(
                    int(st.enc[a.col].run_values.size)
                    if a.col in rle_cols else n
                    for a in prog.cmp_atoms) + n)
                cands.append(("insitu_rle", w_rle,
                              seed_fn() if seed_fn is not None else {}))
            else:
                seed_fn = getattr(engine.backend, "_device_seed", None)
                cands.append(("device_insitu", w_full,
                              seed_fn() if seed_fn is not None else {}))
        cands.append(("decode", w_full))
        # a cached decoded view makes the decode cost sunk — the in-situ
        # path can no longer win, so it isn't offered then
        if st._table is None:
            route, kw = self._insitu_candidate(st, prog)
            cands.append((route, w_full, kw))
        meta = {"rows": int(n), "atoms": int(A)}
        if alive is not None:
            meta.update(partitions=P, alive=ns)
        ch = cm.choose(f"store:{node_id}", cands, meta=meta)
        executed = None
        mask = None
        t0 = time.perf_counter()
        for _, route, _ in ch.ranked:
            if route == "pruned":
                idx = rows_of_alive(alive, zm.part_rows, n)
                mask = self.backend.scan_ranges(prog, st, binding, idx)
                engine.stats.bump(scans=1, insitu_scans=1, prune_calls=1)
                engine.record_prune(ns, P - ns)
            elif route in ("device_insitu", "insitu_rle"):
                mask = dev(prog, st, binding, force=True)
                if mask is None:
                    continue
                self._note_unpruned(engine, alive, P)
                if route == "insitu_rle":
                    engine.stats.bump(scans=1, insitu_scans=1,
                                      rle_insitu_chosen=1)
                else:
                    engine.stats.bump(scans=1, insitu_scans=1,
                                      device_chosen=1)
            elif route == "decode":
                mask = engine.backend.scan(prog, st.to_table(), binding)
                self._note_unpruned(engine, alive, P)
                engine.stats.bump(scans=1, insitu_scans=1, decode_chosen=1)
            else:  # insitu / insitu_heavy
                mask = self.backend.scan(prog, st, binding)
                self._note_unpruned(engine, alive, P)
                engine.stats.bump(scans=1, insitu_scans=1, insitu_chosen=1)
            executed = route
            break
        ch.done(time.perf_counter() - t0, route=executed)
        return mask

    @staticmethod
    def _note_unpruned(engine: ScanEngine, alive, P: int) -> None:
        """Zone maps ran but the full-extent route won: the prune pass still
        counts, with every partition recorded as scanned."""
        if alive is not None:
            engine.stats.bump(prune_calls=1)
            engine.record_prune(P, 0)

    # encodings whose cmp/isin masks are O(1)-setup vectorized code compares;
    # rle/delta/scaled pay real per-atom work, shifting the crossover up
    _CHEAP_SCAN_KINDS = frozenset({"plain", "dict", "for", "bitpack"})

    def _insitu_candidate(self, st: StoredTable, prog):
        """Cost-model candidate for the encoded host path: route name plus
        seed kwargs.  Columns outside the cheap vectorized encodings pay
        real per-atom decode work, shifting the seeded crossover up 16x
        (the ``insitu_heavy`` route)."""
        from .dispatch import insitu_scan_probe

        probe = insitu_scan_probe()
        cols = {a.col for a in prog.cmp_atoms}
        cols.update(a.col for a in prog.isin_atoms)
        kinds = {st.enc[c].kind for c in cols if c in st.enc}
        if kinds - self._CHEAP_SCAN_KINDS:
            return "insitu_heavy", {"cutover": float(probe.value << 4),
                                    "confidence": probe.confidence}
        return "insitu", {"cutover": float(probe.value),
                          "confidence": probe.confidence}

    # ------------------------------------------------------------------ #
    def sizes(self) -> Dict[int, int]:
        """Encoded bytes per stored stage (budget-planner input)."""
        return {nid: st.nbytes() for nid, st in self.stages.items()}

    def partition_sizes(self) -> Dict[int, List[int]]:
        """Per-partition encoded byte estimates per stage (planner input)."""
        return {nid: st.partition_nbytes() for nid, st in self.stages.items()}

    def prune_estimates(self) -> Dict[int, float]:
        """Estimated zone-map prune rate per stage (planner scan-cost input)."""
        return {nid: st.prune_estimate() for nid, st in self.stages.items()}

    def nbytes(self) -> int:
        """Total encoded bytes across all stored stages."""
        return int(sum(st.nbytes() for st in self.stages.values()))

    def raw_nbytes(self) -> int:
        """Total decoded (pre-encoding) bytes across all stages."""
        return int(sum(st.raw_nbytes for st in self.stages.values()))

    def compression_ratio(self) -> float:
        """Raw over encoded bytes (>= 1.0 when encodings help)."""
        return self.raw_nbytes() / max(self.nbytes(), 1)

    def encodings(self) -> Dict[int, Dict[str, str]]:
        """Chosen encoding kind per column per stage (diagnostics)."""
        return {nid: st.encodings() for nid, st in self.stages.items()}
