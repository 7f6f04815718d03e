"""Columnar table abstraction for the PredTrace engine.

Tables are dictionaries of equal-length 1-D numpy arrays.  String columns are
dictionary-encoded at ingest (codes ``int32`` + a host-side vocabulary), dates
are ``int32`` day numbers.  Every table carries an internal ``__rid__`` column
(row ids within the *source* table) used by the eager-tracking oracle and for
reporting lineage answers; PredTrace itself never relies on it (set semantics,
paper section 4.3).

The same layout maps 1:1 onto device arrays for the JAX scan path: a column is
a vector, a table block is a fixed-size slab of rows with a validity mask.
"""

from __future__ import annotations

import itertools
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

RID = "__rid__"

# process-wide monotone table identity: minted at construction, never reused.
# id()-keyed caches can alias when CPython recycles a freed object's address;
# uid-keyed caches cannot (see scan.py engine caches / the device slab cache).
_TABLE_UIDS = itertools.count(1)


def next_table_uid() -> int:
    """Mint a fresh, process-unique table identity token (shared counter with
    :class:`~repro_torch.core.store.StoredTable`)."""
    return next(_TABLE_UIDS)


def table_uid(obj) -> int:
    """Non-aliasing cache token for a table-like object.

    Returns the object's ``uid`` if it carries one, minting and attaching a
    fresh uid otherwise.  Objects that reject attribute assignment fall back
    to ``id(obj)`` — callers keying caches on this value must then keep an
    identity check (weakref or strong ref) in the cache entry, because ids
    can be recycled after collection while uids never are."""
    u = getattr(obj, "uid", None)
    if u is not None:
        return u
    u = next_table_uid()
    try:
        obj.uid = u
    except (AttributeError, TypeError):
        return id(obj)
    return u


@dataclass
class Table:
    """An immutable columnar table."""

    cols: Dict[str, np.ndarray]
    # Optional dictionary per string column: code -> string.  Shared (not
    # copied) across derived tables.
    dicts: Dict[str, List[str]] = field(default_factory=dict)
    name: Optional[str] = None
    # monotone identity token: cache keys derived from it can never alias a
    # dead table the way raw id() keys can (uids are never reused)
    uid: int = field(default_factory=next_table_uid, compare=False, repr=False)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_dict(
        data: Mapping[str, Sequence],
        name: Optional[str] = None,
        dicts: Optional[Dict[str, List[str]]] = None,
    ) -> "Table":
        cols: Dict[str, np.ndarray] = {}
        out_dicts: Dict[str, List[str]] = dict(dicts or {})
        n = None
        for k, v in data.items():
            arr = np.asarray(v)
            if arr.dtype.kind in ("U", "S", "O"):
                # dictionary-encode strings
                vocab, codes = np.unique(arr.astype(str), return_inverse=True)
                out_dicts[k] = list(vocab)
                arr = codes.astype(np.int32)
            cols[k] = arr
            if n is None:
                n = len(arr)
            elif n != len(arr):
                raise ValueError(f"column {k} length {len(arr)} != {n}")
        if n is None:
            n = 0
        if RID not in cols:
            cols[RID] = np.arange(n, dtype=np.int64)
        return Table(cols=cols, dicts=out_dicts, name=name)

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    @property
    def nrows(self) -> int:
        for v in self.cols.values():
            return int(len(v))
        return 0

    @property
    def columns(self) -> List[str]:
        return [c for c in self.cols if c != RID]

    def __getitem__(self, col: str) -> np.ndarray:
        return self.cols[col]

    def has(self, col: str) -> bool:
        return col in self.cols

    def rids(self) -> np.ndarray:
        return self.cols[RID]

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.cols.values()))

    # ------------------------------------------------------------------ #
    # derivation helpers (used by the executor)
    # ------------------------------------------------------------------ #
    def mask(self, m: np.ndarray) -> "Table":
        return Table({k: v[m] for k, v in self.cols.items()}, self.dicts, self.name)

    def take(self, idx: np.ndarray) -> "Table":
        return Table({k: v[idx] for k, v in self.cols.items()}, self.dicts, self.name)

    def with_cols(self, new: Mapping[str, np.ndarray]) -> "Table":
        cols = dict(self.cols)
        for k, v in new.items():
            if len(v) != self.nrows:
                raise ValueError(f"with_cols: {k} has {len(v)} rows, expected {self.nrows}")
            cols[k] = np.asarray(v)
        return Table(cols, self.dicts, self.name)

    def project(self, keep: Iterable[str]) -> "Table":
        keep = list(keep)
        cols = {k: self.cols[k] for k in keep}
        cols[RID] = self.cols[RID]
        dicts = {k: v for k, v in self.dicts.items() if k in cols}
        return Table(cols, dicts, self.name)

    def drop(self, cols: Iterable[str]) -> "Table":
        dead = set(cols)
        return self.project([c for c in self.columns if c not in dead])

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {}
        dicts = {}
        for k, v in self.cols.items():
            nk = mapping.get(k, k)
            cols[nk] = v
            if k in self.dicts:
                dicts[nk] = self.dicts[k]
        return Table(cols, dicts, self.name)

    def prefix(self, p: str) -> "Table":
        return self.rename({c: p + c for c in self.columns})

    def head(self, n: int) -> "Table":
        return Table({k: v[:n] for k, v in self.cols.items()}, self.dicts, self.name)

    # ------------------------------------------------------------------ #
    # decoding / display
    # ------------------------------------------------------------------ #
    def decode(self, col: str) -> np.ndarray:
        """Return string values for a dictionary-encoded column."""
        if col in self.dicts:
            vocab = np.asarray(self.dicts[col], dtype=object)
            return vocab[self.cols[col]]
        return self.cols[col]

    def encode_value(self, col: str, value) -> int:
        """Encode a python string into this column's dictionary code."""
        if col in self.dicts and isinstance(value, str):
            try:
                return self.dicts[col].index(value)
            except ValueError:
                return -1  # value not present: predicate can never match
        return value

    def row(self, i: int, decode: bool = False) -> Dict[str, object]:
        out = {}
        for c in self.columns:
            v = self.cols[c][i]
            if decode and c in self.dicts:
                v = self.dicts[c][int(v)]
            out[c] = v.item() if hasattr(v, "item") and not isinstance(v, str) else v
        return out

    def to_pylist(self, decode: bool = True, limit: Optional[int] = None) -> List[Dict]:
        n = self.nrows if limit is None else min(limit, self.nrows)
        return [self.row(i, decode=decode) for i in range(n)]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        cols = ", ".join(f"{c}:{self.cols[c].dtype}" for c in self.columns)
        return f"Table({self.name or '?'}, {self.nrows} rows, [{cols}])"


# --------------------------------------------------------------------------- #
# partitioned tables + zone maps
# --------------------------------------------------------------------------- #


@dataclass
class ZoneMaps:
    """Per-partition column statistics for fixed-size row chunks.

    ``lo``/``hi`` are null-ignoring min/max per partition (NaN for all-null
    float partitions), ``nulls`` counts NaNs (integer null *sentinels* count as
    values — predicate semantics are value-level throughout the engine), and
    ``distinct`` is a hint: ``1`` means provably constant (single value, no
    nulls), ``2`` means "may vary".  Zone maps drive conservative partition
    pruning (``scan.prune_zone_maps``): a partition is skipped only when its
    statistics prove no row can satisfy an atom."""

    part_rows: int
    nrows: int
    n_partitions: int
    lo: Dict[str, np.ndarray] = field(default_factory=dict)
    hi: Dict[str, np.ndarray] = field(default_factory=dict)
    nulls: Dict[str, np.ndarray] = field(default_factory=dict)
    distinct: Dict[str, np.ndarray] = field(default_factory=dict)

    def part_bounds(self, i: int) -> Tuple[int, int]:
        lo = i * self.part_rows
        return lo, min(lo + self.part_rows, self.nrows)

    def part_sizes(self) -> np.ndarray:
        """Rows per partition (the last chunk may be ragged)."""
        sizes = np.full(self.n_partitions, self.part_rows, dtype=np.int64)
        if self.n_partitions:
            sizes[-1] = self.nrows - (self.n_partitions - 1) * self.part_rows
        return sizes

    def point_hit_fraction(self, col: str) -> float:
        """Expected fraction of partitions a random equality probe on ``col``
        touches — the planner's prune-aware cost signal.  Disjoint narrow
        per-partition ranges (sorted ids) approach ``1/P``; a column whose
        every partition spans the full domain approaches ``1``."""
        lo, hi = self.lo.get(col), self.hi.get(col)
        if lo is None or not len(lo):
            return 1.0
        with np.errstate(invalid="ignore"):
            glo = np.fmin.reduce(lo)
            ghi = np.fmax.reduce(hi)
        try:
            span = float(ghi) - float(glo)
        except (TypeError, ValueError):
            return 1.0
        if not np.isfinite(span) or span <= 0:
            return 1.0 / max(self.n_partitions, 1)
        frac = (hi.astype(np.float64) - lo.astype(np.float64)) / span
        frac = np.nan_to_num(frac, nan=1.0)
        return float(np.clip(frac, 1.0 / max(self.n_partitions, 1), 1.0).mean())

def _never_prune_bounds(dtype: np.dtype) -> Tuple[object, object]:
    """(lo, hi) sentinels spanning the whole domain of ``dtype`` — zone-map
    bounds that can never prove a miss, so the partition always survives."""
    if dtype.kind == "f":
        return dtype.type(-np.inf), dtype.type(np.inf)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return dtype.type(info.min), dtype.type(info.max)
    return dtype.type(False), dtype.type(True)


def build_zone_maps(cols: Mapping[str, np.ndarray], part_rows: int,
                    nrows: int) -> ZoneMaps:
    """One pass of per-partition min/max/null-count/distinct-hint stats.

    ``fmin``/``fmax`` reduceat give null-ignoring bounds.  Degenerate
    partitions get explicit *never-prunes* statistics instead of the garbage
    ``reduceat`` would produce: zero-length segments (an appended empty delta,
    or offsets beyond the column) and all-NaN float partitions both take
    whole-domain sentinel bounds with ``distinct=2`` — such a partition always
    survives pruning, it is never wrongly skipped and never crashes the
    builder."""
    part_rows = max(int(part_rows), 1)
    n_parts = -(-nrows // part_rows) if nrows else 0
    zm = ZoneMaps(part_rows, nrows, n_parts)
    if n_parts == 0:
        return zm
    offs = np.arange(n_parts, dtype=np.int64) * part_rows
    for name, v in cols.items():
        arr = np.asarray(v)
        if arr.dtype.kind not in "iufb":
            continue
        np_lo, np_hi = _never_prune_bounds(arr.dtype)
        good = offs < len(arr)  # segments with at least one element
        if good.all():
            with np.errstate(invalid="ignore"):
                lo = np.fmin.reduceat(arr, offs)
                hi = np.fmax.reduceat(arr, offs)
        else:
            # zero-length tail segments: reduceat would raise (offset past
            # the array) or silently reduce a neighbour's rows — give them
            # never-prune sentinel bounds instead
            lo = np.full(n_parts, np_lo)
            hi = np.full(n_parts, np_hi)
            if good.any():
                with np.errstate(invalid="ignore"):
                    lo[good] = np.fmin.reduceat(arr, offs[good])
                    hi[good] = np.fmax.reduceat(arr, offs[good])
        if arr.dtype.kind == "f":
            isn = np.isnan(arr).astype(np.int64)
            nulls = np.zeros(n_parts, dtype=np.int64)
            if good.any():
                nulls[good] = np.add.reduceat(isn, offs[good])
            # all-NaN partitions: fmin/fmax left NaN bounds, whose comparison
            # semantics downstream are a minefield — replace with explicit
            # never-prune sentinels (the null count still records them)
            allnan = np.isnan(lo) | np.isnan(hi)
            if allnan.any():
                lo = np.where(allnan, np_lo, lo)
                hi = np.where(allnan, np_hi, hi)
        else:
            nulls = np.zeros(n_parts, dtype=np.int64)
        with np.errstate(invalid="ignore"):
            const = (lo == hi) & (nulls == 0) & good
        zm.lo[name] = lo
        zm.hi[name] = hi
        zm.nulls[name] = nulls
        zm.distinct[name] = np.where(const, 1, 2).astype(np.int8)
    return zm


def resolve_part_rows(nrows: int, num_partitions: Optional[int] = None,
                      part_rows: Optional[int] = None) -> Optional[int]:
    """Rows per partition from either a chunk-count or a chunk-size request."""
    if part_rows is not None:
        return max(int(part_rows), 1)
    if num_partitions is not None and num_partitions > 0:
        return max(-(-nrows // int(num_partitions)), 1)
    return None


class PartitionedTable(Table):
    """A :class:`Table` split into fixed-size row chunks, each carrying a zone
    map.  Column arrays are shared with the base table (zero copy); derived
    tables (``mask``/``take``/...) drop back to plain Tables — partitioning is
    a property of the *stored* layout, not of query-time selections."""

    def __init__(self, cols: Dict[str, np.ndarray],
                 dicts: Optional[Dict[str, List[str]]] = None,
                 name: Optional[str] = None,
                 part_rows: int = 1,
                 zone_maps: Optional[ZoneMaps] = None):
        super().__init__(cols, dicts or {}, name)
        n = self.nrows
        self.part_rows = max(int(part_rows), 1)
        self.zone_maps = (
            zone_maps if zone_maps is not None
            else build_zone_maps(self.cols, self.part_rows, n)
        )

    @property
    def num_partitions(self) -> int:
        return self.zone_maps.n_partitions

    def partition_bounds(self, i: int) -> Tuple[int, int]:
        return self.zone_maps.part_bounds(i)

    def partition(self, i: int) -> Table:
        """Partition ``i`` as a zero-copy Table view (numpy slices)."""
        lo, hi = self.partition_bounds(i)
        return Table({k: v[lo:hi] for k, v in self.cols.items()},
                     self.dicts, self.name)

    def partitions(self) -> Iterator[Table]:
        for i in range(self.num_partitions):
            yield self.partition(i)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"PartitionedTable({self.name or '?'}, {self.nrows} rows, "
                f"{self.num_partitions} x {self.part_rows}-row partitions)")


def partition_table(table: Table, num_partitions: Optional[int] = None,
                    part_rows: Optional[int] = None) -> Table:
    """Partitioned zero-copy view of ``table``; returns ``table`` unchanged
    when no partitioning is requested."""
    pr = resolve_part_rows(table.nrows, num_partitions, part_rows)
    if pr is None:
        return table
    return PartitionedTable(dict(table.cols), dict(table.dicts), table.name,
                            part_rows=pr)


def alive_runs(alive: np.ndarray) -> List[Tuple[int, int]]:
    """Contiguous ``[start, stop)`` partition-index runs of surviving (True)
    partitions — scans stitch per-run masks back deterministically."""
    if not len(alive):
        return []
    a = np.asarray(alive, dtype=bool)
    edges = np.flatnonzero(np.diff(a.astype(np.int8)))
    starts = [0] if a[0] else []
    starts += [int(e) + 1 for e in edges if not a[e]]
    stops = [int(e) + 1 for e in edges if a[e]]
    if a[-1]:
        stops.append(len(a))
    return list(zip(starts, stops))


def rows_of_alive(alive: np.ndarray, part_rows: int, nrows: int) -> np.ndarray:
    """Global row indices of the surviving partitions (last chunk clamped)."""
    runs = alive_runs(alive)
    if not runs:
        return np.empty(0, dtype=np.int64)
    return np.concatenate([
        np.arange(p0 * part_rows, min(p1 * part_rows, nrows), dtype=np.int64)
        for p0, p1 in runs
    ])


def concat_tables(tables: Sequence[Table]) -> Table:
    """Concatenate tables with identical schemas (used by Union)."""
    if not tables:
        raise ValueError("concat of zero tables")
    first = tables[0]
    cols = {}
    for k in first.cols:
        cols[k] = np.concatenate([t.cols[k] for t in tables])
    dicts = dict(first.dicts)
    return Table(cols, dicts, first.name)



def catalog_from_numpy(d: Mapping[str, Mapping[str, np.ndarray]],
                       device=None) -> Dict[str, Table]:
    """The port's catalog from tables handed over as numpy arrays — the
    counterpart of carrying weights across: ``{table: {column: array}}``.

    String columns (numpy ``U``/``S``/object arrays) are dictionary-encoded
    exactly as :meth:`Table.from_dict` encodes them (sorted vocabulary of the
    values present), so a table the reference built from the same strings
    gets the same codes; a ``__rid__`` column keeps its row ids.  The tables
    stay host-resident, as in the reference: scans upload the column slabs
    they touch.  ``device`` is resolved like the scan entry points' (``None``
    is the CUDA card) so a handover meant for a missing card fails here."""
    from .scan import resolve_device

    resolve_device(device)
    return {name: Table.from_dict(dict(cols), name=name)
            for name, cols in d.items()}
