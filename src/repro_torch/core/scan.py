"""ScanEngine: compiled predicate scans — the lineage-query hot path.

The paper's headline claim is that lineage querying reduces to *table scans
of pushed-down predicates*.  This module is the one place those scans happen.
A pushed-down predicate ``Expr`` is compiled **once** per structure into a
flat columnar :class:`AtomProgram` — the same atoms-plus-runtime-thresholds
representation the ``pred_filter`` kernel consumes (static
``(col, op)`` atom list, runtime threshold vector) — and cached by structural
signature, so re-binding a new target row ``t_o`` never recompiles.

Atom classes (a conjunction is split at compile time):

* **cmp**   — ``col <op> rhs`` with ``rhs`` a literal, another column, or a
              lineage parameter.  Literal/column atoms are *static* (shared
              across a batch); parameter atoms take their threshold from the
              query-time binding.
* **isin**  — ``col IN values`` with a literal tuple or a Param/ParamSet.
* **residual** — anything else (arithmetic, CASE WHEN, OR-trees), split into
              a paramless part (evaluated once per scan/batch) and a
              param-bearing part (evaluated per binding via ``eval_np``).

Backends are pluggable:

* :class:`NumpyBackend` — vectorized NumPy, the oracle and host fast path.
* :class:`TorchBackend` — routes the whole atom program through the fused
  ``kernels/pred_filter`` batched scan on a torch device: int32 comparison
  atoms directly, float32 comparisons via a monotone sign-folded int32 key
  lane (exact NaN/±inf semantics by threshold translation), and ``IN`` atoms
  in-kernel via per-row binary search over device-resident sorted set
  segments.  On a CUDA device the hand-written kernel runs; on the CPU (the
  tests' configuration) its plain PyTorch version does.

Batched queries (:meth:`ScanEngine.scan_batch`) answer B target rows in one
scan per table: static atoms are evaluated once, equality atoms across all B
bindings collapse into a single composite-key sort + B binary searches
(O(N log N + B log N) instead of B·O(N·K)), and only the few surviving
candidate rows per binding see the remaining atoms.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .expr import (
    BinOp,
    Col,
    Expr,
    IsIn,
    Lit,
    Param,
    ParamSet,
    cols_of,
    conjuncts,
    eval_np,
    key,
    land,
    params_of,
)
from .table import PartitionedTable, Table, ZoneMaps, alive_runs, table_uid
from ..kernels.pred_filter import block_bounds, pred_filter_batch, search_iters
from ..kernels.pred_filter.pred_filter import pack_program

# op codes shared with kernels/pred_filter (0:== 1:!= 2:< 3:<= 4:> 5:>=)
OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
_NP_CMP = (np.equal, np.not_equal, np.less, np.less_equal, np.greater,
           np.greater_equal)
EQ = OPS["=="]


def _is_setlike(v) -> bool:
    return isinstance(v, (list, tuple)) or (
        isinstance(v, np.ndarray) and v.ndim == 1
    )


def _member(col: np.ndarray, vals) -> np.ndarray:
    arr = np.asarray(vals)
    col = np.asarray(col)
    if arr.size == 0:
        return np.zeros(len(col), dtype=bool)
    return np.isin(col, arr)


class _GatherCols:
    """Mapping view gathering rows of one column on first access, so a scan
    over scattered surviving partitions copies only the columns the
    predicate actually touches."""

    def __init__(self, table: "Table", idx: np.ndarray):
        self._cols = table.cols
        self._idx = idx
        self._cache: Dict[str, np.ndarray] = {}

    def __getitem__(self, k: str) -> np.ndarray:
        v = self._cache.get(k)
        if v is None:
            v = np.asarray(self._cols[k])[self._idx]
            self._cache[k] = v
        return v

    def get(self, k, default=None):
        return self[k] if k in self._cols else default

    def __contains__(self, k) -> bool:
        return k in self._cols

    def __iter__(self):
        return iter(self._cols)

    def __len__(self) -> int:
        return len(self._cols)


class _GatherView:
    """Duck-typed Table presenting the gathered rows ``idx`` of a base table
    (lazy per-column); backends see an ordinary small table."""

    def __init__(self, table: "Table", idx: np.ndarray):
        self.cols = _GatherCols(table, idx)
        self.nrows = len(idx)
        self.dicts = table.dicts
        self.name = table.name
        self.uid = table_uid(self)  # non-aliasing token for backend caches

    def has(self, col: str) -> bool:
        return col in self.cols


class LRUCache:
    """Bounded mapping with LRU eviction and hit/miss/evict counters.

    The engine's program / slab / sorted-index caches were unbounded
    dicts; a long-lived service scanning many plans would grow them without
    limit.  Mutations are lock-protected so the parallel partition executor
    can share an engine across worker threads."""

    def __init__(self, maxsize: int):
        self.maxsize = max(int(maxsize), 1)
        self._d: "OrderedDict" = OrderedDict()
        # reentrant: weakref callbacks pop() entries and may fire from cyclic
        # GC triggered *inside* a locked cache method on the same thread
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, k, default=None):
        with self._lock:
            try:
                v = self._d[k]
            except KeyError:
                self.misses += 1
                return default
            self._d.move_to_end(k)
            self.hits += 1
            return v

    def __setitem__(self, k, v):
        with self._lock:
            if k in self._d:
                self._d[k] = v
                self._d.move_to_end(k)
                return
            while len(self._d) >= self.maxsize:
                self._d.popitem(last=False)
                self.evictions += 1
            self._d[k] = v

    def pop(self, k, default=None):
        with self._lock:
            return self._d.pop(k, default)

    def __contains__(self, k) -> bool:
        with self._lock:
            return k in self._d

    def __len__(self) -> int:
        return len(self._d)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._d), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


# membership-set sort cache: zone-restrict overlap checks and the tuple-
# membership evaluator consult the same value sets once per partition /
# per atom; the sort+unique is hoisted here.  Entries anchor the keyed
# array with a weakref whose callback evicts on collection, so a recycled
# id() can never find a stale entry; values that reject weakrefs (lists,
# frozensets) are anchored by strong ref, which pins their id for the
# entry's lifetime — either way the key cannot alias a different object.
_SORTED_SETS: LRUCache = LRUCache(128)


def _sorted_unique(vals: np.ndarray) -> np.ndarray:
    """NaN-free sorted unique of a membership set, cached by identity so
    repeated consults (per partition, per atom, per scan) sort once."""
    k = id(vals)
    ent = _SORTED_SETS.get(k)
    if ent is not None:
        anchor = ent[0]() if isinstance(ent[0], weakref.ref) else ent[0]
        if anchor is vals:
            return ent[1]
    u = np.unique(vals)
    if u.dtype.kind == "f":
        u = u[~np.isnan(u)]
    try:
        anchor = weakref.ref(
            vals, lambda _, k=k: _SORTED_SETS.pop(k, None))
    except TypeError:
        anchor = vals
    _SORTED_SETS[k] = (anchor, u)
    return u


def sorted_set_counters() -> Dict[str, int]:
    """Hit/miss counters of the membership-set sort cache — the proof that
    the per-predicate hoist reuses sorted sets instead of re-sorting."""
    return _SORTED_SETS.counters()


# --------------------------------------------------------------------------- #
# compiled representation
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class CmpAtom:
    """``col <op> rhs``.  ``kind`` is "lit" (rhs = value), "col" (rhs = other
    column name) or "param" (rhs = parameter name, threshold bound at query
    time).  ``expr`` keeps the original atom for exact-semantics fallback."""

    col: str
    op: int
    kind: str
    rhs: object
    expr: Expr


@dataclass(frozen=True)
class IsInAtom:
    """``col IN values``; ``kind`` "lit" (rhs = tuple) or "param"."""

    col: str
    kind: str
    rhs: object
    expr: Expr


@dataclass(frozen=True)
class AtomProgram:
    """A predicate compiled to flat columnar atoms + residual expressions."""

    pred: Expr
    cmp_atoms: Tuple[CmpAtom, ...]
    isin_atoms: Tuple[IsInAtom, ...]
    residual_static: Optional[Expr]  # paramless leftovers, shared per scan
    residual_dynamic: Optional[Expr]  # param-bearing leftovers, per binding
    residual_static_cols: Tuple[str, ...] = ()
    residual_dynamic_cols: Tuple[str, ...] = ()
    signature: Tuple = ()
    params: Tuple[str, ...] = ()
    residual_dynamic_params: Tuple[str, ...] = ()
    # False when the predicate embeds row-aligned array literals whose
    # broadcast semantics depend on the full column length — such programs
    # must not be evaluated on partition slices
    slice_safe: bool = True

    @property
    def static_cmp(self) -> Tuple[CmpAtom, ...]:
        return tuple(a for a in self.cmp_atoms if a.kind != "param")

    @property
    def param_cmp(self) -> Tuple[CmpAtom, ...]:
        return tuple(a for a in self.cmp_atoms if a.kind == "param")


def compile_pred(pred: Expr) -> AtomProgram:
    """Structural compilation of a conjunction into an :class:`AtomProgram`.
    Pure function of the predicate structure — safe to cache by ``key(pred)``."""
    cmp_atoms: List[CmpAtom] = []
    isin_atoms: List[IsInAtom] = []
    rest_static: List[Expr] = []
    rest_dynamic: List[Expr] = []

    for a in conjuncts(pred):
        atom = _compile_atom(a)
        if isinstance(atom, CmpAtom):
            cmp_atoms.append(atom)
        elif isinstance(atom, IsInAtom):
            isin_atoms.append(atom)
        elif params_of(a):
            rest_dynamic.append(a)
        else:
            rest_static.append(a)

    rs = land(*rest_static) if rest_static else None
    rd = land(*rest_dynamic) if rest_dynamic else None
    return AtomProgram(
        pred=pred,
        cmp_atoms=tuple(cmp_atoms),
        isin_atoms=tuple(isin_atoms),
        residual_static=rs,
        residual_dynamic=rd,
        residual_static_cols=tuple(sorted(cols_of(rs))) if rs is not None else (),
        residual_dynamic_cols=tuple(sorted(cols_of(rd))) if rd is not None else (),
        signature=key(pred),
        params=tuple(sorted(params_of(pred))),
        residual_dynamic_params=(
            tuple(sorted(params_of(rd))) if rd is not None else ()
        ),
        slice_safe=not _has_array_lit(pred),
    )


def _has_array_lit(e) -> bool:
    """Does the expression tree embed an array-valued literal?  (``IsIn``
    value tuples are membership sets — elementwise, hence slice-safe.)"""
    if isinstance(e, Lit):
        return isinstance(e.value, (np.ndarray, list, tuple))
    if isinstance(e, IsIn):
        return _has_array_lit(e.operand)
    if isinstance(e, Expr):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name, None)
            if isinstance(v, Expr) and _has_array_lit(v):
                return True
            if isinstance(v, tuple) and any(
                isinstance(x, Expr) and _has_array_lit(x) for x in v
            ):
                return True
        return False
    return False


def _compile_atom(a: Expr):
    if isinstance(a, BinOp) and a.op in OPS:
        l, r, op = a.left, a.right, a.op
        if not isinstance(l, Col) and isinstance(r, Col):
            l, r, op = r, l, _FLIP[op]
        if isinstance(l, Col):
            if isinstance(r, Col):
                return CmpAtom(l.name, OPS[op], "col", r.name, a)
            if isinstance(r, Lit) and not isinstance(r.value, Expr):
                return CmpAtom(l.name, OPS[op], "lit", r.value, a)
            if isinstance(r, (Param, ParamSet)):
                return CmpAtom(l.name, OPS[op], "param", r.name, a)
        return None
    if isinstance(a, IsIn) and isinstance(a.operand, Col):
        if isinstance(a.values, (Param, ParamSet)):
            return IsInAtom(a.operand.name, "param", a.values.name, a)
        if isinstance(a.values, tuple):
            return IsInAtom(a.operand.name, "lit", a.values, a)
        return None
    return None


def _bind(binding: Dict[str, object], name: str):
    if name not in binding:
        raise KeyError(f"unbound parameter {name}")
    return binding[name]


# --------------------------------------------------------------------------- #
# zone-map partition pruning
# --------------------------------------------------------------------------- #

_UNBOUND = object()

_LT, _LE, _GT, _GE, _NE = OPS["<"], OPS["<="], OPS[">"], OPS[">="], OPS["!="]


def _scalar_nan(v) -> bool:
    try:
        return bool(np.isnan(v))
    except (TypeError, ValueError):
        return False


def _set_overlap(vals: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Per-partition: does any member of ``vals`` fall inside ``[lo, hi]``?
    NaN members never match (``np.isin`` semantics); NaN bounds (all-null
    partitions) produce empty windows, i.e. no overlap."""
    u = _sorted_unique(vals)
    if u.size == 0:
        return np.zeros(len(lo), dtype=bool)
    with np.errstate(invalid="ignore"):
        a = np.searchsorted(u, lo, side="left")
        b = np.searchsorted(u, hi, side="right")
    return b > a


def prune_zone_maps(prog: AtomProgram, zm: ZoneMaps,
                    binding: Dict[str, object]) -> np.ndarray:
    """Which partitions *may* contain matching rows (conservative: a False
    entry proves no row in that partition satisfies the conjunction).

    Every comparison / membership atom whose threshold is resolvable narrows
    the alive set using per-partition ``[lo, hi]`` bounds; residual
    expressions, unbound parameters, and columns without zone entries never
    prune.  NaN thresholds exploit IEEE semantics (``x <op> NaN`` is False
    for every op but ``!=``); all-null partitions carry NaN bounds, which
    every comparison treats as un-prunable except where NaN-ness itself
    proves emptiness."""
    P = zm.n_partitions
    alive = np.ones(P, dtype=bool)
    if P == 0:
        return alive
    for a in prog.cmp_atoms:
        lo, hi = zm.lo.get(a.col), zm.hi.get(a.col)
        if lo is None:
            continue
        op = a.op
        if a.kind == "col":
            rlo, rhi = zm.lo.get(a.rhs), zm.hi.get(a.rhs)
            if rlo is None:
                continue
            with np.errstate(invalid="ignore"):
                if op == EQ:
                    alive &= (lo <= rhi) & (hi >= rlo)
                elif op == _LT:
                    alive &= lo < rhi
                elif op == _LE:
                    alive &= lo <= rhi
                elif op == _GT:
                    alive &= hi > rlo
                elif op == _GE:
                    alive &= hi >= rlo
                else:  # != : prune only provably-constant-and-equal partitions
                    alive &= ~(
                        (zm.distinct[a.col] == 1) & (zm.distinct[a.rhs] == 1)
                        & (lo == rlo)
                    )
            continue
        v = a.rhs if a.kind == "lit" else binding.get(a.rhs, _UNBOUND)
        if v is _UNBOUND:
            continue
        if _is_setlike(v):
            # membership semantics apply to param-equality atoms only; other
            # array shapes are handled by the evaluator, never pruned here
            if a.kind == "param" and op == EQ:
                arr = np.asarray(v)
                if arr.dtype.kind not in "iufb":
                    continue
                alive &= _set_overlap(arr, lo, hi)
            continue
        if isinstance(v, np.generic):
            v = v.item()
        if not isinstance(v, (bool, int, float, np.bool_)):
            continue
        if _scalar_nan(v):
            if op != _NE:  # x <op> NaN is False everywhere
                alive[:] = False
            continue
        with np.errstate(invalid="ignore"):
            if op == EQ:
                alive &= (lo <= v) & (hi >= v)
            elif op == _NE:
                alive &= ~((zm.distinct[a.col] == 1) & (lo == v))
            elif op == _LT:
                alive &= lo < v
            elif op == _LE:
                alive &= lo <= v
            elif op == _GT:
                alive &= hi > v
            else:  # _GE
                alive &= hi >= v
        if not alive.any():
            return alive
    for a in prog.isin_atoms:
        lo, hi = zm.lo.get(a.col), zm.hi.get(a.col)
        if lo is None:
            continue
        vals = a.rhs if a.kind == "lit" else binding.get(a.rhs, _UNBOUND)
        if vals is _UNBOUND:
            continue
        try:
            arr = np.asarray(vals)
        except (TypeError, ValueError):  # pragma: no cover - exotic values
            continue
        if arr.ndim != 1 or arr.dtype.kind not in "iufb":
            if arr.size == 0:
                alive[:] = False
            continue
        if arr.size == 0:
            alive[:] = False
            return alive
        alive &= _set_overlap(arr, lo, hi)
    return alive


def partition_safe(prog: AtomProgram, binding: Dict[str, object]) -> bool:
    """Can this (program, binding) pair be evaluated per partition slice with
    answers identical to a full-table scan?  Unsafe shapes — unbound params
    (the full path must raise), literal arrays, array bindings on
    non-equality atoms or in dynamic residuals (their broadcast/error
    semantics depend on the full column length) — fall back to the
    unsliced backend."""
    if not prog.slice_safe:
        return False
    for p in prog.params:
        if p not in binding:
            return False
    for a in prog.cmp_atoms:
        if a.kind == "lit" and _is_setlike(a.rhs):
            return False
        if a.kind == "param" and a.op != EQ and _is_setlike(binding[a.rhs]):
            return False
    for p in prog.residual_dynamic_params:
        if _is_setlike(binding.get(p)):
            return False
    return True


# --------------------------------------------------------------------------- #
# backends
# --------------------------------------------------------------------------- #


class NumpyBackend:
    """Vectorized NumPy evaluation of a bound atom program (the oracle)."""

    name = "numpy"

    def scan(self, prog: AtomProgram, table: Table,
             binding: Dict[str, object]) -> np.ndarray:
        n = table.nrows
        mask = np.ones(n, dtype=bool)
        for a in prog.cmp_atoms:
            mask &= self._cmp_mask(a, table, binding, n)
        for a in prog.isin_atoms:
            mask &= self._isin_mask(a, table, binding, n)
        for r in (prog.residual_static, prog.residual_dynamic):
            if r is not None:
                mask &= np.asarray(eval_np(r, table.cols, binding, n=n), bool)
        return mask

    # -- per-atom evaluation, exactly mirroring ``eval_np`` semantics ------- #
    def _cmp_mask(self, a: CmpAtom, table: Table, binding, n) -> np.ndarray:
        col = table.cols[a.col]
        if a.kind == "col":
            return _NP_CMP[a.op](col, table.cols[a.rhs])
        v = a.rhs if a.kind == "lit" else _bind(binding, a.rhs)
        if a.kind == "param" and _is_setlike(v):
            if a.op == EQ:
                return _member(col, v)  # array binding => set membership
            # array bound to a non-equality comparison: defer to the tree
            # evaluator so broadcast/error behaviour is identical
            return np.asarray(eval_np(a.expr, table.cols, binding, n=n), bool)
        return _NP_CMP[a.op](col, v)

    def _isin_mask(self, a: IsInAtom, table: Table, binding, n) -> np.ndarray:
        vals = a.rhs if a.kind == "lit" else _bind(binding, a.rhs)
        return _member(table.cols[a.col], vals)


INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1

# constant-outcome atoms expressible over any int32 lane: nothing is below
# INT32_MIN, so ``< INT32_MIN`` is always False and ``>= INT32_MIN`` always True
_FALSE_ATOM = (OPS["<"], INT32_MIN)
_TRUE_ATOM = (OPS[">="], INT32_MIN)


def resolve_device(device=None):
    """The torch device a :class:`TorchBackend` scans on.  ``None`` means the
    card (``"cuda"``); the CPU is used only when the caller asks for it (the
    plain PyTorch version of the kernel runs there).  Raises when a CUDA
    device is asked for — explicitly or by default — and none is present:
    no scan silently carries on on the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch scans run on a CUDA device by default and none is "
            "available; pass device='cpu' to use the plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported scan device {dev}")
    return dev


def _lane_thr(op: int, t) -> Optional[Tuple[int, int]]:
    """Translate ``lane <op> t`` (``t`` real, lanes int32-valued) into an
    equivalent int32 comparison.  Non-integral and out-of-range thresholds
    shift to the enclosing integer boundary; impossible/tautological atoms
    become the constant forms above.  Returns None only for un-orderable
    thresholds."""
    try:
        t = float(t)
    except (TypeError, ValueError, OverflowError):
        return None
    if t != t:  # NaN: False under every op but !=
        return _TRUE_ATOM if op == _NE else _FALSE_ATOM
    if t in (float("inf"), float("-inf")):
        below = t < 0
        if op == EQ:
            return _FALSE_ATOM
        if op == _NE:
            return _TRUE_ATOM
        if op in (_LT, _LE):
            return _FALSE_ATOM if below else _TRUE_ATOM
        return _TRUE_ATOM if below else _FALSE_ATOM
    if t.is_integer():
        ti = int(t)
        if INT32_MIN <= ti <= INT32_MAX:
            return (op, ti)
        below = ti < INT32_MIN
        if op == EQ:
            return _FALSE_ATOM
        if op == _NE:
            return _TRUE_ATOM
        if op in (_LT, _LE):
            return _FALSE_ATOM if below else _TRUE_ATOM
        return _TRUE_ATOM if below else _FALSE_ATOM
    # non-integral: lane < t  <=>  lane < floor(t)+1 ; lane > t <=> lane >= floor(t)+1
    ti = math.floor(t) + 1
    if op == EQ:
        return _FALSE_ATOM
    if op == _NE:
        return _TRUE_ATOM
    code = _LT if op in (_LT, _LE) else _GE
    if ti > INT32_MAX:
        return _TRUE_ATOM if code == _LT else _FALSE_ATOM
    if ti < INT32_MIN:
        return _FALSE_ATOM if code == _LT else _TRUE_ATOM
    return (code, ti)


# --------------------------------------------------------------------------- #
# float32 key lane: order-preserving int32 keys
# --------------------------------------------------------------------------- #

_KEY_POS_INF = int(np.float32(np.inf).view(np.int32))   # key(+inf)
_KEY_NEG_INF = -_KEY_POS_INF - 1                        # key(-inf)
# -0.0 canonicalizes to +0.0 before the sign fold, so key -1 (the would-be
# image of -0.0) has no pre-image: a guaranteed-empty equality probe for
# NaN thresholds and values float32 can't represent
_KEY_IMPOSSIBLE = -1


def _f32_key(arr: np.ndarray) -> np.ndarray:
    """Total-order int32 keys for a float32 lane: canonicalize -0.0, then
    fold the sign bit so integer key order equals IEEE numeric order.  NaN
    lanes fold *outside* ``[key(-inf), key(+inf)]`` (above it for +NaN,
    below for -NaN), which the two-sided threshold intervals exploit to
    exclude them exactly as numpy comparisons do."""
    v = np.where(arr == 0.0, np.float32(0.0), arr)
    b = v.view(np.int32)
    return np.where(b < 0, b ^ np.int32(0x7FFFFFFF), b).astype(np.int32)


def _f32_key_scalar(f) -> int:
    f = np.float32(f)
    if f == 0.0:
        f = np.float32(0.0)
    b = int(f.view(np.int32))
    return (b ^ 0x7FFFFFFF) if b < 0 else b


def _f32_atoms(op: int, v) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Key-space expansion of ``f32col <op> v`` whose static structure
    depends on the *op only* (so batched bindings share one kernel trace):
    ``==`` / ``!=`` stay one key atom; order compares become a two-sided
    key interval whose outer bound also excludes NaN lanes.  The
    comparison space mirrors numpy's NEP-50 promotion exactly: weak python
    scalars (and np.float32/float16/bool_) cast onto the float32 lattice
    *before* comparing, while strong np.float64/np.integer scalars compare
    in float64 and snap to the enclosing key.  NaN thresholds become
    impossible / tautological forms.  None when ``v`` leaves the scalar
    fragment (the host oracle then reproduces numpy's behavior, including
    its OverflowError on unconvertible ints)."""
    if v is None or _is_setlike(v):
        return None
    if isinstance(v, np.longdouble):
        return None
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        # strong numpy scalars: float64 / integers promote the comparison
        # to float64; float32 / float16 / bool_ stay on the f32 lattice
        mode64 = isinstance(v, (np.float64, np.integer))
        t = float(v)
    elif isinstance(v, (bool, int, float)):
        mode64 = False  # weak python scalar: casts to the column's float32
        try:
            t = float(v)
        except OverflowError:
            return None  # numpy raises on such ints too
    else:
        return None
    if t != t:  # NaN: False under every op but != (which is all-True)
        if op == EQ:
            return ((EQ, _KEY_IMPOSSIBLE),)
        if op == _NE:
            return ((_NE, _KEY_IMPOSSIBLE),)
        return ((_GE, 0), (_LE, -1))  # empty interval, same static shape
    with np.errstate(over="ignore"):
        f = np.float32(t)
    ff = float(f)
    # float32-space compares use f itself as the (exact) threshold; the
    # float64 mode must instead snap non-representable thresholds to the
    # enclosing key — comparing ff to t in *python float64* on purpose
    exact = ff == t or not mode64
    k = _f32_key_scalar(f)
    if op == EQ:
        return ((EQ, k if exact else _KEY_IMPOSSIBLE),)
    if op == _NE:
        return ((_NE, k if exact else _KEY_IMPOSSIBLE),)
    if exact:
        # k-1 / k+1 never leave int32: real keys stop at key(±inf)
        hi = k if op == _LE else k - 1   # <=t : key<=k ; <t : key<=k-1
        lo = k if op == _GE else k + 1   # >=t : key>=k ; >t : key>=k+1
    else:
        # f = float32(t) rounded; which side f landed on decides the snap
        hi = k - 1 if ff > t else k      # col <(=) t  <=>  key <= hi
        lo = k + 1 if ff < t else k      # col >(=) t  <=>  key >= lo
    if op in (_LT, _LE):
        return ((_GE, _KEY_NEG_INF), (_LE, hi))
    return ((_GE, lo), (_LE, _KEY_POS_INF))


class _SetOps:
    """Launch operands for fused membership: the flat sorted int32 key slab
    (host copy for the stats mirror, ``dev`` on the scan device), per-
    (binding, set-atom) segment offsets/lengths ``[K, M]``, the slab row
    index of each set atom's column, and the binary-search depth."""

    __slots__ = ("set_cols", "slab", "off", "len_", "iters", "dev")

    def __init__(self, set_cols: Tuple[int, ...], slab: np.ndarray,
                 off: np.ndarray, len_: np.ndarray, iters: int, dev=None):
        self.set_cols = set_cols
        self.slab = slab
        self.off = off
        self.len_ = len_
        self.iters = iters
        self.dev = dev


def _skipped_blocks(static_atoms, lo: np.ndarray, hi: np.ndarray,
                    thr: np.ndarray, set_ops: Optional[_SetOps] = None) -> int:
    """Host-side mirror of the kernel's in-kernel zone check (stats only):
    grid blocks no binding can match, which the launch early-outs."""
    alive = np.ones((thr.shape[0], lo.shape[1]), dtype=bool)
    for j, (_, op) in enumerate(static_atoms):
        l, h = lo[j][None, :], hi[j][None, :]
        t = thr[:, j][:, None]
        if op == EQ:
            a = (l <= t) & (t <= h)
        elif op == _NE:
            a = ~((l == h) & (l == t))
        elif op == _LT:
            a = l < t
        elif op == _LE:
            a = l <= t
        elif op == _GT:
            a = h > t
        else:
            a = h >= t
        alive &= a
    if set_ops is not None:
        # set atom m's bounds ride in lane rows A..A+M; a block stays alive
        # for binding k only if some set member falls inside [lo, hi]
        A = len(static_atoms)
        slab = set_ops.slab
        for m in range(len(set_ops.set_cols)):
            l, h = lo[A + m], hi[A + m]
            for k in range(thr.shape[0]):
                o = int(set_ops.off[k, m])
                ln = int(set_ops.len_[k, m])
                if ln == 0:
                    alive[k] = False
                    continue
                seg = slab[o:o + ln]
                i = np.searchsorted(seg, l, side="left")
                alive[k] &= (i < ln) & (seg[np.minimum(i, ln - 1)] <= h)
    return int((~alive.any(axis=0)).sum())


def _prep_set_raw(arr: np.ndarray, flavor: str) -> Optional[np.ndarray]:
    """Sorted unique int32 keys whose fused membership matches
    ``np.isin(col, arr)`` exactly for a column of the given flavor.
    Entries no column value can ever equal are dropped (out-of-range ints,
    values float32 can't represent, NaN — ``isin`` never matches NaN);
    None when the set itself leaves the fragment."""
    if arr.ndim != 1 or arr.dtype.kind not in "iufb":
        return None
    if flavor == "int":
        if arr.dtype.kind == "f":
            ok = np.isfinite(arr) & (np.floor(arr) == arr)
            a = arr[ok]
            keys = a[(a >= INT32_MIN) & (a <= INT32_MAX)].astype(np.int64)
        elif arr.dtype.kind == "u":
            # range-filter in unsigned space before any cast can wrap
            au = arr.astype(np.uint64)
            keys = au[au <= np.uint64(INT32_MAX)].astype(np.int64)
        else:
            a64 = arr.astype(np.int64)
            keys = a64[(a64 >= INT32_MIN) & (a64 <= INT32_MAX)]
        return np.unique(keys.astype(np.int32))
    # f32 flavor: numpy's isin compares in float64, so only set entries a
    # float32 lane value can equal — i.e. exactly float32-representable
    # ones — can ever match; NaN drops out via NaN != NaN
    a64 = arr.astype(np.float64)
    with np.errstate(over="ignore"):
        f32 = a64.astype(np.float32)
    keep = f32.astype(np.float64) == a64
    return np.unique(_f32_key(f32[keep]))


class _KernelSlab:
    """Device-resident launch operands for one (table, column-set): the
    padded int32 slab uploaded once, plus per-block min/max bounds the
    batched kernel prunes against in-kernel.  ``bounds`` caches, per launch
    row layout (atom columns, then set columns), the selected ``[A+M, G]``
    bounds on the host (stats mirror) and on the device (kernel operand)."""

    __slots__ = ("dev", "lo", "hi", "n", "bounds")

    def __init__(self, dev, lo: np.ndarray, hi: np.ndarray, n: int):
        self.dev = dev
        self.lo = lo
        self.hi = hi
        self.n = n
        self.bounds: Dict[Tuple[int, ...], Tuple] = {}


class TorchBackend(NumpyBackend):
    """Device carrier for predicate scans.

    Comparison atoms in the int32 fragment run through the fused
    ``kernels/pred_filter`` batched kernel over a device-resident columnar
    slab (uploaded once per table/column-set, with per-block zone bounds
    fused into the launch).  float32 comparisons join the same launch via
    an order-preserving sign-folded int32 key lane with thresholds
    translated exactly (NaN / ±inf / -0.0 semantics match numpy
    bit-for-bit), and ``IN`` atoms evaluate *in-kernel* by per-row binary
    search over sorted set segments cached on the device next to the slab —
    one launch carries the whole atom program.  Atoms outside the fragment
    (float64 columns, unbound params, residuals) fall back to the NumPy
    oracle — correctness never depends on the kernel fragment.

    ``device`` is explicit (:func:`resolve_device`): ``None``/``"cuda"``
    launches the CUDA kernel, ``"cpu"`` runs its plain PyTorch version.  A
    *measured* rows x atoms cutover decides when the plain numpy path wins
    instead (``core/dispatch.py``); ``device_cutover=0`` sends every
    in-fragment scan to the device — the correctness-testing configuration.

    Encoded ``StoredTable`` stages scan in situ on the device via
    :meth:`scan_stored`: dictionary / frame-of-reference / bitpacked columns
    upload as int32 *code* slabs and thresholds are translated into code
    space, so no decode happens on the scan path."""

    name = "torch"

    # kernel slabs hold full-table copies — keep the cap small
    SLAB_CACHE = 32
    COL_OK_CACHE = 4096
    SET_CACHE = 64
    # largest total key count one launch's set slab may carry: past this the
    # linear host probe beats the deepening binary search anyway, and device
    # set memory stays bounded
    SET_SLAB_LIMIT = 1 << 16

    # this backend records its own device-vs-host cost decision in scan();
    # the engine must not double-report a "serial" decision on top
    reports_cost = True

    def __init__(self, device=None, block_rows: int = 1024,
                 device_cutover: Optional[int] = None,
                 batch_cutover: Optional[int] = None):
        self.device = resolve_device(device)
        # probe keys and explain() meta name the device type
        self.mode = self.device.type
        self.block_rows = block_rows
        self._device_cutover = device_cutover
        self._batch_cutover = batch_cutover if batch_cutover is not None \
            else device_cutover
        # slab cache: table uid -> (weakref, {cols tuple: _KernelSlab});
        # uids are minted once per table and never recycled, so a dead
        # table's key can't alias a new table the way id() can
        self._slabs: LRUCache = LRUCache(self.SLAB_CACHE)
        # per-(table, col) / per-encoding int32-representability verdict
        # (columns are immutable, so the O(N) range check runs once)
        self._col_ok: LRUCache = LRUCache(self.COL_OK_CACHE)
        # guards the check-then-install on both caches: a slab entry's inner
        # {cols: slab} dict is shared state, and two unsynchronized builders
        # for one table would overwrite (lose) each other's entries
        self._lock = threading.Lock()
        self._stats = None  # ScanStats, attached by the owning engine
        self._cost = None  # CostModel, attached by the owning engine
        self._device_confidence = 1.0
        self._batch_confidence = 1.0
        # prepared membership sets (sorted int32 key segments) by value
        # identity — the launch reuses them across bindings and scans
        self._sets: LRUCache = LRUCache(self.SET_CACHE)
        # member / rle cutovers follow the batch pattern: an explicit
        # device_cutover forces them too (the testing configuration)
        self._member_cutover = device_cutover
        self._member_confidence = 1.0
        self._rle_cutover = device_cutover
        self._rle_confidence = 1.0
        self._bench_slabs: Dict = {}  # cutover-measurement slabs (tiny)
        # device copies of prepared key sets, by key-array identity (the
        # prepared arrays are themselves cached, so ids stay stable)
        self._set_devs: LRUCache = LRUCache(self.SET_CACHE)

    def caches(self) -> Dict[str, LRUCache]:
        return {"slabs": self._slabs, "col_ok": self._col_ok,
                "sets": self._sets, "set_devs": self._set_devs}

    def attach_stats(self, stats) -> None:
        """Called by the owning ScanEngine so device launches land in its
        ScanStats (device_scans / device_blocks_pruned / ...)."""
        self._stats = stats

    def attach_cost(self, cost_model) -> None:
        """Called by the owning ScanEngine: device-vs-host dispatch consults
        (and feeds observations into) this ``core.cost.CostModel``."""
        self._cost = cost_model

    # ------------------------------------------------------------------ #
    # measured dispatch cutover
    # ------------------------------------------------------------------ #
    def device_cutover_value(self) -> int:
        """rows x atoms work product below which the numpy path wins a
        single-binding scan."""
        if self._device_cutover is None:
            from .dispatch import device_scan_probe

            probe = device_scan_probe(
                f"scan:{self.mode}:{self.block_rows}", self._bench_launch,
                n_atoms=4, batch=1)
            self._device_cutover = probe.value
            self._device_confidence = probe.confidence
        return self._device_cutover

    def batch_cutover_value(self) -> int:
        """rows x atoms x bindings product below which B sequential numpy
        scans beat one batched launch."""
        if self._batch_cutover is None:
            from .dispatch import device_scan_probe

            probe = device_scan_probe(
                f"batch:{self.mode}:{self.block_rows}", self._bench_launch,
                n_atoms=4, batch=8)
            self._batch_cutover = probe.value
            self._batch_confidence = probe.confidence
        return self._batch_cutover

    def member_cutover_value(self) -> int:
        """rows-work product below which the host ``np.isin`` probe beats
        the fused in-kernel membership search."""
        if self._member_cutover is None:
            from .dispatch import member_scan_probe

            probe = member_scan_probe(
                f"member:{self.mode}:{self.block_rows}", self._bench_member)
            self._member_cutover = probe.value
            self._member_confidence = probe.confidence
        return self._member_cutover

    def rle_cutover_value(self) -> int:
        """rows-work product below which the host run-space evaluate-and-
        expand beats routing the run values through a device launch."""
        if self._rle_cutover is None:
            from .dispatch import rle_scan_probe

            probe = rle_scan_probe(
                f"rle:{self.mode}:{self.block_rows}", self._bench_rle)
            self._rle_cutover = probe.value
            self._rle_confidence = probe.confidence
        return self._rle_cutover

    def _member_seed(self) -> Dict[str, float]:
        """Cost-model seed kwargs for the fused-membership route."""
        from .cost import MEMBER_RATIO

        return {"cutover": float(self.member_cutover_value()),
                "ratio": MEMBER_RATIO,
                "confidence": self._member_confidence}

    def _rle_seed(self) -> Dict[str, float]:
        """Cost-model seed kwargs for the run-space rle route."""
        from .cost import RLE_RATIO

        return {"cutover": float(self.rle_cutover_value()),
                "ratio": RLE_RATIO,
                "confidence": self._rle_confidence}

    @staticmethod
    def _device_ratio() -> float:
        """Seeded device marginal cost relative to the serial host scan,
        measured on the card (``core/cost.py``)."""
        from .cost import DEVICE_RATIO_CUDA

        return DEVICE_RATIO_CUDA

    def _device_seed(self, batch: bool = False) -> Dict[str, float]:
        """Cost-model seed kwargs for the device routes, derived from the
        measured (and invalidatable) dispatch probe."""
        if batch:
            return {"cutover": float(self.batch_cutover_value()),
                    "ratio": self._device_ratio(),
                    "confidence": self._batch_confidence}
        return {"cutover": float(self.device_cutover_value()),
                "ratio": self._device_ratio(),
                "confidence": self._device_confidence}

    def _use_device(self, n: int, n_atoms: int, n_bindings: int) -> bool:
        w = float(n) * n_atoms * n_bindings
        if self._cost is not None:
            route = "device" if n_bindings == 1 else "device_batch"
            return self._cost.prefer(route, w,
                                     **self._device_seed(batch=n_bindings > 1))
        cut = (self.device_cutover_value() if n_bindings == 1
               else self.batch_cutover_value())
        return w >= cut

    def _bench_launch(self, slab: np.ndarray, thr: np.ndarray) -> np.ndarray:
        """Measurement probe for ``dispatch.device_scan_probe``: the real
        launch path on a synthetic slab (entry build amortized, as in real
        scans where the slab cache is warm)."""
        key = (id(slab), thr.shape)
        ent = self._bench_slabs.get(key)
        if ent is not None and ent[0] is slab:
            entry = ent[1]
        else:
            entry = self._build_entry(slab)
            # anchor the probe array: its id stays pinned while cached, so
            # a recycled id can't hand a different probe this entry
            self._bench_slabs[key] = (slab, entry)
        # op order must mirror the dispatch module's host ops: >= < > <=
        codes = (_GE, _LT, _GT, _LE)
        atoms = tuple((j, codes[j % 4]) for j in range(thr.shape[1]))
        return self._launch(entry, atoms, thr, count_stats=False)

    def _bench_member(self, vals: np.ndarray, vset: np.ndarray) -> np.ndarray:
        """Measurement probe for ``dispatch.member_scan_probe``: a real
        fused-membership launch over a synthetic column (slab build
        amortized, as in warm real scans)."""
        key = ("member", id(vals), vals.shape)
        ent = self._bench_slabs.get(key)
        if ent is not None and ent[0] is vals:
            entry = ent[1]
        else:
            entry = self._build_entry(vals[None, :].astype(np.int32))
            self._bench_slabs[key] = (vals, entry)
        slab = np.unique(vset.astype(np.int32))
        ops = _SetOps((0,), slab, np.zeros((1, 1), np.int32),
                      np.full((1, 1), slab.size, np.int32),
                      search_iters(int(slab.size)),
                      dev=self._to_dev(slab))
        thr = np.full((1, 1), INT32_MIN, dtype=np.int32)
        return self._launch(entry, ((0, _GE),), thr, count_stats=False,
                            set_ops=ops)[0]

    def _bench_rle(self, rv: np.ndarray, rl: np.ndarray,
                   thr: int) -> np.ndarray:
        """Measurement probe for ``dispatch.rle_scan_probe``: evaluate in
        run space on device, expand survivors on the host."""
        key = ("rle", id(rv), rv.shape)
        ent = self._bench_slabs.get(key)
        if ent is not None and ent[0] is rv:
            entry = ent[1]
        else:
            entry = self._build_entry(rv[None, :].astype(np.int32))
            self._bench_slabs[key] = (rv, entry)
        t = np.asarray([[thr]], dtype=np.int32)
        run_mask = self._launch(entry, ((0, _GE),), t, count_stats=False)[0]
        return np.repeat(run_mask, rl)

    # ------------------------------------------------------------------ #
    # table scans
    # ------------------------------------------------------------------ #
    def scan(self, prog: AtomProgram, table: Table,
             binding: Dict[str, object]) -> np.ndarray:
        n = table.nrows
        mask = np.ones(n, dtype=bool)
        kernel_cmp, fallback_cmp = self._split_cmp(prog, table, binding)
        if n:
            kernel_isin, fallback_isin = self._split_isin(prog, table,
                                                          binding)
        else:
            kernel_isin, fallback_isin = [], list(prog.isin_atoms)
        ch = None
        if (kernel_cmp or kernel_isin) and n:
            # route name tells explain() what the launch carries: fused
            # membership dominates the cost shape when present, the float
            # key lane otherwise, plain int32 compares else
            route = ("device_member" if kernel_isin
                     else "device_float" if any(
                         self._f32_col(table, a.col) for a in kernel_cmp)
                     else "device")
            seed = (self._member_seed() if route == "device_member"
                    else self._device_seed())
            if self._cost is not None:
                # cost-model consult, recorded for explain(): the fused
                # launch vs. keeping every atom on the numpy path
                from .cost import prog_atoms

                A = prog_atoms(prog)
                ch = self._cost.choose(
                    f"scan:{getattr(table, 'name', None) or '?'}",
                    [("serial", float(n) * A),
                     (route, float(n) * (len(kernel_cmp) + len(kernel_isin)),
                      seed)],
                    meta={"rows": int(n), "atoms": int(A),
                          "kernel_atoms": len(kernel_cmp),
                          "kernel_sets": len(kernel_isin),
                          "backend": self.mode},
                )
                use_dev = ch.route == route
            else:
                use_dev = self._use_device(
                    n, len(kernel_cmp) + len(kernel_isin), 1)
            if not use_dev:
                # below the measured crossover the numpy path wins — keep it
                fallback_cmp = kernel_cmp + fallback_cmp
                kernel_cmp = []
                fallback_isin = [a for a, _ in kernel_isin] + fallback_isin
                kernel_isin = []
        t0 = time.perf_counter() if ch is not None else 0.0
        if (kernel_cmp or kernel_isin) and n:
            mask &= self._kernel_scan(kernel_cmp, table, binding,
                                      isin=kernel_isin)
        for a in fallback_cmp:
            mask &= self._cmp_mask(a, table, binding, n)
        for a in fallback_isin:
            mask &= self._isin_mask(a, table, binding, n)
        for r in (prog.residual_static, prog.residual_dynamic):
            if r is not None:
                mask &= np.asarray(eval_np(r, table.cols, binding, n=n), bool)
        if ch is not None:
            ch.done(time.perf_counter() - t0)
        return mask

    def scan_batch_fused(self, prog: AtomProgram, table: Table,
                         bindings: Sequence[Dict[str, object]]
                         ) -> Optional[List[np.ndarray]]:
        """One fused launch answering every binding of a coalesced
        ``query_batch``: thresholds become a ``[B, A]`` runtime operand, each
        column block is read once for all B predicates, and in-kernel zone
        pruning skips blocks no binding can match.  Membership atoms ride
        the same launch as ragged per-binding set segments; float32 atoms
        expand into key-space intervals with op-only static structure.
        Returns None when the program leaves the kernel fragment or the
        batch is below the measured cutover (callers keep the host batch
        path)."""
        if (prog.residual_static is not None
                or prog.residual_dynamic is not None
                or not (prog.cmp_atoms or prog.isin_atoms) or not bindings):
            return None
        atoms = prog.cmp_atoms
        n = table.nrows
        if n and not self._use_device(n, len(atoms) + len(prog.isin_atoms),
                                      len(bindings)):
            return None
        B = len(bindings)
        cols = tuple(sorted({a.col for a in atoms}
                            | {a.col for a in prog.isin_atoms}))
        order = {c: i for i, c in enumerate(cols)}
        static: List[Tuple[int, int]] = []
        thr_cols: List[np.ndarray] = []
        for a in atoms:
            if a.kind == "col":
                return None
            flavor = self._col_flavor(table, a.col)
            if flavor is None:
                return None
            if flavor == "f32":
                # canonical expansions share static structure across B:
                # one key atom for ==/!=, a two-sided interval otherwise
                plans = []
                for b in bindings:
                    v = a.rhs if a.kind == "lit" else _bind(b, a.rhs)
                    p = _f32_atoms(a.op, v)
                    if p is None:
                        return None
                    plans.append(p)
                for j in range(len(plans[0])):
                    static.append((order[a.col], plans[0][j][0]))
                    thr_cols.append(np.asarray([p[j][1] for p in plans],
                                               dtype=np.int32))
                continue
            if a.kind == "lit":
                t = self._kernel_value(a.rhs)
                if t is None:
                    return None
                col_thr = np.full(B, t, dtype=np.int32)
            else:
                col_thr = np.empty(B, dtype=np.int32)
                for k, b in enumerate(bindings):
                    t = self._kernel_value(_bind(b, a.rhs))
                    if t is None:
                        return None
                    col_thr[k] = t
            static.append((order[a.col], a.op))
            thr_cols.append(col_thr)
        set_ops = None
        if prog.isin_atoms:
            set_ops = self._batch_set_operands(prog, table, bindings, order)
            if set_ops is None:
                return None
        if n == 0:
            return [np.zeros(0, dtype=bool) for _ in bindings]
        if not static:
            # pure-membership batch: the kernel wants >= 1 cmp atom, so
            # inject the tautology lane >= INT32_MIN on a set column
            static.append((set_ops.set_cols[0], _GE))
            thr_cols.append(np.full(B, INT32_MIN, dtype=np.int32))
        entry = self._slab_entry(table, cols)
        thr = np.stack(thr_cols, axis=1)
        masks = self._launch(entry, tuple(static), thr, set_ops=set_ops)
        if self._stats is not None:
            bumps = {"device_batch_scans": 1, "device_batch_rows": B}
            if prog.isin_atoms:
                bumps["member_fused_scans"] = 1
                bumps["member_fused_sets"] = len(prog.isin_atoms) * B
            if any(self._f32_col(table, a.col) for a in atoms):
                bumps["float_lane_scans"] = 1
            self._stats.bump(**bumps)
        return list(masks)

    def _batch_set_operands(self, prog: AtomProgram, table: Table,
                            bindings: Sequence[Dict[str, object]],
                            order: Dict[str, int]) -> Optional[_SetOps]:
        """Ragged ``[B, M]`` segment table for a coalesced batch: per-binding
        sets concatenate into one slab, lit sets share one segment across
        all bindings.  None when any set leaves the fragment, a param is
        unbound, or the combined slab blows the launch budget."""
        B = len(bindings)
        M = len(prog.isin_atoms)
        col_idxs: List[int] = []
        segs: List[np.ndarray] = []
        off = np.zeros((B, M), dtype=np.int32)
        ln = np.zeros((B, M), dtype=np.int32)
        pos = 0
        max_len = 1
        for m, a in enumerate(prog.isin_atoms):
            flavor = (self._col_flavor(table, a.col)
                      if a.kind != "col" else None)
            if flavor is None:
                return None
            col_idxs.append(order[a.col])
            if a.kind == "lit":
                keys = self._prepared_set(a.rhs, flavor)
                if keys is None:
                    return None
                segs.append(keys)
                off[:, m] = pos
                ln[:, m] = keys.size
                pos += keys.size
                max_len = max(max_len, int(keys.size))
            else:
                for k, b in enumerate(bindings):
                    if a.rhs not in b:
                        return None  # unbound: the host path raises uniformly
                    keys = self._prepared_set(b[a.rhs], flavor)
                    if keys is None:
                        return None
                    segs.append(keys)
                    off[k, m] = pos
                    ln[k, m] = keys.size
                    pos += keys.size
                    max_len = max(max_len, int(keys.size))
        if pos > self.SET_SLAB_LIMIT:
            return None
        slab = (np.concatenate(segs).astype(np.int32) if pos
                else np.zeros(1, dtype=np.int32))
        return _SetOps(tuple(col_idxs), slab, off, ln, search_iters(max_len),
                       dev=self._slab_dev(segs, slab))

    # ------------------------------------------------------------------ #
    # encoded (StoredTable) scans — in situ, on device, no decode
    # ------------------------------------------------------------------ #
    def scan_stored(self, prog: AtomProgram, st,
                    binding: Dict[str, object],
                    force: bool = False) -> Optional[np.ndarray]:
        """Device mask over an encoded ``core.store.StoredTable``: encoded
        columns upload once as int32 *code* slabs (dict codes, FoR frame
        offsets, unpacked bits, delta/scaled value lanes) and thresholds
        translate into code space, so the fused kernel scans in situ.  RLE
        columns never flatten: their atoms evaluate directly on the run
        *values* (an n_runs-length lane) and only surviving runs expand —
        touched work is O(runs), not O(rows), and the column never decodes.
        None when any atom falls outside the encoded-int32 fragment or
        below the cutover — the caller keeps the host in-situ / decode
        paths.  ``force=True`` skips the cutover consult (the store's
        cost-model dispatch already approved the device route); viability
        checks still apply."""
        if (prog.isin_atoms or prog.residual_static is not None
                or prog.residual_dynamic is not None or not prog.cmp_atoms):
            return None
        n = st.nrows
        if not force and not self._use_device(n, len(prog.cmp_atoms), 1):
            return None
        trans = []      # flat int32 code lanes -> one fused launch
        run_trans = []  # rle columns -> run-space atoms, expanded after
        for a in prog.cmp_atoms:
            if a.kind == "col":
                return None
            enc = st.enc.get(a.col)
            if enc is None:
                return None
            v = a.rhs if a.kind == "lit" else binding.get(a.rhs, _UNBOUND)
            if v is _UNBOUND:
                return None  # unbound param: the fallback raises uniformly
            if getattr(enc, "kind", None) == "rle" and self._rle_lane_ok(enc):
                ot = self._rle_thr(a.op, v)
                if ot is None:
                    return None
                run_trans.append((a.col, ot[0], ot[1]))
                continue
            if not self._stored_lane_ok(enc):
                return None
            ot = self._stored_thr(enc, a.op, v)
            if ot is None:
                return None
            trans.append((a.col, ot[0], ot[1]))
        if n == 0:
            return np.zeros(0, dtype=bool)
        mask: Optional[np.ndarray] = None
        if run_trans:
            mask = self._rle_scan(st, run_trans)
        if trans:
            cols = tuple(sorted({c for c, _, _ in trans}))
            order = {c: i for i, c in enumerate(cols)}
            static = tuple((order[c], op) for c, op, _ in trans)
            thr = np.asarray([[t for _, _, t in trans]], dtype=np.int32)
            entry = self._stored_entry(st, cols)
            flat = self._launch(entry, static, thr)[0]
            mask = flat if mask is None else (mask & flat)
        return mask

    def _rle_lane_ok(self, enc) -> bool:
        """Can this RLE column evaluate in run space?  The run *values*
        must fit the int32 lanes (run lengths only drive the expansion).
        Keyed by (uid, row watermark): a column that grows rows under a
        stable identity can never serve its pre-growth verdict."""
        ck = ("rle", table_uid(enc), int(enc.n))
        entry = self._col_ok.get(ck)
        if entry is not None and entry[0]() is enc:
            return entry[1]
        rv = enc.run_values
        ok = rv.dtype.kind in "iu" and (
            rv.size == 0
            or (int(rv.min()) >= INT32_MIN and int(rv.max()) <= INT32_MAX))
        with self._lock:
            self._col_ok[ck] = (
                weakref.ref(enc, lambda _, k=ck, d=self._col_ok: d.pop(k, None)),
                ok,
            )
        return ok

    @staticmethod
    def _rle_thr(op: int, v) -> Optional[Tuple[int, int]]:
        """Run-space atom for ``col <op> v``: runs carry the decoded values
        themselves, so the flat-lane threshold shift applies unchanged."""
        if v is None or _is_setlike(v):
            return None
        if isinstance(v, np.generic):
            v = v.item()
        if not isinstance(v, (bool, int, float)):
            return None
        return _lane_thr(op, v)

    def _rle_scan(self, st, run_trans) -> np.ndarray:
        """Evaluate rle atoms on their run-value lanes (one launch per
        column) and expand only the surviving runs on the host."""
        mask = np.ones(st.nrows, dtype=bool)
        by_col: Dict[str, List[Tuple[int, int]]] = {}
        for c, op, t in run_trans:
            by_col.setdefault(c, []).append((op, t))
        for c, atoms in by_col.items():
            enc = st.enc[c]
            if enc.run_values.size == 0:
                continue
            entry = self._stored_entry(st, (("runs", c),))
            static = tuple((0, op) for op, _ in atoms)
            thr = np.asarray([[t for _, t in atoms]], dtype=np.int32)
            run_mask = self._launch(entry, static, thr)[0]
            if self._stats is not None:
                self._stats.bump(rle_run_scans=1,
                                 rle_rows_expanded=int(st.nrows))
            mask &= np.repeat(run_mask, enc.run_lengths)
        return mask

    def _stored_lane_ok(self, enc) -> bool:
        """Can this encoding scan as an int32 code lane?  Cached per
        (encoded-column object, row watermark) — appends build new columns,
        but the watermark guards even an in-place grower."""
        ck = ("enc", table_uid(enc), int(enc.n))
        entry = self._col_ok.get(ck)
        if entry is not None and entry[0]() is enc:
            return entry[1]
        kind = enc.kind
        if kind == "plain":
            arr = enc.values
            ok = arr.dtype.kind in "iu" and np.abs(arr).max(initial=0) < 2**31
        elif kind == "dict":
            codes = enc.codes
            ok = codes.dtype.kind in "iu" and (
                codes.dtype.itemsize <= 2 or int(codes.max(initial=0)) < 2**31
            ) and enc.values.dtype.kind in "iuf"
        elif kind == "for":
            p = enc.packed
            ok = p.dtype.kind in "iu" and (
                p.dtype.itemsize <= 2 or int(p.max(initial=0)) < 2**31
            )
        elif kind == "bitpack":
            ok = True
        elif kind == "delta":
            # delta lanes materialize into the slab cache once; viable when
            # the (sorted) column's span fits int32 — min is the first
            # anchor, max the last value of the last block
            try:
                if enc.n == 0:
                    ok = True
                elif np.dtype(enc.dtype).kind not in "iu":
                    ok = False
                else:
                    lo = int(enc.anchors[0])
                    hi = int(enc._block_vals(len(enc.anchors) - 1)[-1])
                    ok = lo >= INT32_MIN and hi <= INT32_MAX
            except Exception:
                ok = False
        elif kind == "scaled":
            # scaled columns scan on the *inner* integer lane; thresholds
            # translate through the verified-boundary walk (_scaled_thr),
            # which assumes the inner decode yields the integers k itself —
            # so only integer-decoding inner kinds qualify
            ok = (enc.inner.kind in ("plain", "for", "bitpack", "delta")
                  and self._stored_lane_ok(enc.inner))
        else:  # rle: run-space path (scan_stored), no flat row lane
            ok = False
        with self._lock:
            self._col_ok[ck] = (
                weakref.ref(enc, lambda _, k=ck, d=self._col_ok: d.pop(k, None)),
                ok,
            )
        return ok

    @staticmethod
    def _stored_lane(enc) -> np.ndarray:
        kind = enc.kind
        if kind == "plain":
            return enc.values.astype(np.int32)
        if kind == "dict":
            return enc.codes.astype(np.int32)
        if kind == "for":
            return enc.packed.astype(np.int32)
        if kind == "scaled":
            return TorchBackend._stored_lane(enc.inner)
        # bitpack (0/1 lanes) and delta (cached cumsum) materialize values
        return enc.decode().astype(np.int32)

    @staticmethod
    def _stored_lane_for(st, c) -> np.ndarray:
        """Lane for one stored-slab column spec: a plain column name uploads
        its int32 code lane; ``("runs", col)`` uploads the rle run *values*
        — a lane of length n_runs, not n_rows."""
        if isinstance(c, tuple):
            return st.enc[c[1]].run_values.astype(np.int32)
        return TorchBackend._stored_lane(st.enc[c])

    @staticmethod
    def _stored_thr(enc, op: int, v) -> Optional[Tuple[int, int]]:
        """``(op, threshold)`` in the encoding's code space, equivalent to
        ``col <op> v`` over the decoded column — the same order-isomorphism
        ``core.store`` exploits for host in-situ compares.  None when the
        atom can't be answered in code space exactly."""
        if v is None or _is_setlike(v):
            return None
        v_orig = v  # scaled columns verify in numpy's own promotion space
        if isinstance(v, np.generic):
            v = v.item()
        if not isinstance(v, (bool, int, float)):
            return None
        kind = enc.kind
        if kind == "dict":
            if v != v:  # NaN
                return _TRUE_ATOM if op == _NE else _FALSE_ATOM
            values = enc.values
            # NaN dictionary values sort last: order-compares that would
            # sweep the tail in (>= / >) can't stay in code space
            if (values.dtype.kind == "f" and len(values)
                    and np.isnan(values[-1]) and op in (_GT, _GE)):
                return None
            try:
                lo = int(values.searchsorted(v, side="left"))
                hi = int(values.searchsorted(v, side="right"))
            except (TypeError, ValueError):
                return None
            if op == EQ:
                return (EQ, lo) if hi > lo else _FALSE_ATOM
            if op == _NE:
                return (_NE, lo) if hi > lo else _TRUE_ATOM
            if op == _LT:
                return (_LT, lo)
            if op == _GE:
                return (_GE, lo)
            if op == _LE:
                return (_LT, hi)
            return (_GE, hi)  # _GT
        if kind == "for":
            if v != v:
                return _TRUE_ATOM if op == _NE else _FALSE_ATOM
            t = (int(v) if isinstance(v, (bool, int)) else float(v)) - enc.base
            return _lane_thr(op, t)
        if kind in ("plain", "bitpack", "delta"):
            # delta lanes carry the materialized values themselves
            return _lane_thr(op, v)
        if kind == "scaled":
            return TorchBackend._scaled_thr(enc, op, v_orig)
        return None

    @staticmethod
    def _scaled_bound(enc, v, strict: bool) -> Optional[int]:
        """Smallest inner value ``k`` whose decode satisfies ``>= v``
        (``> v`` when strict), verified against the *actual* decode chain
        ``dtype(float64(k) / scale)``.  The chain double-rounds (float64
        divide, then the dtype cast), so a purely rational translation of
        the threshold is unsound; instead the exact-rational seed
        ``ceil(v * scale)`` is walked to the verified crossing — g is
        monotone non-decreasing, so a local crossing is the global one.
        The comparison keeps ``v``'s original scalar type so numpy's own
        promotion rules decide the comparison space, exactly as the
        decoded oracle would (NEP-50: weak python floats compare on the
        dtype's lattice, strong float64 scalars in float64).  None when
        the bounded walk doesn't converge (host fallback)."""
        ty = np.dtype(enc.dtype).type
        scale = enc.scale

        def ok(k: int) -> bool:
            g = ty(np.float64(k) / scale)  # the decoded dtype scalar itself
            return bool(g > v) if strict else bool(g >= v)

        try:
            p, q = float(v).as_integer_ratio()
            b = -((-p * scale) // q)  # exact ceil(v * scale)
            for _ in range(256):
                if ok(b):
                    if not ok(b - 1):
                        return int(b)
                    b -= 1
                else:
                    b += 1
        except (TypeError, ValueError, OverflowError):
            return None
        return None

    @staticmethod
    def _scaled_thr(enc, op: int, v) -> Optional[Tuple[int, int]]:
        """``col <op> v`` over a scaled column, rewritten onto the inner
        integer encoding's code space through the verified boundary
        B = min{k : decode(k) >= v} (and its strict twin U).  Equality only
        stays in code space when the decode plateau at ``v`` is a single
        inner value; wider plateaus defer to the host oracle."""
        if v != v:  # NaN
            return _TRUE_ATOM if op == _NE else _FALSE_ATOM
        try:
            fv = float(v)
        except (TypeError, ValueError, OverflowError):
            return None
        if fv in (float("inf"), float("-inf")):
            return _lane_thr(op, fv)  # decoded values are always finite
        B = TorchBackend._scaled_bound(enc, v, strict=False)
        if B is None:
            return None
        if op == _GE:
            return TorchBackend._stored_thr(enc.inner, _GE, B)
        if op == _LT:
            return TorchBackend._stored_thr(enc.inner, _LT, B)
        U = TorchBackend._scaled_bound(enc, v, strict=True)
        if U is None:
            return None
        if op == _GT:
            return TorchBackend._stored_thr(enc.inner, _GE, U)
        if op == _LE:
            return TorchBackend._stored_thr(enc.inner, _LT, U)
        if op == EQ:
            if U == B:
                return _FALSE_ATOM
            if U == B + 1:
                return TorchBackend._stored_thr(enc.inner, EQ, B)
            return None
        # _NE
        if U == B:
            return _TRUE_ATOM
        if U == B + 1:
            return TorchBackend._stored_thr(enc.inner, _NE, B)
        return None

    # ------------------------------------------------------------------ #
    # launch plumbing
    # ------------------------------------------------------------------ #
    def _int32_col(self, table: Table, col: str) -> bool:
        """Is a column exactly representable in the kernel's int32 lanes?
        Cached per (table, row watermark, col) — the range scan runs once
        per table, and growth under a stable identity misses."""
        ck = (table_uid(table), int(table.nrows), col)
        entry = self._col_ok.get(ck)
        if entry is not None and entry[0]() is table:
            return entry[1]
        arr = table.cols.get(col)
        ok = (
            arr is not None
            and arr.dtype.kind in "iu"
            and np.abs(arr).max(initial=0) < 2**31
        )
        with self._lock:
            self._col_ok[ck] = (
                weakref.ref(table,
                            lambda _, k=ck, d=self._col_ok: d.pop(k, None)),
                ok,
            )
        return ok

    @staticmethod
    def _kernel_value(v) -> Optional[int]:
        """int32 kernel threshold for a binding value, or None when the
        value leaves the fragment (sets, bools, non-integral floats, out of
        int32 range)."""
        if v is None or _is_setlike(v) or isinstance(v, (bool, np.bool_)):
            return None
        if isinstance(v, (float, np.floating)) and not float(v).is_integer():
            return None
        try:
            i = int(v)
        except (TypeError, ValueError, OverflowError):
            return None
        if abs(i) >= 2**31:
            return None
        return i

    def _f32_col(self, table: Table, col: str) -> bool:
        """Is a column a float32 lane for the key-space kernel path?
        (float64 columns stay on the host oracle — no exact int64 key lane
        exists in the int32 kernel fragment)."""
        ck = (table_uid(table), int(table.nrows), col, "f32")
        entry = self._col_ok.get(ck)
        if entry is not None and entry[0]() is table:
            return entry[1]
        arr = table.cols.get(col)
        ok = arr is not None and arr.dtype == np.float32
        with self._lock:
            self._col_ok[ck] = (
                weakref.ref(table,
                            lambda _, k=ck, d=self._col_ok: d.pop(k, None)),
                ok,
            )
        return ok

    def _col_flavor(self, table: Table, col: str) -> Optional[str]:
        """Kernel lane flavor of a column: ``"int"`` (raw int32 lane),
        ``"f32"`` (sign-folded key lane), or None (out of fragment)."""
        if self._int32_col(table, col):
            return "int"
        if self._f32_col(table, col):
            return "f32"
        return None

    def _split_cmp(self, prog, table, binding):
        kernel, fallback = [], []
        for a in prog.cmp_atoms:
            v = _UNBOUND
            if a.kind == "lit":
                v = a.rhs
            elif a.kind == "param" and a.rhs in binding:
                v = binding[a.rhs]
            ok = False
            if a.kind != "col" and v is not _UNBOUND:
                flavor = self._col_flavor(table, a.col)
                if flavor == "int":
                    ok = self._kernel_value(v) is not None
                elif flavor == "f32":
                    ok = _f32_atoms(a.op, v) is not None
            (kernel if ok else fallback).append(a)
        return kernel, fallback

    def _prepared_set(self, vals, flavor: str) -> Optional[np.ndarray]:
        """Sorted int32 key segment for one membership set, cached by value
        identity (the strong ref in the entry keeps ids stable).  None when
        the set can't be keyed for this column flavor."""
        ck = ("set", id(vals), flavor)
        ent = self._sets.get(ck)
        if ent is not None and ent[0] is vals:
            return ent[1]
        keys = _prep_set_raw(np.asarray(vals), flavor)
        with self._lock:
            self._sets[ck] = (vals, keys)
        return keys

    def _split_isin(self, prog, table, binding):
        """Partition membership atoms into fused-kernel candidates
        ``[(atom, keys)]`` and host-fallback atoms, under the launch's set
        slab budget."""
        kernel, fallback = [], []
        budget = self.SET_SLAB_LIMIT
        for a in prog.isin_atoms:
            flavor = (self._col_flavor(table, a.col)
                      if a.kind != "col" else None)
            vals = None
            if flavor is not None:
                if a.kind == "lit":
                    vals = a.rhs
                elif a.rhs in binding:
                    vals = binding[a.rhs]
            keys = (self._prepared_set(vals, flavor)
                    if vals is not None else None)
            if keys is None or keys.size > budget:
                fallback.append(a)
            else:
                budget -= int(keys.size)
                kernel.append((a, keys))
        return kernel, fallback

    def _build_entry(self, slab: np.ndarray) -> _KernelSlab:
        """Pad to the block grid with zeros, compute per-block zone bounds
        over the padded slab (as the reference does, so block-prune stats
        agree), and upload the slab — done once per (table, column-set),
        cached."""
        n = slab.shape[1]
        pad = (-n) % self.block_rows
        padded = np.pad(slab, ((0, 0), (0, pad))) if pad else slab
        padded = np.ascontiguousarray(padded, dtype=np.int32)
        lo, hi = block_bounds(padded, self.block_rows,
                              tuple(range(padded.shape[0])))
        return _KernelSlab(self._to_dev(padded), lo, hi, n)

    def _to_dev(self, arr: np.ndarray):
        """``arr`` (int32) as a tensor on the scan device: a zero-copy view
        on the CPU, one host-to-device copy on the card."""
        import torch

        return torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.int32)).to(self.device)

    def _keys_dev(self, keys: np.ndarray):
        """Device copy of one prepared key set, cached beside it (by the
        identity of the cached key array) so repeated launches with the same
        set upload it once."""
        ck = id(keys)
        ent = self._set_devs.get(ck)
        if ent is not None and ent[0] is keys:
            return ent[1]
        dev = self._to_dev(keys)
        with self._lock:
            self._set_devs[ck] = (keys, dev)
        return dev

    def _slab_dev(self, segs: Sequence[np.ndarray], slab: np.ndarray):
        """The launch's set slab on the device: the cached device copies of
        its segments, concatenated there (the all-empty case is the one-key
        dummy slab, as on the host)."""
        import torch

        parts = [self._keys_dev(k) for k in segs if k.size]
        if not parts:
            return self._to_dev(slab)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _table_lane(self, table: Table, c: str) -> np.ndarray:
        """int32 kernel lane for one column: raw values for int columns,
        sign-folded total-order keys for float32 columns."""
        arr = np.asarray(table.cols[c])
        if arr.dtype == np.float32:
            return _f32_key(arr)
        return arr.astype(np.int32)

    def _slab_entry(self, table: Table, cols: Tuple[str, ...]) -> _KernelSlab:
        # per-colset values carry the row watermark: a slab built before an
        # append is never served for the grown table, even though the table's
        # identity (uid) is stable across in-place appends
        tk = table_uid(table)
        n = int(table.nrows)
        entry = self._slabs.get(tk)
        if entry is not None and entry[0]() is table:
            hit = entry[1].get(cols)
            if hit is not None and hit[0] == n:
                return hit[1]
        slab = np.stack([self._table_lane(table, c) for c in cols])
        built = self._build_entry(slab)
        with self._lock:
            entry = self._slabs.get(tk)
            if entry is None or entry[0]() is not table:
                # the weakref callback evicts the entry when the table dies, so
                # dead tables don't pin their slabs for the engine's lifetime
                ref = weakref.ref(table,
                                  lambda _, k=tk, d=self._slabs: d.pop(k, None))
                self._slabs[tk] = (ref, {cols: (n, built)})
            else:
                cur = entry[1].get(cols)
                if cur is not None and cur[0] == n:
                    built = cur[1]
                else:
                    entry[1][cols] = (n, built)
        return built

    def _stored_entry(self, st, cols: Tuple[str, ...]) -> _KernelSlab:
        tk = ("stored", table_uid(st))
        n = int(st.nrows)
        entry = self._slabs.get(tk)
        if entry is not None and entry[0]() is st:
            hit = entry[1].get(cols)
            if hit is not None and hit[0] == n:
                return hit[1]
        slab = np.stack([self._stored_lane_for(st, c) for c in cols])
        built = self._build_entry(slab)
        with self._lock:
            entry = self._slabs.get(tk)
            if entry is None or entry[0]() is not st:
                ref = weakref.ref(st,
                                  lambda _, k=tk, d=self._slabs: d.pop(k, None))
                self._slabs[tk] = (ref, {cols: (n, built)})
            else:
                cur = entry[1].get(cols)
                if cur is not None and cur[0] == n:
                    built = cur[1]
                else:
                    entry[1][cols] = (n, built)
        return built

    def _launch(self, entry: _KernelSlab, static_atoms: Tuple[Tuple[int, int], ...],
                thr: np.ndarray, count_stats: bool = True,
                set_ops: Optional[_SetOps] = None) -> np.ndarray:
        """Run one fused launch: ``[K, A]`` thresholds against the cached
        slab, in-kernel zone pruning from the cached block bounds, plus —
        when ``set_ops`` is given — ragged per-binding membership segments
        searched in-kernel.  Returns ``[K, n]`` boolean masks (padding
        sliced away); the readback synchronizes with the device."""
        K, A = thr.shape
        rows = tuple(ci for ci, _ in static_atoms)
        if set_ops is not None:
            # set atom m's zone bounds ride in lane rows A..A+M
            rows = rows + tuple(set_ops.set_cols)
        bnd = entry.bounds.get(rows)
        if bnd is None:
            lo, hi = entry.lo[list(rows)], entry.hi[list(rows)]
            bnd = (lo, hi, self._to_dev(lo), self._to_dev(hi))
            with self._lock:
                entry.bounds[rows] = bnd
        lo, hi, lo_dev, hi_dev = bnd
        # one upload carries the per-launch operands: thresholds, the set
        # segment offsets and lengths, then the atom program
        set_cols = set_ops.set_cols if set_ops is not None else ()
        parts = [thr.ravel()]
        if set_ops is not None:
            parts += [set_ops.off.ravel(), set_ops.len_.ravel()]
        parts.append(pack_program(static_atoms, set_cols))
        ops_dev = self._to_dev(np.concatenate(parts))
        thr_dev = ops_dev[:K * A].view(K, A)
        M = len(set_cols)
        kw = dict(program=ops_dev[K * (A + 2 * M):])
        if set_ops is not None:
            slab_dev = (set_ops.dev if set_ops.dev is not None
                        else self._to_dev(set_ops.slab))
            kw.update(set_cols=set_cols, set_slab=slab_dev,
                      set_off=ops_dev[K * A:K * (A + M)].view(K, M),
                      set_len=ops_dev[K * (A + M):K * (A + 2 * M)].view(K, M),
                      iters=set_ops.iters)
        out = pred_filter_batch(entry.dev, thr_dev, static_atoms, lo_dev,
                                hi_dev, block_rows=self.block_rows, **kw)
        mask = out[:, :entry.n].cpu().numpy()
        if count_stats and self._stats is not None:
            self._stats.bump(
                device_scans=1,
                device_rows=K * entry.n,
                device_blocks_pruned=_skipped_blocks(static_atoms, lo, hi,
                                                     thr, set_ops=set_ops),
            )
        return mask

    def _set_operands(self, col_idxs: List[int],
                      key_sets: List[np.ndarray]) -> _SetOps:
        """Pack per-atom sorted key sets into the single-binding launch's
        flat slab + ``[1, M]`` segment table (the batch path builds its own
        ragged ``[B, M]`` in ``_batch_set_operands``)."""
        off = np.zeros((1, len(key_sets)), dtype=np.int32)
        ln = np.zeros((1, len(key_sets)), dtype=np.int32)
        pos = 0
        for m, ks in enumerate(key_sets):
            off[0, m] = pos
            ln[0, m] = ks.size
            pos += int(ks.size)
        slab = (np.concatenate(key_sets).astype(np.int32) if pos
                else np.zeros(1, dtype=np.int32))
        iters = search_iters(max((int(ks.size) for ks in key_sets),
                                 default=1))
        return _SetOps(tuple(col_idxs), slab, off, ln, iters,
                       dev=self._slab_dev(key_sets, slab))

    def _kernel_scan(self, atoms: List[CmpAtom], table: Table, binding,
                     isin: Sequence = ()):
        cols = tuple(sorted({a.col for a in atoms}
                            | {a.col for a, _ in isin}))
        order = {c: i for i, c in enumerate(cols)}
        entry = self._slab_entry(table, cols)
        static: List[Tuple[int, int]] = []
        thr: List[int] = []
        n_f32 = 0
        for a in atoms:
            v = a.rhs if a.kind == "lit" else binding[a.rhs]
            if self._f32_col(table, a.col):
                n_f32 += 1
                for op, k in _f32_atoms(a.op, v):
                    static.append((order[a.col], op))
                    thr.append(k)
            else:
                static.append((order[a.col], a.op))
                thr.append(int(v))
        set_ops = (self._set_operands([order[a.col] for a, _ in isin],
                                      [keys for _, keys in isin])
                   if isin else None)
        if not static:
            # pure-membership launch: the kernel wants >= 1 cmp atom, so
            # inject the tautology lane >= INT32_MIN on a set column
            static.append((set_ops.set_cols[0], _GE))
            thr.append(INT32_MIN)
        if self._stats is not None:
            bumps: Dict[str, int] = {}
            if isin:
                bumps["member_fused_scans"] = 1
                bumps["member_fused_sets"] = len(isin)
            if n_f32:
                bumps["float_lane_scans"] = 1
            if bumps:
                self._stats.bump(**bumps)
        return self._launch(entry, tuple(static),
                            np.asarray([thr], dtype=np.int32),
                            set_ops=set_ops)[0]


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #


@dataclass
class ScanStats:
    compiles: int = 0
    hits: int = 0
    scans: int = 0
    batch_scans: int = 0
    batch_rows: int = 0
    # scans answered on encoded columns without decoding (core/store.py)
    insitu_scans: int = 0
    # zone-map partition pruning (PartitionedTable / partitioned store scans)
    prune_calls: int = 0
    partitions_scanned: int = 0
    partitions_pruned: int = 0
    # device (fused-kernel) carrier: launches, rows x bindings answered, and
    # grid blocks the in-kernel zone check early-outed
    device_scans: int = 0
    device_rows: int = 0
    device_blocks_pruned: int = 0
    # coalesced query_batch launches ([B, A] thresholds, one launch for B
    # bindings) and the bindings they covered
    device_batch_scans: int = 0
    device_batch_rows: int = 0
    # fused membership: launches that carried IN atoms in-kernel, and the set
    # segments they bound; float_lane_scans counts launches with at least
    # one float32 key-lane expansion
    member_fused_scans: int = 0
    member_fused_sets: int = 0
    float_lane_scans: int = 0
    # run-space rle scans on encoded stores: per-column run launches and the
    # rows the host expansion produced without ever decoding the column
    rle_run_scans: int = 0
    rle_rows_expanded: int = 0
    # store dispatch picked the run-space rle route for a stage
    rle_insitu_chosen: int = 0
    # partitioned scans where the fused-carry cost compare refused the
    # device and the host path ran instead (stamped as fallback_from on the
    # recorded decision under explain())
    carry_refused: int = 0
    # per-stage scan-path choice on encoded stores (core/store.py dispatch):
    # device in-situ kernel / host in-situ compare / decode-then-scan
    device_chosen: int = 0
    insitu_chosen: int = 0
    decode_chosen: int = 0
    # disk-tier (memmap-backed) stages answered in situ without promotion
    disk_insitu_chosen: int = 0
    # scans the worker pool actually fanned out (surviving work cleared the
    # measured cutover); zero means the parallel path ran serial throughout
    fanout_scans: int = 0
    # the engine's bounded caches, registered for the stats() snapshot
    caches: Dict[str, "LRUCache"] = field(default_factory=dict, repr=False)
    # counter increments are read-modify-write; concurrent scans (the
    # LineageService / PartitionExecutor paths) go through bump() so no
    # update is lost.  Plain attribute reads/resets stay available for
    # single-threaded callers (tests, benchmarks).
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def bump(self, **deltas: int) -> None:
        """Atomically add ``deltas`` to the named counters."""
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                k: v for k, v in self.__dict__.items() if isinstance(v, int)
            }
        out["caches"] = {k: c.counters() for k, c in self.caches.items()}
        return out

    # ``engine.stats()`` — counters plus per-cache hit/evict numbers — while
    # ``engine.stats.scans`` etc. keep working as attributes
    __call__ = snapshot


_BACKENDS = {"numpy": NumpyBackend, "torch": TorchBackend}


class ScanEngine:
    """Compile-once, bind-many predicate scans with pluggable backends.

    One engine instance is the scan authority for one PredTrace / Executor:
    it owns the program cache (keyed by predicate structure) and the scan
    statistics the tests and benchmarks
    assert on.  The default backend is ``"torch"`` on the CUDA device
    (``device="cpu"`` selects the kernel's plain PyTorch version);
    ``ScanEngine("numpy")`` is the host oracle, asked for by name.
    """

    # default cache caps: generous for any realistic plan count, bounded for
    # a long-lived service scanning arbitrarily many plans
    PROGRAM_CACHE = 512
    SORT_CACHE = 256
    SLICE_CACHE = 1024

    def __init__(self, backend: str = "torch",
                 program_cache: int = PROGRAM_CACHE,
                 sort_cache: int = SORT_CACHE,
                 slice_cache: int = SLICE_CACHE,
                 **backend_opts):
        if isinstance(backend, str):
            if backend not in _BACKENDS:
                raise ValueError(
                    f"unknown scan backend {backend!r}; have {sorted(_BACKENDS)}"
                )
            self.backend = _BACKENDS[backend](**backend_opts)
        else:
            self.backend = backend
        self._programs: LRUCache = LRUCache(program_cache)
        # sorted-column index per (table, col): the batch path's scan
        # structure, built once and reused by every batched re-binding
        self._sorts: LRUCache = LRUCache(sort_cache)
        # partition slice views per (table, lo, hi): keeps slice identity
        # stable across queries so identity-keyed backend caches stay warm
        self._slices: LRUCache = LRUCache(slice_cache)
        # serializes cache *installs* (compile, sort build, slice
        # build): concurrent scans of one predicate/table then agree on a
        # single cached object instead of racing duplicate builds, and
        # stats.compiles stays exact (one per distinct structure).  Reads
        # stay lock-free through the LRUCache's own lock.
        self._build_lock = threading.RLock()
        # per-engine cost model: every dispatch heuristic in the scan stack
        # (pruned-vs-full, device, in-situ-vs-decode) consults
        # it, and every executed choice is timed back into it (core/cost.py)
        from .cost import CostModel

        self.cost_model = CostModel()
        self.stats = ScanStats()
        self.stats.caches = {
            "programs": self._programs,
            "sorts": self._sorts,
            "slices": self._slices,
        }
        for name, cache in getattr(self.backend, "caches", lambda: {})().items():
            self.stats.caches[name] = cache
        if hasattr(self.backend, "attach_stats"):
            self.backend.attach_stats(self.stats)
        if hasattr(self.backend, "attach_cost"):
            self.backend.attach_cost(self.cost_model)

    # ------------------------------------------------------------------ #
    def compile(self, pred: Expr) -> AtomProgram:
        """Compiled atom program for ``pred``; cached by structural key so a
        new target-row binding never recompiles."""
        sig = key(pred)
        prog = self._programs.get(sig)
        if prog is None:
            with self._build_lock:
                prog = self._programs.get(sig)
                if prog is None:
                    prog = compile_pred(pred)
                    self._programs[sig] = prog
                    self.stats.bump(compiles=1)
                    return prog
        self.stats.bump(hits=1)
        return prog

    # ------------------------------------------------------------------ #
    def scan(self, pred: Expr, table: Table,
             binding: Optional[Dict[str, object]] = None) -> np.ndarray:
        """Boolean mask of ``pred`` over ``table`` — drop-in for
        ``eval_np(pred, table.cols, binding, n=table.nrows).astype(bool)``.

        Partitioned tables first run the zone-map pruning pass: partitions
        whose statistics prove no row can match are skipped entirely, and the
        survivors are scanned as contiguous slices."""
        self.stats.bump(scans=1)
        prog = self.compile(pred)
        binding = binding or {}
        plan = self._partition_plan(prog, table, binding)
        if plan is not None:
            return self._scan_pruned(prog, table, binding, plan)
        n = table.nrows
        if n == 0 or getattr(self.backend, "reports_cost", False):
            # device-capable backends record their own device-vs-host
            # decision inside backend.scan
            return self.backend.scan(prog, table, binding)
        from .cost import prog_atoms

        A = prog_atoms(prog)
        ch = self.cost_model.note(
            f"scan:{getattr(table, 'name', None) or '?'}", "serial",
            float(n) * A, meta={"rows": int(n), "atoms": int(A)})
        t0 = time.perf_counter()
        mask = self.backend.scan(prog, table, binding)
        ch.done(time.perf_counter() - t0)
        return mask

    # ------------------------------------------------------------------ #
    # partition pruning
    # ------------------------------------------------------------------ #
    def _partition_plan(self, prog: AtomProgram, table: Table,
                        binding: Dict[str, object]):
        if not isinstance(table, PartitionedTable) or table.num_partitions <= 1:
            return None
        if not partition_safe(prog, binding):
            return None
        self.stats.bump(prune_calls=1)
        return prog, prune_zone_maps(prog, table.zone_maps, binding)

    def record_prune(self, scanned: int, pruned: int) -> None:
        """Account partitions actually scanned vs actually skipped — recorded
        where the scan shape is decided, so a prune result that fell back to
        a full scan never inflates the skip counters."""
        self.stats.bump(partitions_scanned=scanned, partitions_pruned=pruned)

    # historical seed of the pruned-vs-full crossover, kept as the calibration
    # constant behind the cost model's PRUNED_RATIO (= 1 / (1 - 1/8) th extra
    # marginal cost for sliced/gathered scans): pruning below ~this fraction
    # of skipped rows isn't worth the slicing overhead at seed time
    MIN_SKIP_FRACTION = 1 / 8

    def _scan_pruned(self, prog: AtomProgram, table: "PartitionedTable",
                     binding: Dict[str, object], plan) -> np.ndarray:
        """Scan shape for a zone-pruned partitioned table, chosen by the cost
        model between two routes: ``serial`` (full vectorized scan — wins when
        too little is skipped) and ``pruned`` (slice or gathered scan of the
        surviving runs, charged one partition's floor plus the gather
        penalty)."""
        _, alive = plan
        n = table.nrows
        P = len(alive)
        mask = np.zeros(n, dtype=bool)
        runs = alive_runs(alive)
        if not runs:
            self.record_prune(0, P)
            return mask
        pr = table.part_rows
        bounds = [(p0 * pr, min(p1 * pr, n)) for p0, p1 in runs]
        scanned = sum(hi - lo for lo, hi in bounds)
        from .cost import prog_atoms

        A = prog_atoms(prog)
        cands = [("serial", float(n) * A),
                 ("pruned", float(scanned + pr) * A)]
        ns = int(np.count_nonzero(alive))
        ch = self.cost_model.choose(
            f"scan:{getattr(table, 'name', None) or '?'}", cands,
            meta={"rows": int(n), "atoms": int(A), "partitions": int(P),
                  "alive": ns, "rows_alive": int(scanned)})
        t0 = time.perf_counter()
        if ch.route == "serial":
            # too little to skip: the vectorized full scan wins
            self.record_prune(P, 0)
            mask = self.backend.scan(prog, table, binding)
        elif len(bounds) == 1:
            self.record_prune(ns, P - ns)
            lo, hi = bounds[0]
            sub = self.partition_slice(table, lo, hi)
            mask[lo:hi] = self.backend.scan(prog, sub, binding)
        else:
            # scattered survivors: one gathered scan beats per-run dispatch
            self.record_prune(ns, P - ns)
            idx = np.concatenate([np.arange(lo, hi, dtype=np.int64)
                                  for lo, hi in bounds])
            mask[idx] = self.backend.scan(prog, _GatherView(table, idx),
                                          binding)
        ch.done(time.perf_counter() - t0)
        return mask

    def partition_slice(self, table: Table, lo: int, hi: int) -> Table:
        """Row-range view of ``table`` with stable identity: repeated scans of
        the same partition run reuse one slice object, so identity-keyed
        backend caches (slabs, sorted indexes) stay warm across queries."""
        ck = (table_uid(table), int(table.nrows), lo, hi)
        entry = self._slices.get(ck)
        if entry is not None and entry[0]() is table:
            return entry[1]
        with self._build_lock:
            entry = self._slices.get(ck)
            if entry is not None and entry[0]() is table:
                return entry[1]
            sub = Table({k: v[lo:hi] for k, v in table.cols.items()},
                        table.dicts, table.name)
            ref = weakref.ref(table,
                              lambda _, k=ck, d=self._slices: d.pop(k, None))
            self._slices[ck] = (ref, sub)
        return sub

    # ------------------------------------------------------------------ #
    def scan_batch(self, pred: Expr, table: Table,
                   bindings: Sequence[Dict[str, object]]) -> List[np.ndarray]:
        """B boolean masks, one scan over ``table``: equivalent to
        ``[self.scan(pred, table, b) for b in bindings]`` but with the whole
        batch answered in one vectorized pass (see :meth:`scan_batch_idx`)."""
        from .cost import active_recorder

        record = active_recorder() is not None
        t0 = time.perf_counter() if record else 0.0
        masks = self._fused_batch(pred, table, bindings)
        if masks is not None:
            self.stats.bump(batch_scans=1, batch_rows=len(bindings))
            if record:
                self._note_batch(pred, table, bindings, "device_batch",
                                 time.perf_counter() - t0)
            return masks
        n = table.nrows
        out = []
        for idx in self.scan_batch_idx(pred, table, bindings):
            m = np.zeros(n, dtype=bool)
            m[idx] = True
            out.append(m)
        if record:
            self._note_batch(pred, table, bindings, "batch_pivot",
                             time.perf_counter() - t0)
        return out

    def _note_batch(self, pred: Expr, table: Table, bindings, route: str,
                    seconds: float) -> None:
        """Record the batched-vs-single-binding decision for explain(): the
        batch structure (pivot-index probes vs. one fused [B, A] launch vs.
        B sequential scans) is determined by program shape and the measured
        batch cutover, but the considered alternatives and their estimates
        belong in the plan report."""
        from .cost import prog_atoms

        B = len(bindings)
        n = table.nrows
        prog = self.compile(pred)
        A = prog_atoms(prog)
        serial_work = float(n) * A * B  # B sequential full scans
        if route == "batch_pivot":
            # B binary searches + candidate filtering: ~B * (log2 n + c) * A
            work = float(B) * (math.log2(n + 1) + 64.0) * A
        else:
            work = float(n) * A * B
        alts = [("serial", serial_work)]
        fused = getattr(self.backend, "scan_batch_fused", None)
        if fused is not None and route != "device_batch":
            alts.append(("device_batch", float(n) * A * B,
                         self.backend._device_seed(batch=True)))
        ch = self.cost_model.note(
            f"batch:{getattr(table, 'name', None) or '?'}", route, work,
            meta={"rows": int(n), "atoms": int(A), "bindings": B},
            alternatives=alts)
        ch.done(seconds)

    def _fused_batch(self, pred: Expr, table: Table,
                     bindings: Sequence[Dict[str, object]]
                     ) -> Optional[List[np.ndarray]]:
        """Masks for the whole batch from one fused device launch, or None
        when the backend / program / scale can't carry it.  Predicates with a
        NaN-free equality atom stay on the binary-search pivot path — B tiny
        index probes beat any full-table launch."""
        fused = getattr(self.backend, "scan_batch_fused", None)
        if fused is None or not bindings or not params_of(pred):
            return None
        prog = self.compile(pred)
        try:
            if any(a.op == EQ and a.kind == "param"
                   and not _is_setlike(_bind(b, a.rhs))
                   and not _has_nan(np.asarray(_bind(b, a.rhs)))
                   for a in prog.param_cmp for b in bindings[:1]):
                return None
        except KeyError:
            return None
        return fused(prog, table, bindings)

    def scan_batch_idx(self, pred: Expr, table: Table,
                       bindings: Sequence[Dict[str, object]]) -> List[np.ndarray]:
        """Matching row indices of ``pred`` under each binding — the batched
        scan core.

        One equality atom (the *pivot*) is answered for all B bindings by
        binary search against a cached sorted-column index, built once per
        table/column and reused across batches.  The surviving candidates of
        all bindings are then filtered **flattened** — one vectorized pass
        per remaining atom over ``sum(len(cand_b))`` rows with per-binding
        thresholds gathered via ``np.repeat`` — so per-binding work is a few
        hundred elements, not a table scan.  Atoms that resist vectorization
        (array-valued bindings, param-bearing residuals) run per binding on
        the already-tiny candidate sets."""
        B = len(bindings)
        if B == 0:
            return []
        self.stats.bump(batch_scans=1, batch_rows=B)
        prog = self.compile(pred)
        n = table.nrows
        cols = table.cols
        be = self.backend if isinstance(self.backend, NumpyBackend) else NumpyBackend()

        # binding-independent predicate: one scan answers every row
        if not params_of(pred):
            idx = np.nonzero(self.backend.scan(prog, table, {}))[0]
            return [idx] * B

        # classify parameter atoms over the whole batch -------------------- #
        eq_atoms: List[Tuple[CmpAtom, np.ndarray]] = []  # all-scalar ==
        vec_cmp: List[Tuple[CmpAtom, np.ndarray]] = []  # all-scalar < <= > >= !=
        row_cmp: List[CmpAtom] = []  # some binding is array-valued
        for a in prog.param_cmp:
            vals = [_bind(b, a.rhs) for b in bindings]
            if any(_is_setlike(v) for v in vals):
                row_cmp.append(a)
            elif a.op == EQ:
                eq_atoms.append((a, np.asarray(vals)))
            else:
                vec_cmp.append((a, np.asarray(vals)))
        row_isin = [a for a in prog.isin_atoms if a.kind == "param"]

        # pivot atom: first NaN-free equality (NaN thresholds break binary
        # search order; np.equal semantics for them are all-False anyway, so
        # NaN-carrying atoms are fine as candidate filters but not as pivot)
        pivot = next(
            (i for i, (_, vals) in enumerate(eq_atoms) if not _has_nan(vals)),
            None,
        )

        if pivot is not None and n:
            # B binary searches against the cached sorted-column index
            a0, vals0 = eq_atoms[pivot]
            order, sorted_vals = self._sorted_col(table, a0.col)
            lo = np.searchsorted(sorted_vals, vals0, side="left")
            hi = np.searchsorted(sorted_vals, vals0, side="right")
            lens = hi - lo
            flat = np.concatenate([order[lo[b]:hi[b]] for b in range(B)]) \
                if lens.sum() else np.empty(0, dtype=order.dtype)
            rest_eq = eq_atoms[:pivot] + eq_atoms[pivot + 1:]
            statics_pending = True  # static atoms applied per candidate
        else:
            # no pivot to binary-search: this is the device carrier's case —
            # one fused launch answers the whole coalesced batch ([B, A]
            # thresholds, one column read per block for all B bindings) when
            # the program sits in the kernel fragment and the batch clears
            # the measured cutover
            fused = getattr(self.backend, "scan_batch_fused", None)
            if fused is not None:
                masks = fused(prog, table, bindings)
                if masks is not None:
                    return [np.flatnonzero(m) for m in masks]
            # no usable equality: one shared pass for the static conjunction
            static_mask = np.ones(n, dtype=bool)
            for a in prog.static_cmp:
                static_mask &= be._cmp_mask(a, table, {}, n)
            for a in prog.isin_atoms:
                if a.kind == "lit":
                    static_mask &= be._isin_mask(a, table, {}, n)
            if prog.residual_static is not None:
                static_mask &= np.asarray(
                    eval_np(prog.residual_static, table.cols, {}, n=n), bool
                )
            idx0 = np.nonzero(static_mask)[0]
            lens = np.full(B, len(idx0), dtype=np.int64)
            flat = np.tile(idx0, B)
            rest_eq = eq_atoms  # filtered below like any other atom
            statics_pending = False

        rep = np.repeat(np.arange(B), lens)

        # vectorized filters over the flattened candidates ----------------- #
        if len(flat):
            keep = np.ones(len(flat), dtype=bool)
            for a, vals in rest_eq:
                keep &= np.equal(cols[a.col][flat], vals[rep])
            for a, vals in vec_cmp:
                keep &= _NP_CMP[a.op](cols[a.col][flat], vals[rep])
            if statics_pending:
                for a in prog.static_cmp:
                    rhs = cols[a.rhs][flat] if a.kind == "col" else a.rhs
                    keep &= _NP_CMP[a.op](cols[a.col][flat], rhs)
                for a in prog.isin_atoms:
                    if a.kind == "lit":
                        keep &= _member(cols[a.col][flat], a.rhs)
                if prog.residual_static is not None:
                    env = {c: cols[c][flat] for c in prog.residual_static_cols
                           if c in cols}
                    keep &= np.asarray(
                        eval_np(prog.residual_static, env, {}, n=len(flat)), bool
                    )
            flat, rep = flat[keep], rep[keep]

        # split back per binding ------------------------------------------- #
        counts = np.bincount(rep, minlength=B)
        idxs = np.split(flat, np.cumsum(counts)[:-1])

        # atoms that resist flattening: per binding, on tiny candidate sets  #
        if row_cmp or row_isin or prog.residual_dynamic is not None:
            for b, binding in enumerate(bindings):
                idx = idxs[b]
                for a in row_cmp:
                    if not len(idx):
                        break
                    v = _bind(binding, a.rhs)
                    colv = cols[a.col][idx]
                    if _is_setlike(v):
                        if a.op == EQ:
                            keep = _member(colv, v)
                        else:
                            keep = np.asarray(
                                eval_np(a.expr, {a.col: colv}, binding,
                                        n=len(idx)),
                                bool,
                            )
                    else:
                        keep = _NP_CMP[a.op](colv, v)
                    idx = idx[keep]
                for a in row_isin:
                    if not len(idx):
                        break
                    idx = idx[_member(cols[a.col][idx], _bind(binding, a.rhs))]
                if prog.residual_dynamic is not None and len(idx):
                    env = {c: cols[c][idx] for c in prog.residual_dynamic_cols
                           if c in cols}
                    keep = np.asarray(
                        eval_np(prog.residual_dynamic, env, binding, n=len(idx)),
                        bool,
                    )
                    idx = idx[keep]
                idxs[b] = idx
        return idxs

    def member_batch_idx(self, table: Table, lhs: Expr,
                         value_sets: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Row indices where ``eval(lhs) IN value_set``, one index array per
        set, answered against a single sorted pass over ``lhs`` (the cached
        sorted-column index when ``lhs`` is a plain column).  ``np.isin``
        equality semantics: NaN never matches."""
        if isinstance(lhs, Col):
            order, sorted_vals = self._sorted_col(table, lhs.name)
        else:
            v = np.asarray(eval_np(lhs, table.cols, {}, n=table.nrows))
            order = np.argsort(v, kind="stable")
            sorted_vals = v[order]
        out: List[np.ndarray] = []
        for vals in value_sets:
            u = np.unique(np.asarray(vals))
            if u.dtype.kind == "f":
                u = u[~np.isnan(u)]  # searchsorted would pair NaN with NaN
            lo = np.searchsorted(sorted_vals, u, side="left")
            hi = np.searchsorted(sorted_vals, u, side="right")
            segs = [order[l:h] for l, h in zip(lo, hi) if h > l]
            if segs:
                idx = np.concatenate(segs)
                idx.sort()
            else:
                idx = np.empty(0, dtype=order.dtype)
            out.append(idx)
        return out

    def _sorted_col(self, table: Table, col: str):
        """(order, sorted_values) for a column — the batch path's scan index,
        computed once per (table, row watermark)/column and cached."""
        ck = (table_uid(table), int(table.nrows), col)
        entry = self._sorts.get(ck)
        if entry is not None and entry[0]() is table:
            return entry[1], entry[2]
        with self._build_lock:
            entry = self._sorts.get(ck)
            if entry is not None and entry[0]() is table:
                return entry[1], entry[2]
            arr = np.asarray(table.cols[col])
            order = np.argsort(arr, kind="stable")
            sorted_vals = arr[order]
            # weakref callback evicts on table death (dict would otherwise pin
            # two full-length arrays per dead table for the engine's lifetime)
            ref = weakref.ref(table,
                              lambda _, k=ck, d=self._sorts: d.pop(k, None))
            self._sorts[ck] = (ref, order, sorted_vals)
        return order, sorted_vals


_DEFAULT_ENGINE: Optional[ScanEngine] = None


def default_engine() -> ScanEngine:
    """Process-wide fallback engine for callers that don't own one (direct
    ``refine`` calls, ad-hoc scans): the torch backend on the CUDA device,
    raising without one.  PredTrace/Executor instances each own their own
    engine instead."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = ScanEngine()
    return _DEFAULT_ENGINE


def _has_nan(vals) -> bool:
    for v in vals:
        try:
            if np.isnan(v):
                return True
        except TypeError:
            pass
    return False
