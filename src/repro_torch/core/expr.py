"""Expression / predicate IR for PredTrace.

A small, closed expression language.  Everything PredTrace pushes up or down is
an ``Expr``:

* ``Col(name)``              — column reference
* ``Lit(value)``             — constant (ints/floats/bools; strings are
                               dictionary codes by the time they reach here)
* ``Param(name)``            — a lineage parameter ``v_i`` (bound at query time
                               to a scalar *or* to an array of values, in which
                               case equality atoms become set membership)
* ``ParamSet(name)``         — a row-value V-set variable (Algorithm 3)
* ``BinOp(op, l, r)``        — ``+ - * / == != < <= > >= and or``
* ``Not(e)``
* ``IsIn(e, values)``        — membership in a literal value set / Param /
                               ParamSet
* ``IfThenElse(c, t, f)``    — CASE WHEN
* ``UnaryOp(op, e)``         — ``neg``/``abs``/``year`` (dates are int32
                               YYYYMMDD so ``year`` is ``x // 10000``)

UDFs in the paper's scope (deterministic, symbolically executable) are
expressed *in this language* — which is exactly the closure the paper's
MagicPush module requires.  The language is closed under the pushdown rules,
which is what makes equivalence checking decidable without an SMT solver.

Evaluation backends: numpy (``eval_np``) for the oracle executor and the
host engine, torch (``eval_torch``) over tensors on an explicit device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------- #
# node types
# --------------------------------------------------------------------------- #


class Expr:
    """Base class.  Instances are immutable and hash by structure."""

    def __eq__(self, other):  # structural equality
        return isinstance(other, Expr) and key(self) == key(other)

    def __hash__(self):
        return hash(key(self))

    # sugar for plan building -------------------------------------------------
    def _wrap(self, other) -> "Expr":
        return other if isinstance(other, Expr) else Lit(other)

    def __add__(self, o):
        return BinOp("+", self, self._wrap(o))

    def __radd__(self, o):
        return BinOp("+", self._wrap(o), self)

    def __sub__(self, o):
        return BinOp("-", self, self._wrap(o))

    def __rsub__(self, o):
        return BinOp("-", self._wrap(o), self)

    def __mul__(self, o):
        return BinOp("*", self, self._wrap(o))

    def __rmul__(self, o):
        return BinOp("*", self._wrap(o), self)

    def __truediv__(self, o):
        return BinOp("/", self, self._wrap(o))

    def eq(self, o):
        return BinOp("==", self, self._wrap(o))

    def ne(self, o):
        return BinOp("!=", self, self._wrap(o))

    def __lt__(self, o):
        return BinOp("<", self, self._wrap(o))

    def __le__(self, o):
        return BinOp("<=", self, self._wrap(o))

    def __gt__(self, o):
        return BinOp(">", self, self._wrap(o))

    def __ge__(self, o):
        return BinOp(">=", self, self._wrap(o))

    def and_(self, o):
        return land(self, o)

    def or_(self, o):
        return lor(self, o)

    def isin(self, values):
        return IsIn(self, values)

    def between(self, lo, hi):
        return land(self >= lo, self <= hi)


@dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def __repr__(self):
        return self.name


@dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: object

    def __repr__(self):
        return repr(self.value)


@dataclass(frozen=True, eq=False)
class Param(Expr):
    """Lineage parameter v_i.  ``origin`` records (stage, column) provenance of
    the binding so the query phase knows where to read the value."""

    name: str
    origin: Optional[Tuple[str, str]] = None

    def __repr__(self):
        return f"${self.name}"


@dataclass(frozen=True, eq=False)
class ParamSet(Expr):
    """Row-value set variable  V^{table}_{col}  (Algorithm 3)."""

    name: str
    table: str = ""
    column: str = ""

    def __repr__(self):
        return f"$V[{self.name}]"


@dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True, eq=False)
class UnaryOp(Expr):
    op: str  # neg | abs | year | not
    operand: Expr

    def __repr__(self):
        return f"{self.op}({self.operand})"


@dataclass(frozen=True, eq=False)
class IsIn(Expr):
    operand: Expr
    values: object  # tuple of literals | Param | ParamSet

    def __post_init__(self):
        if isinstance(self.values, (list, np.ndarray)):
            object.__setattr__(self, "values", tuple(np.asarray(self.values).tolist()))

    def __repr__(self):
        v = self.values
        if isinstance(v, tuple) and len(v) > 6:
            v = f"<{len(v)} values>"
        return f"({self.operand} IN {v})"


@dataclass(frozen=True, eq=False)
class IfThenElse(Expr):
    cond: Expr
    then: Expr
    other: Expr

    def __repr__(self):
        return f"if({self.cond}, {self.then}, {self.other})"


@dataclass(frozen=True, eq=False)
class UDFExpr(Expr):
    """A black-box but *executable* UDF call over column expressions.

    The body is an opaque callable (``fn(*arrays) -> array``) rather than a
    closed-form ``Expr`` tree, so nothing can be proven about it symbolically
    — but because the paper's UDFs are deterministic and re-executable, the
    call itself can travel inside a pushed-down predicate and be evaluated
    during a lineage-query scan (the ScanEngine routes it through the
    residual path).  This is what makes ``filter-like`` UDF pushdowns precise
    (paper's annotation-driven rules): the pushed predicate literally carries
    the UDF.

    Structural identity (hashing / program caching) is ``(name, args)`` —
    ``name`` must therefore be unique per distinct function body; the UDF
    operator nodes derive it from their node id."""

    name: str
    fn: object  # Callable[*np.ndarray] -> np.ndarray (vectorized, pure)
    args: Tuple[Expr, ...] = ()

    def __post_init__(self):
        if not isinstance(self.args, tuple):
            object.__setattr__(self, "args", tuple(self.args))

    def __repr__(self):
        return f"{self.name}({', '.join(repr(a) for a in self.args)})"


TRUE = Lit(True)
FALSE = Lit(False)


# --------------------------------------------------------------------------- #
# UDF lineage annotations (paper's pushdown-rule classes for opaque operators)
# --------------------------------------------------------------------------- #

ROW_PRESERVING = "row_preserving"
FILTER_LIKE = "filter_like"
ONE_TO_ONE = "one_to_one"
ONE_TO_MANY = "one_to_many"
OPAQUE = "opaque"

ANNOTATION_KINDS = (
    ROW_PRESERVING, FILTER_LIKE, ONE_TO_ONE, ONE_TO_MANY, OPAQUE,
)


@dataclass(frozen=True)
class LineageAnnotation:
    """What a UDF operator promises about its input-row -> output-row map.

    The annotation is the *only* information the pushdown engine has about a
    UDF body, so it fully determines the pushdown rule (paper's
    annotation-driven architecture):

    * ``row_preserving`` — emits exactly the input rows, in order, adding or
      replacing columns computed from the declared input columns (a
      vectorized ``withColumn``).
    * ``filter_like``    — output rows are a subset of input rows, schema
      unchanged, and the keep-decision is re-executable per row.
    * ``one_to_one``     — row-preserving, and the outputs are a function of
      ``key_cols`` only (e.g. a keyed feature lookup); pinning just the keys
      then determines every UDF output.
    * ``one_to_many``    — each input row yields k >= 0 output rows whose
      new columns are a function of the declared inputs (explode/parse).
    * ``opaque``         — no row correspondence at all; lineage through the
      operator is the *whole input* (the paper's well-defined superset) and
      the operator is a mandatory materialization boundary.
    """

    kind: str
    key_cols: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind not in ANNOTATION_KINDS:
            raise ValueError(
                f"unknown annotation kind {self.kind!r}; "
                f"have {ANNOTATION_KINDS}"
            )
        if not isinstance(self.key_cols, tuple):
            object.__setattr__(self, "key_cols", tuple(self.key_cols))
        if self.kind == ONE_TO_ONE and not self.key_cols:
            raise ValueError("one_to_one annotation requires key_cols")

    # -- constructors --------------------------------------------------- #
    @classmethod
    def row_preserving(cls) -> "LineageAnnotation":
        return cls(ROW_PRESERVING)

    @classmethod
    def filter_like(cls) -> "LineageAnnotation":
        return cls(FILTER_LIKE)

    @classmethod
    def one_to_one(cls, *key_cols: str) -> "LineageAnnotation":
        return cls(ONE_TO_ONE, tuple(key_cols))

    @classmethod
    def one_to_many(cls) -> "LineageAnnotation":
        return cls(ONE_TO_MANY)

    @classmethod
    def opaque(cls) -> "LineageAnnotation":
        return cls(OPAQUE)

    def determines(self, declared_cols: Sequence[str]) -> Tuple[str, ...]:
        """Input columns that functionally determine the UDF's outputs:
        ``key_cols`` for one_to_one, else every declared input column."""
        if self.kind == ONE_TO_ONE:
            return self.key_cols
        return tuple(declared_cols)


# --------------------------------------------------------------------------- #
# structural key (for hashing / canonicalization)
# --------------------------------------------------------------------------- #


def key(e: Expr):
    if isinstance(e, Col):
        return ("col", e.name)
    if isinstance(e, Lit):
        return ("lit", repr(e.value))
    if isinstance(e, Param):
        return ("param", e.name)
    if isinstance(e, ParamSet):
        return ("pset", e.name)
    if isinstance(e, BinOp):
        return ("bin", e.op, key(e.left), key(e.right))
    if isinstance(e, UnaryOp):
        return ("un", e.op, key(e.operand))
    if isinstance(e, IsIn):
        v = e.values
        vk = key(v) if isinstance(v, Expr) else ("vals", v)
        return ("isin", key(e.operand), vk)
    if isinstance(e, IfThenElse):
        return ("ite", key(e.cond), key(e.then), key(e.other))
    if isinstance(e, UDFExpr):
        return ("udf", e.name, tuple(key(a) for a in e.args))
    raise TypeError(f"unknown expr {type(e)}")


# --------------------------------------------------------------------------- #
# boolean algebra helpers
# --------------------------------------------------------------------------- #


def land(*es: Expr) -> Expr:
    """Conjunction with TRUE/FALSE folding."""
    out: List[Expr] = []
    for e in es:
        if e is None or e == TRUE:
            continue
        if e == FALSE:
            return FALSE
        out.extend(conjuncts(e))
    # dedupe, stable order
    seen = set()
    uniq = []
    for e in out:
        k = key(e)
        if k not in seen:
            seen.add(k)
            uniq.append(e)
    if not uniq:
        return TRUE
    acc = uniq[0]
    for e in uniq[1:]:
        acc = BinOp("and", acc, e)
    return acc


def lor(*es: Expr) -> Expr:
    out = []
    for e in es:
        if e is None or e == FALSE:
            continue
        if e == TRUE:
            return TRUE
        out.append(e)
    if not out:
        return FALSE
    acc = out[0]
    for e in out[1:]:
        acc = BinOp("or", acc, e)
    return acc


def lnot(e: Expr) -> Expr:
    if e == TRUE:
        return FALSE
    if e == FALSE:
        return TRUE
    return UnaryOp("not", e)


def conjuncts(e: Expr) -> List[Expr]:
    """Flatten a conjunction into atoms."""
    if isinstance(e, BinOp) and e.op == "and":
        return conjuncts(e.left) + conjuncts(e.right)
    if e == TRUE:
        return []
    return [e]


def disjuncts(e: Expr) -> List[Expr]:
    """Flatten a disjunction into branches."""
    if isinstance(e, BinOp) and e.op == "or":
        return disjuncts(e.left) + disjuncts(e.right)
    if e == FALSE:
        return []
    return [e]


def cols_of(e: Expr) -> Set[str]:
    out: Set[str] = set()

    def walk(x: Expr):
        if isinstance(x, Col):
            out.add(x.name)
        elif isinstance(x, BinOp):
            walk(x.left), walk(x.right)
        elif isinstance(x, UnaryOp):
            walk(x.operand)
        elif isinstance(x, IsIn):
            walk(x.operand)
            if isinstance(x.values, Expr):
                walk(x.values)
        elif isinstance(x, IfThenElse):
            walk(x.cond), walk(x.then), walk(x.other)
        elif isinstance(x, UDFExpr):
            for a in x.args:
                walk(a)

    walk(e)
    return out


def params_of(e: Expr) -> Set[str]:
    out: Set[str] = set()

    def walk(x: Expr):
        if isinstance(x, Param):
            out.add(x.name)
        elif isinstance(x, ParamSet):
            out.add(x.name)
        elif isinstance(x, BinOp):
            walk(x.left), walk(x.right)
        elif isinstance(x, UnaryOp):
            walk(x.operand)
        elif isinstance(x, IsIn):
            walk(x.operand)
            if isinstance(x.values, Expr):
                walk(x.values)
        elif isinstance(x, IfThenElse):
            walk(x.cond), walk(x.then), walk(x.other)
        elif isinstance(x, UDFExpr):
            for a in x.args:
                walk(a)

    walk(e)
    return out


def paramsets_of(e: Expr) -> Set[str]:
    out: Set[str] = set()

    def walk(x: Expr):
        if isinstance(x, ParamSet):
            out.add(x.name)
        elif isinstance(x, BinOp):
            walk(x.left), walk(x.right)
        elif isinstance(x, UnaryOp):
            walk(x.operand)
        elif isinstance(x, IsIn):
            walk(x.operand)
            if isinstance(x.values, Expr):
                walk(x.values)
        elif isinstance(x, IfThenElse):
            walk(x.cond), walk(x.then), walk(x.other)
        elif isinstance(x, UDFExpr):
            for a in x.args:
                walk(a)

    walk(e)
    return out


def substitute_cols(e: Expr, mapping: Mapping[str, Expr]) -> Expr:
    """Replace column references according to ``mapping`` (used to push
    predicates through RowTransform / renames)."""

    def walk(x: Expr) -> Expr:
        if isinstance(x, Col):
            return mapping.get(x.name, x)
        if isinstance(x, BinOp):
            return BinOp(x.op, walk(x.left), walk(x.right))
        if isinstance(x, UnaryOp):
            return UnaryOp(x.op, walk(x.operand))
        if isinstance(x, IsIn):
            vals = walk(x.values) if isinstance(x.values, Expr) else x.values
            return IsIn(walk(x.operand), vals)
        if isinstance(x, IfThenElse):
            return IfThenElse(walk(x.cond), walk(x.then), walk(x.other))
        if isinstance(x, UDFExpr):
            return UDFExpr(x.name, x.fn, tuple(walk(a) for a in x.args))
        return x

    return walk(e)


def substitute_params(e: Expr, binding: Mapping[str, object]) -> Expr:
    """Bind parameters.  A scalar binding turns ``Param`` into ``Lit``; an
    array binding turns ``col == $v`` atoms into ``col IN values`` and a bare
    ``Param``/``ParamSet`` inside ``IsIn`` into a literal value tuple."""

    def walk(x: Expr) -> Expr:
        if isinstance(x, (Param, ParamSet)):
            if x.name not in binding:
                return x
            v = binding[x.name]
            if isinstance(v, (list, tuple, np.ndarray)):
                arr = np.asarray(v)
                if arr.ndim == 0:
                    return Lit(arr.item())
                return _ValueSet(tuple(arr.tolist()))
            return Lit(v)
        if isinstance(x, BinOp):
            l, r = walk(x.left), walk(x.right)
            if x.op in ("==",) and isinstance(r, _ValueSet):
                return IsIn(l, r.values)
            if x.op in ("==",) and isinstance(l, _ValueSet):
                return IsIn(r, l.values)
            return BinOp(x.op, l, r)
        if isinstance(x, UnaryOp):
            return UnaryOp(x.op, walk(x.operand))
        if isinstance(x, IsIn):
            vals = x.values
            if isinstance(vals, Expr):
                w = walk(vals)
                if isinstance(w, _ValueSet):
                    vals = w.values
                elif isinstance(w, Lit):
                    vals = (w.value,)
                else:
                    vals = w
            return IsIn(walk(x.operand), vals)
        if isinstance(x, IfThenElse):
            return IfThenElse(walk(x.cond), walk(x.then), walk(x.other))
        if isinstance(x, UDFExpr):
            return UDFExpr(x.name, x.fn, tuple(walk(a) for a in x.args))
        return x

    return walk(e)


@dataclass(frozen=True, eq=False)
class _ValueSet(Expr):
    """Internal: an array binding flowing through substitution."""

    values: tuple


# --------------------------------------------------------------------------- #
# evaluation
# --------------------------------------------------------------------------- #

_NP_BIN = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": np.divide,
    "==": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "and": np.logical_and,
    "or": np.logical_or,
}


def eval_np(
    e: Expr,
    env: Mapping[str, np.ndarray],
    binding: Optional[Mapping[str, object]] = None,
    n: Optional[int] = None,
) -> np.ndarray:
    """Evaluate over numpy columns.  ``binding`` supplies Param/ParamSet values.
    Returns an array broadcastable to ``n`` rows."""
    binding = binding or {}
    if n is None:
        for v in env.values():
            n = len(v)
            break
        if n is None:
            n = 0

    def ev(x: Expr):
        if isinstance(x, Col):
            if x.name not in env:
                raise KeyError(f"column {x.name} not in environment {sorted(env)[:10]}")
            return env[x.name]
        if isinstance(x, Lit):
            return x.value
        if isinstance(x, (Param, ParamSet)):
            if x.name not in binding:
                raise KeyError(f"unbound parameter {x.name}")
            return binding[x.name]
        if isinstance(x, BinOp):
            l, r = ev(x.left), ev(x.right)
            # equality against a parameter bound to an array => membership.
            # The dispatch is structural (which side is a Param), because a
            # column evaluation is also a 1-D array.
            if x.op == "==":
                if isinstance(x.right, (Param, ParamSet, _ValueSet)) and _is_set(r):
                    return _member_np(l, r, n)
                if isinstance(x.left, (Param, ParamSet, _ValueSet)) and _is_set(l):
                    return _member_np(r, l, n)
            return _NP_BIN[x.op](l, r)
        if isinstance(x, UnaryOp):
            v = ev(x.operand)
            if x.op == "not":
                return np.logical_not(v)
            if x.op == "neg":
                return np.negative(v)
            if x.op == "abs":
                return np.abs(v)
            if x.op == "year":
                return v // 10000
            raise ValueError(f"unary {x.op}")
        if isinstance(x, IsIn):
            vals = x.values
            if isinstance(vals, Expr):
                vals = ev(vals)
            if isinstance(vals, _ValueSet):
                vals = vals.values
            return _member_np(ev(x.operand), vals, n)
        if isinstance(x, IfThenElse):
            return np.where(ev(x.cond), ev(x.then), ev(x.other))
        if isinstance(x, UDFExpr):
            vals = []
            for a in x.args:
                v = np.asarray(ev(a))
                if v.ndim == 0:
                    v = np.broadcast_to(v, (n,))
                vals.append(v)
            return np.asarray(x.fn(*vals))
        if isinstance(x, _ValueSet):
            return np.asarray(x.values)
        raise TypeError(f"cannot eval {type(x)}")

    out = ev(e)
    if np.ndim(out) == 0:
        out = np.broadcast_to(np.asarray(out), (n,))
    return out


def _is_set(v) -> bool:
    return isinstance(v, (list, tuple)) or (isinstance(v, np.ndarray) and v.ndim == 1)


def _member_np(col, vals, n) -> np.ndarray:
    arr = np.asarray(vals)
    col = np.asarray(col)
    if np.ndim(col) == 0:
        col = np.broadcast_to(col, (n,))
    if arr.size == 0:
        return np.zeros(len(col), dtype=bool)
    return np.isin(col, arr)


def eval_torch(e: Expr, env, binding=None, device=None):
    """Evaluate over torch tensors on ``device`` (the columns in ``env`` must
    already live there; array-valued bindings and literal value sets are
    moved there).  Membership sets must be bound to concrete arrays.
    Mirrors ``eval_np``."""
    import torch

    binding = binding or {}

    def val(v):
        if isinstance(v, (np.ndarray, list, tuple)):
            return torch.as_tensor(np.asarray(v), device=device)
        return v

    def ev(x: Expr):
        if isinstance(x, Col):
            return env[x.name]
        if isinstance(x, Lit):
            return val(x.value)
        if isinstance(x, (Param, ParamSet)):
            return val(binding[x.name])
        if isinstance(x, BinOp):
            if x.op == "and":
                return torch.logical_and(_t(ev(x.left), device),
                                         _t(ev(x.right), device))
            if x.op == "or":
                return torch.logical_or(_t(ev(x.left), device),
                                        _t(ev(x.right), device))
            l, r = ev(x.left), ev(x.right)
            if x.op == "==":
                if isinstance(x.right, (Param, ParamSet)) and _ndim(r) == 1:
                    return torch.isin(l, r)
                if isinstance(x.left, (Param, ParamSet)) and _ndim(l) == 1:
                    return torch.isin(r, l)
            if not isinstance(l, torch.Tensor):
                l = _t(l, device)
            return {
                "+": torch.add, "-": torch.sub, "*": torch.mul,
                "/": torch.true_divide, "==": torch.eq, "!=": torch.ne,
                "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
            }[x.op](l, r)
        if isinstance(x, UnaryOp):
            v = _t(ev(x.operand), device)
            if x.op == "not":
                return torch.logical_not(v)
            if x.op == "neg":
                return -v
            if x.op == "abs":
                return torch.abs(v)
            if x.op == "year":
                return v // 10000
            raise ValueError(x.op)
        if isinstance(x, IsIn):
            vals = x.values
            if isinstance(vals, Expr):
                vals = ev(vals)
            vals = _t(val(vals), device)
            return torch.isin(ev(x.operand), vals)
        if isinstance(x, IfThenElse):
            return torch.where(_t(ev(x.cond), device), ev(x.then), ev(x.other))
        if isinstance(x, UDFExpr):
            # opaque python bodies never run on the device; callers keep
            # such predicates on the host engine
            raise TypeError(f"UDF expression {x.name} is host-only")
        raise TypeError(f"cannot eval {type(x)}")

    return ev(e)


def _ndim(v) -> int:
    return v.dim() if hasattr(v, "dim") else np.ndim(v)


def _t(v, device):
    """``v`` as a tensor on ``device`` (python scalars become 0-d tensors)."""
    import torch

    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)


# --------------------------------------------------------------------------- #
# canonicalization (verification support)
# --------------------------------------------------------------------------- #

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


def canonical_atoms(e: Expr) -> FrozenSet:
    """Canonical form of a conjunction: a frozen set of normalized atom keys.
    Comparison atoms are normalized so a column reference appears on the left.
    Used by ``verify.py`` for equivalence checking of pushed-down predicates."""
    atoms = []
    for a in conjuncts(e):
        atoms.append(_norm_atom(a))
    return frozenset(atoms)


def _norm_atom(a: Expr):
    if isinstance(a, BinOp) and a.op in _FLIP:
        l, r = a.left, a.right
        if not isinstance(l, Col) and isinstance(r, Col):
            return ("cmp", _FLIP[a.op], key(r), key(l))
        return ("cmp", a.op, key(l), key(r))
    return key(a)


def is_row_selection(e: Expr, columns: Sequence[str]) -> bool:
    """Is ``e`` a row-selection predicate over ``columns``: a conjunction of
    ``col == Param`` atoms covering all listed columns?"""
    pinned = set()
    for a in conjuncts(e):
        if (
            isinstance(a, BinOp)
            and a.op == "=="
            and isinstance(a.left, Col)
            and isinstance(a.right, Param)
        ):
            pinned.add(a.left.name)
        else:
            return False
    return set(columns) <= pinned


def pinned_cols(e: Expr) -> Dict[str, Expr]:
    """Columns pinned to a Param/Lit by an equality atom in ``e``."""
    out: Dict[str, Expr] = {}
    for a in conjuncts(e):
        if isinstance(a, BinOp) and a.op == "==":
            if isinstance(a.left, Col) and isinstance(a.right, (Param, Lit)):
                out[a.left.name] = a.right
            elif isinstance(a.right, Col) and isinstance(a.left, (Param, Lit)):
                out[a.right.name] = a.left
    return out


def membership_cols(e: Expr) -> Dict[str, Expr]:
    """Columns constrained by membership in a ParamSet."""
    out: Dict[str, Expr] = {}
    for a in conjuncts(e):
        if isinstance(a, IsIn) and isinstance(a.operand, Col) and isinstance(a.values, ParamSet):
            out[a.operand.name] = a.values
    return out


# fresh-name factory -------------------------------------------------------- #

_counter = [0]


def fresh(prefix: str = "v") -> str:
    _counter[0] += 1
    return f"{prefix}{_counter[0]}"


def row_selection_for(columns: Sequence[str], stage: str = "out") -> Tuple[Expr, Dict[str, str]]:
    """Build a parameterized row-selection predicate over ``columns``.
    Returns (predicate, param_name -> column map)."""
    atoms = []
    pmap: Dict[str, str] = {}
    for c in columns:
        p = Param(fresh(f"v_{c}_"), origin=(stage, c))
        atoms.append(BinOp("==", Col(c), p))
        pmap[p.name] = c
    return land(*atoms), pmap
