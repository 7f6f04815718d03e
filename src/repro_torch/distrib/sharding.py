"""Logical-axis sharding rules (MaxText-style, simplified), on DTensor.

Model code annotates tensors with *logical* axis names; a rules table maps
them to mesh axes.  Swapping the table changes the layout without touching
model code.

* ``axis_rules(rules)``: context manager installing a rules table (per
  thread, nested tables merge).
* ``spec_for(mesh, shape, logical)``: the reference's ``PartitionSpec``
  as a tuple, one entry per tensor dim (a mesh axis, a tuple of axes or
  None), trailing Nones dropped, with its divisibility guard: a dim that
  does not divide by its axes' size is replicated (2 KV heads on a 16-way
  model axis), never split unevenly.  It reads only the mesh's dim names
  and sizes (:class:`AbstractMesh` has nothing else).
* ``placements(mesh, spec)``: the same layout in DTensor's direction, one
  ``Shard(dim)`` / ``Replicate()`` per mesh dim.  A tensor dim on two
  axes (``batch`` on ``("pod", "data")``) is ``Shard`` on both mesh dims,
  split over the first one first, which is the reference's order while the
  mesh's dims run ``pod, data, model``.  A mesh dim of size 1 holds the
  whole dim, so it is ``Replicate()``, the same layout.
* ``shard(x, *logical)``: the counterpart of ``with_sharding_constraint``:
  a DTensor under an active mesh (``with mesh:``) is redistributed to its
  spec's placements; anything else passes through unchanged, so every
  single-device path is as it was.
* ``tree_sharding``: parameter layouts from spec trees, with optional
  FSDP: the largest unsharded dim divisible by the FSDP axes (ties to the
  later dim) is sharded over them, the ZeRO-3 layout.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections.abc import Mapping
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

from ..compat import (DTensor, Partial, Replicate, Shard, current_mesh,
                      distribute_tensor, local_map)

Logical = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

# default rules: data-parallel batch, tensor-parallel heads/mlp/vocab
DEFAULT_RULES: Dict[str, Logical] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": None,  # "model" => expert parallelism
    "kv_seq": "model",  # decode KV-cache sequence sharding (when heads can't)
    "seq_act": None,  # residual-stream sequence sharding between blocks (SP)
    "state": None,
    "conv": None,
}

_local = threading.local()


def current_rules() -> Dict[str, Logical]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Logical]):
    old = current_rules()
    merged = dict(old)
    merged.update(rules)
    _local.rules = merged
    try:
        yield merged
    finally:
        _local.rules = old


class AbstractMesh(NamedTuple):
    """A mesh's dim sizes and names without ranks or a process group: what
    :func:`spec_for` and :func:`tree_sharding` read."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_axes(mesh, logical: Logical) -> Tuple[str, ...]:
    if logical is None:
        return ()
    rules = current_rules()
    resolved = rules.get(logical, None) if isinstance(logical, str) else logical
    if resolved is None:
        return ()
    if isinstance(resolved, str):
        resolved = (resolved,)
    names = mesh.mesh_dim_names
    return tuple(a for a in resolved if a in names)


def _axis_size(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(sizes[a] for a in axes)


def spec_for(mesh, shape: Sequence[int], logical: Sequence[Logical]) -> Spec:
    """The reference's ``PartitionSpec`` (as a tuple), with divisibility
    guards."""
    sizes = _sizes(mesh)
    entries = []
    used = set()
    for dim, name in zip(shape, logical):
        axes = tuple(a for a in _mesh_axes(mesh, name) if a not in used)
        if axes and dim % _axis_size(sizes, axes) == 0:
            entries.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(mesh, spec: Spec) -> tuple:
    """``spec`` (tensor dim -> mesh axes) as DTensor placements (mesh dim
    -> ``Shard(tensor dim)`` or ``Replicate()``)."""
    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in (entry if isinstance(entry, tuple)
                                        else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"dim {i} is sharded over {entry}, against the "
                             f"order of the mesh's dims {names}")
        for j in idx:
            if sizes[j] > 1:  # a dim of one rank holds it all: replicated
                out[j] = Shard(i)
    return tuple(out)


def shard(x, *logical: Logical):
    """Redistribute a DTensor to its logical layout when a mesh is active."""
    if current_mesh() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(mesh, spec_for(mesh, x.shape, logical))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicate_like(x, t):
    """``t``, a plain tensor equal on every rank, as a replicated DTensor on
    ``x``'s mesh when ``x`` is a DTensor (DTensor ops take no plain
    tensors); otherwise ``t`` itself."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def local_call(fn, args, in_logical, outs):
    """``fn`` on each rank's own shards, for ops DTensor has no rule for
    (a kernel, a recurrence, top-k routing).  ``args`` are DTensors with
    a logical spec each in ``in_logical`` (``()``: replicated everywhere;
    None: passed as it is); each is redistributed to its spec first.
    ``outs`` is ``(shape, logical)`` of the output, or a list of them.  A
    mesh dim that shards an input but no output makes that output a
    partial sum over it (a contraction split across ranks); an input
    replicated over a mesh dim that splits the work gets a partial-sum
    gradient there.  Without DTensor arguments ``fn`` runs as it is."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    in_pl = [None if lg is None else placements(mesh, spec_for(mesh, a.shape, lg))
             for a, lg in zip(args, in_logical)]
    single = not isinstance(outs, list)
    out_pl = [list(placements(mesh, spec_for(mesh, shape, lg)))
              for shape, lg in ([outs] if single else outs)]
    split = {j for pl in in_pl if pl for j, p in enumerate(pl) if p.is_shard()}
    for pl in out_pl:
        for j in split:
            if pl[j].is_replicate():
                pl[j] = Partial()
    busy = {j for pl in out_pl for j, p in enumerate(pl) if not p.is_replicate()}
    grad_pl = [None if pl is None else tuple(
        Partial() if j in busy and p.is_replicate() else p
        for j, p in enumerate(pl)) for pl in in_pl]
    return local_map(fn, out_placements=out_pl[0] if single else tuple(out_pl),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# --------------------------------------------------------------------------- #
# parameter shardings (with FSDP)
# --------------------------------------------------------------------------- #


class NamedSharding(NamedTuple):
    """A layout: the mesh and the reference's spec for it."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def distribute(self, tensor):
        """``tensor`` (the full array, the same on every rank) as a DTensor
        in this layout, each rank keeping its own part (no collective)."""
        return distribute_tensor(tensor.to(self.mesh.device_type), self.mesh,
                                 self.placements, src_data_rank=None)


def layout_of(x) -> NamedSharding:
    """A DTensor's layout as a :class:`NamedSharding` (its placements read
    back into the reference's spec)."""
    mesh = x.device_mesh
    axes = [[] for _ in range(x.ndim)]
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if pl.is_shard():
            axes[pl.dim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"{pl} is not a layout of stored values")
    spec = [None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes]
    while spec and spec[-1] is None:
        spec.pop()
    return NamedSharding(mesh, tuple(spec))


def is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _map_specs(fn, shapes, specs):
    """``fn(shape, spec)`` over the leaves of ``specs`` (tuples of logical
    names), ``shapes`` walked alongside (dicts, lists, tuples)."""
    if is_spec_leaf(specs):
        return fn(tuple(getattr(shapes, "shape", shapes)), specs)
    if isinstance(specs, Mapping):
        return {k: _map_specs(fn, shapes[k], v) for k, v in specs.items()}
    return type(specs)(_map_specs(fn, s, v) for s, v in zip(shapes, specs))


def fsdp_spec(mesh, shape: Sequence[int], spec: Spec,
              fsdp_axes: Tuple[str, ...] = ("pod", "data")) -> Spec:
    """``spec`` with the FSDP axes on the largest unsharded dim they
    divide, when the spec uses none of them."""
    names = mesh.mesh_dim_names
    fsdp_ax = tuple(a for a in fsdp_axes if a in names)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in spec:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    if fsdp_ax and not (set(fsdp_ax) & used):
        size = _axis_size(_sizes(mesh), fsdp_ax)
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] % size == 0]
        if cands:
            _, i = max(cands)
            spec[i] = fsdp_ax if len(fsdp_ax) > 1 else fsdp_ax[0]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def tree_sharding(mesh, shapes, specs, fsdp: bool = False,
                  fsdp_axes: Tuple[str, ...] = ("pod", "data")):
    """A :class:`NamedSharding` per leaf of ``specs`` (one logical name per
    dim), the shapes (tuples or anything with ``.shape``) in a tree of the
    same structure."""

    def one(shape, sp):
        spec = spec_for(mesh, shape, sp)
        if fsdp:
            spec = fsdp_spec(mesh, shape, spec, fsdp_axes)
        return NamedSharding(mesh, spec)

    return _map_specs(one, shapes, specs)
