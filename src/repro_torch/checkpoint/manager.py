"""Fault-tolerant checkpointing with elastic restore, in the reference's
on-disk layout (``src/repro/checkpoint/manager.py``), so each package reads
the other's checkpoints.

Layout (one directory per step)::

    <root>/step_000000042.tmp/...   # staged writes
    <root>/step_000000042/
        manifest.json                # leaf names, shapes, dtypes, hashes
        leaf_00000.npy ...           # one file per leaf (full logical array)

* **Tree**: nested dicts (keys in sorted order, as ``jax.tree`` flattens
  them), lists and tuples (``AdamWState`` included) of tensors or numpy
  arrays; ``None`` holds no leaf.  A training state is
  ``{"params": model.state_dict(), "opt": opt_state}``: one fixed, named
  order, each leaf's name in the manifest.
* **bfloat16** leaves are stored as the reference stores them: their raw
  2-byte words under a ``'<V2'`` header, ``"bfloat16"`` in the manifest, so
  neither side needs ``ml_dtypes`` to read them.
* **Atomicity**: writes stage into ``.tmp`` and ``os.replace`` to the final
  name — a crash mid-write never corrupts the latest checkpoint.
* **Integrity**: per-leaf SHA-256 (first 16 hex digits) recorded in the
  manifest and verified on restore; corrupt checkpoints are skipped and the
  previous one is used.
* **Sharded saves**: a tree of DTensors (a sharded model and its
  optimizer state) is saved by every rank together: each leaf's full
  tensor is gathered, and rank 0 alone writes it, in the layout an
  unsharded save writes.
* **Elastic restore**: leaves are full logical arrays, placed on the
  caller's ``device`` (or where the ``like`` tree's leaves live), or, with
  ``shardings``, distributed onto the caller's mesh and layouts, whatever
  the topology (or the package) that saved them.  A DTensor leaf of
  ``like`` without a sharding takes its own layout.
* **Retention**: keeps the newest ``keep`` checkpoints, deleting stale ones
  only after a successful new write.

Leaves are copied, hashed and written (or read, hashed and placed) by a
pool of ``WORKERS`` threads; the manifest keeps the leaves' order.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..compat import DTensor

BF16 = "bfloat16"
# threads that move leaves: SHA-256 and file I/O release the GIL
WORKERS = min(8, os.cpu_count() or 1)


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``jax.tree``'s order: dict keys sorted,
    sequences in order, ``None`` empty."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        return [kv for k, sub in zip(keys, tree) for kv in flatten(sub, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, Mapping):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            kids = [build(sub) for sub in t]
            return type(t)(*kids) if hasattr(t, "_fields") else type(t)(kids)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array, manifest dtype); bfloat16 as its raw words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == BF16:
        return arr.view("V2"), BF16
    return arr, str(arr.dtype)


def _save(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:  # np.save's bytes for an ml_dtypes bfloat16 array
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _write_leaf(tmp: Path, i: int, name: str, leaf) -> Dict[str, Any]:
    arr, dtype = _to_numpy(leaf)
    _save(tmp / f"leaf_{i:05d}.npy", arr, dtype)
    return {"name": name, "shape": list(arr.shape), "dtype": dtype, "sha": _hash(arr)}


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, root, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
        """Write ``tree`` as step ``step``.  A tree with DTensor leaves is
        saved by every rank of its mesh together (each leaf gathered in
        turn, rank 0 writing); the call returns on every rank once the
        step is in place."""
        leaves = flatten(tree)
        tmp = self.root / f"step_{step:09d}.tmp"
        final = self.root / f"step_{step:09d}"
        if any(isinstance(x, DTensor) for _, x in leaves):
            return self._save_sharded(step, leaves, tmp, final, extra)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "treedef": "names",
            "n_leaves": len(leaves),
            "time": time.time(),
            "extra": extra or {},
            "leaves": [],
        }
        with ThreadPoolExecutor(WORKERS) as pool:
            manifest["leaves"] = list(pool.map(
                lambda a: _write_leaf(tmp, a[0], *a[1]), enumerate(leaves)))
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _save_sharded(self, step: int, leaves, tmp: Path, final: Path,
                      extra: Optional[Dict]) -> Path:
        """Gather each DTensor leaf in the tree's order on every rank (the
        collectives line up), and write it on rank 0 while the next one is
        gathered."""
        writer = dist.get_rank() == 0
        if writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        metas = []
        with ThreadPoolExecutor(WORKERS) as pool:
            for i, (name, leaf) in enumerate(leaves):
                if isinstance(leaf, DTensor):
                    leaf = leaf.full_tensor()
                if writer:
                    metas.append(pool.submit(_write_leaf, tmp, i, name,
                                             leaf.detach().cpu()
                                             if isinstance(leaf, torch.Tensor)
                                             else leaf))
        if writer:
            manifest = {"step": step, "treedef": "names",
                        "n_leaves": len(leaves), "time": time.time(),
                        "extra": extra or {},
                        "leaves": [m.result() for m in metas]}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        dist.barrier()
        return final

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    def list_steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                out.append(int(p.name[5:]))
        return sorted(out)

    # ------------------------------------------------------------------ #
    def restore(
        self,
        like: Any,
        step: Optional[int] = None,
        shardings: Any = None,
        device=None,
        verify: bool = True,
    ) -> Tuple[int, Any]:
        """Restore into the structure of ``like`` as tensors of the stored
        dtypes, on ``device`` (``None``: the device of ``like``'s leaf where
        that is a tensor, else the CPU).  With ``shardings`` (a tree like
        ``like`` of ``NamedSharding`` leaves, or None where a leaf stays
        plain) each leaf is distributed onto its mesh and layout: every
        rank reads the file and keeps its own part.  The newest step first;
        a corrupt or partial one is skipped."""
        steps = self.list_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            path = self.root / f"step_{s:09d}"
            try:
                manifest = json.loads((path / "manifest.json").read_text())
                leaves_like = [leaf for _, leaf in flatten(like)]
                layouts = _layouts(like, shardings)
                if manifest["n_leaves"] != len(leaves_like):
                    raise ValueError(f"leaf count mismatch: ckpt {manifest['n_leaves']} "
                                     f"vs {len(leaves_like)}")

                def read(i):
                    meta, target = manifest["leaves"][i], leaves_like[i]
                    arr = np.load(path / f"leaf_{i:05d}.npy")
                    if verify and _hash(arr) != meta["sha"]:
                        raise IOError(f"hash mismatch leaf {i}")
                    if layouts[i] is not None:
                        return layouts[i].distribute(
                            _to_tensor(arr, meta["dtype"], "cpu"))
                    dev = device if device is not None else (
                        target.device if isinstance(target, torch.Tensor) else "cpu")
                    return _to_tensor(arr, meta["dtype"], dev)

                with ThreadPoolExecutor(WORKERS) as pool:
                    new_leaves = list(pool.map(read, range(len(leaves_like))))
                return s, unflatten(like, new_leaves)
            except Exception as e:  # corrupt/partial: fall back to previous
                print(f"[ckpt] step {s} unusable ({e}); trying previous")
                continue
        raise FileNotFoundError(f"no restorable checkpoint under {self.root}")


def _layouts(like: Any, shardings: Any) -> List[Any]:
    """Per leaf of ``like``, in :func:`flatten`'s order: its sharding from
    ``shardings`` (a tree of ``like``'s structure), else the layout of a
    DTensor leaf, else None."""
    from ..distrib.sharding import layout_of

    out: List[Any] = []

    def walk(t, sh):
        if t is None:
            return
        if isinstance(t, Mapping):
            for k in sorted(t):
                walk(t[k], None if sh is None else sh[k])
        elif isinstance(t, (list, tuple)):
            for i, sub in enumerate(t):
                walk(sub, None if sh is None else sh[i])
        else:
            out.append(sh if sh is not None else
                       layout_of(t) if isinstance(t, DTensor) else None)

    walk(like, shardings)
    return out


def train_state(model: torch.nn.Module, opt_state) -> Dict[str, Any]:
    """The tree a training checkpoint holds: the model's ``state_dict`` and
    the optimizer state."""
    return {"params": model.state_dict(), "opt": opt_state}
