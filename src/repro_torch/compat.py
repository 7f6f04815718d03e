"""Meshes over ``torch.distributed``, and the one import site of DTensor.

The reference's ``compat`` shims JAX's mesh API (``AxisType``,
``make_mesh(axis_types=)``).  Here a mesh is a ``DeviceMesh`` with named
dims over the ranks of a process group:

* :class:`AxisType` keeps the reference's members.  Only ``Auto`` (the
  sharding follows the ops, as GSPMD's does) is supported; ``Explicit``
  and ``Manual`` raise.
* :func:`make_mesh` builds the mesh with ``init_device_mesh``.  The process
  group is the one ``torch.distributed`` already has (``torchrun``, or a
  test's ``init_process_group``); otherwise a one-rank group is started on
  a ``FileStore`` under ``build/`` of the repository: NCCL for ``cuda``,
  gloo for ``cpu``.  A ``cuda`` mesh never falls back to gloo.
* :func:`current_mesh` is the mesh of the innermost ``with mesh:``.

Every other module takes ``DTensor``, ``Shard``, ``Replicate``,
``distribute_tensor`` and ``local_map`` from here.
"""

from __future__ import annotations

import atexit
import enum
import math
import os
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

__all__ = ["AxisType", "DTensor", "DeviceMesh", "Partial", "Replicate",
           "Shard", "current_mesh", "distribute_tensor", "local_map",
           "make_mesh"]

_BUILD = Path(__file__).resolve().parents[2] / "build"


class AxisType(enum.Enum):  # the members of jax.sharding.AxisType
    Auto = "auto"
    Explicit = "explicit"
    Manual = "manual"


def _default_device_type() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch meshes run on CUDA devices by default "
                           "and none is available; pass device_type='cpu'")
    return "cuda"


def _ensure_process_group(device_type: str) -> None:
    """The caller's process group, else a one-rank group of this process
    on a ``FileStore`` (removed at exit)."""
    if dist.is_initialized():
        return
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="pg_", dir=_BUILD)
    os.close(fd)
    os.unlink(path)  # the store creates its own file
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(path, 1), rank=0,
                            world_size=1, **kw)

    def _close():
        if dist.is_initialized():
            dist.destroy_process_group()
        if os.path.exists(path):
            os.unlink(path)

    atexit.register(_close)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              axis_types=None, device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of shape ``axis_shapes`` with dims ``axis_names``
    over every rank of the process group (its size must equal the
    product of the shape).  ``device_type`` defaults to ``cuda``."""
    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{axis_shapes} and {axis_names} differ in length")
    if axis_types is not None:
        bad = [t for t in axis_types if t is not AxisType.Auto]
        if bad or len(axis_types) != len(axis_names):
            raise NotImplementedError(
                f"only AxisType.Auto axes are supported, got {axis_types}")
    device_type = device_type or _default_device_type()
    # checked before a one-rank group is started for a mesh it cannot hold
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(axis_shapes) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, axis_shapes))} needs "
                         f"{math.prod(axis_shapes)} ranks; the process group "
                         f"has {world}")
    _ensure_process_group(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, axis_shapes, mesh_dim_names=axis_names)


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    from torch.distributed.device_mesh import _mesh_resources

    stack = getattr(_mesh_resources, "mesh_stack", None)
    return stack[-1] if stack else None
