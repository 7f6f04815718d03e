"""Mesh construction: the reference's shapes and axis names over the ranks
of a ``torch.distributed`` process group.

Single pod: ``(data=16, model=16)``, 256 ranks.  Multi-pod:
``(pod=2, data=16, model=16)``, 512 ranks; ``pod`` composes with ``data``
for data parallelism and FSDP.  Each raises unless the process group has
that many ranks.  :func:`make_host_mesh` is the small mesh of the tests and
of ``launch/train``: a gloo world of CPU processes (``device_type="cpu"``)
or the cards of one host.
"""

from __future__ import annotations

from typing import Optional

from ..compat import AxisType, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                     device_type=device_type)


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 1,
                   device_type: Optional[str] = None):
    """``(pod, data, model)`` when ``pod > 1``, else ``(data, model)``."""
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3,
                         device_type=device_type)
    return make_mesh((data, model), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2, device_type=device_type)
