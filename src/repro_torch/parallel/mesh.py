"""Mesh axis conventions, the port of ``repro.parallel.mesh``.

Single-pod production mesh: (16, 16) over ("data", "model").
Multi-pod:                  (2, 16, 16) over ("pod", "data", "model").

"pod" is the disaggregation boundary from the paper's heterogeneous story:
weight sync and batch parallelism cross it (DCN-class links), while "model"
stays inside an NVLink domain.  Batch dims shard over ("pod","data");
weights, experts, and head/ff dims shard over "model".

The helpers take a ``torch.distributed`` ``DeviceMesh`` (axis names from
``mesh_dim_names``) or any object with ``axis_names`` and a ``shape``
mapping axis name to size, so the plans run without a process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))


def axis_names(mesh: Any) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def axis_shape(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a duck-typed mesh."""
    shape = mesh.shape
    if hasattr(shape, "get"):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def data_axes(mesh: Any) -> Tuple[str, ...]:
    """Axes that shard batch dims: ("pod","data") when a pod axis exists."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh: Any) -> Optional[str]:
    return "model" if "model" in axis_names(mesh) else None


def axis_size(mesh: Any, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = axis_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n
