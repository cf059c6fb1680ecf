"""Meshes: the production meshes and small debug meshes as
``torch.distributed`` ``DeviceMesh``es — ``src/repro/launch/mesh.py``.

Axes: "data" carries the batch and FSDP, "model" tensor and expert
parallelism, and "pod" extends data parallelism across pods (the
reference's cross-pod boundary). A ``DeviceMesh`` needs a process group
of its size, so each mesh is first a ``MeshShape``: its axis names and
sizes, the two attributes (``mesh_dim_names``, ``shape``) that the
sharding rules read of a mesh. The rules then run on the production
meshes' shapes without 256 or 512 ranks.

  mesh = make_debug_mesh(2, 2, device_type="cpu")  # in a 4-rank gloo group
  specs = param_specs(production_mesh_shape(), model.abstract_params())
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, in mesh order."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def debug_mesh_shape(data: int = 2, model: int = 2, *,
                     pod: int = 0) -> MeshShape:
    """A small mesh for tests: (pod,) data x model."""
    if pod:
        return MeshShape(("pod", "data", "model"), (pod, data, model))
    return MeshShape(("data", "model"), (data, model))


def build_mesh(shape: MeshShape, device_type: str = "cuda"):
    """The ``DeviceMesh`` of `shape` over the default process group,
    whose world size must be the mesh's size (ranks in row-major
    order)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape.shape,
                            mesh_dim_names=shape.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return build_mesh(production_mesh_shape(multi_pod=multi_pod),
                      device_type)


def make_debug_mesh(data: int = 2, model: int = 2, *, pod: int = 0,
                    device_type: str = "cuda"):
    return build_mesh(debug_mesh_shape(data, model, pod=pod), device_type)


def data_axes(mesh) -> tuple:
    """The mesh axes that carry the batch (pod folds into data)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
