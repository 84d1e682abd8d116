"""Production mesh definitions (port of ``launch/mesh.py``).

The production layouts are only shapes here: :class:`MeshShape` carries
the axis names and sizes, which is all :class:`~repro_torch.runtime.
sharding.ShardingPolicy` reads, so the policy can be evaluated for a
256- or 512-device layout with no process group.  Importing this module
touches no device and no process group.  A real mesh is a
``torch.distributed.device_mesh.DeviceMesh`` made inside an initialised
group (:func:`make_test_mesh`).

Mesh axes:
  single-pod : (data=16, model=16)            - 256 devices
  multi-pod  : (pod=2, data=16, model=16)     - 512 devices across 2 pods

Axis roles (see repro_torch.runtime.sharding):
  "pod"   - outermost data parallelism; gradient reduction across pods rides
            this axis (optionally int8-compressed - the S-Paxos control/data
            decoupling).
  "data"  - in-pod data parallelism (batch) + ZeRO-1 optimizer sharding.
  "model" - tensor/expert parallelism (heads, ffn, experts, vocab) and the
            sequence axis of decode KV caches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """The shape of a :class:`MeshShape` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(n_data: int = 2, n_model: int = 2,
                   device_type: str = "cpu"):
    """A (data, model) ``DeviceMesh`` over the ranks of the initialised
    default group (``n_data * n_model`` of them)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    """All axes that carry batch parallelism."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> str:
    return "model"
