"""Mesh builders.

Counterpart of ``repro.launch.mesh``. ``make_production_mesh`` is a
function, not a module constant, so importing this module touches no
device or process-group state.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.parallel.api import Mesh


def _device_mesh(shape, names, device_type: Optional[str]):
    """The DeviceMesh of the default process group over ``shape`` (on
    ``device_type``; by default CUDA under NCCL, else the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_mesh(names, shape, device_type: Optional[str] = None) -> Mesh:
    """A mesh of axes ``names`` and sizes ``shape``: a description with no
    devices, which also holds the default process group's DeviceMesh
    when a group of the mesh's size is up."""
    import torch.distributed as dist
    mesh = Mesh(tuple(names), tuple(shape))
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == mesh.size:
        mesh = Mesh(mesh.axis_names, mesh.shape,
                    _device_mesh(mesh.shape, mesh.axis_names, device_type))
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> Mesh:
    """The reference's production mesh (:func:`make_mesh`): ("data",
    "model") (16, 16), or with ``multi_pod`` ("pod", "data", "model")
    (2, 16, 16); under the dry run's fake group of 256 or 512 ranks it
    holds that group's DeviceMesh."""
    if multi_pod:
        return make_mesh(("pod", "data", "model"), (2, 16, 16), device_type)
    return make_mesh(("data", "model"), (16, 16), device_type)


def make_host_mesh() -> Mesh:
    """A ("data", "model") mesh of (world size, 1): one data shard per
    rank of the default process group, with its DeviceMesh (on CUDA
    under NCCL, else on the CPU); (1, 1) without a process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(("data", "model"), (1, 1))
    world = dist.get_world_size()
    names = ("data", "model")
    return Mesh(names, (world, 1), _device_mesh((world, 1), names, None))
