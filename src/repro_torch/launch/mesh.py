"""Host mesh builder.

Counterpart of ``repro.launch.mesh.make_host_mesh``. The reference's
``make_production_mesh`` (the dry run's forced 512-device mesh) stays
reference-only.
"""
from __future__ import annotations

from repro_torch.parallel.api import Mesh


def make_host_mesh() -> Mesh:
    """A ("data", "model") mesh of (world size, 1): one data shard per
    rank of the default process group, with its DeviceMesh (on CUDA
    under NCCL, else on the CPU); (1, 1) without a process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(("data", "model"), (1, 1))
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(dev, (world, 1), mesh_dim_names=("data", "model"))
    return Mesh(("data", "model"), (world, 1), device_mesh=dm)
