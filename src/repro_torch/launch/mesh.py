"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

Functions, never module-level meshes, so importing this module touches no
process group.  :func:`make_host_mesh` is a real
:class:`~torch.distributed.device_mesh.DeviceMesh` over the initialised
world; the production meshes are shapes and axis names only
(:class:`~repro_torch.distributed.sharding.MeshShape`), for the policy's
accounting -- one card cannot hold their 256 or 512 ranks.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16 x 16 = 256 chips, axes (data, model).  Multi-pod: 2 x
    16 x 16 = 512, axes (pod, data, model); the pod axis is pure data
    parallelism over the slower links between pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) DeviceMesh over the initialised world: on "cuda"
    when the world's backend is NCCL, on "cpu" for gloo.  Raises when no
    process group is initialised (a DeviceMesh would otherwise start one
    from the environment) or ``data * model`` is not the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; "
                         f"the world has {world}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))
