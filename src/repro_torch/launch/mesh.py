"""Mesh construction over ``torch.distributed`` (``repro/launch/mesh.py``).

``make_host_mesh`` lays the initialized default process group out as a
("data", "model") mesh; the production pod meshes of the reference (and its
TPU roofline constants) belong to the dry-run tooling, which is ported
later (ROADMAP queue A, item 12).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Mesh

#: how to start a sharded run of the port
LAUNCH_HINT = ("start one process a rank under torchrun, e.g. "
               "`torchrun --nproc-per-node 2 -m repro_torch.launch.serve "
               "--mesh host ...`")


def axis_sizes(mesh) -> dict:
    """{axis name: size} for a mesh (the {"data": 4, "model": 2} map)."""
    return dict(mesh.sizes)


def make_host_mesh(*, model_axis: int = 2, device_type: str = None) -> Mesh:
    """("data", "model") mesh over the ranks of the default process group:
    ``(world // m, m)`` with ``m`` the largest divisor of the world size
    not above ``model_axis``. Its ``DeviceMesh`` (on ``device_type``,
    default the CUDA device when the group runs NCCL, else the CPU) gives
    the axis groups, on the default group's backend. Raises when no
    process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("--mesh host needs an initialized process "
                           "group: " + LAUNCH_HINT)
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    model_axis = max(1, min(model_axis, n))
    while n % model_axis:
        model_axis -= 1
    shape = (n // model_axis, model_axis)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                    mesh_dim_names=("data", "model"))
    return Mesh(shape, ("data", "model"), device_mesh=dm)


def init_distributed(device: str = "cuda", backend: str = None):
    """Join the process group that ``torchrun`` describes (its
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` environment) and return
    this rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU
    when ``device`` is "cpu". The backend defaults to NCCL on CUDA and to
    gloo on the CPU; ranks that share one card pass ``backend="gloo"``
    (NCCL refuses two ranks on one device, and that stays an error)."""
    import os
    if not os.environ.get("WORLD_SIZE"):
        raise RuntimeError("--mesh host needs a process group: "
                           + LAUNCH_HINT)
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                            else "gloo"))
    return dev
