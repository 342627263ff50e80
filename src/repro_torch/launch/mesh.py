"""Mesh construction (``repro/launch/mesh.py``) and the roofline
constants of one NVIDIA H100.

``make_host_mesh`` lays the initialized default process group out as a
("data", "model") mesh, or, given ``ranks``, a shape-only mesh of that many
ranks (the dry-run's ``--mesh host``). ``make_production_mesh`` gives the
dry-run's pod meshes as H100 clusters, shape only: a pod is 256 GPUs, 32
nodes of 8 with 'model' inside a node's NVLink domain; two pods make 512,
the reference's chip counts.

The constants below are the one home of the H100's peaks: the dry-run's
roofline terms, the dispatch profiler (``obs/prof.py``), the kernel cost
formulas (``kernels/cost.py``) and ``chip_smoke.py``'s bounds read them.
The module imports torch only inside the functions that build a process
group's mesh, so the torch-free profile store can import the constants.
"""
from __future__ import annotations

#: one NVIDIA H100 SXM5 80GB at 700 W (NVIDIA's data sheet; dense rates):
#: bf16 tensor-core FLOP/s, HBM3 bytes/s, TF32 tensor-core FLOP/s and f32
#: FLOP/s outside the tensor cores
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
#: NVLink 4 bytes/s a direction (18 links x 25 GB/s): collectives over
#: 'model', which stays inside one node's eight GPUs
NVLINK_BW = 450e9
#: one 400 Gb/s NDR InfiniBand port a GPU: collectives over 'data' and
#: 'pod', which cross nodes
NET_BW = 50e9

#: how to start a sharded run of the port
LAUNCH_HINT = ("start one process a rank under torchrun, e.g. "
               "`torchrun --nproc-per-node 2 -m repro_torch.launch.serve "
               "--mesh host ...`")


#: the wire bandwidth of a collective over each mesh axis
AXIS_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}


def axis_sizes(mesh) -> dict:
    """{axis name: size} for a mesh (the {"data": 4, "model": 2} map)."""
    return dict(mesh.sizes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (32, 8) over ("data", "model") = 256 GPUs.
    Multi-pod:  (2, 32, 8) over ("pod", "data", "model") = 512 GPUs.
    Shape only: the dry-run reads the local program of one rank."""
    from repro_torch.dist.sharding import Mesh
    if multi_pod:
        return Mesh((2, 32, 8), ("pod", "data", "model"))
    return Mesh((32, 8), ("data", "model"))


def _host_shape(n: int, model_axis: int) -> tuple:
    model_axis = max(1, min(model_axis, n))
    while n % model_axis:
        model_axis -= 1
    return (n // model_axis, model_axis)


def make_host_mesh(*, model_axis: int = 2, device_type: str = None,
                   ranks: int = None):
    """("data", "model") mesh ``(n // m, m)`` with ``m`` the largest
    divisor of ``n`` not above ``model_axis``. With ``ranks`` it is a
    shape-only mesh of ``n = ranks`` (no process group: the dry-run's host
    layout). Without, ``n`` is the world size of the default process group
    and the mesh's ``DeviceMesh`` (on ``device_type``, default the CUDA
    device when the group runs NCCL, else the CPU) gives the axis groups,
    on the default group's backend; raises when no process group is
    initialized."""
    from repro_torch.dist.sharding import Mesh
    if ranks is not None:
        return Mesh(_host_shape(int(ranks), model_axis), ("data", "model"))
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("--mesh host needs an initialized process "
                           "group: " + LAUNCH_HINT)
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    shape = _host_shape(n, model_axis)
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

    import torch
    import torch.distributed as dist
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
