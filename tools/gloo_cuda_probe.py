#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, on one card with two ranks.

    python3 tools/gloo_cuda_probe.py

Spawns two ranks on cuda:0 in one gloo group (NCCL refuses two ranks on
one device) and tries ``all_reduce``, ``all_gather``,
``all_gather_into_tensor`` and ``broadcast`` on CUDA tensors, a
``DeviceMesh`` over "cuda" on that group, and an ``all_reduce`` inside a
CUDA graph capture (which gloo cannot be captured into); then times a
[896] f32 ``all_reduce`` (host clock over 200 calls after 10 warm-up
calls, each followed by a synchronize). Prints the card, torch and CUDA
versions and one JSON object a rank. ``repro_torch.dist.sharding``'s
collectives rest on what it finds.
"""
import json
import socket
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(res, name, fn):
    try:
        out = fn()
        torch.cuda.synchronize()
        res[name] = ["ok", out]
    except Exception as e:                       # the probe's finding
        res[name] = ["fail", repr(e)[:300]]


def _rank(rank, world, port, queue):
    res = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        dev = torch.device("cuda:0")

        def all_reduce():
            x = torch.full((4,), float(rank + 1), device=dev)
            dist.all_reduce(x)
            return x.tolist()

        def all_gather():
            x = torch.full((2,), float(rank), device=dev)
            out = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(out, x)
            return torch.cat(out).tolist()

        def all_gather_into_tensor():
            x = torch.full((2,), float(rank), device=dev)
            out = torch.empty(2 * world, device=dev)
            dist.all_gather_into_tensor(out, x)
            return out.tolist()

        def broadcast():
            x = torch.full((2,), float(rank), device=dev)
            dist.broadcast(x, 0)
            return x.tolist()

        def device_mesh():
            from torch.distributed.device_mesh import DeviceMesh
            m = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                           mesh_dim_names=("data", "model"))
            x = torch.full((4,), float(rank + 1), device=dev)
            dist.all_reduce(x, group=m.get_group("model"))
            return [list(m.get_coordinate()),
                    dist.get_backend(m.get_group("model")), x.tolist()]

        for name, fn in (("all_reduce", all_reduce),
                         ("all_gather", all_gather),
                         ("all_gather_into_tensor", all_gather_into_tensor),
                         ("broadcast", broadcast),
                         ("device_mesh_cuda", device_mesh)):
            _try(res, name, fn)
        x = torch.zeros(896, device=dev)
        for _ in range(10):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(x)
            torch.cuda.synchronize()
        res["all_reduce_896_f32_ms"] = (time.perf_counter() - t0) / 200 * 1e3

        def capture():
            graph = torch.cuda.CUDAGraph()
            y = torch.ones(4, device=dev)
            with torch.cuda.graph(graph):
                dist.all_reduce(y)
            return "captured"

        _try(res, "capture_all_reduce", capture)   # last: it may poison
    except Exception:
        res["error"] = traceback.format_exc()[-1500:]
    queue.put((rank, res))


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    print(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
