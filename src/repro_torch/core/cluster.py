"""Cluster resource model: homogeneous servers with (GPU, CPU, mem) vectors
(a copy of ``repro/core/cluster.py``).

Matches the paper's experimental server: 8 accelerators, 24 CPU cores, 500 GB
DRAM (§5.1) — i.e. CPU:GPU ratio 3, GPU-proportional memory 62.5 GB/GPU. The
ratio is configurable for the Fig. 12 sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Allocation:
    """Resources a job holds on ONE server."""
    job_id: int
    gpus: int
    cpus: float
    mem: float


@dataclass
class ServerSpec:
    gpus: int = 8
    cpus: float = 24.0
    mem: float = 500.0        # GB

    @property
    def cpu_per_gpu(self) -> float:
        return self.cpus / self.gpus

    @property
    def mem_per_gpu(self) -> float:
        return self.mem / self.gpus


@dataclass
class Server:
    sid: int
    spec: ServerSpec
    allocs: Dict[int, Allocation] = field(default_factory=dict)

    # -- free resources ------------------------------------------------------
    @property
    def free_gpus(self) -> int:
        return self.spec.gpus - sum(a.gpus for a in self.allocs.values())

    @property
    def free_cpus(self) -> float:
        return self.spec.cpus - sum(a.cpus for a in self.allocs.values())

    @property
    def free_mem(self) -> float:
        return self.spec.mem - sum(a.mem for a in self.allocs.values())

    def fits(self, gpus: int, cpus: float, mem: float, eps: float = 1e-9) -> bool:
        return (self.free_gpus >= gpus and self.free_cpus >= cpus - eps
                and self.free_mem >= mem - eps)

    def allocate(self, job_id: int, gpus: int, cpus: float, mem: float) -> None:
        if not self.fits(gpus, cpus, mem):
            raise ValueError(
                f"server {self.sid}: cannot fit ({gpus},{cpus},{mem}); free="
                f"({self.free_gpus},{self.free_cpus:.1f},{self.free_mem:.1f})")
        if job_id in self.allocs:
            a = self.allocs[job_id]
            a.gpus += gpus
            a.cpus += cpus
            a.mem += mem
        else:
            self.allocs[job_id] = Allocation(job_id, gpus, cpus, mem)

    def release(self, job_id: int) -> Optional[Allocation]:
        return self.allocs.pop(job_id, None)


class Cluster:
    """A homogeneous cluster of servers."""

    def __init__(self, n_servers: int, spec: ServerSpec = ServerSpec()):
        self.spec = spec
        self.servers: List[Server] = [Server(i, spec) for i in range(n_servers)]

    # -- capacity ------------------------------------------------------------
    @property
    def total_gpus(self) -> int:
        return self.spec.gpus * len(self.servers)

    @property
    def total_cpus(self) -> float:
        return self.spec.cpus * len(self.servers)

    @property
    def total_mem(self) -> float:
        return self.spec.mem * len(self.servers)

    @property
    def free_gpus(self) -> int:
        return sum(s.free_gpus for s in self.servers)

    @property
    def free_cpus(self) -> float:
        return sum(s.free_cpus for s in self.servers)

    @property
    def free_mem(self) -> float:
        return sum(s.free_mem for s in self.servers)

    # -- GPU-proportional shares (§2) -----------------------------------------
    def proportional_demand(self, gpus: int) -> Tuple[float, float]:
        return gpus * self.spec.cpu_per_gpu, gpus * self.spec.mem_per_gpu

    # -- job placement bookkeeping --------------------------------------------
    def placement_of(self, job_id: int) -> List[Tuple[int, Allocation]]:
        return [(s.sid, s.allocs[job_id]) for s in self.servers
                if job_id in s.allocs]

    def release_job(self, job_id: int) -> None:
        for s in self.servers:
            s.release(job_id)

    def release_all(self) -> None:
        for s in self.servers:
            s.allocs.clear()

    def job_totals(self, job_id: int) -> Tuple[int, float, float]:
        g = c = m = 0.0
        for _, a in self.placement_of(job_id):
            g += a.gpus
            c += a.cpus
            m += a.mem
        return int(g), c, m

    def utilization(self) -> Dict[str, float]:
        return {
            "gpu": 1.0 - self.free_gpus / self.total_gpus,
            "cpu": 1.0 - self.free_cpus / self.total_cpus,
            "mem": 1.0 - self.free_mem / self.total_mem,
        }

    def running_job_ids(self) -> Sequence[int]:
        ids = set()
        for s in self.servers:
            ids.update(s.allocs)
        return sorted(ids)
