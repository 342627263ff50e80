"""Scheduling policies (§2.2, §5.1; a copy of ``repro/core/policies.py``):
FIFO, SRTF, LAS, FTF, and DRF for §5.7.

A policy only orders the queue; the mechanism (``allocators.py``) decides
placement and the auxiliary resources. The serve scheduler orders its
requests with FIFO and SRTF, and ``serve.tenant.SLOSlack`` orders by SLO
slack on the same ``Policy``.
"""
from __future__ import annotations

from typing import List, Sequence


class Policy:
    name = "policy"

    def priority(self, job, now: float) -> float:
        raise NotImplementedError

    def order(self, jobs: Sequence, now: float) -> List:
        return sorted(jobs, key=lambda j: (self.priority(j, now),
                                           j.arrival_time, j.job_id))


class FIFO(Policy):
    name = "fifo"

    def priority(self, job, now: float) -> float:
        return job.arrival_time


class SRTF(Policy):
    """Shortest remaining work first (GPU-proportional work left)."""
    name = "srtf"

    def priority(self, job, now: float) -> float:
        return job.remaining


class LAS(Policy):
    """Least attained service (Tiresias-style; GPU-seconds attained)."""
    name = "las"

    def priority(self, job, now: float) -> float:
        return job.attained_service


class FTF(Policy):
    """Finish-time fairness (Themis-style): rho = projected completion
    (elapsed + remaining at the proportional rate) over the job's ideal
    isolated runtime; the largest rho goes first."""
    name = "ftf"

    def priority(self, job, now: float) -> float:
        elapsed = now - job.arrival_time
        projected = elapsed + job.remaining
        ideal = max(job.duration, 1e-9)
        return -(projected / ideal)


class DRF(Policy):
    """Dominant resource fairness (§5.7): the smallest dominant share of the
    job's static demand vector first, weighted by the service attained."""
    name = "drf"

    def __init__(self, total_gpus: float, total_cpus: float, total_mem: float):
        self.totals = (total_gpus, total_cpus, total_mem)

    def priority(self, job, now: float) -> float:
        g, c, m = job.gpu_demand, job.demand_cpu, job.demand_mem
        shares = (g / self.totals[0], c / self.totals[1], m / self.totals[2])
        return max(shares) * (1.0 + job.attained_service / 3600.0)


POLICIES = {p.name: p for p in (FIFO(), SRTF(), LAS(), FTF())}


def get_policy(name: str, cluster=None) -> Policy:
    if name == "drf":
        if cluster is None:
            raise ValueError("the drf policy needs the cluster's totals")
        return DRF(cluster.total_gpus, cluster.total_cpus, cluster.total_mem)
    return {"fifo": FIFO, "srtf": SRTF, "las": LAS, "ftf": FTF}[name]()
