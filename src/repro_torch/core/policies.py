"""Queue orderings the serve scheduler uses (a copy of the FIFO / SRTF part
of ``repro.core.policies``; ``serve.tenant.SLOSlack`` orders by SLO
slack on the same ``Policy``). A policy only orders the queue; admission
is the pool's and the tenant allocation's decision."""
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
    """Shortest remaining work first (a request's ``remaining``)."""
    name = "srtf"

    def priority(self, job, now: float) -> float:
        return job.remaining
