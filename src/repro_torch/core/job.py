"""Job model (a copy of ``repro/core/job.py``).

A job arrives with a fixed GPU demand (never altered: §3), a workload
model name, an arrival time and a duration (seconds under GPU-proportional
allocation, §5.1). After optimistic profiling it carries a sensitivity
matrix and a best-case demand vector (g, c*, m*); the scheduler
arbitrates only (c, m). Each round a job advances by
``dt * current_rate / prop_rate`` proportional-seconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.core.sensitivity import SensitivityMatrix


@dataclass
class Job:
    job_id: int
    model_name: str
    gpu_demand: int
    arrival_time: float
    duration: float                      # seconds under GPU-proportional alloc
    arch_id: Optional[str] = None        # assigned-architecture job

    # -- filled by the profiler ---------------------------------------------
    matrix: Optional[SensitivityMatrix] = None
    demand_cpu: float = 0.0              # best-case CPU demand (job total)
    demand_mem: float = 0.0              # best-case memory demand (GB)
    prop_rate: float = 0.0               # W[Cg, Mg]: GPU-proportional rate
    profile_overhead_s: float = 0.0      # wall-clock spent profiling (§5)

    # -- runtime state --------------------------------------------------------
    remaining: float = field(default=-1.0)   # proportional-seconds left
    current_rate: float = 0.0
    attained_service: float = 0.0        # GPU-seconds of service (LAS)
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_preemptions: int = 0

    def __post_init__(self):
        if self.remaining < 0:
            self.remaining = self.duration

    @property
    def speedup(self) -> float:
        if self.prop_rate <= 0:
            return 1.0 if self.current_rate > 0 else 0.0
        return self.current_rate / self.prop_rate

    def demand_vector(self) -> Tuple[int, float, float]:
        return self.gpu_demand, self.demand_cpu, self.demand_mem

    def advance(self, dt: float) -> float:
        """Advance by wall-clock ``dt``; returns the proportional work done."""
        work = dt * self.speedup
        self.remaining = max(0.0, self.remaining - work)
        if self.current_rate > 0:
            self.attained_service += dt * self.gpu_demand
        return work

    def time_to_finish(self) -> float:
        """Wall-clock time to completion at the current rate (inf if idle)."""
        if self.remaining <= 0:
            return 0.0
        if self.current_rate <= 0 or self.speedup <= 0:
            return float("inf")
        return self.remaining / self.speedup

    @property
    def finished(self) -> bool:
        return self.remaining <= 1e-9

    def jct(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time
