"""Job model (the part of ``repro/core/job.py`` the Philly trace fills).

A job arrives with a fixed GPU demand, a workload model name, an arrival
time and a duration (seconds under GPU-proportional allocation, §5.1).
The profiler's and the scheduler's fields come with the scheduler core
(ROADMAP queue A, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Job:
    job_id: int
    model_name: str
    gpu_demand: int
    arrival_time: float
    duration: float                      # seconds under GPU-proportional alloc
    arch_id: Optional[str] = None        # assigned-architecture job
