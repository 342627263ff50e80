"""Workload traces (§5.1; a copy of ``repro/core/trace.py``).

GPU demand from the public Philly trace analysis (mostly 1-GPU jobs,
multi-GPU up to 16); durations 10^x minutes with x ~ U[1.5, 3] w.p. 0.8
else U[3, 4]; arrivals static (all at 0) or Poisson at a load in jobs an
hour; a workload split (image %, language %, speech %) gives each job a
model of the paper's zoo. Python's ``random.Random(seed)`` draws in the
reference's order, so a seed gives the reference's jobs exactly.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.core.job import Job
from repro_torch.core.sensitivity import MODEL_ZOO

#: empirical GPU-demand mix from the Philly trace characterization
PHILLY_GPU_MIX: Sequence[Tuple[int, float]] = (
    (1, 0.70), (2, 0.10), (4, 0.10), (8, 0.05), (16, 0.05),
)

_BY_TASK = {
    task: [m for m in MODEL_ZOO.values() if m.task == task]
    for task in ("image", "language", "speech")
}


@dataclass
class TraceConfig:
    n_jobs: int = 1000
    split: Tuple[int, int, int] = (20, 70, 10)       # image, language, speech %
    arrival: str = "poisson"                          # poisson | static
    jobs_per_hour: float = 8.0
    multi_gpu: bool = True                            # False -> all 1-GPU
    max_gpus_per_job: int = 16
    seed: int = 0
    duration_scale: float = 1.0


def _sample_duration(rng: random.Random) -> float:
    """10^x minutes; x ~ U[1.5, 3] w.p. 0.8, else U[3, 4] (seconds)."""
    if rng.random() < 0.8:
        x = rng.uniform(1.5, 3.0)
    else:
        x = rng.uniform(3.0, 4.0)
    return (10.0 ** x) * 60.0


def _sample_gpus(rng: random.Random, cfg: TraceConfig) -> int:
    if not cfg.multi_gpu:
        return 1
    r = rng.random()
    acc = 0.0
    for g, p in PHILLY_GPU_MIX:
        acc += p
        if r <= acc and g <= cfg.max_gpus_per_job:
            return g
    return 1


def _sample_model(rng: random.Random, cfg: TraceConfig) -> str:
    r = rng.random() * 100.0
    im, la, _ = cfg.split
    if r < im:
        task = "image"
    elif r < im + la:
        task = "language"
    else:
        task = "speech"
    return rng.choice(_BY_TASK[task]).name


def generate(cfg: TraceConfig) -> List[Job]:
    rng = random.Random(cfg.seed)
    jobs: List[Job] = []
    t = 0.0
    for i in range(cfg.n_jobs):
        if cfg.arrival == "poisson":
            t += rng.expovariate(cfg.jobs_per_hour / 3600.0)
            arrival = t
        else:
            arrival = 0.0
        jobs.append(Job(
            job_id=i,
            model_name=_sample_model(rng, cfg),
            gpu_demand=_sample_gpus(rng, cfg),
            arrival_time=arrival,
            duration=_sample_duration(rng) * cfg.duration_scale,
        ))
    return jobs


def philly_trace(n_jobs: int = 8000, split=(20, 70, 10), seed: int = 7,
                 jobs_per_hour: float = 64.0) -> List[Job]:
    """Philly-like subrange (§5.3.1): the published GPU-demand and duration
    distributions with Poisson arrivals at production load."""
    return generate(TraceConfig(n_jobs=n_jobs, split=split, arrival="poisson",
                                jobs_per_hour=jobs_per_hour, multi_gpu=True,
                                seed=seed))
