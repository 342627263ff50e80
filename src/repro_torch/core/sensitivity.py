"""Resource-sensitivity model: the physics behind W_j[c, m] (§2, §3.1; a
copy of ``repro/core/sensitivity.py``).

A step on ``g`` accelerators takes the longest of three service times:

    t_gpu              accelerator step time (model-specific)
    t_prep(c)  = g*b*k_cpu / c            k_cpu: CPU-seconds per sample
    t_fetch(m) = g*b*(1-h(m))*s_mb / bw   h(m): MinIO cache hit rate

MinIO holds a fixed hit rate h = min(1, cache / dataset_gb) per epoch, so
t_fetch is linear and predictable in m: what lets the optimistic profiler
probe only along c at full memory.

``SensitivityMatrix`` is W[c, m]: a job's progress rate over discrete
allocations of two resources. The serve-side tenant profiler puts cache
units on the first (CPU) axis and the decode horizon K on the second
(memory) axis (``serve/tenant.py``). ``MODEL_ZOO`` holds the paper's ten
workload models, calibrated to its Figure 2 (CPUs a GPU to saturate) and
the §2.1 memory experiments; ``ARCH_SENSITIVITY`` maps the registry's
architectures onto them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class WorkloadModel:
    """Constants for one DNN workload (per single accelerator)."""
    name: str
    task: str                # image | language | speech
    batch_per_gpu: int       # samples per accelerator per step
    t_gpu: float             # seconds per step (compute-bound floor)
    k_cpu: float             # CPU-seconds of preprocessing per sample
    sample_mb: float         # bytes fetched per sample (MB)
    dataset_gb: float        # full dataset size (GB) -> MinIO hit rate
    disk_bw_mbps: float = 500.0   # storage bandwidth per job (MB/s)

    def cpus_to_saturate(self) -> float:
        return self.batch_per_gpu * self.k_cpu / self.t_gpu


def _image(name, sat_cpus, t_gpu=0.20, b=128, sample_mb=0.12, dataset_gb=550):
    # k_cpu chosen so that t_prep(c=sat_cpus) == t_gpu (Fig. 2)
    return WorkloadModel(name, "image", b, t_gpu, sat_cpus * t_gpu / b,
                         sample_mb, dataset_gb)


def _speech(name, sat_cpus, t_gpu=0.25, b=32, sample_mb=0.5, dataset_gb=700):
    return WorkloadModel(name, "speech", b, t_gpu, sat_cpus * t_gpu / b,
                         sample_mb, dataset_gb)


def _lang(name, sat_cpus=1.0, t_gpu=0.30, b=64, sample_mb=0.02, dataset_gb=15):
    return WorkloadModel(name, "language", b, t_gpu, sat_cpus * t_gpu / b,
                         sample_mb, dataset_gb)


#: the paper's Table 4 models, in the reference's order (the trace draws
#: from each task's list by position)
MODEL_ZOO: Dict[str, WorkloadModel] = {m.name: m for m in [
    _image("shufflenetv2", 12.0, t_gpu=0.10),
    _image("alexnet", 12.0, t_gpu=0.12),
    _image("resnet18", 9.0, t_gpu=0.17),
    _image("mobilenetv2", 9.0, t_gpu=0.18),
    _image("resnet50", 6.0, t_gpu=0.35),
    _lang("gnmt", 1.0, t_gpu=0.55),
    _lang("lstm", 1.0, t_gpu=0.20),
    _lang("transformer-xl", 1.0, t_gpu=0.40),
    _speech("m5", 8.0, t_gpu=0.22),
    _speech("deepspeech", 5.0, t_gpu=0.60),
]}

TASK_OF = {name: m.task for name, m in MODEL_ZOO.items()}

#: each registered architecture's workload class: a live job of that
#: architecture takes the zoo model's calibrated sensitivity
ARCH_SENSITIVITY = {
    "whisper-large-v3": "deepspeech",
    "phi-3-vision-4.2b": "resnet18",
    "olmoe-1b-7b": "transformer-xl",
    "llama3.2-1b": "lstm",
    "phi3.5-moe-42b-a6.6b": "gnmt",
    "qwen2-0.5b": "lstm",
    "zamba2-7b": "gnmt",
    "qwen2-7b": "gnmt",
    "mamba2-780m": "transformer-xl",
    "gemma3-27b": "gnmt",
}


def throughput(model: WorkloadModel, gpus: int, cpus: float, mem_gb: float,
               *, min_mem_gb: float = 20.0) -> float:
    """Steady-state samples/s for a job holding (gpus, cpus, mem_gb); memory
    below ``min_mem_gb`` (the process's working set) runs nothing."""
    if gpus <= 0 or cpus <= 0 or mem_gb < min_mem_gb:
        return 0.0
    b = model.batch_per_gpu * gpus
    t_prep = b * model.k_cpu / cpus
    cache_gb = max(mem_gb - min_mem_gb, 0.0)
    hit = min(1.0, cache_gb / model.dataset_gb)
    t_fetch = b * (1.0 - hit) * model.sample_mb / model.disk_bw_mbps
    step = max(model.t_gpu, t_prep, t_fetch)
    return b / step


@dataclass
class SensitivityMatrix:
    """W[c, m]: progress rate over discrete (first, second) allocations."""
    cpu_points: np.ndarray         # [NC] candidate first-axis allocations
    mem_points: np.ndarray         # [NM] candidate second-axis allocations
    W: np.ndarray                  # [NC, NM] rates
    gpus: int
    profile_probes: int = 0        # empirical probes spent
    profile_seconds: float = 0.0

    def rate(self, cpus: float, mem: float) -> float:
        """The rate at an arbitrary (c, m), floor-indexed into the grid."""
        ci = int(np.searchsorted(self.cpu_points, cpus + 1e-9) - 1)
        mi = int(np.searchsorted(self.mem_points, mem + 1e-9) - 1)
        ci = max(0, min(ci, len(self.cpu_points) - 1))
        mi = max(0, min(mi, len(self.mem_points) - 1))
        return float(self.W[ci, mi])

    def max_rate(self) -> float:
        return float(self.W.max())

    def best_demand(self, knee: float = 0.95,
                    floor_rate: float = 0.0) -> Tuple[float, float]:
        """The least (c, m) reaching ``knee`` of the best rate, and never
        less than ``floor_rate`` (the fairness floor)."""
        target = max(self.max_rate() * knee, min(floor_rate, self.max_rate()))
        best = (float(self.cpu_points[-1]), float(self.mem_points[-1]))
        best_cost = math.inf
        for ci, c in enumerate(self.cpu_points):
            for mi, m in enumerate(self.mem_points):
                if self.W[ci, mi] >= target:
                    cost = (c / self.cpu_points[-1]
                            + 0.5 * m / self.mem_points[-1])
                    if cost < best_cost:
                        best_cost, best = cost, (float(c), float(m))
        return best

    def curve(self, mem: float):
        """The 1-D rate curve along the first axis at a fixed ``mem``: what
        ``opt.greedy_allocate`` splits a pool over."""
        return lambda c: self.rate(c, mem)

    def best_second_axis(self, cpus: float, knee: float = 0.95) -> float:
        """The least second-axis point reaching ``knee`` of the best rate at
        a fixed ``cpus`` (the serve profiler's horizon knee at a tenant's
        unit budget)."""
        ci = int(np.searchsorted(self.cpu_points, cpus + 1e-9) - 1)
        ci = max(0, min(ci, len(self.cpu_points) - 1))
        row = self.W[ci]
        target = float(row.max()) * knee
        for mi, m in enumerate(self.mem_points):
            if row[mi] >= target:
                return float(m)
        return float(self.mem_points[-1])

    def options(self) -> List[Tuple[float, float, float]]:
        """Every (c, m, W) triple of the grid."""
        return [(float(c), float(m), float(self.W[ci, mi]))
                for ci, c in enumerate(self.cpu_points)
                for mi, m in enumerate(self.mem_points)]


def full_matrix(model: WorkloadModel, gpus: int,
                cpu_points: Sequence[float], mem_points: Sequence[float],
                min_mem_gb: float = 20.0) -> SensitivityMatrix:
    """The ground-truth matrix (what exhaustive profiling would measure)."""
    cpu_points = np.asarray(sorted(cpu_points), float)
    mem_points = np.asarray(sorted(mem_points), float)
    W = np.zeros((len(cpu_points), len(mem_points)))
    for ci, c in enumerate(cpu_points):
        for mi, m in enumerate(mem_points):
            W[ci, mi] = throughput(model, gpus, c, m, min_mem_gb=min_mem_gb)
    return SensitivityMatrix(cpu_points, mem_points, W, gpus)
