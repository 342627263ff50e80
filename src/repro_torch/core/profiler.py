"""Optimistic profiling (§3.1; a copy of ``repro/core/profiler.py``).

Naive profiling cost: |CPU points| x |mem points| probes (~4 hours for a
24-CPU/500GB server at a minute each). Synergy instead:

 1. Empirically probes throughput only along the CPU axis at FULL memory
    (so t_fetch == 0), choosing probe points by the paper's binary search:
    probe the midpoint; if the improvement from mid -> hi is below a
    threshold the knee lies below, so recurse into the lower half, else into
    the upper half. ~log2(24)+2 ~ 8 probes instead of 24.
 2. Analytically fills the rest of the matrix: with a MinIO cache the hit
    rate at memory m is fixed and known (h = cache/dataset), so
    t_fetch(m) is predictable and  W[c, m] = b / max(b / W_emp(c), t_fetch(m)).

``measure_fn`` abstracts "run the job for ~50 iterations": the simulator
passes the analytic ground truth (optionally + noise); the live runtime
passes a closure that runs the job's steps on the device with a bounded CPU
pool (``chip_smoke.py``'s synergy phase).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.cluster import ServerSpec
from repro_torch.core.sensitivity import (MODEL_ZOO, SensitivityMatrix,
                                    WorkloadModel, throughput)


@dataclass(frozen=True)
class ProfilerConfig:
    improvement_threshold: float = 0.10   # paper's 10% binary-search threshold
    knee: float = 0.95                    # demand vector: min alloc @ 95% of max
    probe_seconds: float = 60.0           # ~1 min per empirical probe (§3.1)
    mem_unit_gb: float = 50.0             # memory discretization (§3.1 example)
    min_mem_gb: float = 20.0              # process working set floor


class OptimisticProfiler:
    def __init__(self, spec: ServerSpec = ServerSpec(),
                 cfg: ProfilerConfig = ProfilerConfig()):
        self.spec = spec
        self.cfg = cfg

    # -- grids -----------------------------------------------------------------
    def cpu_grid(self, gpus: int) -> np.ndarray:
        n_servers = max(1, -(-gpus // self.spec.gpus))
        max_cpu = int(n_servers * self.spec.cpus)
        return np.arange(1.0, max_cpu + 1.0)

    def mem_grid(self, gpus: int) -> np.ndarray:
        n_servers = max(1, -(-gpus // self.spec.gpus))
        max_mem = n_servers * self.spec.mem
        grid = set(np.arange(self.cfg.mem_unit_gb, max_mem + 1e-9,
                             self.cfg.mem_unit_gb).tolist())
        grid.add(gpus * self.spec.mem_per_gpu)      # GPU-proportional share
        grid.add(self.cfg.min_mem_gb)
        grid.add(max_mem)
        return np.asarray(sorted(g for g in grid if g <= max_mem + 1e-9))

    # -- the binary-search CPU probe placement (§3.1) ---------------------------
    def probe_cpu_curve(self, measure: Callable[[float], float],
                        cpu_points: np.ndarray) -> Dict[float, float]:
        probed: Dict[float, float] = {}

        def probe(idx: int) -> float:
            c = float(cpu_points[idx])
            if c not in probed:
                probed[c] = measure(c)
            return probed[c]

        lo, hi = 0, len(cpu_points) - 1
        probe(lo)
        probe(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            t_mid, t_hi = probe(mid), probe(hi)
            gain = (t_hi - t_mid) / max(t_mid, 1e-12)
            if gain < self.cfg.improvement_threshold:
                hi = mid          # knee is below: search lower half
            else:
                lo = mid          # real improvements above: search upper half
        return probed

    # -- optimistic matrix -------------------------------------------------------
    def profile(self, model: WorkloadModel, gpus: int,
                measure_fn: Optional[Callable[[float], float]] = None
                ) -> SensitivityMatrix:
        """Build W[c, m] from ~8 empirical CPU probes + the analytic mem model."""
        cpu_points = self.cpu_grid(gpus)
        mem_points = self.mem_grid(gpus)
        m_max = float(mem_points[-1])

        if measure_fn is None:          # simulator: ground truth at full memory
            def measure_fn(c: float) -> float:
                return throughput(model, gpus, c, m_max,
                                  min_mem_gb=self.cfg.min_mem_gb)

        probed = self.probe_cpu_curve(measure_fn, cpu_points)

        # piecewise-linear interpolation over the probed CPU points
        xs = np.asarray(sorted(probed))
        ys = np.asarray([probed[x] for x in xs])
        w_cpu = np.interp(cpu_points, xs, ys)

        # analytic memory fill: known storage bw + MinIO fixed hit rate
        b = model.batch_per_gpu * gpus
        cache = np.maximum(mem_points - self.cfg.min_mem_gb, 0.0)
        hit = np.minimum(1.0, cache / model.dataset_gb)
        t_fetch = b * (1.0 - hit) * model.sample_mb / model.disk_bw_mbps

        W = np.zeros((len(cpu_points), len(mem_points)))
        for ci in range(len(cpu_points)):
            t_star = b / max(w_cpu[ci], 1e-12)
            W[ci, :] = b / np.maximum(t_star, t_fetch)
        W[:, mem_points < self.cfg.min_mem_gb - 1e-9] = 0.0

        return SensitivityMatrix(
            cpu_points, mem_points, W, gpus,
            profile_probes=len(probed),
            profile_seconds=len(probed) * self.cfg.probe_seconds)

    # -- job-facing helpers --------------------------------------------------------
    def profile_job(self, job, measure_fn=None) -> None:
        if job.matrix is not None:      # already profiled (once per lifetime)
            return
        model = MODEL_ZOO[job.model_name]
        mat = self.profile(model, job.gpu_demand, measure_fn)
        job.matrix = mat
        cg, mg = (job.gpu_demand * self.spec.cpu_per_gpu,
                  job.gpu_demand * self.spec.mem_per_gpu)
        job.prop_rate = mat.rate(cg, mg)
        # The demand vector must reach at least GPU-proportional throughput
        # (fairness floor, §4.2) but otherwise be the knee of the curve.
        job.demand_cpu, job.demand_mem = mat.best_demand(
            self.cfg.knee, floor_rate=job.prop_rate)
        if mat.rate(job.demand_cpu, job.demand_mem) < job.prop_rate - 1e-12:
            job.demand_cpu, job.demand_mem = cg, mg
