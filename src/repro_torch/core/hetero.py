"""Heterogeneous GPU clusters (paper Appendix A.2; a copy of
``repro/core/hetero.py``).

The paper's homogeneous LP extends with a machine-type dimension: each job
carries a per-type sensitivity matrix W_ij[c, m] (the 3-D matrix of §6), the
variables become y_{c,m,i,j} (job j gets c CPU / m mem on super-machine type
i — a job never splits across types within a round), and the fairness floor
compares against an oracle fair throughput W_j^Fair (eqs. 22–26).

This module implements that ILP plus the paper's "improving utilization"
loop: re-solve over leftover capacity and the next wait-queue slice until no
GPUs or jobs remain.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import optimize, sparse

from repro_torch.core.cluster import ServerSpec
from repro_torch.core.job import Job
from repro_torch.core.opt import pareto_options
from repro_torch.core.sensitivity import (MODEL_ZOO, SensitivityMatrix,
                                          WorkloadModel, full_matrix)


@dataclass(frozen=True)
class MachineType:
    name: str
    n_machines: int
    spec: ServerSpec
    gpu_speed: float = 1.0          # relative accelerator generation speed


def hetero_matrix(model: WorkloadModel, gpus: int, mtype: MachineType,
                  cpu_points, mem_points, min_mem_gb: float = 20.0
                  ) -> SensitivityMatrix:
    """W_ij: the per-type sensitivity matrix — t_gpu scales with the
    generation speed, CPU/memory behaviour is unchanged."""
    scaled = dataclasses.replace(model, t_gpu=model.t_gpu / mtype.gpu_speed)
    return full_matrix(scaled, gpus, cpu_points, mem_points, min_mem_gb)


@dataclass
class HeteroResult:
    alloc: Dict[int, Tuple[str, float, float]]      # job -> (type, c*, m*)
    throughput: float
    fair_throughput: float
    solve_seconds: float
    unplaced: List[int] = field(default_factory=list)


def solve_hetero(jobs: Sequence[Job], types: Sequence[MachineType],
                 *, mem_unit: float = 50.0, time_limit: float = 30.0,
                 fair_oracle: Dict[int, float] = None) -> HeteroResult:
    """ILP (22)–(26): one (c, m, type) per job; per-type CPU/mem/GPU caps;
    throughput >= W_j^Fair."""
    t0 = time.perf_counter()
    mats: Dict[Tuple[int, str], SensitivityMatrix] = {}
    for job in jobs:
        model = MODEL_ZOO[job.model_name]
        for t in types:
            cpu_pts = np.arange(1.0, t.spec.cpus + 1.0)
            mem_pts = np.arange(mem_unit, t.spec.mem + 1e-9, mem_unit)
            mats[(job.job_id, t.name)] = hetero_matrix(
                model, job.gpu_demand, t, cpu_pts, mem_pts)

    # fair oracle: proportional share on the SLOWEST type (a conservative,
    # heterogeneity-aware floor — the paper defers to an external scheduler)
    if fair_oracle is None:
        slowest = min(types, key=lambda t: t.gpu_speed)
        fair_oracle = {}
        for job in jobs:
            m = mats[(job.job_id, slowest.name)]
            cg = job.gpu_demand * slowest.spec.cpu_per_gpu
            mg = job.gpu_demand * slowest.spec.mem_per_gpu
            fair_oracle[job.job_id] = m.rate(cg, mg)

    # variables: pareto options per (job, type)
    opts: List[Tuple[int, int, float, float, float]] = []  # (ji, ti, c, m, w)
    job_slices: List[Tuple[int, int]] = []
    for ji, job in enumerate(jobs):
        lo = len(opts)
        for ti, t in enumerate(types):
            mat = mats[(job.job_id, t.name)]
            tmp = Job(job_id=-1, model_name=job.model_name,
                      gpu_demand=job.gpu_demand, arrival_time=0, duration=1)
            tmp.matrix = mat
            for c, m, w in pareto_options(tmp):
                opts.append((ji, ti, c, m, w))
        job_slices.append((lo, len(opts)))

    nv = len(opts)
    n, k = len(jobs), len(types)
    wvec = np.array([o[4] for o in opts])
    rows, cols, vals, b_lo, b_hi = [], [], [], [], []
    r = 0
    for ti, t in enumerate(types):        # per-type CPU/mem/GPU caps (23,24)
        caps = (t.spec.cpus * t.n_machines, t.spec.mem * t.n_machines,
                t.spec.gpus * t.n_machines)
        for dim, cap in enumerate(caps):
            for vi, (ji, ti2, c, m, w) in enumerate(opts):
                if ti2 != ti:
                    continue
                val = (c, m, jobs[ji].gpu_demand)[dim]
                rows.append(r)
                cols.append(vi)
                vals.append(val)
            b_lo.append(-np.inf)
            b_hi.append(cap)
            r += 1
    for ji, (lo, hi) in enumerate(job_slices):     # one config (25)
        rows += [r] * (hi - lo)
        cols += list(range(lo, hi))
        vals += [1.0] * (hi - lo)
        b_lo.append(1.0)
        b_hi.append(1.0)
        r += 1
    for ji, (lo, hi) in enumerate(job_slices):     # fairness (26)
        rows += [r] * (hi - lo)
        cols += list(range(lo, hi))
        vals += list(wvec[lo:hi])
        b_lo.append(fair_oracle[jobs[ji].job_id])
        b_hi.append(np.inf)
        r += 1

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nv))
    res = optimize.milp(
        c=-wvec,
        constraints=optimize.LinearConstraint(A, np.array(b_lo), np.array(b_hi)),
        bounds=optimize.Bounds(0.0, 1.0),
        integrality=np.ones(nv),
        options={"time_limit": time_limit})

    dt = time.perf_counter() - t0
    if res.x is None:
        return HeteroResult({}, 0.0, sum(fair_oracle.values()), dt,
                            unplaced=[j.job_id for j in jobs])
    alloc = {}
    for ji, (lo, hi) in enumerate(job_slices):
        best = lo + int(np.argmax(res.x[lo:hi]))
        _, ti, c, m, w = opts[best]
        alloc[jobs[ji].job_id] = (types[ti].name, c, m)
    return HeteroResult(alloc, float(-res.fun),
                        float(sum(fair_oracle.values())), dt)
