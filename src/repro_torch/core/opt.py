"""Synergy-OPT (§4.1, §A.1; a copy of ``repro/core/opt.py``): the two-LP
upper bound and feasible placement, and the greedy one-resource split
that serving uses.

LP1 (ideal single super-machine): pick one (c, m) option per job maximizing
total throughput s.t. capacity + fairness (>= GPU-proportional throughput).
Solved with scipy HiGHS — as the LP relaxation (Theorem 4.1: an upper bound
on any feasible solution) and optionally as the ILP (tighter bound, what the
paper runs via CVXPY).

LP2 (placement): spread the chosen (g_j, c*_j, m*_j) demand vectors across s
machines minimizing fragmentation; Theorem A.2 bounds fragmented jobs by 3s.

The per-job option set is pruned to its Pareto frontier ((c,m) minimal for
each achievable throughput) — identical optimum, much smaller program.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import optimize, sparse

from repro_torch.core.cluster import Cluster
from repro_torch.core.job import Job


def pareto_options(job: Job) -> List[Tuple[float, float, float]]:
    opts = job.matrix.options()
    opts.sort(key=lambda t: (t[0], t[1]))
    keep = []
    for c, m, w in opts:
        dominated = any(c2 <= c and m2 <= m and w2 >= w and (c2, m2) != (c, m)
                        for c2, m2, w2 in keep)
        if not dominated:
            keep = [(c2, m2, w2) for c2, m2, w2 in keep
                    if not (c <= c2 and m <= m2 and w >= w2)]
            keep.append((c, m, w))
    return keep


@dataclass
class OptResult:
    alloc: Dict[int, Tuple[float, float]]          # job -> (c*, m*)
    throughput: float                               # objective value
    fair_throughput: float                          # sum of W[Cg, Mg]
    solve_seconds: float
    is_integral: bool
    placement: Optional[Dict[int, List[Tuple[int, float]]]] = None
    fragmented_jobs: int = 0
    lp2_seconds: float = 0.0
    status: str = "ok"


def solve_ideal(jobs: Sequence[Job], cluster: Cluster,
                integer: bool = True, time_limit: float = 60.0) -> OptResult:
    """LP1/ILP1: ideal allocation on the super-machine (eqs. 1–5)."""
    t0 = time.perf_counter()
    C, M = cluster.total_cpus, cluster.total_mem

    opts: List[Tuple[int, float, float, float]] = []    # (job_idx, c, m, w)
    job_slices: List[Tuple[int, int]] = []
    fair = []
    for ji, job in enumerate(jobs):
        cg, mg = cluster.proportional_demand(job.gpu_demand)
        w_fair = job.matrix.rate(cg, mg)
        fair.append(w_fair)
        lo = len(opts)
        for c, m, w in pareto_options(job):
            opts.append((ji, c, m, w))
        job_slices.append((lo, len(opts)))

    nv = len(opts)
    n = len(jobs)
    cvec = np.array([o[1] for o in opts])
    mvec = np.array([o[2] for o in opts])
    wvec = np.array([o[3] for o in opts])

    rows, cols, vals = [], [], []
    b_lo, b_hi = [], []
    # capacity constraints (2),(3)
    rows += [0] * nv + [1] * nv
    cols += list(range(nv)) * 2
    vals += list(cvec) + list(mvec)
    b_lo += [-np.inf, -np.inf]
    b_hi += [C, M]
    # one configuration per job (4)
    for ji, (lo, hi) in enumerate(job_slices):
        rows += [2 + ji] * (hi - lo)
        cols += list(range(lo, hi))
        vals += [1.0] * (hi - lo)
        b_lo.append(1.0)
        b_hi.append(1.0)
    # fairness (5)
    for ji, (lo, hi) in enumerate(job_slices):
        rows += [2 + n + ji] * (hi - lo)
        cols += list(range(lo, hi))
        vals += list(wvec[lo:hi])
        b_lo.append(fair[ji])
        b_hi.append(np.inf)

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(2 + 2 * n, nv))
    constraints = optimize.LinearConstraint(A, np.array(b_lo), np.array(b_hi))
    integrality = np.ones(nv) if integer else np.zeros(nv)
    res = optimize.milp(
        c=-wvec, constraints=constraints,
        bounds=optimize.Bounds(0.0, 1.0),
        integrality=integrality,
        options={"time_limit": time_limit, "presolve": True})

    dt = time.perf_counter() - t0
    if res.x is None:
        return OptResult({}, 0.0, sum(fair), dt, integer, status="infeasible")

    alloc: Dict[int, Tuple[float, float]] = {}
    for ji, (lo, hi) in enumerate(job_slices):
        x = res.x[lo:hi]
        best = lo + int(np.argmax(x))
        alloc[jobs[ji].job_id] = (opts[best][1], opts[best][2])
    return OptResult(alloc, float(-res.fun), float(sum(fair)), dt, integer)


def solve_placement(jobs: Sequence[Job], cluster: Cluster,
                    alloc: Dict[int, Tuple[float, float]]) -> Tuple[
                        Dict[int, List[Tuple[int, float]]], int, float]:
    """LP2 (eqs. 15–19): fractional placement minimizing fragmentation.

    Returns ({job -> [(server, fraction)]}, n_fragmented, seconds).
    """
    t0 = time.perf_counter()
    s = len(cluster.servers)
    n = len(jobs)
    nv = s * n

    def vid(i, j):
        return i * n + j

    g = np.array([j.gpu_demand for j in jobs], float)
    c = np.array([alloc[j.job_id][0] for j in jobs])
    m = np.array([alloc[j.job_id][1] for j in jobs])

    rows, cols, vals, b_lo, b_hi = [], [], [], [], []
    r = 0
    for i in range(s):                      # per-machine capacities (15)-(17)
        for arr, cap in ((g, cluster.spec.gpus), (c, cluster.spec.cpus),
                         (m, cluster.spec.mem)):
            for j in range(n):
                rows.append(r)
                cols.append(vid(i, j))
                vals.append(arr[j])
            b_lo.append(-np.inf)
            b_hi.append(cap)
            r += 1
    for j in range(n):                      # full allocation (18)
        for i in range(s):
            rows.append(r)
            cols.append(vid(i, j))
            vals.append(1.0)
        b_lo.append(1.0)
        b_hi.append(np.inf)
        r += 1

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nv))
    # LP (no integrality): Theorem A.2's vertex-solution argument is about the
    # *fractional* optimum — at most 3s jobs fragmented.
    res = optimize.milp(
        c=np.ones(nv),
        constraints=optimize.LinearConstraint(A, np.array(b_lo), np.array(b_hi)),
        bounds=optimize.Bounds(0.0, np.inf),
        integrality=np.zeros(nv))

    dt = time.perf_counter() - t0
    placement: Dict[int, List[Tuple[int, float]]] = {}
    fragmented = 0
    if res.x is not None:
        x = res.x.reshape(s, n)
        for j, job in enumerate(jobs):
            locs = [(i, float(x[i, j])) for i in range(s) if x[i, j] > 1e-6]
            placement[job.job_id] = locs
            if len(locs) > 1:
                fragmented += 1
    return placement, fragmented, dt


def greedy_allocate(curves: Sequence, total: float, *,
                    weights: Optional[Sequence[float]] = None,
                    floors: Optional[Sequence[float]] = None,
                    quantum: float = 1.0) -> List[float]:
    """Split ``total`` units of one resource over rate curves.

    Maximizes ``sum_i w_i * curve_i(x_i)`` subject to ``sum_i x_i <= total``
    and ``x_i >= floor_i`` by handing the next ``quantum`` to the consumer
    with the highest weighted marginal gain: optimal for concave curves,
    near-optimal for knee-shaped ones. A step-shaped curve is read ahead:
    each consumer's gain is its weighted rate over the smallest stride of
    quanta that shows one, and the winner takes that whole stride. Once
    every curve is flat the remainder goes out by weight (heaviest first)
    so the budgets cover the pool.
    """
    n = len(curves)
    if n == 0:
        return []
    w = list(weights) if weights is not None else [1.0] * n
    x = [float(f) for f in (floors if floors is not None else [0.0] * n)]
    if sum(x) > total + 1e-9:
        raise ValueError(
            f"floors {x} already exceed the pool ({total} units)")
    left = total - sum(x)
    while left >= quantum:
        best_i, best_rate, best_stride = -1, 0.0, 0
        for i in range(n):
            base = curves[i](x[i])
            j = 1
            while j * quantum <= left + 1e-9:
                d = curves[i](x[i] + j * quantum) - base
                if d > 1e-12:
                    rate = w[i] * d / j
                    if rate > best_rate:
                        best_i, best_rate, best_stride = i, rate, j
                    break
                j += 1
        if best_i < 0:
            break
        x[best_i] += best_stride * quantum
        left -= best_stride * quantum
    order = sorted(range(n), key=lambda i: (-w[i], i))
    j = 0
    while left >= quantum:
        x[order[j % n]] += quantum
        left -= quantum
        j += 1
    return x


def solve(jobs: Sequence[Job], cluster: Cluster, integer: bool = True,
          with_placement: bool = False, time_limit: float = 60.0) -> OptResult:
    result = solve_ideal(jobs, cluster, integer=integer, time_limit=time_limit)
    if with_placement and result.alloc:
        placement, frag, dt2 = solve_placement(jobs, cluster, result.alloc)
        result.placement = placement
        result.fragmented_jobs = frag
        result.lp2_seconds = dt2
    return result
