"""Event-driven cluster simulator (§4.3; a copy of
``repro/core/simulator.py``).

A global event queue carries job arrivals, round-boundary schedule events and
job finishes. On arrival a job is profiled (optimistic profiler) and enqueued.
At each schedule event the policy orders the queue, all leases are recomputed
and the mechanism re-packs the runnable set (lease renewal is implicit: a job
keeps running iff it is re-placed). Between rounds jobs advance at the rate
given by their sensitivity matrix at the allocated (c, m); finishes release
resources immediately (reused at the next round).

Fidelity knobs match the paper: 5-minute rounds, profiling overhead
accounting, steady-state measurement windows.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import opt as opt_mod
from repro_torch.core.allocators import (Allocator, RoundPlan, SynergyTune,
                                         get_allocator, try_place)
from repro_torch.core.cluster import Cluster, ServerSpec
from repro_torch.core.job import Job
from repro_torch.core.policies import Policy, get_policy
from repro_torch.core.profiler import OptimisticProfiler


@dataclass
class SimConfig:
    round_seconds: float = 300.0
    policy: str = "srtf"
    allocator: str = "tune"
    include_profile_overhead: bool = False
    steady_skip: int = 0              # ignore the first N finished jobs
    steady_count: int = 0             # 0 = measure all jobs
    max_hours: float = 24_000.0
    opt_time_limit: float = 30.0      # Synergy-OPT per-round ILP budget


@dataclass
class SimResult:
    jobs: List[Job]
    avg_jct: float
    p99_jct: float
    makespan: float
    util_samples: List[Dict[str, float]] = field(default_factory=list)
    util_times: List[float] = field(default_factory=list)
    queue_len_samples: List[int] = field(default_factory=list)
    rounds: int = 0
    opt_solve_seconds: float = 0.0

    def monitored(self, skip: int, count: int) -> List[Job]:
        done = [j for j in self.jobs if j.finish_time is not None]
        done.sort(key=lambda j: j.arrival_time)
        if count:
            return done[skip:skip + count]
        return done[skip:]


class _OptAllocator(Allocator):
    """Synergy-OPT as a round mechanism: ILP for (c,m), TUNE-style placement."""
    name = "opt"

    def __init__(self, time_limit: float = 30.0):
        self._tune = SynergyTune()
        self.time_limit = time_limit
        self.total_solve_seconds = 0.0

    def schedule(self, cluster: Cluster, queue: Sequence[Job]):
        # runnable set exactly like TUNE (GPUs first)
        runnable, skipped = [], []
        free = cluster.free_gpus
        for job in queue:
            if job.gpu_demand <= free:
                runnable.append(job)
                free -= job.gpu_demand
            else:
                skipped.append(job.job_id)
        if not runnable:
            return self._finish(cluster, queue, RoundPlan(skipped=skipped))

        res = opt_mod.solve_ideal(runnable, cluster, integer=True,
                                  time_limit=self.time_limit)
        self.total_solve_seconds += res.solve_seconds
        if not res.alloc:               # infeasible -> fall back to TUNE
            return self._tune.schedule(cluster, queue)

        plan = RoundPlan(skipped=skipped)
        order = sorted(runnable, key=lambda j: (-j.gpu_demand,))
        for job in order:
            c, m = res.alloc[job.job_id]
            if try_place(cluster, job, c, m):
                plan.scheduled[job.job_id] = (c, m)
            else:
                # materialization fallback (§4.1.3): demote via TUNE chain
                self._tune._place_with_fallback(cluster, job, plan)
        return self._finish(cluster, queue, plan)


def _make_allocator(name: str, cfg: SimConfig) -> Allocator:
    if name == "opt":
        return _OptAllocator(cfg.opt_time_limit)
    return get_allocator(name)


class Simulator:
    def __init__(self, cluster: Cluster, jobs: Sequence[Job], cfg: SimConfig,
                 profiler: Optional[OptimisticProfiler] = None,
                 policy: Optional[Policy] = None,
                 allocator: Optional[Allocator] = None):
        self.cluster = cluster
        self.jobs = sorted(jobs, key=lambda j: j.arrival_time)
        self.cfg = cfg
        self.profiler = profiler or OptimisticProfiler(cluster.spec)
        self.policy = policy or get_policy(cfg.policy, cluster)
        self.allocator = allocator or _make_allocator(cfg.allocator, cfg)

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.cfg
        t = 0.0
        next_arrival_idx = 0
        queue: List[Job] = []
        finished: List[Job] = []
        result = SimResult(jobs=list(self.jobs), avg_jct=0, p99_jct=0, makespan=0)
        n = len(self.jobs)
        max_t = cfg.max_hours * 3600.0
        dirty = True                     # re-schedule only when the mix changed

        pending: List = []               # (ready_time, job_id, job) min-heap

        while len(finished) < n and t < max_t:
            # admit arrivals; with overhead accounting a job only becomes
            # schedulable after its empirical probes finish (§5: JCT is still
            # measured from arrival, so profiling time is charged to the job)
            while (next_arrival_idx < n
                   and self.jobs[next_arrival_idx].arrival_time <= t + 1e-9):
                job = self.jobs[next_arrival_idx]
                self.profiler.profile_job(job)
                next_arrival_idx += 1
                if cfg.include_profile_overhead and job.matrix is not None:
                    job.profile_overhead_s = job.matrix.profile_seconds
                ready = job.arrival_time + job.profile_overhead_s
                if ready <= t + 1e-9:
                    queue.append(job)
                    dirty = True
                else:
                    heapq.heappush(pending, (ready, job.job_id, job))
            while pending and pending[0][0] <= t + 1e-9:
                queue.append(heapq.heappop(pending)[2])
                dirty = True

            # schedule round
            if dirty or self.policy.name in ("las", "ftf"):
                self.cluster.release_all()
                ordered = self.policy.order(queue, t)
                plan = self.allocator.schedule(self.cluster, ordered)
                for job in queue:
                    if job.current_rate > 0 and job.start_time is None:
                        job.start_time = t
                result.rounds += 1
                dirty = False
            util = self.cluster.utilization()
            result.util_samples.append(util)
            result.util_times.append(t)
            result.queue_len_samples.append(
                sum(1 for j in queue if j.current_rate == 0) + len(pending))

            # advance to next round boundary, processing finishes inside
            round_end = t + cfg.round_seconds
            if next_arrival_idx < n:
                round_end = min(round_end,
                                max(t + 1.0, self.jobs[next_arrival_idx].arrival_time))
            if pending:
                round_end = min(round_end, max(t + 1.0, pending[0][0]))
            while t < round_end - 1e-9:
                running = [j for j in queue if j.current_rate > 0]
                ttf = min((j.time_to_finish() for j in running),
                          default=float("inf"))
                dt = min(round_end - t, ttf)
                if dt <= 0:
                    dt = 1e-6
                for j in running:
                    j.advance(dt)
                t += dt
                done_now = [j for j in running if j.finished]
                for j in done_now:
                    j.finish_time = t
                    j.current_rate = 0.0
                    self.cluster.release_job(j.job_id)
                    queue.remove(j)
                    finished.append(j)
                    dirty = True
                if not running:
                    # idle: jump to the next arrival or profile completion
                    upcoming = []
                    if next_arrival_idx < n:
                        upcoming.append(self.jobs[next_arrival_idx].arrival_time)
                    if pending:
                        upcoming.append(pending[0][0])
                    if upcoming:
                        t = max(t, min(upcoming))
                    break
            if not queue and not pending and next_arrival_idx >= n:
                break

        mon = [j for j in finished]
        if cfg.steady_count:
            mon.sort(key=lambda j: j.arrival_time)
            mon = mon[cfg.steady_skip:cfg.steady_skip + cfg.steady_count]
        jcts = np.array([j.jct() for j in mon if j.jct() is not None])
        result.avg_jct = float(jcts.mean()) if len(jcts) else float("nan")
        result.p99_jct = float(np.percentile(jcts, 99)) if len(jcts) else float("nan")
        result.makespan = max((j.finish_time or 0.0) for j in finished) if finished else 0.0
        if isinstance(self.allocator, _OptAllocator):
            result.opt_solve_seconds = self.allocator.total_solve_seconds
        return result


def simulate(n_servers: int, jobs: Sequence[Job], *, policy: str = "srtf",
             allocator: str = "tune", round_seconds: float = 300.0,
             spec: ServerSpec = ServerSpec(), steady_skip: int = 0,
             steady_count: int = 0, max_hours: float = 24_000.0,
             include_profile_overhead: bool = False) -> SimResult:
    cfg = SimConfig(round_seconds=round_seconds, policy=policy,
                    allocator=allocator, steady_skip=steady_skip,
                    steady_count=steady_count, max_hours=max_hours,
                    include_profile_overhead=include_profile_overhead)
    sim = Simulator(Cluster(n_servers, spec), jobs, cfg)
    return sim.run()
