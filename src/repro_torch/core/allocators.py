"""Scheduling mechanisms (§3.2-§4.2; a copy of ``repro/core/allocators.py``).

All mechanisms receive (a) an empty cluster (round-based rescheduling: every
round the full placement is recomputed, jobs renew leases) and (b) the queue
in policy order. They write allocations into the cluster and set each
scheduled job's ``current_rate`` from its sensitivity matrix.

 * ``GPUProportional`` — the ubiquitous baseline (§2).
 * ``SynergyGreedy``   — first-fit with best-case demands; SKIPS jobs that do
                         not fit (fragmentation + unfairness, §3.3).
 * ``SynergyTune``     — the paper's contribution (§4.2): never skips a job
                         whose GPU demand fits; reverts over-proportional
                         demands, and demotes over-proportional *victims* to
                         their fair share to make room. Guarantees every
                         scheduled job >= GPU-proportional throughput.
 * ``StaticBestFit``   — static multi-dim packing for the DRF/Tetris
                         comparison (§5.7): demands fixed, no tuning.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import Cluster, Server
from repro_torch.core.job import Job


@dataclass
class RoundPlan:
    """Outcome of one scheduling round."""
    scheduled: Dict[int, Tuple[float, float]] = field(default_factory=dict)
    skipped: List[int] = field(default_factory=list)
    demoted: List[int] = field(default_factory=list)

    def rate_of(self, job: Job) -> float:
        if job.job_id not in self.scheduled:
            return 0.0
        c, m = self.scheduled[job.job_id]
        return job.matrix.rate(c, m)


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------
def _best_fit_single(cluster: Cluster, g: int, c: float, m: float
                     ) -> Optional[Server]:
    """Server with the least free resources that still fits (g, c, m)."""
    cands = [s for s in cluster.servers if s.fits(g, c, m)]
    if not cands:
        return None
    return min(cands, key=lambda s: (s.free_gpus, s.free_cpus, s.free_mem))


def _split_proportional(g: int, c: float, m: float,
                        shares: Sequence[int]) -> List[Tuple[int, float, float]]:
    """CPU/mem proportional to the per-server GPU share (§4.2 requirement)."""
    return [(gi, c * gi / g, m * gi / g) for gi in shares]


def _min_server_set(cluster: Cluster, g: int, *, by_gpu_only: bool,
                    c: float = 0.0, m: float = 0.0
                    ) -> Optional[List[Tuple[Server, int]]]:
    """Minimum set of servers (by free GPUs desc) covering ``g`` GPUs.

    When ``by_gpu_only`` is False, each chosen server must also fit its
    proportional CPU/mem share.
    """
    avail = [s for s in cluster.servers if s.free_gpus > 0]
    # best-fit when one server suffices: fewest free GPUs that still fit
    single = sorted((s for s in avail if s.free_gpus >= g),
                    key=lambda s: (s.free_gpus, s.free_cpus, s.free_mem))
    for s in single:
        if by_gpu_only or s.fits(g, c, m):
            return [(s, g)]
    servers = sorted(avail, key=lambda s: -s.free_gpus)
    chosen: List[Tuple[Server, int]] = []
    left = g
    for s in servers:
        take = min(s.free_gpus, left)
        if take <= 0:
            continue
        if not by_gpu_only:
            if not s.fits(take, c * take / g, m * take / g):
                continue
        chosen.append((s, take))
        left -= take
        if left == 0:
            return chosen
    return None


def try_place(cluster: Cluster, job: Job, c: float, m: float) -> bool:
    """Place ``job`` with auxiliary demand (c, m); single-GPU jobs (and any
    job that fits) are consolidated on one server, larger jobs split with
    proportional shares."""
    g = job.gpu_demand
    if g <= cluster.spec.gpus:
        s = _best_fit_single(cluster, g, c, m)
        if s is not None:
            s.allocate(job.job_id, g, c, m)
            return True
        if g <= 1:
            return False
    chosen = _min_server_set(cluster, g, by_gpu_only=False, c=c, m=m)
    if chosen is None:
        return False
    for s, gi in chosen:
        s.allocate(job.job_id, gi, c * gi / g, m * gi / g)
    return True


# ---------------------------------------------------------------------------
# allocators
# ---------------------------------------------------------------------------
class Allocator:
    name = "allocator"

    def schedule(self, cluster: Cluster, queue: Sequence[Job]) -> RoundPlan:
        raise NotImplementedError

    # shared: record outcome + set job rates
    def _finish(self, cluster: Cluster, queue: Sequence[Job],
                plan: RoundPlan) -> RoundPlan:
        for job in queue:
            if job.job_id in plan.scheduled:
                c, m = plan.scheduled[job.job_id]
                job.current_rate = job.matrix.rate(c, m)
            else:
                job.current_rate = 0.0
        return plan


class GPUProportional(Allocator):
    name = "proportional"

    def schedule(self, cluster: Cluster, queue: Sequence[Job]) -> RoundPlan:
        plan = RoundPlan()
        for job in queue:
            g = job.gpu_demand
            if g > cluster.free_gpus:
                plan.skipped.append(job.job_id)
                continue
            c, m = cluster.proportional_demand(g)
            if try_place(cluster, job, c, m):
                plan.scheduled[job.job_id] = (c, m)
            else:
                plan.skipped.append(job.job_id)
        return self._finish(cluster, queue, plan)


class SynergyGreedy(Allocator):
    """First-fit with best-case demands; skips non-fitting jobs (§3.3)."""
    name = "greedy"

    def schedule(self, cluster: Cluster, queue: Sequence[Job]) -> RoundPlan:
        plan = RoundPlan()
        for job in queue:
            if job.gpu_demand > cluster.free_gpus:
                plan.skipped.append(job.job_id)
                continue
            if try_place(cluster, job, job.demand_cpu, job.demand_mem):
                plan.scheduled[job.job_id] = (job.demand_cpu, job.demand_mem)
            else:
                plan.skipped.append(job.job_id)     # the fatal skip
        return self._finish(cluster, queue, plan)


class StaticBestFit(Allocator):
    """DRF/Tetris-style static multi-dimensional packing (§5.7): demands are
    fixed inputs; no reversion/demotion.

    ``blocking=True`` models DRF's share-ordered offers: resources go to the
    lowest-dominant-share job first, and a job that does not fit BLOCKS the
    queue (head-of-line) — which is what fragments GPUs at resource-heavy
    splits in the paper's Fig. 13. Tetris instead re-sorts by its packing
    alignment score each placement and skips."""
    name = "static"

    def __init__(self, tetris_order: bool = False, blocking: bool = True):
        self.tetris_order = tetris_order
        self.blocking = blocking and not tetris_order
        if tetris_order:
            self.name = "tetris"

    def schedule(self, cluster: Cluster, queue: Sequence[Job]) -> RoundPlan:
        plan = RoundPlan()
        pending = list(queue)
        while pending:
            if self.tetris_order:
                # Tetris: pick the job with max alignment(demand, free)
                def score(j):
                    return (j.gpu_demand * cluster.free_gpus
                            + j.demand_cpu * cluster.free_cpus
                            + (j.demand_mem * cluster.free_mem) / 100.0)
                pending.sort(key=score, reverse=True)
            job = pending.pop(0)
            if (job.gpu_demand <= cluster.free_gpus
                    and try_place(cluster, job, job.demand_cpu, job.demand_mem)):
                plan.scheduled[job.job_id] = (job.demand_cpu, job.demand_mem)
            else:
                plan.skipped.append(job.job_id)
                if self.blocking:
                    plan.skipped.extend(j.job_id for j in pending)
                    break
        return self._finish(cluster, queue, plan)


class SynergyTune(Allocator):
    """The paper's near-optimal heuristic (§4.2)."""
    name = "tune"

    def schedule(self, cluster: Cluster, queue: Sequence[Job]) -> RoundPlan:
        plan = RoundPlan()

        # 1. runnable set: top jobs whose GPU demand can be exactly satisfied,
        #    irrespective of fungible demands. Never skip a job that fits by
        #    GPUs -> no GPU under-utilization at full load.
        runnable: List[Job] = []
        free = cluster.free_gpus
        for job in queue:
            if job.gpu_demand <= free:
                runnable.append(job)
                free -= job.gpu_demand
            else:
                plan.skipped.append(job.job_id)

        # 2. pack hardest-to-place first: GPU, then CPU, then memory demand.
        order = sorted(runnable, key=lambda j: (-j.gpu_demand, -j.demand_cpu,
                                                -j.demand_mem))
        by_id = {j.job_id: j for j in runnable}
        for job in order:
            self._place_with_fallback(cluster, job, plan)

        # 3. redistribute leftovers (§5.3.2): per server, hand unallocated CPU
        #    and memory to the resident job with the highest marginal gain.
        self._redistribute(cluster, by_id, plan)
        return self._finish(cluster, queue, plan)

    def _redistribute(self, cluster: Cluster, by_id: Dict[int, Job],
                      plan: RoundPlan, mem_step: float = 25.0) -> None:
        for s in cluster.servers:
            # only single-server residents: multi-server jobs require
            # GPU-proportional shares on every server (§4.2), which a local
            # bump would break.
            local = [a for a in s.allocs.values()
                     if len(cluster.placement_of(a.job_id)) == 1
                     and a.job_id in by_id]
            while True:
                best_gain, best_apply = 0.0, None
                for a in local:
                    job = by_id[a.job_id]
                    base = job.matrix.rate(a.cpus, a.mem)
                    if s.free_cpus >= 1.0:
                        gain = job.matrix.rate(a.cpus + 1.0, a.mem) - base
                        if gain > best_gain * (1 + 1e-12):
                            best_gain, best_apply = gain, (a, 1.0, 0.0)
                    if s.free_mem >= mem_step:
                        gain = job.matrix.rate(a.cpus, a.mem + mem_step) - base
                        if gain > best_gain * (1 + 1e-12):
                            best_gain, best_apply = gain, (a, 0.0, mem_step)
                if best_apply is None or best_gain <= 1e-12:
                    break
                a, dc, dm = best_apply
                a.cpus += dc
                a.mem += dm
                plan.scheduled[a.job_id] = cluster.job_totals(a.job_id)[1:]

    # -- the §4.2 fallback chain ------------------------------------------------
    def _place_with_fallback(self, cluster: Cluster, job: Job,
                             plan: RoundPlan) -> None:
        g = job.gpu_demand
        c, m = job.demand_cpu, job.demand_mem
        cg, mg = cluster.proportional_demand(g)

        if try_place(cluster, job, c, m):
            plan.scheduled[job.job_id] = (c, m)
            return

        # (1) demand above proportional -> revert to proportional and retry
        if c > cg + 1e-9 or m > mg + 1e-9:
            c, m = min(c, cg), min(m, mg)
            if try_place(cluster, job, c, m):
                plan.scheduled[job.job_id] = (c, m)
                return

        # (2) place by GPUs only; demote over-proportional victims on those
        #     servers to fair share until the job fits.
        chosen = _min_server_set(cluster, g, by_gpu_only=True)
        if chosen is None:         # cannot happen for runnable set, by GPUs
            plan.skipped.append(job.job_id)
            return
        for s, gi in chosen:
            need_c, need_m = c * gi / g, m * gi / g
            self._demote_until_fits(cluster, s, gi, need_c, need_m, plan)
            # after demotion the fair-share invariant guarantees fit at <= prop
            s.allocate(job.job_id, gi, min(need_c, s.free_cpus),
                       min(need_m, s.free_mem))
        plan.scheduled[job.job_id] = cluster.job_totals(job.job_id)[1:]

    def _demote_until_fits(self, cluster: Cluster, s: Server, gi: int,
                           need_c: float, need_m: float,
                           plan: RoundPlan) -> None:
        """Switch over-proportional jobs on server ``s`` to fair share, largest
        excess first, until (gi, need_c, need_m) fits."""
        spec = cluster.spec
        if s.free_gpus < gi:
            return                 # GPU deficit cannot be fixed by demotion
        while not s.fits(gi, need_c, need_m):
            # a victim is over-proportional in a dimension the server is
            # short on; score by excess in the deficit dimension(s) only
            short_c = s.free_cpus < need_c - 1e-9
            short_m = s.free_mem < need_m - 1e-9
            victims = []
            for a in s.allocs.values():
                exc_c = a.cpus - a.gpus * spec.cpu_per_gpu
                exc_m = a.mem - a.gpus * spec.mem_per_gpu
                score = ((exc_c / spec.cpus if short_c else 0.0)
                         + (exc_m / spec.mem if short_m else 0.0))
                if score > 1e-9:
                    victims.append((score, a))
            if not victims:
                break              # nothing left to demote
            victims.sort(key=lambda t: -t[0])
            _, a = victims[0]
            a.cpus = min(a.cpus, a.gpus * spec.cpu_per_gpu)
            a.mem = min(a.mem, a.gpus * spec.mem_per_gpu)
            plan.demoted.append(a.job_id)
            if a.job_id in plan.scheduled:
                plan.scheduled[a.job_id] = cluster.job_totals(a.job_id)[1:]


class SynergyTuneSplit(SynergyTune):
    """Beyond-paper: the consolidation-vs-allocation tradeoff the paper
    leaves to future work (§6).

    A multi-GPU job that *could* consolidate on one server may instead be
    split across servers when the extra CPU/memory it can then claim raises
    its throughput by more than the network-split penalty. The penalty is a
    multiplicative throughput tax (default 10%, cf. the consolidation
    penalties measured by [43, 58]).
    """
    name = "tune_split"

    def __init__(self, split_penalty: float = 0.10):
        self.split_penalty = split_penalty

    def _place_with_fallback(self, cluster: Cluster, job: Job,
                             plan: RoundPlan) -> None:
        g = job.gpu_demand
        if 1 < g <= cluster.spec.gpus:
            # candidate A: consolidated placement at whatever (c, m) fits
            servers = [s for s in cluster.servers if s.free_gpus >= g]
            best_single = None
            for s in servers:
                c = min(job.demand_cpu, s.free_cpus)
                m = min(job.demand_mem, s.free_mem)
                r = job.matrix.rate(c, m)
                if best_single is None or r > best_single[0]:
                    best_single = (r, s, c, m)
            # candidate B: split across the 2 freest servers, proportional
            chosen = _min_server_set(cluster, g, by_gpu_only=False,
                                     c=job.demand_cpu, m=job.demand_mem)
            if chosen and len(chosen) > 1 and best_single is not None:
                split_rate = (job.matrix.rate(job.demand_cpu, job.demand_mem)
                              * (1.0 - self.split_penalty))
                if split_rate > best_single[0] + 1e-9:
                    for s, gi in chosen:
                        s.allocate(job.job_id, gi,
                                   job.demand_cpu * gi / g,
                                   job.demand_mem * gi / g)
                    plan.scheduled[job.job_id] = (job.demand_cpu,
                                                  job.demand_mem)
                    return
        super()._place_with_fallback(cluster, job, plan)

    def _finish(self, cluster, queue, plan):
        plan = super()._finish(cluster, queue, plan)
        # apply the split penalty to the achieved rates
        for job in queue:
            if (job.job_id in plan.scheduled
                    and len(cluster.placement_of(job.job_id)) > 1
                    and job.gpu_demand <= cluster.spec.gpus):
                job.current_rate *= (1.0 - self.split_penalty)
        return plan


ALLOCATORS = {
    "proportional": GPUProportional,
    "greedy": SynergyGreedy,
    "tune": SynergyTune,
    "tune_split": SynergyTuneSplit,
    "static": StaticBestFit,
}


def get_allocator(name: str) -> Allocator:
    if name == "tetris":
        return StaticBestFit(tetris_order=True)
    return ALLOCATORS[name]()
