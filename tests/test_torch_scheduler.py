"""The Synergy scheduler core on the port (``repro_torch.core``) against the
JAX package's (``repro.core``), on the CPU.

Both are host-side numpy / scipy code, so every result is held exactly
(``==``, bitwise for arrays): the throughput model and ``full_matrix``,
the zoo and architecture maps, ``sens_class`` of every registered arch,
the cluster's bookkeeping, every policy's order, each allocator's round
plan and placements, the optimistic profiler's probes and matrix (analytic
and seeded noisy measures), Synergy-OPT's LP1 / ILP1 / LP2, and whole
simulations under every allocator and policy. The reference's own
invariants (``tests/test_scheduler.py``) are checked on the port's results
beside them.
"""
import copy
import math

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import allocators as J_alloc
from repro.core import cluster as J_cluster
from repro.core import opt as J_opt
from repro.core import policies as J_pol
from repro.core import profiler as J_prof
from repro.core import sensitivity as J_sens
from repro.core import simulator as J_sim
from repro.core import trace as J_trace
from repro.core.job import Job as JaxJob
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import allocators as P_alloc
from repro_torch.core import cluster as P_cluster
from repro_torch.core import opt as P_opt
from repro_torch.core import policies as P_pol
from repro_torch.core import profiler as P_prof
from repro_torch.core import sensitivity as P_sens
from repro_torch.core import simulator as P_sim
from repro_torch.core import trace as P_trace
from repro_torch.core.job import Job

#: (module of the reference, module of the port) for each side of a pair
SIDES = {
    "jax": (J_trace, J_prof, J_cluster, J_alloc, J_pol),
    "port": (P_trace, P_prof, P_cluster, P_alloc, P_pol),
}
ALLOCATORS = ("proportional", "greedy", "tune", "tune_split", "static",
              "tetris")
POLICIES = ("fifo", "srtf", "las", "ftf", "drf")


def _profiled(side, n, split, seed):
    trace, prof = SIDES[side][:2]
    jobs = trace.generate(trace.TraceConfig(n_jobs=n, split=split,
                                            arrival="static", seed=seed))
    p = prof.OptimisticProfiler()
    for j in jobs:
        p.profile_job(j)
    return jobs


def _job_state(j):
    return (j.job_id, j.model_name, j.gpu_demand, j.arrival_time, j.duration,
            j.demand_cpu, j.demand_mem, j.prop_rate, j.profile_overhead_s,
            j.remaining, j.current_rate, j.attained_service, j.start_time,
            j.finish_time, j.n_preemptions)


def _matrix(m):
    return (m.cpu_points.tolist(), m.mem_points.tolist(), m.W.tobytes(),
            m.W.shape, m.gpus, m.profile_probes, m.profile_seconds)


def _placements(cluster):
    return [sorted((a.job_id, a.gpus, a.cpus, a.mem)
                   for a in s.allocs.values()) for s in cluster.servers]


def _check_capacity(cluster):
    for s in cluster.servers:
        assert s.free_gpus >= 0
        assert s.free_cpus >= -1e-6
        assert s.free_mem >= -1e-6


# ---------------------------------------------------------------------------
# the sensitivity model
# ---------------------------------------------------------------------------
def test_zoo_maps_and_sens_class_match():
    assert list(P_sens.MODEL_ZOO) == list(J_sens.MODEL_ZOO)
    for name, m in P_sens.MODEL_ZOO.items():
        r = J_sens.MODEL_ZOO[name]
        assert (m.name, m.task, m.batch_per_gpu, m.t_gpu, m.k_cpu,
                m.sample_mb, m.dataset_gb, m.disk_bw_mbps) == (
            r.name, r.task, r.batch_per_gpu, r.t_gpu, r.k_cpu, r.sample_mb,
            r.dataset_gb, r.disk_bw_mbps)
        assert m.cpus_to_saturate() == r.cpus_to_saturate()
    assert P_sens.TASK_OF == J_sens.TASK_OF
    assert P_sens.ARCH_SENSITIVITY == J_sens.ARCH_SENSITIVITY
    # every registered arch (and the one the port defers) has a class
    assert set(ARCH_IDS) | {"phi3.5-moe-42b-a6.6b"} == set(
        P_sens.ARCH_SENSITIVITY)
    for arch in ARCH_IDS:
        assert get_config(arch).sens_class == jax_config(arch).sens_class
        assert (get_config(arch, smoke=True).sens_class
                == jax_config(arch, smoke=True).sens_class)
    assert get_config("phi-3-vision-4.2b").sens_class == "image"
    assert get_config("whisper-large-v3").sens_class == "speech"
    # phi-3-vision is the paper's CPU-sensitive image case: 9 CPUs a GPU
    phi = P_sens.MODEL_ZOO[P_sens.ARCH_SENSITIVITY["phi-3-vision-4.2b"]]
    assert phi.task == "image" and phi.cpus_to_saturate() == pytest.approx(9)


def test_throughput_and_full_matrix_match():
    cpus = [0.0, 0.5, 1.0, 2.0, 3.0, 5.5, 9.0, 12.0, 24.0, 48.0]
    mems = [0.0, 19.9, 20.0, 45.0, 62.5, 150.0, 500.0, 1000.0]
    for name in P_sens.MODEL_ZOO:
        pm, jm = P_sens.MODEL_ZOO[name], J_sens.MODEL_ZOO[name]
        for g in (0, 1, 2, 8, 16):
            for c in cpus:
                for m in mems:
                    for floor in (0.0, 20.0):
                        got = P_sens.throughput(pm, g, c, m, min_mem_gb=floor)
                        assert got == J_sens.throughput(jm, g, c, m,
                                                        min_mem_gb=floor)
                        # more CPU or memory never lowers the rate
                        assert P_sens.throughput(
                            pm, g, c + 1.0, m, min_mem_gb=floor) >= got
                        assert P_sens.throughput(
                            pm, g, c, m + 10.0, min_mem_gb=floor) >= got
        for g in (1, 4):
            a = P_sens.full_matrix(pm, g, cpus[::-1], mems)
            b = J_sens.full_matrix(jm, g, cpus[::-1], mems)
            assert _matrix(a) == _matrix(b)
            assert a.best_demand() == b.best_demand()
            assert a.options() == b.options()


# ---------------------------------------------------------------------------
# the cluster
# ---------------------------------------------------------------------------
def _cluster_script(mod):
    spec = mod.ServerSpec(gpus=4, cpus=12.0, mem=200.0)
    cl = mod.Cluster(3, spec)
    log = [(cl.total_gpus, cl.total_cpus, cl.total_mem, spec.cpu_per_gpu,
            spec.mem_per_gpu, cl.proportional_demand(3))]
    steps = [("a", 0, 7, 2, 5.5, 60.0), ("a", 1, 3, 4, 12.0, 200.0),
             ("a", 0, 7, 1, 2.5, 10.0), ("a", 2, 9, 1, 1.0, 50.5),
             ("a", 0, 8, 2, 4.0, 200.0),         # does not fit: raises
             ("r", 1, 3), ("a", 1, 8, 2, 4.0, 100.0), ("j", 7),
             ("a", 2, 8, 1, 3.0, 25.0), ("r", 0, 99)]
    for st in steps:
        if st[0] == "a":
            _, sid, jid, g, c, m = st
            s = cl.servers[sid]
            fits = s.fits(g, c, m)
            try:
                s.allocate(jid, g, c, m)
                raised = False
            except ValueError:
                raised = True
            log.append(("a", fits, raised))
        elif st[0] == "r":
            a = cl.servers[st[1]].release(st[2])
            log.append(("r", None if a is None else
                        (a.job_id, a.gpus, a.cpus, a.mem)))
        else:
            cl.release_job(st[1])
        log.append((cl.free_gpus, cl.free_cpus, cl.free_mem,
                    [(s.free_gpus, s.free_cpus, s.free_mem)
                     for s in cl.servers],
                    cl.utilization(), list(cl.running_job_ids()),
                    [(jid, cl.job_totals(jid),
                      [(sid, a.gpus, a.cpus, a.mem)
                       for sid, a in cl.placement_of(jid)])
                     for jid in (3, 7, 8, 9)]))
    cl.release_all()
    log.append((cl.free_gpus, cl.free_cpus, cl.free_mem))
    return log


def test_cluster_bookkeeping_matches():
    got = _cluster_script(P_cluster)
    assert got == _cluster_script(J_cluster)
    assert ("a", False, True) in got          # the over-fit raised
    # the paper's server: 8 GPUs, 24 CPUs, 500 GB
    spec = P_cluster.ServerSpec()
    assert (spec.gpus, spec.cpus, spec.mem) == (8, 24.0, 500.0)
    assert P_cluster.Cluster(2).proportional_demand(1) == (3.0, 62.5)


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------
def test_every_policy_orders_like_the_reference():
    jobs = {side: _profiled(side, 16, (30, 50, 20), seed=1)
            for side in SIDES}
    for side, js in jobs.items():
        for k, j in enumerate(js):
            j.attained_service = float((k * 37) % 11) * 100.0
            j.remaining = j.duration * (0.2 + 0.05 * ((k * 7) % 9))
            j.arrival_time = float((k * 13) % 5) * 60.0
    for name in POLICIES:
        orders = {}
        for side, js in jobs.items():
            cl = SIDES[side][2].Cluster(4)
            pol = SIDES[side][4].get_policy(name, cl)
            assert pol.name == name
            orders[side] = [j.job_id for j in pol.order(js, 900.0)]
        assert orders["port"] == orders["jax"], name
    js = jobs["port"]
    fifo = P_pol.get_policy("fifo").order(js, 0)
    assert [j.arrival_time for j in fifo] == sorted(j.arrival_time for j in js)
    srtf = P_pol.get_policy("srtf").order(js, 0)
    assert [j.remaining for j in srtf] == sorted(j.remaining for j in js)
    las = P_pol.get_policy("las").order(js, 0)
    assert [j.attained_service for j in las] == sorted(
        j.attained_service for j in js)
    assert set(P_pol.POLICIES) == set(J_pol.POLICIES)
    with pytest.raises(ValueError):
        P_pol.get_policy("drf")


# ---------------------------------------------------------------------------
# the allocators
# ---------------------------------------------------------------------------
QUEUES = [((20, 70, 10), 0, 2, 40), ((50, 0, 50), 3, 4, 40),
          ((80, 10, 10), 5, 4, 24), ((100, 0, 0), 11, 2, 30),
          ((33, 33, 34), 7, 8, 60)]


@pytest.mark.parametrize("name", ALLOCATORS)
def test_allocator_round_plans_match(name):
    for split, seed, n_servers, n in QUEUES:
        res = {}
        for side in SIDES:
            jobs = _profiled(side, n, split, seed)
            cl = SIDES[side][2].Cluster(n_servers)
            alloc = SIDES[side][3].get_allocator(name)
            plan = alloc.schedule(cl, SIDES[side][4].get_policy(
                "fifo").order(jobs, 0))
            res[side] = (plan.scheduled, plan.skipped, plan.demoted,
                         _placements(cl), [_job_state(j) for j in jobs],
                         [plan.rate_of(j) for j in jobs])
            _check_capacity(cl)                                 # I1
            if side == "port" and name in ("tune", "tune_split"):
                for j in jobs:
                    placement = cl.placement_of(j.job_id)
                    if j.job_id in plan.scheduled and name == "tune":
                        assert j.current_rate >= j.prop_rate - 1e-9  # I2
                    if len(placement) > 1:                       # I4
                        g, c, m = cl.job_totals(j.job_id)
                        for _, a in placement:
                            assert a.cpus == pytest.approx(c * a.gpus / g)
                            assert a.mem == pytest.approx(m * a.gpus / g)
                if cl.free_gpus > 0:                             # I3
                    assert not [jid for jid in plan.skipped if next(
                        x for x in jobs if x.job_id == jid).gpu_demand
                        <= cl.free_gpus]
        assert res["port"] == res["jax"], (name, split, seed)


def test_try_place_and_helpers_match():
    for seed in range(4):
        out = {}
        for side in SIDES:
            mod = SIDES[side][3]
            jobs = _profiled(side, 30, (40, 40, 20), seed)
            cl = SIDES[side][2].Cluster(3)
            log = []
            for j in jobs:
                c, m = ((j.demand_cpu, j.demand_mem) if j.job_id % 2
                        else cl.proportional_demand(j.gpu_demand))
                s = mod._best_fit_single(cl, j.gpu_demand, c, m)
                chosen = mod._min_server_set(cl, j.gpu_demand,
                                             by_gpu_only=bool(j.job_id % 3),
                                             c=c, m=m)
                log.append((None if s is None else s.sid,
                            None if chosen is None else
                            [(s2.sid, g) for s2, g in chosen],
                            mod._split_proportional(j.gpu_demand, c, m,
                                                    [1] * j.gpu_demand),
                            mod.try_place(cl, j, c, m), _placements(cl)))
            out[side] = log
        assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the optimistic profiler
# ---------------------------------------------------------------------------
def _noisy(side, model, gpus, m_max, seed):
    rng = np.random.default_rng(seed)
    sens = P_sens if side == "port" else J_sens

    def measure(c):
        return sens.throughput(model, gpus, c, m_max) * (
            1.0 + 0.05 * rng.standard_normal())
    return measure


def test_optimistic_profiler_matches():
    for k, name in enumerate(P_sens.MODEL_ZOO):
        for gpus in (1, 2, 8, 16):
            for noisy in (False, True):
                out = {}
                for side in SIDES:
                    prof_mod = SIDES[side][1]
                    sens = P_sens if side == "port" else J_sens
                    model = sens.MODEL_ZOO[name]
                    p = prof_mod.OptimisticProfiler()
                    cpu_pts, mem_pts = p.cpu_grid(gpus), p.mem_grid(gpus)
                    measure = (_noisy(side, model, gpus, float(mem_pts[-1]),
                                      k * 100 + gpus) if noisy else None)
                    mat = p.profile(model, gpus, measure)
                    probed = p.probe_cpu_curve(
                        lambda c: sens.throughput(model, gpus, c, 500.0),
                        cpu_pts)
                    job_mod = Job if side == "port" else JaxJob
                    job = job_mod(k, name, gpus, 0.0, 3600.0)
                    p.profile_job(job, _noisy(side, model, gpus,
                                              float(mem_pts[-1]), k)
                                  if noisy else None)
                    out[side] = (cpu_pts.tolist(), mem_pts.tolist(),
                                 _matrix(mat), list(probed.items()),
                                 _matrix(job.matrix), _job_state(job))
                assert out["port"] == out["jax"], (name, gpus, noisy)
    # the reference's invariant: probe + analytic fill ~= exhaustive truth
    prof = P_prof.OptimisticProfiler()
    for model in P_sens.MODEL_ZOO.values():
        est = prof.profile(model, gpus=1)
        truth = P_sens.full_matrix(model, 1, est.cpu_points, est.mem_points,
                                   min_mem_gb=prof.cfg.min_mem_gb)
        nz = truth.W > 0
        rel = np.abs(est.W[nz] - truth.W[nz]) / truth.W[nz]
        assert rel.max() < 0.12
        assert est.profile_probes <= math.ceil(math.log2(24)) + 2


def test_profiler_config_and_grids_match():
    for cfg_kw in ({}, {"mem_unit_gb": 1.0, "min_mem_gb": 0.0},
                   {"improvement_threshold": 0.05, "knee": 0.9}):
        for spec_kw in ({}, {"gpus": 2, "cpus": 6.0, "mem": 4.0}):
            out = {}
            for side in SIDES:
                prof_mod, cl_mod = SIDES[side][1], SIDES[side][2]
                p = prof_mod.OptimisticProfiler(
                    cl_mod.ServerSpec(**spec_kw),
                    prof_mod.ProfilerConfig(**cfg_kw))
                out[side] = [(p.cpu_grid(g).tolist(), p.mem_grid(g).tolist())
                             for g in (1, 2, 3, 8, 9, 16)]
            assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# Synergy-OPT
# ---------------------------------------------------------------------------
def _runnable(side, n, split, seed, n_servers):
    jobs = _profiled(side, n, split, seed)
    cl = SIDES[side][2].Cluster(n_servers)
    runnable, free = [], cl.total_gpus
    for j in SIDES[side][4].get_policy("fifo").order(jobs, 0):
        if j.gpu_demand <= free:
            runnable.append(j)
            free -= j.gpu_demand
    return runnable, cl


def _opt_result(r):
    return (r.alloc, r.throughput, r.fair_throughput, r.is_integral,
            r.placement, r.fragmented_jobs, r.status)


@pytest.mark.parametrize("seed,n,n_servers", [(0, 16, 2), (5, 24, 2),
                                              (3, 30, 4)])
def test_opt_solves_match(seed, n, n_servers):
    out = {}
    for side, opt in (("jax", J_opt), ("port", P_opt)):
        jobs, cl = _runnable(side, n, (30, 50, 20), seed, n_servers)
        pareto = [opt.pareto_options(j) for j in jobs]
        ilp = opt.solve_ideal(jobs, cl, integer=True, time_limit=20.0)
        lp = opt.solve_ideal(jobs, cl, integer=False, time_limit=20.0)
        placement = opt.solve_placement(jobs, cl, ilp.alloc)[:2]
        both = opt.solve(jobs, cl, integer=True, with_placement=True,
                         time_limit=20.0)
        out[side] = (pareto, _opt_result(ilp), _opt_result(lp), placement,
                     _opt_result(both))
        if side == "port":
            assert lp.throughput >= ilp.throughput - 1e-6          # I5
            assert ilp.throughput >= ilp.fair_throughput - 1e-6
            P_alloc.get_allocator("tune").schedule(
                P_cluster.Cluster(n_servers), jobs)
            assert ilp.throughput >= sum(j.current_rate for j in jobs) - 1e-6
            assert both.fragmented_jobs <= 3 * n_servers            # I6
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# whole simulations
# ---------------------------------------------------------------------------
#: tests/test_scheduler.py:163's trace at split (20, 70, 10), cut to 30 jobs
SIM_TRACE = dict(n_jobs=30, split=(20, 70, 10), arrival="poisson",
                 jobs_per_hour=6.0, seed=9)
SIM_CASES = [(a, p) for a in ALLOCATORS for p in POLICIES] + [
    ("opt", "fifo"), ("opt", "srtf")]


def _sim(side, allocator, policy, **kw):
    trace = SIDES[side][0]
    sim = J_sim if side == "jax" else P_sim
    res = sim.simulate(4, trace.generate(trace.TraceConfig(**SIM_TRACE)),
                       policy=policy, allocator=allocator, **kw)
    return res, (res.avg_jct, res.p99_jct, res.makespan, res.rounds,
                 res.util_samples, res.util_times, res.queue_len_samples,
                 [(j.job_id, j.start_time, j.finish_time, j.n_preemptions,
                   j.attained_service) for j in res.jobs])


@pytest.mark.parametrize("allocator,policy", SIM_CASES)
def test_simulation_matches(allocator, policy):
    res, got = _sim("port", allocator, policy)
    assert got == _sim("jax", allocator, policy)[1]
    assert all(j.finish_time is not None for j in res.jobs)
    for j in res.jobs:
        assert j.jct() >= j.duration * 0.2


def test_simulation_profile_overhead_matches():
    res, got = _sim("port", "tune", "srtf", include_profile_overhead=True)
    assert got == _sim("jax", "tune", "srtf",
                       include_profile_overhead=True)[1]
    for j in res.jobs:
        assert j.profile_overhead_s == j.matrix.profile_seconds > 0
        assert j.start_time is None or (
            j.start_time >= j.arrival_time + j.profile_overhead_s - 1e-6)
    # the steady-state window and the monitored slice
    res, got = _sim("port", "tune", "fifo", steady_skip=5, steady_count=10)
    assert got == _sim("jax", "tune", "fifo", steady_skip=5,
                       steady_count=10)[1]
    assert [j.job_id for j in res.monitored(5, 10)] == [
        j.job_id for j in _sim("jax", "tune", "fifo")[0].monitored(5, 10)]


def test_simulation_tune_never_worse():
    """The reference's end-to-end bound on the port: TUNE's avg JCT within
    3% of proportional's and its makespan within 5%."""
    jobs = P_trace.generate(P_trace.TraceConfig(
        n_jobs=60, split=(50, 0, 50), arrival="poisson", jobs_per_hour=6.0,
        seed=9))
    prop = P_sim.simulate(4, copy.deepcopy(jobs), allocator="proportional")
    tune = P_sim.simulate(4, copy.deepcopy(jobs), allocator="tune")
    assert tune.avg_jct <= prop.avg_jct * 1.03
    assert tune.makespan <= prop.makespan * 1.05
