"""Multi-tenant serving on the port (``repro_torch.serve.tenant``,
``core.opt``, ``core.sensitivity``) against the JAX package, on the CPU.

Host-side results are held exactly: ``greedy_allocate`` on knee and step
curves, the rate model and its calibration, each class's sensitivity
matrix, the allocator's budgets, horizon knees, lane shares and headroom,
``reserves`` / ``rescaled_reserves`` / ``k_cap_for`` / ``lane_share``,
the slack arithmetic, SLO-slack admission with the budget skip, the
stats' SLO accounting. The olmoe paged engine with tenants under all eight
fault kinds gives the JAX engine's tokens, faults, drops, counters and
steps-based per-tenant stats (``_torch_parity``); a mixed-tenant run
equals the untagged static engine token for token; the serve CLI takes
``--tenants`` and verifies.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.serve as J
from repro.configs import get_config as jax_config
from repro.core.opt import greedy_allocate as jax_greedy
from repro.models.api import build_model as jax_build
from repro.serve import tenant as jax_tenant
import repro_torch.serve as P
from repro_torch.configs import get_config
from repro_torch.core.opt import greedy_allocate
from repro_torch.models.api import build_model
from repro_torch.obs import RunObs
from repro_torch.serve import tenant as port_tenant

from _torch_parity import (ALL_KINDS, chaos_kw, chaos_requests, jax_engine,
                           port_engine, record)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _registry(M):
    return M.TenantRegistry([M.Tenant("lat", weight=2.0, slo_steps=12.0),
                             M.Tenant("batch"),
                             M.Tenant("mid", weight=0.5, slo_steps=30.0)])


# ---------------------------------------------------------------------------
# greedy_allocate, the rate model, the profiles
# ---------------------------------------------------------------------------
def _knee(cap, slope=1.0):
    return lambda x: slope * float(min(x, cap))


def _step(unit, n):
    return lambda x: float(min(int(x) // unit, n))


CURVES = {
    "knees": ([_knee(4), _knee(10, 0.5)], 10.0, {}),
    "knees-weighted": ([_knee(6), _knee(6), _knee(3, 2.0)], 11.0,
                       dict(weights=[1.0, 3.0, 0.5])),
    "steps": ([_step(3, 4), _step(2, 2), _knee(1)], 17.0, {}),
    "steps-quantum": ([_step(4, 3), _step(6, 2)], 24.0, dict(quantum=2.0)),
    "flat-remainder": ([lambda x: 0.0, lambda x: 0.0], 5.0,
                       dict(weights=[2.0, 1.0])),
    "floors": ([_knee(2), _step(5, 1)], 12.0, dict(floors=[1.0, 5.0])),
}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_greedy_allocate_like_reference(name):
    curves, total, kw = CURVES[name]
    assert greedy_allocate(curves, total, **kw) == jax_greedy(curves, total,
                                                              **kw)


def test_greedy_allocate_floor_error():
    with pytest.raises(ValueError, match="exceed"):
        greedy_allocate([lambda x: 0.0], 2.0, floors=[3.0])
    assert greedy_allocate([], 4.0) == []


@pytest.mark.parametrize("u,k,upr,conc", [(8, 1, 2, 4), (8, 8, 2, 4),
                                          (3, 4, 2, 4), (0, 2, 1, 1),
                                          (16, 0.5, 3, 5)])
def test_serve_rate_and_calibrate_like_reference(u, k, upr, conc):
    kw = dict(units_per_req=upr, concurrency=conc, t_tok=2e-3, t_fixed=8e-3)
    assert (port_tenant.serve_rate(u, k, **kw)
            == jax_tenant.serve_rate(u, k, **kw))
    r1 = jax_tenant.serve_rate(8, 1, **kw)
    rk = jax_tenant.serve_rate(8, 8, **kw)
    assert port_tenant.calibrate(r1, rk, conc, 8) == jax_tenant.calibrate(
        r1, rk, conc, 8)
    for bad in ((r1, rk, conc, 1), (0.0, rk, conc, 8)):
        with pytest.raises(ValueError):
            port_tenant.calibrate(*bad)


def _matrix(m):
    return (m.cpu_points.tolist(), m.mem_points.tolist(), m.W.tolist(),
            m.gpus, m.profile_probes)


@pytest.mark.parametrize("upr,conc,total,max_k", [(2, 4, 16, 8),
                                                  (1, 2, 10, 8),
                                                  (5, 3, 12, 6),
                                                  (3, 9, 20, 1)])
def test_profile_class_like_reference(upr, conc, total, max_k):
    kw = dict(units_per_req=upr, concurrency=conc, total_units=total,
              max_k=max_k)
    ref = jax_tenant.profile_class("t", **kw)
    port = port_tenant.profile_class("t", **kw)
    assert _matrix(port.matrix) == _matrix(ref.matrix)
    assert (port.t_tok, port.t_fixed, port.source) == (ref.t_tok,
                                                       ref.t_fixed,
                                                       ref.source)
    for u in range(0, total + 2):
        for k in (1, 2, 3, 8):
            assert port.matrix.rate(u, k) == ref.matrix.rate(u, k)
        assert (port.matrix.best_second_axis(u)
                == ref.matrix.best_second_axis(u))
    assert port.matrix.best_demand() == ref.matrix.best_demand()
    assert port.matrix.options() == ref.matrix.options()
    assert port.lane_curve()(conc + 3) == ref.lane_curve()(conc + 3)


def test_profile_store_is_item_9():
    """The store item 9 brought: with a fit the profiles are measured, as
    the reference's are on the same records."""
    from repro.obs import ProfileStore as JStore
    from repro_torch.obs import ProfileStore as PStore
    recs = [{"source": "serve", "arch": "a1", "backend": "paged",
             "phase": "decode", "sig": f"decode/W{w}/K8", "width": w,
             "k": 8, "n": 3, "mean_s": 5e-3 + w * 8 * 3e-4}
            for w in (1, 2, 4)]
    kw = dict(units_per_req=1, concurrency=1, total_units=4, arch="a1",
              backend="paged")
    port = port_tenant.profile_class("t", store=PStore(recs), **kw)
    ref = jax_tenant.profile_class("t", store=JStore(recs), **kw)
    assert port.source == ref.source == "measured"
    assert (port.t_tok, port.t_fixed) == (ref.t_tok, ref.t_fixed)
    assert P.profiles_from_requests(_registry(P), [], total_units=4,
                                    store=PStore(recs)) == {}


# ---------------------------------------------------------------------------
# the allocator and the allocation
# ---------------------------------------------------------------------------
PLANS = {
    "paged": dict(total=24, lanes=4, max_k=8, watermark=3),
    "tight": dict(total=9, lanes=2, max_k=4, watermark=1),
    "slots": dict(total=3, lanes=1, max_k=8, watermark=0),
    "wide": dict(total=64, lanes=8, max_k=16, watermark=6),
}


def _plan(M, plan):
    reg = _registry(M)
    reqs = chaos_requests(M) + [M.ServeRequest(
        np.arange(1, 9, dtype=np.int32), max_new_tokens=20, tenant="mid")]
    profiles = M.profiles_from_requests(
        reg, reqs, total_units=plan["total"], max_k=plan["max_k"],
        units_for=lambda r: -(-(len(r.prompt) + r.max_new_tokens) // 4))
    return profiles, M.plan_allocation(
        reg, profiles, plan["total"], total_lanes=plan["lanes"],
        max_k=plan["max_k"], watermark_units=plan["watermark"])


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_allocation_like_reference(name):
    (jprof, ref), (pprof, port) = (_plan(M, PLANS[name]) for M in (J, P))
    assert sorted(pprof) == sorted(jprof)
    for tid in jprof:
        assert _matrix(pprof[tid].matrix) == _matrix(jprof[tid].matrix)
    assert ({t: s.__dict__ for t, s in port.shares.items()}
            == {t: s.__dict__ for t, s in ref.shares.items()})
    assert (port.total_units, port.max_k) == (ref.total_units, ref.max_k)
    assert port.reserves() == ref.reserves()
    for total in range(0, 2 * PLANS[name]["total"] + 3):
        assert port.rescaled_reserves(total) == ref.rescaled_reserves(total)
    for ids in (set(), {"lat"}, {"batch"}, {"lat", "batch", "mid"},
                {"nobody"}):
        assert port.k_cap_for(ids) == ref.k_cap_for(ids)
    for tid in ("lat", "batch", "mid", "nobody"):
        assert port.lane_share(tid) == ref.lane_share(tid)


def test_allocator_missing_profile_raises():
    with pytest.raises(ValueError, match="no serve profile"):
        P.TenantAllocator(_registry(P), {})


@pytest.mark.parametrize("total", [16, 8, 6, 3, 1, 0])
def test_rescaled_reserves_edge_cases_like_reference(total):
    def alloc(M, heads):
        return M.TenantAllocation(
            shares={t: M.TenantShare(t, units=4, k_cap=4, lanes=1,
                                     headroom=h) for t, h in heads},
            total_units=8, max_k=8)
    for heads in ([("a", 7), ("b", 3)], [("b", 3), ("a", 3), ("c", 3)],
                  [("solo", 5)], [("a", 6), ("z", 0)]):
        assert (alloc(P, heads).rescaled_reserves(total)
                == alloc(J, heads).rescaled_reserves(total))


# ---------------------------------------------------------------------------
# slack, admission, preemption order, stats
# ---------------------------------------------------------------------------
def test_registry_and_slack_like_reference():
    reg, jreg = _registry(P), _registry(J)
    assert reg.ids == jreg.ids == ["batch", "lat", "mid"]
    with pytest.raises(ValueError):
        reg.register(P.Tenant("lat"))
    with pytest.raises(ValueError):
        P.Tenant("bad", weight=0.0)
    for tenant in ("lat", "batch", "mid", "nobody"):
        for out, now in (([], 0.0), ([7, 7], 6.0), ([1] * 5, 30.0)):
            r = P.ServeRequest(np.arange(1, 4, dtype=np.int32),
                               max_new_tokens=5, arrival_time=2.0,
                               tenant=tenant)
            q = J.ServeRequest(np.arange(1, 4, dtype=np.int32),
                               max_new_tokens=5, arrival_time=2.0,
                               tenant=tenant)
            r.output, q.output = list(out), list(out)
            assert reg.slack(r, now) == jreg.slack(q, now)
    r.tenant = "lat"
    assert math.isfinite(reg.slack(r, 6.0))


@pytest.mark.parametrize("policy", ["fcfs", "sjf", "slo"])
def test_admission_with_budgets_like_reference(policy):
    """The same queue through both schedulers over both packages'
    ``BlockManager``s: SLO-slack (or FCFS / SJF) order, the per-tenant
    budget skip that lets later tenants pass, the reserve-aware watermark
    — the same admissions round after round."""
    plan = dict(total=14, lanes=2, max_k=4, watermark=3)
    picks = []
    kw = dict(n_slots=4, max_len=48, block_size=4, n_blocks=14,
              watermark=0.2)
    pools = {J: lambda: J.BlockManager(
        jax_build(jax_config("qwen2-0.5b", smoke=True)), **kw),
             P: lambda: P.BlockManager(
        build_model(get_config("qwen2-0.5b", smoke=True)), device="cpu",
        **kw)}
    for M in (J, P):
        _, alloc = _plan(M, plan)
        pool = pools[M]()
        pool.tenant_reserves = alloc.reserves()
        pol = M.SLOSlack(_registry(M)) if policy == "slo" else policy
        sched = M.ContinuousScheduler(pool, pol, allocation=alloc)
        for i, r in enumerate(chaos_requests(M)):
            r.job_id = i
            sched.submit(r)
        rounds = []
        for step in range(12):
            sched.step = step
            rounds.append([(r.job_id, r.slot) for r in sched.admit()])
            if step % 3 == 2 and sched.active:    # one leaves now and then
                slot = min(sched.active)
                sched.active[slot].output = [1] * 99
                sched.evict_finished()
        picks.append((rounds, pool.tables.tolist(), list(pool._free_blocks)))
    assert picks[1] == picks[0]
    assert sum(len(r) for r in picks[1][0]) >= 4


def test_admissible_budget_and_no_starvation():
    share = P.TenantShare("batch", units=1, k_cap=8, lanes=1, headroom=0)
    alloc = P.TenantAllocation(shares={"batch": share}, total_units=4,
                               max_k=8)
    r1, r2, free = (P.ServeRequest(np.arange(1, 4, dtype=np.int32),
                                   tenant=t) for t in ("batch", "batch",
                                                       "lat"))
    assert alloc.admissible(r1, {}, object())
    assert not alloc.admissible(r2, {0: r1}, object())
    assert alloc.last_decision == {"held": 1, "need": 1, "budget": 1}
    assert alloc.admissible(free, {0: r1}, object())


def _stamped(tenant, steps, wall):
    r = P.ServeRequest(np.arange(1, 5, dtype=np.int32), max_new_tokens=2,
                       tenant=tenant)
    r.output = [1, 2]
    r.finished_at = float(steps)
    r.t_arrived, r.t_finished = 0.0, float(wall)
    return r


def test_stats_slo_accounting():
    """Unfinished requests are SLO misses, dropped ones leave the scored
    set, each clock's target counts, no tags and no registry give no
    per-tenant block (the reference's ``_stats`` rules)."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    reg = P.TenantRegistry([P.Tenant("t", slo_steps=10.0, slo_s=1.0)])
    eng = P.ServeEngine(cfg, max_len=32, tenants=reg, device="cpu")
    c = RunObs()
    c.inc("steps", 20)
    unstamped = _stamped("t", 5, 0.1)
    unstamped.t_finished = None
    dropped = _stamped("t", 5, 0.1)
    dropped.dropped, dropped.drop_cause = True, "pool_shrink"
    reqs = [_stamped("t", 5, 0.1), _stamped("t", 20, 0.1),
            _stamped("t", 5, 5.0), unstamped, dropped]
    st = eng._stats(reqs, c, 2, 1.0)
    assert (st.unfinished, st.dropped) == (1, 1)
    assert st.slo_attainment == pytest.approx(1 / 4)
    t = st.tenants["t"]
    assert (t["n_requests"], t["dropped"], t["unfinished"]) == (5, 1, 1)
    assert t["p50_latency_steps"] == 5.0 and t["slo_steps"] == 10.0
    plain = P.ServeEngine(cfg, max_len=32, device="cpu")
    assert plain._stats([_stamped("default", 3, 0.1)], c, 1, 1.0).tenants \
        is None


def test_engine_validates_tenant_wiring():
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(ValueError, match="slo"):
        P.ServeEngine(cfg, max_len=32, policy="slo", device="cpu")
    alloc = P.TenantAllocation(shares={}, total_units=4, max_k=8)
    with pytest.raises(ValueError, match="TenantRegistry"):
        P.ServeEngine(cfg, max_len=32, allocation=alloc, device="cpu")


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------
def test_olmoe_paged_tenants_under_chaos_match_jax_engine():
    """olmoe's paged engine with two tenants, SLO-slack ordering, an
    allocation, all eight fault kinds and an elastic controller: the JAX
    engine's tokens, injected faults, drops, counters and steps-based
    per-tenant stats; the pool audits clean."""
    spec = ALL_KINDS.format(fail=9, fail_units=4)
    ref = jax_engine("olmoe-1b-7b", **chaos_kw(J, "paged", spec))
    want = record(ref, *ref.run(chaos_requests(J)))
    eng = port_engine("olmoe-1b-7b", **chaos_kw(P, "paged", spec))
    out, st = eng.run(chaos_requests(P))
    got = record(eng, out, st)
    for key in want:
        assert got[key] == want[key], key
    assert set(P.FAULT_KINDS) <= {k for k, _ in got["injected"]}
    assert set(st.tenants) == {"lat", "batch"}
    assert st.migrated_blocks > 0 and st.preemptions >= 1
    eng.pool.audit()


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_mixed_tenant_run_equals_static_engine(cache):
    """Tenant mechanisms reorder who runs when, never what a request
    computes: a mixed-tenant SLO run with a plan gives the untagged static
    engine's tokens."""
    kw = chaos_kw(P, cache, "", elastic=False, k=4)
    kw.pop("injector")
    reqs = chaos_requests(P)
    out, st = port_engine("qwen2-0.5b", **kw).run(reqs)
    static, _ = port_engine("qwen2-0.5b", max_len=48).run(
        [P.ServeRequest(r.prompt.copy(), max_new_tokens=r.max_new_tokens)
         for r in reqs])
    assert [r.output for r in out] == [r.output for r in static]
    assert set(st.tenants) == {"lat", "batch"}


def test_serve_cli_tenants_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--engine", "continuous", "--cache", "paged", "--batch", "6",
         "--slots", "2", "--prompt-len", "12", "--max-new", "6",
         "--max-len", "32", "--block-size", "4", "--tenants", "2",
         "--slo", "16,none", "--tenant-weights", "2,1", "--tenant-mix",
         "2,1", "--policy", "slo", "--arrival-rate", "2", "--elastic",
         "--verify"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["verified"] and rec["policy"] == "slo" and rec["elastic"]
    assert set(rec["tenant_budgets"]) == {"t0", "t1"}
    assert rec["tenants"]["t0"]["n_requests"] == 4
