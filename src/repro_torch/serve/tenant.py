"""Synergy-on-serve: SLO-aware multi-tenant resource allocation (a port of
``repro/serve/tenant.py``; every host-side result equals the reference's).

The paper's loop — optimistic profiling, per-resource sensitivity curves,
near-optimal online allocation — applied to the serving engine's scarce
resources instead of a training cluster's CPUs and memory:

    training (core/)                 serving (this module)
    ----------------                 ---------------------
    CPU cores per job                KV cache units (blocks / slots)
    DRAM cache GB per job            prefill lanes
    W_j[c, m] sensitivity matrix     W_t[units, K] per request class
    optimistic profiling (§3.1)      2 empirical probes + analytic model
    Synergy-Greedy / OPT (§4)        ``TenantAllocator`` (greedy knees)
    GPU-proportional fairness floor  weight-proportional unit floor

A ``Tenant`` carries an identity, a weight and a latency SLO (in decode
steps and/or wall seconds); ``ServeRequest.tenant`` tags every request and
the ``TenantRegistry`` computes its *SLO slack*, the engine's scheduling
currency:

    slack(r, now) = (arrival + slo_steps) - (now + tokens still owed)

It orders admission (``SLOSlack``), picks the preemption victim (largest
slack first) and shortens the decode horizon toward the smallest waiting
slack (``ServeEngine._pick_h``).

The optimistic serve profiler builds each request class's sensitivity as a
``core.sensitivity.SensitivityMatrix`` over cache units x decode horizon K
from the model

    n(U)       = min(concurrency, U // units_per_req)   admissible rows
    rate(U, K) = n * K / (t_fixed + n * K * t_tok)      tokens / second

calibrated from two probes of the real engine (K=1 and K=K_max) or from
caller constants. ``TenantAllocator.plan`` turns the matrices into budgets
with ``core.opt.greedy_allocate``: the weight-proportional share is each
tenant's floor, knees cap what a tenant can use, and the watermark reserve
is split by marginal growth sensitivity. The resulting ``TenantAllocation``
drives admission budgets, per-tenant watermark headroom, prefill-lane
shares and per-tenant horizon caps. None of it touches a request's
computation, so greedy outputs stay token-identical to the single-tenant
engine.

What the port does not hold exactly: a probe-calibrated profile
(``profile_class(probe=...)``) measures the real engine on its own clock,
and ``profile_seconds`` and the ``slo_s`` wall-clock target are wall time.
The analytic, caller-constant and store-measured profiles (for the same
store records), and everything on the step clock, equal the reference's.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.opt import greedy_allocate
from repro_torch.core.policies import Policy
from repro_torch.core.sensitivity import SensitivityMatrix


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Tenant:
    """One tenant: identity, scheduling weight, and latency SLOs.

    ``slo_steps`` is the latency target in decode steps (the engine's
    deterministic clock — drives slack ordering, preemption, and the
    horizon choice); ``slo_s`` is the wall-clock target (seconds — only
    scored in the stats, never scheduled on: wall time is machine-speed
    dependent). Either may be None (no target on that clock).
    """
    tenant_id: str
    weight: float = 1.0
    slo_steps: Optional[float] = None
    slo_s: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.tenant_id!r}: weight must be > 0")


class TenantRegistry:
    """Tenant lookup + the slack arithmetic every mechanism shares."""

    def __init__(self, tenants: Sequence[Tenant] = ()):
        self._tenants: Dict[str, Tenant] = {}
        for t in tenants:
            self.register(t)

    def register(self, tenant: Tenant) -> Tenant:
        if tenant.tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant.tenant_id!r} already registered")
        self._tenants[tenant.tenant_id] = tenant
        return tenant

    def get(self, tenant_id: str) -> Optional[Tenant]:
        return self._tenants.get(tenant_id)

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def __iter__(self):
        return iter(self._tenants.values())

    def __len__(self) -> int:
        return len(self._tenants)

    @property
    def ids(self) -> List[str]:
        return sorted(self._tenants)

    def slack(self, req, now: float) -> float:
        """SLO slack of ``req`` at engine step ``now``, in decode steps.

        Deadline minus projected finish: a request still owes
        ``max_new_tokens - len(output)`` tokens (~1 per step once
        running). Requests of tenants without a step SLO have infinite
        slack — they order last and preempt first.
        """
        t = self.get(getattr(req, "tenant", None))
        if t is None or t.slo_steps is None:
            return math.inf
        owed = req.max_new_tokens - len(req.output)
        return (req.arrival_time + t.slo_steps) - (now + owed)


class SLOSlack(Policy):
    """Queue ordering by SLO slack, smallest (most urgent) first.

    A serve-side policy in the ``core.policies`` mold: it only ORDERS the
    ready queue (``Policy.order`` tie-breaks on arrival then id); the
    allocator decides amounts — the same policy/mechanism separation the
    paper draws for training jobs.
    """
    name = "slo"

    def __init__(self, registry: TenantRegistry):
        self.registry = registry

    def priority(self, req, now: float) -> float:
        return self.registry.slack(req, now)


# ---------------------------------------------------------------------------
# optimistic serve profiler
# ---------------------------------------------------------------------------
def serve_rate(units: float, k: float, *, units_per_req: int,
               concurrency: int, t_tok: float, t_fixed: float) -> float:
    """Steady-state decode tokens/s of one request class at a cache-unit
    budget and decode horizon (the analytic model the probes calibrate)."""
    if units_per_req <= 0:
        raise ValueError("units_per_req must be >= 1")
    n = min(concurrency, int(units) // units_per_req)
    if n <= 0 or k < 1:
        return 0.0
    return n * k / (t_fixed + n * k * t_tok)


def calibrate(rate_k1: float, rate_kmax: float, n_rows: int,
              k_max: int) -> tuple:
    """(t_tok, t_fixed) from the two edge probes.

    Inverting rate = n·K / (t_fixed + n·K·t_tok):
        1/rate = t_fixed / (n·K) + t_tok
    so two probes at K=1 and K=k_max solve both constants.
    """
    if k_max <= 1:
        raise ValueError("calibration needs k_max > 1")
    if rate_k1 <= 0 or rate_kmax <= 0:
        raise ValueError("probe rates must be positive")
    t_fixed = max(0.0, n_rows * (1.0 / rate_k1 - 1.0 / rate_kmax)
                  * k_max / (k_max - 1))
    t_tok = max(1e-9, 1.0 / rate_k1 - t_fixed / n_rows)
    return t_tok, t_fixed


@dataclass
class ServeClassProfile:
    """One request class's calibrated sensitivity to its serve resources.

    ``matrix`` is a ``core.sensitivity.SensitivityMatrix`` with cache
    units (KV blocks, or slots for the contiguous pool) on the CPU axis
    and decode-horizon K on the memory axis; ``lane_curve`` is the 1-D
    prefill-lane sensitivity (prompts per chunk-round saturates at the
    class's offered concurrency).
    """
    tenant_id: str
    units_per_req: int            # cache units one request needs
    concurrency: int              # offered concurrent requests
    t_tok: float                  # seconds per decode token per row
    t_fixed: float                # per-dispatch overhead seconds
    matrix: SensitivityMatrix = field(repr=False)
    source: str = "analytic"      # where (t_tok, t_fixed) came from:
                                  # "analytic" | "measured" | "probed"

    def lane_curve(self) -> Callable[[float], float]:
        """Prefill-lane sensitivity: a class can fill at most
        ``concurrency`` lanes per chunk-round — flat beyond that knee."""
        return lambda p: float(min(p, self.concurrency))


def profile_class(tenant_id: str, *, units_per_req: int, concurrency: int,
                  total_units: int, max_k: int = 8,
                  t_tok: float = 2e-3, t_fixed: float = 6e-3,
                  probe: Optional[Callable[[int], float]] = None,
                  store=None, arch: Optional[str] = None,
                  backend: Optional[str] = None) -> ServeClassProfile:
    """Build one class's sensitivity profile, optimistically.

    ``probe(k) -> tokens/s`` measures the REAL engine at full allocation
    with horizon ``k``; two calls (k=1 and k=max_k) calibrate the analytic
    model that fills the whole [units x K] grid — |units|·|K| runs of
    exhaustive profiling collapse to 2, the §3.1 trick. Without a probe
    the caller-supplied constants are used directly (cheap CLI default;
    units-axis knees are exact either way because the units axis is pure
    admission arithmetic).

    ``store`` (an ``obs.ProfileStore``, with ``arch`` naming the model and
    ``backend`` the cache kind) closes the measurement loop: when the
    store's decode records for (arch, backend) support a rate fit, the
    measured (t_tok, t_fixed) replace the analytic defaults. A probe still
    wins (it measured this workload), and a store without a usable fit
    falls back to the analytic constants.
    """
    units_per_req = max(int(units_per_req), 1)
    concurrency = max(int(concurrency), 1)
    probes, probe_s = 0, 0.0
    source = "analytic"
    if probe is not None:
        t0 = time.perf_counter()
        r1 = probe(1)
        rk = probe(max_k)
        probe_s = time.perf_counter() - t0
        probes = 2
        n_rows = min(concurrency, total_units // units_per_req)
        t_tok, t_fixed = calibrate(r1, rk, max(n_rows, 1), max_k)
        source = "probed"
    elif store is not None and arch is not None:
        fit = store.rate_fit(arch, backend)
        if fit is not None:
            t_tok, t_fixed = fit
            source = "measured"

    # unit grid: one requests's footprint up to the pool, plus the pool
    # itself so the proportional floor always lands on the grid.
    unit_points = sorted({min(u, total_units) for u in
                          [units_per_req * i
                           for i in range(1, concurrency + 1)]
                          } | {total_units})
    k_points = [k for k in (1, 2, 4, 8, 16, 32) if k <= max_k] or [1]
    if k_points[-1] != max_k:
        k_points.append(max_k)
    W = np.zeros((len(unit_points), len(k_points)))
    for ui, u in enumerate(unit_points):
        for ki, k in enumerate(k_points):
            W[ui, ki] = serve_rate(u, k, units_per_req=units_per_req,
                                   concurrency=concurrency, t_tok=t_tok,
                                   t_fixed=t_fixed)
    matrix = SensitivityMatrix(np.asarray(unit_points, float),
                               np.asarray(k_points, float), W, gpus=1,
                               profile_probes=probes,
                               profile_seconds=probe_s)
    return ServeClassProfile(tenant_id=tenant_id,
                             units_per_req=units_per_req,
                             concurrency=concurrency, t_tok=t_tok,
                             t_fixed=t_fixed, matrix=matrix, source=source)


def profiles_from_requests(registry: TenantRegistry, requests, *,
                           total_units: int, units_for=None, max_k: int = 8,
                           t_tok: float = 2e-3, t_fixed: float = 6e-3,
                           probe=None, store=None,
                           arch: Optional[str] = None,
                           backend: Optional[str] = None,
                           ) -> Dict[str, ServeClassProfile]:
    """One profile per tenant, its class shape read off its request mix.

    ``units_for(req) -> int`` maps a request to its cache-unit footprint
    (paged: ``blocks_for(prompt + max_new)``; contiguous: 1 slot).
    ``probe(tenant_id, k) -> tokens/s`` optionally runs the real engine.
    ``store``/``arch``/``backend`` feed measured rate constants from an
    ``obs.ProfileStore`` when no probe is given (see ``profile_class``).
    """
    if units_for is None:
        units_for = lambda r: 1
    profiles = {}
    for t in registry:
        rs = [r for r in requests if r.tenant == t.tenant_id]
        if not rs:
            continue
        upr = max(1, int(round(float(np.mean([units_for(r) for r in rs])))))
        profiles[t.tenant_id] = profile_class(
            t.tenant_id, units_per_req=upr, concurrency=len(rs),
            total_units=total_units, max_k=max_k, t_tok=t_tok,
            t_fixed=t_fixed,
            probe=(lambda k, tid=t.tenant_id: probe(tid, k)) if probe
            else None, store=store, arch=arch, backend=backend)
    return profiles


# ---------------------------------------------------------------------------
# the online allocator
# ---------------------------------------------------------------------------
@dataclass
class TenantShare:
    """One tenant's allocated serve resources."""
    tenant_id: str
    units: int                    # cache-unit budget (blocks / slots)
    k_cap: int                    # horizon knee at this unit budget
    lanes: int                    # prefill-lane share under contention
    headroom: int                 # watermark reserve blocks owned
    knee_rate: float = 0.0        # modeled tokens/s at the budget


@dataclass
class TenantAllocation:
    """Per-tenant budgets the engine enforces online.

    Budgets are allocation guidance, not hard partitions: a tenant's
    FIRST request always admits (no deadlock on an undersized budget),
    and units left on the table by one tenant are usable by others once
    their budgets are exhausted only via preemption pressure — the same
    work-conserving discipline as Synergy's cluster allocations.
    """
    shares: Dict[str, TenantShare]
    total_units: int
    max_k: int
    #: arithmetic of the most recent ``admissible`` check (held / need /
    #: budget), what a ``budget_skip`` trace event reports
    last_decision: Optional[Dict[str, int]] = None

    def share(self, tenant_id: str) -> Optional[TenantShare]:
        return self.shares.get(tenant_id)

    def footprint(self, req, pool) -> int:
        """One request's FULL eventual cache-unit footprint — prompt plus
        generation budget, the same unit the profiler's ``units_per_req``
        measures (paged: blocks; contiguous: one slot)."""
        return (pool.blocks_for(len(req.prompt) + req.max_new_tokens)
                if hasattr(pool, "blocks_for") else 1)

    def units_used(self, tenant_id: str, active, pool) -> int:
        """Cache units the tenant's active requests have COMMITTED: each
        one's full eventual footprint, not just the blocks it owns right
        now — admission reserves decode-growth room, so a budget binds
        when the tenant floods the pool, not only after it has grown."""
        return sum(self.footprint(r, pool)
                   for r in active.values() if r.tenant == tenant_id)

    def admissible(self, req, active, pool) -> bool:
        """Budget check at admission: the request's footprint fits the
        tenant's unit budget. A tenant with nothing active always passes
        (budgets guide, they must never starve).

        ``last_decision`` keeps the arithmetic of the MOST RECENT check —
        (units held, request footprint, budget) — so a ``budget_skip``
        trace event can say why a request was skipped."""
        share = self.shares.get(req.tenant)
        if share is None:
            self.last_decision = None
            return True
        used = self.units_used(req.tenant, active, pool)
        need = self.footprint(req, pool)
        self.last_decision = {"held": used, "need": need,
                              "budget": share.units}
        if used == 0:
            return True
        return used + need <= share.units

    def reserves(self) -> Dict[str, int]:
        """Per-tenant watermark headroom (blocks) — installed on the
        ``BlockManager`` so a tenant admitting only has to keep the OTHER
        tenants' headroom free."""
        return {tid: s.headroom for tid, s in self.shares.items()}

    def rescaled_reserves(self, new_total: int) -> Dict[str, int]:
        """Headroom re-fit to a pool whose capacity changed mid-run (a
        ``pool_shrink``/``pool_restore`` fault or an elastic reshape): each
        tenant's reserve scales by ``new_total / total_units`` with
        largest-remainder rounding, so the proportions the allocator
        planned survive the shrink and the summed reserve never exceeds
        the scaled original — reserves pinned to the old capacity would
        deadlock admission on a pool that no longer has that many blocks.

        Ties in the rounding remainder break on the tenant id, so the
        result is a pure function of (shares, new_total) — reshapes replay
        deterministically regardless of dict insertion order. As a final
        backstop the summed reserve is clamped to the new capacity
        (trimming the largest reserves first): a hand-built allocation
        whose headroom exceeds the pool must not wedge admission."""
        if self.total_units <= 0:
            return self.reserves()
        frac = max(0.0, min(1.0, new_total / self.total_units))
        raw = {tid: s.headroom * frac for tid, s in self.shares.items()}
        out = {tid: int(v) for tid, v in raw.items()}
        owed = int(round(sum(raw.values()))) - sum(out.values())
        for tid in sorted(raw, key=lambda t: (out[t] - raw[t], t)
                          )[:max(owed, 0)]:
            out[tid] += 1
        over = sum(out.values()) - max(int(new_total), 0)
        while over > 0:
            tid = max(sorted(out), key=lambda t: out[t])
            if out[tid] <= 0:
                break
            out[tid] -= 1
            over -= 1
        return out

    def k_cap_for(self, tenant_ids) -> int:
        """Horizon cap for a boundary whose active rows belong to
        ``tenant_ids``: the LARGEST knee among them (a longer horizon
        cannot hurt a tenant whose curve flattened earlier, and cutting
        to the smallest knee would tax every co-resident tenant)."""
        caps = [self.shares[t].k_cap for t in tenant_ids
                if t in self.shares]
        return max(caps) if caps else self.max_k

    def lane_share(self, tenant_id: str) -> int:
        share = self.shares.get(tenant_id)
        return share.lanes if share is not None else 1


class TenantAllocator:
    """Sensitivity curves -> per-tenant budgets, greedily near-optimal.

    The serve-side Synergy-Greedy: the weight-proportional unit share is
    each tenant's fairness floor (never allocate less *throughput* than
    proportional — §4.2), knees cap useful consumption, and
    ``core.opt.greedy_allocate`` hands out the pool by weighted marginal
    gain, so an insensitive tenant's surplus flows to whoever's curve is
    still climbing.
    """

    def __init__(self, registry: TenantRegistry,
                 profiles: Dict[str, ServeClassProfile]):
        self.registry = registry
        self.profiles = profiles
        missing = [t.tenant_id for t in registry
                   if t.tenant_id not in profiles]
        if missing:
            raise ValueError(f"no serve profile for tenants {missing}")

    def plan(self, total_units: int, *, total_lanes: int = 4,
             max_k: int = 8, watermark_units: int = 0,
             knee: float = 0.95) -> TenantAllocation:
        tenants = sorted(self.registry, key=lambda t: t.tenant_id)
        profs = [self.profiles[t.tenant_id] for t in tenants]
        weights = [t.weight for t in tenants]

        # floors: one request's footprint each (the no-starvation floor);
        # the fairness floor enters through each curve's knee target below.
        floors = [min(p.units_per_req,
                      total_units // max(len(tenants), 1)) for p in profs]
        quantum = max(1, min(p.units_per_req for p in profs))
        curves = [p.matrix.curve(float(max_k)) for p in profs]
        units = greedy_allocate(curves, float(total_units), weights=weights,
                                floors=[float(f) for f in floors],
                                quantum=float(quantum))
        units = [int(u) for u in units]

        # per-tenant horizon knee at the settled budget
        k_caps = [int(p.matrix.best_second_axis(u, knee))
                  for p, u in zip(profs, units)]

        # prefill lanes: same greedy over the 1-D lane curves, everyone
        # keeps at least one lane (lanes are time-shared, not partitioned).
        lane_floor = [1.0] * len(tenants)
        if total_lanes >= len(tenants):
            lanes = greedy_allocate([p.lane_curve() for p in profs],
                                    float(total_lanes), weights=weights,
                                    floors=lane_floor, quantum=1.0)
        else:
            lanes = [1.0] * len(tenants)
        lanes = [max(1, int(l)) for l in lanes]

        # watermark headroom by marginal growth sensitivity at the budget:
        # a tenant whose curve is flat there (insensitive) donates its
        # reserve to tenants still climbing. Fallback to weight when every
        # curve is flat. Largest-remainder rounding keeps the sum exact.
        sens = [max(0.0, c(u + quantum) - c(max(u - quantum, 0)))
                for c, u in zip(curves, units)]
        raw = [w * s for w, s in zip(weights, sens)]
        if sum(raw) <= 0:
            raw = weights[:]
        scale = watermark_units / sum(raw) if sum(raw) else 0.0
        head = [int(r * scale) for r in raw]
        rem = watermark_units - sum(head)
        order = sorted(range(len(raw)),
                       key=lambda i: -(raw[i] * scale - head[i]))
        for i in range(rem):
            head[order[i % len(head)]] += 1

        shares = {}
        for i, t in enumerate(tenants):
            shares[t.tenant_id] = TenantShare(
                tenant_id=t.tenant_id, units=units[i], k_cap=k_caps[i],
                lanes=lanes[i], headroom=head[i],
                knee_rate=float(curves[i](units[i])))
        return TenantAllocation(shares=shares, total_units=total_units,
                                max_k=max_k)


def plan_allocation(registry: TenantRegistry,
                    profiles: Dict[str, ServeClassProfile],
                    total_units: int, **kw) -> TenantAllocation:
    """Convenience: ``TenantAllocator(registry, profiles).plan(...)``."""
    return TenantAllocator(registry, profiles).plan(total_units, **kw)
