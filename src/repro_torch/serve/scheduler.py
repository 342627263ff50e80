"""Continuous-batching scheduler (``repro/serve/scheduler.py:38-268``):
a request queue with admission by free pool capacity and per-boundary
join/evict of finished requests.

Ordering reuses the queue policies (``core.policies``): FCFS is FIFO on
arrival, SJF is SRTF on the work a request still owes, and the engine
passes ``tenant.SLOSlack`` for SLO-slack ordering. The clock is the
engine's decode-step counter. A ``tenant.TenantAllocation`` adds the
per-tenant budget check at admission, and a fault injector's admission
holds (``tenant_slowdown`` / ``defer_storm``) skip the held requests
(``admit(hold=...)``); a request the pool cannot validate yet, but
scheduled capacity will cover, waits in the queue (``park``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.policies import FIFO, SRTF, Policy
from repro_torch.obs.events import NULL_TRACER

SERVE_POLICIES = {"fcfs": FIFO, "sjf": SRTF}


@dataclass(eq=False)                   # identity equality: prompts are arrays
class ServeRequest:
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    job_id: int = 0
    arrival_time: float = 0.0          # engine decode-step clock
    #: tenant tag, resolved against the engine's ``TenantRegistry``
    #: (untagged requests share the "default" tenant)
    tenant: str = "default"
    output: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    #: stopped before its budget (EOS token)
    finished_early: bool = False
    #: times preempted under pool pressure (each bounce regenerates its
    #: tokens identically after re-admission)
    n_preempted: int = 0
    # -- fault recovery (serve/chaos.py; idle without an injector) ---------
    #: admission retries burned while a shrunken pool could not hold the
    #: request, and the step the next retry is due at
    n_retries: int = 0
    next_retry: float = 0.0
    #: a recovery path gave up on the request: counted in ``dropped``,
    #: not ``unfinished``, and left out of slo_attainment
    dropped: bool = False
    drop_cause: Optional[str] = None
    # wall clocks: t_arrived is stamped when the engine clock first passes
    # arrival_time (not at admission), so latency_s includes queue wait.
    t_arrived: Optional[float] = None
    t_admitted: Optional[float] = None
    t_finished: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finished_early or len(self.output) >= self.max_new_tokens

    @property
    def remaining(self) -> float:
        """Work still owed (SJF key): prompt prefill + tokens left."""
        return float(len(self.prompt) + self.max_new_tokens - len(self.output))

    @property
    def latency_steps(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival_time

    @property
    def latency_s(self) -> Optional[float]:
        """Wall seconds from becoming admissible to finishing (incl. queue)."""
        if self.t_finished is None or self.t_arrived is None:
            return None
        return self.t_finished - self.t_arrived


class ContinuousScheduler:
    """Admission + eviction over a pool — a contiguous ``CachePool``
    (admission by free slot) or a paged ``BlockManager`` (admission by
    free blocks) — ordered by a queue policy (a registered name or a
    ``Policy`` instance). ``allocation`` (a ``tenant.TenantAllocation``)
    skips a request over its tenant's cache-unit budget without blocking
    the requests behind it. ``tracer`` (an ``obs.Tracer``) records every
    admission decision (admit / budget_skip / defer / preempt); the
    default ``NULL_TRACER`` is falsy, so tracing off costs one branch per
    decision."""

    def __init__(self, pool, policy="fcfs", allocation=None,
                 tracer=NULL_TRACER):
        if isinstance(policy, Policy):
            self.policy: Policy = policy
        elif policy in SERVE_POLICIES:
            self.policy = SERVE_POLICIES[policy]()
        else:
            raise KeyError(f"unknown serve policy {policy!r}; "
                           f"known: {sorted(SERVE_POLICIES)}")
        self.pool = pool
        self.allocation = allocation
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.n_preempted = 0
        self.waiting: List[ServeRequest] = []
        self.active: Dict[int, ServeRequest] = {}
        #: admitted-but-not-yet-prefilled requests, drained into the
        #: engine's prefill lanes
        self.prefill_queue: deque = deque()
        self.step: int = 0

    def submit(self, req: ServeRequest) -> None:
        if hasattr(self.pool, "validate_request"):
            self.pool.validate_request(req)      # paged: blocks + table span
        elif len(req.prompt) + req.max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"request needs {len(req.prompt) + req.max_new_tokens} cache "
                f"positions but the pool holds {self.pool.max_len}")
        self.waiting.append(req)

    def park(self, req: ServeRequest) -> None:
        """Queue a request the current pool cannot validate but scheduled
        capacity (a pending restore or join, elastic scale-up headroom)
        will cover: it waits for the engine's bounded-retry admission.
        ``admit`` re-checks capacity every round, so a parked request
        only waits."""
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.waiting), default=None)

    def admit(self, hold=None) -> List[ServeRequest]:
        """Admit policy-ordered admissible requests while the pool has room
        (a free slot; paged: also free blocks above the watermark).
        ``hold`` maps a request to a defer cause or None: a held request
        skips this round without blocking the requests behind it, as does
        one over its tenant's budget."""
        ready = [r for r in self.waiting if r.arrival_time <= self.step]
        now = time.perf_counter()
        for r in ready:
            if r.t_arrived is None:
                r.t_arrived = now
        admitted = []
        tr = self.tracer
        for req in self.policy.order(ready, float(self.step)):
            if hold is not None:
                cause = hold(req)
                if cause is not None:
                    if tr:
                        tr.emit("defer", req=req.job_id, tenant=req.tenant,
                                cause=cause)
                    continue
            if (self.allocation is not None
                    and not self.allocation.admissible(req, self.active,
                                                       self.pool)):
                if tr:
                    why = self.allocation.last_decision or {}
                    tr.emit("budget_skip", req=req.job_id, tenant=req.tenant,
                            held=why.get("held"), need=why.get("need"),
                            budget=why.get("budget"))
                continue
            slot = (self.pool.alloc_for(req)
                    if hasattr(self.pool, "alloc_for") else self.pool.alloc())
            if slot is None:
                # a prefix-cache deferral (donor still prefilling) parks
                # only that request; pool exhaustion ends the scan.
                if getattr(self.pool, "deferred_last_alloc", False):
                    if tr:
                        tr.emit("defer", req=req.job_id, tenant=req.tenant,
                                cause="prefix_unready")
                    continue
                break
            req.slot = slot
            req.admitted_at = float(self.step)
            req.t_admitted = time.perf_counter()
            self.active[slot] = req
            self.waiting.remove(req)
            self.prefill_queue.append(req)
            admitted.append(req)
            if tr:
                units = (self.pool.owned_blocks(slot)
                         if hasattr(self.pool, "owned_blocks") else 1)
                tr.emit("admit", req=req.job_id, tenant=req.tenant, slot=slot,
                        prompt_len=len(req.prompt),
                        max_new=req.max_new_tokens,
                        wait_steps=float(self.step) - req.arrival_time,
                        units=units)
        return admitted

    def drain_prefill(self) -> List[ServeRequest]:
        """All admitted requests awaiting prefill (clears the queue)."""
        items = list(self.prefill_queue)
        self.prefill_queue.clear()
        return items

    def preempt(self, req: ServeRequest, cause: str = "pool_pressure") -> None:
        """Return an active request to the queue (``cause``: pool pressure,
        a killed slot, an exhausted pool): its slot and blocks are freed
        and its tokens discarded; greedy decoding regenerates them
        identically after re-admission. ``cause`` names the ``preempt``
        event."""
        if req.slot is None or self.active.get(req.slot) is not req:
            raise ValueError("can only preempt an active request")
        self.n_preempted += 1
        if self.tracer:
            self.tracer.emit("preempt", req=req.job_id, tenant=req.tenant,
                             slot=req.slot, cause=cause,
                             n_preempted=self.n_preempted)
        self.pool.free(req.slot)
        del self.active[req.slot]
        req.slot = None
        req.admitted_at = None
        req.t_admitted = None
        req.output = []
        req.finished_early = False
        req.n_preempted += 1
        self.waiting.append(req)

    def evict_finished(self) -> List[ServeRequest]:
        """Release slots of finished requests."""
        done = [r for r in self.active.values() if r.done]
        for req in done:
            # the engine pre-stamps the exact finishing step of a request
            # that finished inside a decode horizon
            if req.finished_at is None:
                req.finished_at = float(self.step)
            req.t_finished = time.perf_counter()
            self.pool.free(req.slot)
            del self.active[req.slot]
            req.slot = None
        return done
