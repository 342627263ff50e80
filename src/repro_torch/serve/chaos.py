"""Deterministic fault injection for the serve engine (a port of
``repro/serve/chaos.py``: the same schedule and seed give the reference's
faults, victims and burst prompts).

The robustness half of ROADMAP item 5: Synergy's scheduling claims only
matter if the engine survives what multi-tenant clusters actually produce —
Jeon et al.'s Philly analysis (arXiv:1901.05758) shows failures, preemptions
and bursty arrivals dominate cluster behavior, and the gap Gao et al.
(arXiv:2205.11913) names between simulated and deployed schedulers is
exactly fault tolerance. This module provides the injection side; the
recovery paths live in the engine (regenerate-on-loss, retry-with-backoff,
graceful horizon degradation) and the block pool (``BlockManager.shrink`` /
``flush_prefix`` / ``audit``).

Faults are keyed to the engine's *decode-step clock*, not wall time: a
``Fault`` fires at the first horizon boundary whose step is >= its
``step``, and the engine caps horizon length at the next pending fault so
boundaries land promptly. Combined with a seeded RNG for every stochastic
choice (burst prompt content, slot-kill victim selection), a
``FaultSchedule`` replay is fully deterministic — the same schedule against
the same workload produces the same faults and recoveries twice, which lets
chaos runs assert the exactness invariant (greedy outputs token-identical
to a fault-free K=1 reference for every non-dropped request).

Fault taxonomy (``FAULT_KINDS``):

=================  ==========================================================
``pool_shrink``    ``blocks`` KV blocks revoked from the ``BlockManager``
                   mid-run (a co-tenant claims the memory); optionally
                   returned after ``restore_after`` steps.
``slot_kill``      a live slot's device state is declared lost; the engine
                   recovers by preempt-and-regenerate (token-identical).
``tenant_slowdown``  admission of one tenant's requests stalls for
                   ``duration`` steps (a slow/misbehaving tenant).
``arrival_burst``  ``n_requests`` synthetic requests (seeded content)
                   arrive at once on top of the open-loop trace.
``prefix_flush``   every prefix-cache entry is force-evicted; entries still
                   referenced by live requests are *retired* (unhittable,
                   freed when their last holder exits).
``defer_storm``    ALL admission stalls for ``duration`` steps (an
                   admission-control brownout).
``device_fail``    a device leaves the serving mesh: the engine shrinks the
                   block pool by ``blocks`` AND narrows the mesh 'data'
                   bucketing multiple (decode buckets fall back to
                   replicated layouts); optionally undone by an
                   auto-scheduled ``device_join`` after ``restore_after``.
``device_join``    a device (re)joins the mesh: pool capacity returns —
                   growing PAST the original allocation when the join
                   exceeds what a failure revoked (``BlockManager.
                   grow_physical`` migrates live KV blocks into the larger
                   buffers) — and the 'data' bucketing multiple is restored.
=================  ==========================================================

``pool_restore`` is the internal inverse of ``pool_shrink`` (auto-scheduled
by ``restore_after``, or usable directly in a schedule); ``device_join`` is
likewise the inverse ``device_fail`` auto-schedules. ``pending_capacity``
sums the blocks those pending inverses will return — the engine's admission
path holds (rather than drops) requests that fit the pool *plus* that
incoming capacity.
"""
from __future__ import annotations

import bisect
import json
import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

#: the injectable fault kinds (plus the internal pool_restore inverse)
FAULT_KINDS = ("pool_shrink", "slot_kill", "tenant_slowdown",
               "arrival_burst", "prefix_flush", "defer_storm",
               "device_fail", "device_join")
_ALL_KINDS = FAULT_KINDS + ("pool_restore",)

#: fault kinds whose pending application RETURNS pool capacity (the engine
#: holds — instead of drops — requests that fit current + pending blocks)
_CAPACITY_KINDS = ("pool_restore", "device_join")

#: spec-key -> (attribute, parser) for the ``kind@step:key=val`` grammar
_SPEC_KEYS = {
    "blocks": ("blocks", int),
    "slot": ("slot", int),
    "tenant": ("tenant", str),
    "duration": ("duration", float),
    "n": ("n_requests", int),
    "prompt_len": ("prompt_len", int),
    "max_new": ("max_new", int),
    "restore_after": ("restore_after", float),
}


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: a kind, the step-clock key it fires at, and the
    kind-specific magnitude fields (unused fields are ignored)."""
    kind: str
    step: float
    blocks: int = 4                    # pool_shrink / pool_restore
    slot: Optional[int] = None         # slot_kill: None = seeded pick
    tenant: Optional[str] = None       # tenant_slowdown / arrival_burst tag
    duration: float = 8.0              # tenant_slowdown / defer_storm window
    n_requests: int = 4                # arrival_burst size
    prompt_len: int = 12               # arrival_burst prompt cap
    max_new: int = 8                   # arrival_burst generation budget
    restore_after: Optional[float] = None   # pool_shrink: steps until return

    def __post_init__(self):
        if self.kind not in _ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {sorted(_ALL_KINDS)}")
        if self.kind == "tenant_slowdown" and self.tenant is None:
            raise ValueError("tenant_slowdown needs tenant=<id>")

    @classmethod
    def from_spec(cls, spec: str) -> "Fault":
        """Parse one ``kind@step[:key=val[:key=val...]]`` spec, e.g.
        ``pool_shrink@12:blocks=4:restore_after=20`` or ``slot_kill@8``."""
        head, _, tail = spec.strip().partition(":")
        kind, at, step = head.partition("@")
        if not at:
            raise ValueError(f"fault spec {spec!r} needs kind@step")
        kw: dict = {}
        for part in filter(None, tail.split(":")):
            key, eq, val = part.partition("=")
            if not eq or key not in _SPEC_KEYS:
                raise ValueError(f"bad fault spec field {part!r} in {spec!r};"
                                 f" known keys: {sorted(_SPEC_KEYS)}")
            attr, parse = _SPEC_KEYS[key]
            kw[attr] = parse(val)
        return cls(kind=kind.strip(), step=float(step), **kw)


@dataclass
class FaultSchedule:
    """A declarative, seeded list of faults. ``seed`` drives every
    stochastic choice the injector makes, so the schedule fully determines
    the chaos a replay sees."""
    faults: List[Fault] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultSchedule":
        """Comma-separated ``Fault.from_spec`` specs, e.g.
        ``"slot_kill@8,pool_shrink@16:blocks=6,defer_storm@24:duration=4"``."""
        faults = [Fault.from_spec(s) for s in spec.split(",") if s.strip()]
        return cls(faults=faults, seed=seed)

    @classmethod
    def from_json(cls, path: str) -> "FaultSchedule":
        """Load ``{"seed": ..., "faults": [{...}, ...]}`` from a file."""
        with open(path) as f:
            doc = json.load(f)
        return cls(faults=[Fault(**f) for f in doc.get("faults", [])],
                   seed=int(doc.get("seed", 0)))

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [{"kind": f.kind, "step": f.step,
                            "blocks": f.blocks, "slot": f.slot,
                            "tenant": f.tenant, "duration": f.duration,
                            "n_requests": f.n_requests,
                            "prompt_len": f.prompt_len,
                            "max_new": f.max_new,
                            "restore_after": f.restore_after}
                           for f in self.faults]}


class FaultInjector:
    """Seeded, step-clock-keyed fault source the engine polls at horizon
    boundaries.

    The injector owns the *schedule* side of chaos — which fault is due,
    the seeded RNG behind victim picks and burst content, and the
    admission-hold windows ``tenant_slowdown`` / ``defer_storm`` open. The
    engine owns the *application* side (it holds the scheduler, pool and
    device state) and the recovery paths. ``reset()`` re-arms everything
    from (schedule, seed); the engine calls it at the top of every ``run``
    so warm-up double-runs and determinism checks replay identical chaos.
    """

    def __init__(self, schedule: FaultSchedule, seed: Optional[int] = None):
        self.schedule = schedule
        self.seed = schedule.seed if seed is None else int(seed)
        self.vocab_size = 2            # rebound by the engine (bind())
        self.max_len = 64
        self.n_slots = 1
        self.reset()

    def bind(self, *, vocab_size: int, max_len: int, n_slots: int) -> None:
        """Engine geometry for burst generation / victim picks."""
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.n_slots = int(n_slots)

    def reset(self) -> None:
        """Re-arm the schedule and re-seed the RNG (start of every run)."""
        self.rng = np.random.default_rng(self.seed)
        #: pending faults in (step, schedule-order) — stable sort keeps
        #: same-step faults in declaration order
        self._pending: List[Fault] = sorted(
            self.schedule.faults, key=lambda f: f.step)
        self._steps: List[float] = [f.step for f in self._pending]
        #: admission holds: tenant id (None = global) -> hold-until step
        self._holds: Dict[Optional[str], float] = {}
        #: applied-fault log (kind, step), the record two runs must share
        self.injected: List[Tuple[str, float]] = []

    # -- schedule queries (the engine's boundary hooks) ----------------------
    def next_fault_step(self, step: float) -> Optional[float]:
        """The earliest pending fault step strictly after ``step`` (the
        engine caps horizon length here so boundaries land on faults)."""
        for s in self._steps:
            if s > step:
                return s
        return None

    def due(self, step: float) -> List[Fault]:
        """Pop every pending fault with ``fault.step <= step``."""
        i = bisect.bisect_right(self._steps, step)
        out, self._pending = self._pending[:i], self._pending[i:]
        self._steps = self._steps[i:]
        return out

    def defer_restore(self, fault: Fault, applied_step: float,
                      blocks: int) -> None:
        """Schedule the kind-appropriate inverse of an applied capacity
        loss: ``pool_restore`` for a ``pool_shrink``, ``device_join`` for a
        ``device_fail`` (the join must also widen the mesh bucketing, which
        a plain restore does not)."""
        inverse = "device_join" if fault.kind == "device_fail" \
            else "pool_restore"
        restore = replace(fault, kind=inverse, blocks=blocks,
                          step=applied_step + float(fault.restore_after),
                          restore_after=None)
        i = bisect.bisect_right(self._steps, restore.step)
        self._pending.insert(i, restore)
        self._steps.insert(i, restore.step)

    def pending_capacity(self, step: float) -> int:
        """KV blocks that pending ``pool_restore`` / ``device_join`` faults
        strictly after ``step`` will hand back — the capacity an admission
        decision may count on arriving (the hold-don't-drop window)."""
        return sum(f.blocks for f in self._pending
                   if f.step > step and f.kind in _CAPACITY_KINDS)

    # -- admission holds ------------------------------------------------------
    def hold(self, tenant: Optional[str], until: float) -> None:
        """Open (or extend) an admission-hold window; ``tenant=None`` holds
        every tenant (defer_storm)."""
        self._holds[tenant] = max(self._holds.get(tenant, -math.inf), until)

    def has_holds(self, step: float) -> bool:
        self._holds = {t: u for t, u in self._holds.items() if u > step}
        return bool(self._holds)

    def hold_cause(self, req, step: float) -> Optional[str]:
        """Why ``req`` must wait this round (None = admissible): the global
        storm outranks per-tenant slowdowns in the emitted cause."""
        if self._holds.get(None, -math.inf) > step:
            return "defer_storm"
        if self._holds.get(req.tenant, -math.inf) > step:
            return "tenant_slowdown"
        return None

    def release_step(self, step: float) -> Optional[float]:
        """The earliest hold expiry strictly after ``step``."""
        later = [u for u in self._holds.values() if u > step]
        return min(later) if later else None

    # -- seeded choices -------------------------------------------------------
    def pick_slot(self, live_slots: List[int],
                  want: Optional[int] = None) -> Optional[int]:
        """The slot a ``slot_kill`` lands on: the requested slot when it is
        live, else a seeded uniform pick (None when nothing is live)."""
        if not live_slots:
            return None
        if want is not None and want in live_slots:
            return want
        order = sorted(live_slots)
        return order[int(self.rng.integers(len(order)))]

    def burst_requests(self, fault: Fault) -> list:
        """Synthetic requests for an ``arrival_burst``: seeded prompt
        content sized to the bound engine geometry (job ids and arrival
        steps are stamped by the engine at application time)."""
        from repro_torch.serve.scheduler import ServeRequest
        cap = max(1, min(fault.prompt_len, self.max_len - fault.max_new))
        out = []
        for _ in range(max(1, fault.n_requests)):
            n = int(self.rng.integers(max(1, cap // 2), cap + 1))
            toks = self.rng.integers(
                1, max(2, self.vocab_size), size=n).astype(np.int32)
            out.append(ServeRequest(prompt=toks,
                                    max_new_tokens=fault.max_new,
                                    tenant=fault.tenant or "default"))
        return out
