"""Elastic serving: live pool/mesh reshaping at horizon boundaries (a port
of ``repro/serve/elastic.py``; on one device the mesh multiple ``dmult``
stays 1).

ROADMAP item 4 (the DLRover ScalePlan idiom) applied to this engine: the
capacity a serve run sees is not static — devices fail and rejoin, pools
shrink under co-tenant pressure and grow back — and Synergy's continuous
re-packing argument applies to the *serving* pool exactly as it does to the
training cluster. This module owns the *decision* side of elasticity; the
engine owns application (it holds the scheduler, pool, device state and
sharding) and performs every reshape at a horizon boundary, where device
state is already host-synced and delta-scattered.

A reshape is described by a ``ScalePlan`` — grow or shrink, how many cache
units, why, and (optionally) the new mesh 'data' bucketing multiple — and
plans come from two sources:

  * **reactive**: ``device_fail`` / ``device_join`` faults (serve/chaos.py)
    force a plan at the boundary they fire on. A fail revokes blocks AND
    narrows the bucketing multiple (on a mesh, decode buckets stop being
    data-axis multiples; the port runs on one device, where it is 1 and
    stays 1); a join returns capacity — growing PAST the original
    allocation when needed, in which case ``BlockManager.grow_physical``
    migrates every live KV block into the larger buffers — and restores
    the multiple.
  * **proactive**: ``ElasticController.decide`` reads the run's
    ``obs.MetricsRegistry`` (the occupancy / queue-depth / slack gauges the
    engine samples at exactly these boundaries) and emits a plan when a
    threshold is crossed: occupancy or queue depth high → scale up toward
    ``max_units``; pool idle → scale down toward ``min_units``. A cooldown
    keeps the controller from thrashing against its own reshapes (and
    against chaos recovery, which shares the cooldown clock).

Every reshape preserves the exactness invariant: migration moves state, it
never recomputes it, and admission/bucketing changes are reorder-only — so
non-dropped greedy outputs stay token-identical to the fault-free K=1
single-device reference (``--verify`` holds across any reshape sequence).

``ElasticController.pending_units`` is the admission side's window into
proactive capacity: a request that cannot fit the current pool but fits
``capacity + pending`` is *held* with bounded retry instead of dropped —
the same hold-don't-drop contract ``FaultInjector.pending_capacity`` gives
scheduled restores.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def pool_capacity(pool) -> int:
    """Live cache-unit capacity of either backend: KV blocks for the paged
    ``BlockManager``, live (non-revoked) slots for the contiguous
    ``CachePool``."""
    if hasattr(pool, "n_blocks"):
        return int(pool.n_blocks)
    return int(getattr(pool, "capacity", pool.n_slots))


@dataclass(frozen=True)
class ScalePlan:
    """One reshape decision: direction, magnitude, provenance.

    ``units`` is the capacity delta in cache units (blocks / slots);
    ``dmult`` is the new mesh 'data' bucketing multiple the engine should
    round decode widths to after the reshape (None = unchanged — proactive
    pool-only reshapes never touch the mesh)."""
    kind: str                      # "scale_up" | "scale_down"
    units: int                     # capacity delta, >= 0 (0 = pure mesh
                                   # re-bucket: only ``dmult`` changes)
    reason: str                    # "device_fail" | "device_join" |
                                   # "occupancy" | "queue_depth" | "slack"
    step: float = 0.0              # boundary the decision was made at
    dmult: Optional[int] = None    # new data-axis multiple (None = keep)

    def __post_init__(self):
        if self.kind not in ("scale_up", "scale_down"):
            raise ValueError(f"unknown scale kind {self.kind!r}")
        if self.units < 0:
            raise ValueError("a ScalePlan cannot move negative units")
        if self.units == 0 and self.dmult is None:
            raise ValueError("a ScalePlan must move units or change dmult")


class ElasticController:
    """Threshold-driven proactive scale decisions over the metrics gauges.

    ``decide`` is called once per horizon boundary with the engine's pool
    and live ``MetricsRegistry``; it returns a ``ScalePlan`` or None. The
    thresholds read the gauges the engine already samples there:

      * ``occupancy >= occupancy_hi`` or ``queue_depth >= queue_hi`` or any
        ``slack[tenant] <= slack_lo`` → scale UP by ``step_units`` (capped
        at ``max_units`` total capacity),
      * ``occupancy <= occupancy_lo`` and the queue empty → scale DOWN by
        ``step_units`` (floored at ``min_units``).

    ``max_units`` defaults to the pool's capacity at first sight (proactive
    growth then only *reclaims* revoked capacity); ``min_units`` defaults
    the same way (no proactive shrink unless configured below it). The
    controller is deliberately clock-free: ``cooldown`` is measured on the
    engine's decode-step clock, so decisions replay deterministically.
    """

    def __init__(self, *, occupancy_hi: float = 0.92,
                 occupancy_lo: float = 0.15, queue_hi: int = 6,
                 slack_lo: float = 0.0, step_units: int = 8,
                 max_units: Optional[int] = None,
                 min_units: Optional[int] = None, cooldown: float = 16.0):
        if not 0.0 <= occupancy_lo < occupancy_hi <= 1.0:
            raise ValueError("need 0 <= occupancy_lo < occupancy_hi <= 1")
        if step_units < 1:
            raise ValueError("step_units must be >= 1")
        self.occupancy_hi = float(occupancy_hi)
        self.occupancy_lo = float(occupancy_lo)
        self.queue_hi = int(queue_hi)
        self.slack_lo = float(slack_lo)
        self.step_units = int(step_units)
        self.max_units = max_units if max_units is None else int(max_units)
        self.min_units = min_units if min_units is None else int(min_units)
        self.cooldown = float(cooldown)
        self.reset()

    def reset(self) -> None:
        """Re-arm for a fresh run (the engine calls this from ``run`` so
        warm-up double-runs replay identical decisions)."""
        self._last_scale = -float("inf")
        self.decisions: list = []      # applied (kind, reason, step) log

    # -- the cooldown clock (shared with reactive reshapes) ------------------
    def note_scale(self, step: float, plan: ScalePlan) -> None:
        """Record an APPLIED reshape (reactive or proactive) — both arms
        share one cooldown so the controller never fights chaos recovery."""
        self._last_scale = float(step)
        self.decisions.append((plan.kind, plan.reason, float(step)))

    def _bind_limits(self, capacity: int) -> None:
        if self.max_units is None:
            self.max_units = int(capacity)
        if self.min_units is None:
            self.min_units = int(capacity)

    def pending_units(self, pool) -> int:
        """Capacity a proactive scale-up could still add — the admission
        path counts this (plus the injector's scheduled restores) before
        giving up on a request that does not fit the current pool."""
        self._bind_limits(pool_capacity(pool))
        return max(0, self.max_units - pool_capacity(pool))

    def decide(self, step: float, pool, metrics) -> Optional[ScalePlan]:
        """One boundary's proactive decision (None = leave the pool alone).

        ``metrics`` is the run's ``MetricsRegistry``; the occupancy /
        queue_depth / slack[...] gauges were set this boundary, so the
        decision reads the engine's *current* state, not a stale sample.
        """
        capacity = pool_capacity(pool)
        self._bind_limits(capacity)
        if step - self._last_scale < self.cooldown:
            return None
        if "occupancy" not in metrics.gauges:
            return None                # no boundary sampled yet: the run
                                       # has not started decoding
        occ = metrics.value("occupancy")
        queue = metrics.value("queue_depth")
        slacks = [g.value for name, g in metrics.gauges.items()
                  if name.startswith("slack[")]

        reason = None
        if occ >= self.occupancy_hi:
            reason = "occupancy"
        elif queue >= self.queue_hi:
            reason = "queue_depth"
        elif slacks and min(slacks) <= self.slack_lo:
            reason = "slack"
        if reason is not None:
            grow = min(self.step_units, self.max_units - capacity)
            if grow > 0:
                return ScalePlan(kind="scale_up", units=grow, reason=reason,
                                 step=float(step))
            return None

        if occ <= self.occupancy_lo and queue <= 0:
            shrink = min(self.step_units, capacity - self.min_units)
            # never shrink below what the live requests are holding
            held = capacity - getattr(pool, "free_blocks", 0) \
                if hasattr(pool, "free_blocks") else 0
            shrink = min(shrink, capacity - max(self.min_units, held))
            if shrink > 0:
                return ScalePlan(kind="scale_down", units=shrink,
                                 reason="occupancy", step=float(step))
        return None
