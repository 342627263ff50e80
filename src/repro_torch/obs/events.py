"""Structured event tracing: a ring-buffered event log for the serve engine
(a copy of ``repro.obs.events``; the schema is the reference's, field for
field, so a trace from either package validates against the other).

The telemetry substrate Synergy-style scheduling needs: decisions must be
*observed*, not assumed (the same argument PAPER.md makes for per-job
resource sensitivity), and event-level traces are what make utilization and
queueing pathologies diagnosable at all (Jeon et al., arXiv:1901.05758).

An event is one flat dict:

    {"ev": <type>, "step": <engine decode-step clock>,
     "t": <wall seconds since tracer start>, ...payload}

``EVENT_SCHEMA`` is the taxonomy — every type's exact payload field set.
The schema is a stability contract: ``tests/test_torch_obs.py`` holds the
port's traces to the reference engine's, event for event, and
``launch/trace_report.py`` replays traces against it, so
adding a field means extending the schema (append-only), never mutating an
existing type in place.

``Tracer`` is a bounded ring: events past ``capacity`` drop the OLDEST
entry (``dropped`` counts them) so a long run's tail — usually what you
are debugging — survives at a fixed memory cost. ``NullTracer`` is the
tracing-off stand-in: it is falsy and its hooks do nothing, so every
instrumentation site in the engine guards with a single truthiness check
(``if tr: tr.emit(...)``) and tracing off costs one branch per site.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Tuple

#: event taxonomy: type -> exact payload field set (beyond ev/step/t).
#: Span events additionally carry ``dur_s`` (listed explicitly). The
#: golden-trace test asserts emitted events match these sets EXACTLY, so
#: schema drift is a deliberate, reviewed change.
EVENT_SCHEMA: Dict[str, FrozenSet[str]] = {
    # -- run lifecycle ------------------------------------------------------
    "run_start": frozenset({"backend", "n_slots", "horizon", "n_requests"}),
    "run_end": frozenset({"steps", "wall_s"}),
    # -- scheduler decisions ------------------------------------------------
    "admit": frozenset({"req", "tenant", "slot", "prompt_len", "max_new",
                        "wait_steps", "units"}),
    "evict": frozenset({"req", "tenant", "slot", "latency_steps",
                        "finished_early", "slo_steps", "met"}),
    "preempt": frozenset({"req", "tenant", "slot", "cause", "n_preempted"}),
    "budget_skip": frozenset({"req", "tenant", "held", "need", "budget"}),
    "defer": frozenset({"req", "tenant", "cause"}),
    # -- phase dispatches (spans: carry dur_s) ------------------------------
    "prefill": frozenset({"req", "tenant", "slot", "prompt_len", "dur_s"}),
    "prefill_round": frozenset({"lanes", "width", "dur_s"}),
    "decode_horizon": frozenset({"k", "width", "active", "full", "dur_s"}),
    "horizon_shrink": frozenset({"from_k", "to_k", "cause"}),
    # -- dispatch profiling (obs/prof.py; emitted only when a profiler AND
    # a tracer are both attached) -------------------------------------------
    "dispatch_profile": frozenset({"phase", "sig", "dur_s", "compile",
                                   "tokens", "flops", "hbm_bytes", "util"}),
    # -- fault injection (serve/chaos.py; emitted only with an injector) ----
    # ``target``: slot id / tenant / None; ``mag``: the kind's magnitude
    # (blocks revoked, hold steps, burst size, entries flushed).
    "fault_inject": frozenset({"kind", "target", "mag"}),
    # a recovery action the engine took for an injected fault: action in
    # {regenerate, retry, drop, restore, reserve_rescale, replan, noop};
    # ``req`` is the affected request id (None for pool-wide actions).
    "recover": frozenset({"kind", "action", "req", "detail"}),
    # -- elastic reshapes (serve/elastic.py; emitted at horizon boundaries) -
    # ``units``: the capacity delta applied (may be less than planned when
    # the pool could not satisfy it); ``capacity``: pool capacity AFTER;
    # ``dmult``: the mesh 'data' bucketing multiple after the reshape;
    # ``reason``: device_fail / device_join / occupancy / queue_depth /
    # slack.
    "scale_up": frozenset({"units", "capacity", "dmult", "reason"}),
    "scale_down": frozenset({"units", "capacity", "dmult", "reason"}),
    # a physical-growth state migration (BlockManager.grow_physical):
    # ``blocks`` existing blocks whose content moved into the new buffers.
    "migrate": frozenset({"blocks", "added", "dur_s"}),
    # -- block pool ---------------------------------------------------------
    "block_alloc": frozenset({"slot", "blocks", "hits"}),
    "block_grow": frozenset({"slot", "blocks"}),
    "block_free": frozenset({"slot", "blocks", "shared"}),
    "prefix_evict": frozenset({"blocks"}),
    # -- metadata (first line of a dumped trace) ----------------------------
    "trace_meta": frozenset({"events", "dropped", "capacity"}),
}

#: span types: rendered as duration tracks by the Chrome exporter
SPAN_EVENTS = frozenset({"prefill", "prefill_round", "decode_horizon",
                         "migrate"})


class NullTracer:
    """The tracing-off tracer: falsy, every hook a no-op.

    The engine's default — ``if tr:`` short-circuits every instrumentation
    site, so a run without tracing pays one truthiness check per site and
    nothing else.
    """
    enabled = False
    step: float = 0.0
    dropped = 0
    events: List[dict] = []

    def __bool__(self) -> bool:
        return False

    def emit(self, ev: str, step: Optional[float] = None, **fields) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Ring-buffered structured event log.

    ``capacity`` bounds memory: once full, each new event drops the OLDEST
    one and bumps ``dropped``. ``step`` is the engine's decode-step clock —
    the engine advances it, so call sites that have no clock of their own
    (the block pool) inherit the current step. Wall time is
    ``time.perf_counter`` relative to tracer construction (monotonic,
    sub-microsecond).
    """
    enabled = True

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = int(capacity)
        self._events: deque = deque()
        self.dropped = 0
        self.step: float = 0.0
        self._t0 = time.perf_counter()

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._events)

    def emit(self, ev: str, step: Optional[float] = None, **fields) -> None:
        """Append one event (dropping the oldest when the ring is full)."""
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        e = {"ev": ev,
             "step": float(self.step if step is None else step),
             "t": time.perf_counter() - self._t0}
        e.update(fields)
        self._events.append(e)

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def dump_jsonl(self, path: str) -> None:
        """Write the trace as JSONL: a ``trace_meta`` header line (event
        count, drops, capacity) followed by one event per line."""
        with open(path, "w") as f:
            f.write(json.dumps({"ev": "trace_meta", "step": 0.0, "t": 0.0,
                                "events": len(self._events),
                                "dropped": self.dropped,
                                "capacity": self.capacity}) + "\n")
            for e in self._events:
                f.write(json.dumps(e) + "\n")


def read_trace(path: str) -> Tuple[List[dict], bool]:
    """Read a JSONL trace back into event dicts, tolerating a truncated
    FINAL line — the artifact a crash mid-``dump_jsonl`` leaves behind,
    exactly the situation a post-mortem reader must survive. Returns
    ``(events, truncated)``; a malformed line anywhere *else* still
    raises (that is corruption, not truncation)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    while lines and not lines[-1]:
        lines.pop()
    events, truncated = [], False
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                truncated = True
            else:
                raise
    return events, truncated


def load_trace(path: str) -> List[dict]:
    """Read a JSONL trace back into a list of event dicts (the
    ``trace_meta`` header, when present, stays at index 0). A truncated
    final line — crash mid-dump — is silently dropped; use ``read_trace``
    to observe the truncation flag."""
    return read_trace(path)[0]


def validate_events(events, schema: Dict[str, FrozenSet[str]] = EVENT_SCHEMA,
                    ) -> List[str]:
    """Schema check: every event's type must be known and its payload field
    set must match the schema EXACTLY. Returns human-readable violations
    (empty = conformant) — the golden-trace test and ``trace_report
    --validate`` both run this."""
    problems = []
    for i, e in enumerate(events):
        ev = e.get("ev")
        if ev not in schema:
            problems.append(f"event {i}: unknown type {ev!r}")
            continue
        missing = {"ev", "step", "t"} - set(e)
        if missing:
            problems.append(f"event {i} ({ev}): missing base fields "
                            f"{sorted(missing)}")
        payload = frozenset(set(e) - {"ev", "step", "t"})
        if payload != schema[ev]:
            extra = sorted(payload - schema[ev])
            absent = sorted(schema[ev] - payload)
            problems.append(f"event {i} ({ev}): payload mismatch "
                            f"(extra={extra}, missing={absent})")
    return problems
