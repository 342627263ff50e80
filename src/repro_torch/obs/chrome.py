"""Chrome trace-event export: render a serve trace for Perfetto (a copy of
``repro.obs.chrome``).

Converts the tracer's flat event list into the Chrome Trace Event JSON
format (https://ui.perfetto.dev loads it directly, as does
chrome://tracing): span events (``prefill``, ``prefill_round``,
``decode_horizon``) become complete ("X") events with real durations on
per-phase tracks, instantaneous scheduler/pool decisions become instant
("i") events on their own tracks, and every event carries its payload —
tenant, request id, K, width — as ``args`` so the Perfetto query engine
can slice by them.

Track layout (one process, one thread per phase):

    tid 0  scheduler   admit / evict / preempt / budget_skip / defer
    tid 1  prefill     prefill + prefill_round spans
    tid 2  decode      decode_horizon spans (+ horizon_shrink instants)
    tid 3  pool        block_alloc / block_grow / block_free / prefix_evict
    tid 4  profile     dispatch_profile — utilization counter ("C") tracks
                       per phase, compile dispatches as instants
    tid 5  chaos       fault_inject / recover instants
    tid 6  elastic     scale_up / scale_down instants, migrate spans

``dispatch_profile`` events (obs/prof.py) render as Chrome COUNTER events:
one ``util[<phase>]`` counter track per phase carrying the
measured-vs-roofline utilization ratio over time, so Perfetto plots the
utilization curve directly under the span tracks. Compile dispatches (no
meaningful utilization) render as instants named ``compile[<sig>]``.
"""
from __future__ import annotations

import json
from typing import Iterable, List

from repro_torch.obs.events import SPAN_EVENTS

#: event type -> (tid, track name)
_TRACKS = {
    "admit": (0, "scheduler"), "evict": (0, "scheduler"),
    "preempt": (0, "scheduler"), "budget_skip": (0, "scheduler"),
    "defer": (0, "scheduler"), "run_start": (0, "scheduler"),
    "run_end": (0, "scheduler"),
    "prefill": (1, "prefill"), "prefill_round": (1, "prefill"),
    "decode_horizon": (2, "decode"), "horizon_shrink": (2, "decode"),
    "block_alloc": (3, "pool"), "block_grow": (3, "pool"),
    "block_free": (3, "pool"), "prefix_evict": (3, "pool"),
    "dispatch_profile": (4, "profile"),
    "fault_inject": (5, "chaos"), "recover": (5, "chaos"),
    "scale_up": (6, "elastic"), "scale_down": (6, "elastic"),
    "migrate": (6, "elastic"),
}


def _name(e: dict) -> str:
    """Display name: the type, decorated with the span's shape so a glance
    at the track reads the dispatch geometry."""
    ev = e["ev"]
    if ev == "decode_horizon":
        return f"decode[K={e.get('k')},W={e.get('width')}]"
    if ev == "prefill_round":
        return f"prefill_round[{e.get('lanes')}/{e.get('width')}]"
    if ev == "prefill":
        return f"prefill[req={e.get('req')}]"
    if ev == "fault_inject":
        return f"fault[{e.get('kind')}]"
    if ev == "recover":
        return f"recover[{e.get('kind')}:{e.get('action')}]"
    if ev in ("scale_up", "scale_down"):
        return f"{ev}[{e.get('reason')}:{e.get('units')}]"
    if ev == "migrate":
        return f"migrate[{e.get('blocks')}+{e.get('added')}]"
    return ev


def to_chrome_trace(events: Iterable[dict]) -> dict:
    """Event list -> Chrome trace object ({"traceEvents": [...], ...})."""
    out: List[dict] = []
    pid = 0
    out.append({"ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": "repro.serve"}})
    for tid, label in sorted({v for v in _TRACKS.values()}):
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": label}})
    for e in events:
        ev = e.get("ev")
        if ev == "trace_meta":
            continue
        tid = _TRACKS.get(ev, (0, "scheduler"))[0]
        args = {k: v for k, v in e.items() if k not in ("ev", "t")}
        t_us = float(e.get("t", 0.0)) * 1e6
        if ev == "dispatch_profile":
            if e.get("compile"):
                out.append({"ph": "i", "pid": pid, "tid": tid,
                            "name": f"compile[{e.get('sig')}]",
                            "ts": t_us, "s": "t", "args": args})
            else:
                out.append({"ph": "C", "pid": pid, "tid": tid,
                            "name": f"util[{e.get('phase')}]", "ts": t_us,
                            "args": {"util": float(e.get("util") or 0.0)}})
        elif ev in SPAN_EVENTS:
            dur_us = max(float(e.get("dur_s") or 0.0) * 1e6, 1.0)
            # the tracer stamps t at emit time (span END); Chrome wants the
            # start timestamp.
            out.append({"ph": "X", "pid": pid, "tid": tid, "name": _name(e),
                        "ts": max(t_us - dur_us, 0.0), "dur": dur_us,
                        "args": args})
        else:
            out.append({"ph": "i", "pid": pid, "tid": tid, "name": _name(e),
                        "ts": t_us, "s": "t", "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: Iterable[dict]) -> None:
    """Write a Perfetto-loadable Chrome trace JSON file."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events), f)
