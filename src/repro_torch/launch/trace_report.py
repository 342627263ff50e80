"""Offline trace analyzer: reconstruct run behavior from a serve trace (a
copy of ``repro.launch.trace_report``).

    PYTHONPATH=src python -m repro_torch.launch.trace_report out.jsonl

Replays a JSONL event trace (``launch/serve.py --trace out.jsonl``, of
either package: the schema is shared) into
the summaries the raw event stream only implies:

  * **SLO-attainment timeline** — evictions bucketed over the decode-step
    clock, per tenant: attainment per bucket, so an SLO collapse shows
    WHEN it happened, not just that the run-level average dipped.
  * **Per-tenant occupancy shares** — admit/evict/preempt plus the block
    events replayed into step-weighted per-tenant cache holdings: the
    observed analogue of the allocator's planned shares.
  * **Preemption-cause breakdown** — victims grouped by (cause, tenant).
  * **Dispatch summaries** — decode-horizon geometry (K, width) and
    prefill round shapes with wall-time splits.
  * **Per-phase dispatch costs** — count / total / mean wall per phase
    from the span events; traces recorded with ``--profile`` additionally
    carry ``dispatch_profile`` events, which add the compile-vs-execute
    split and the measured-vs-roofline utilization column.
  * **Queue report** — admission wait distribution plus budget_skip /
    defer counts per tenant.
  * **Fault report** — chaos-replay traces (``launch/replay.py``) carry
    ``fault_inject`` / ``recover`` events; these are tabulated by fault
    kind and by recovery action (regenerate / retry / drop / restore).
  * **Scale report** — elastic reshapes (``scale_up`` / ``scale_down`` /
    ``migrate``): one row per reshape with units moved, capacity and mesh
    multiple after, and the reason, plus state-migration totals.

Flags: ``--json`` emits the full report as one JSON object; ``--buckets``
sets the timeline resolution; ``--validate`` checks every event against
``EVENT_SCHEMA`` first; ``--require-slo-timeline`` exits nonzero when the
trace yields no SLO timeline.

Pure stdlib + the event schema (no torch, no device), so it runs anywhere
the trace file lands.
"""
import argparse
import json
import sys
from collections import defaultdict

from repro_torch.obs.events import EVENT_SCHEMA, read_trace, validate_events


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def slo_timeline(events, n_buckets: int):
    """Evictions bucketed over the decode-step clock, per tenant.

    Returns {tenant: [{"step_lo", "step_hi", "n", "met", "attainment"},
    ...]} with one entry per non-empty bucket."""
    evs = [e for e in events if e["ev"] == "evict"]
    if not evs:
        return {}
    hi = max(e["step"] for e in evs)
    width = max(hi / n_buckets, 1e-9)
    by_tenant = defaultdict(lambda: defaultdict(lambda: [0, 0]))
    for e in evs:
        b = min(int(e["step"] / width), n_buckets - 1)
        cell = by_tenant[e["tenant"]][b]
        cell[0] += 1
        cell[1] += bool(e["met"])
    out = {}
    for tenant, buckets in sorted(by_tenant.items()):
        out[tenant] = [
            {"step_lo": b * width, "step_hi": (b + 1) * width,
             "n": n, "met": met, "attainment": met / n}
            for b, (n, met) in sorted(buckets.items())]
    return out


def occupancy_shares(events):
    """Step-weighted per-tenant cache holdings, replayed from the trace.

    Admission stamps a slot's tenant and starting units (blocks for the
    paged pool, 1 slot otherwise); block_grow adds, evict / preempt
    releases. Each event integrates ``held * dt`` since the previous
    event's step, so the shares weigh holdings by how LONG they were
    held — the observed counterpart of the allocator's planned shares."""
    slot_tenant = {}
    slot_units = defaultdict(float)
    acc = defaultdict(float)           # tenant -> unit-steps
    last_step = 0.0

    def advance(step):
        nonlocal last_step
        dt = step - last_step
        if dt > 0:
            for s, t in slot_tenant.items():
                acc[t] += slot_units[s] * dt
            last_step = step
        elif dt < 0:
            last_step = step

    for e in events:
        ev = e["ev"]
        if ev not in ("admit", "evict", "preempt", "block_grow", "run_end"):
            continue
        advance(e["step"])
        slot = e.get("slot")
        if ev == "admit":
            slot_tenant[slot] = e["tenant"]
            slot_units[slot] = float(e["units"])
        elif ev == "block_grow":
            if slot in slot_tenant:
                slot_units[slot] += float(e["blocks"])
        elif ev in ("evict", "preempt"):
            slot_tenant.pop(slot, None)
            slot_units.pop(slot, None)
    total = sum(acc.values())
    return {t: {"unit_steps": v, "share": v / total if total else 0.0}
            for t, v in sorted(acc.items())}


def preemption_breakdown(events):
    """Preemption victims grouped by (cause, tenant)."""
    table = defaultdict(int)
    for e in events:
        if e["ev"] == "preempt":
            table[(e["cause"], e["tenant"])] += 1
    return [{"cause": c, "tenant": t, "n": n}
            for (c, t), n in sorted(table.items())]


def dispatch_summary(events):
    """Decode-horizon geometry and prefill shapes, with wall splits."""
    dec = [e for e in events if e["ev"] == "decode_horizon"]
    pre = [e for e in events
           if e["ev"] in ("prefill", "prefill_round")]
    shrinks = [e for e in events if e["ev"] == "horizon_shrink"]
    return {
        "decode": {
            "dispatches": len(dec),
            "mean_k": _mean(e["k"] for e in dec),
            "mean_width": _mean(e["width"] for e in dec),
            "mean_active": _mean(e["active"] for e in dec),
            "wall_s": sum(e["dur_s"] for e in dec),
        },
        "prefill": {
            "dispatches": len(pre),
            "wall_s": sum(e["dur_s"] for e in pre),
        },
        "horizon_shrinks": len(shrinks),
    }


#: span event type -> profiler phase name (the join key between the span
#: tracks and obs/prof.py's dispatch_profile events)
_PHASE_OF = {"prefill": "prefill", "prefill_round": "prefill_round",
             "decode_horizon": "decode"}


def phase_costs(events):
    """Per-phase dispatch-cost rows: count, total/mean wall from the span
    events, plus — when the trace carries ``dispatch_profile`` events
    (``launch/serve.py --profile --trace``) — the compile count/seconds
    and the mean measured-vs-roofline utilization of execute dispatches.
    ``util`` is None for traces recorded without profiling."""
    spans = defaultdict(list)
    for e in events:
        ph = _PHASE_OF.get(e["ev"])
        if ph is not None:
            spans[ph].append(float(e["dur_s"]))
    prof = defaultdict(lambda: {"utils": [], "compiles": 0, "compile_s": 0.0})
    for e in events:
        if e["ev"] == "dispatch_profile":
            p = prof[e["phase"]]
            if e.get("compile"):
                p["compiles"] += 1
                p["compile_s"] += float(e["dur_s"])
            elif e.get("util") is not None:
                p["utils"].append(float(e["util"]))
    rows = []
    for ph in sorted(set(spans) | set(prof)):
        durs = spans.get(ph, [])
        p = prof.get(ph)
        rows.append({
            "phase": ph, "count": len(durs),
            "total_ms": sum(durs) * 1e3, "mean_ms": _mean(durs) * 1e3,
            "compiles": p["compiles"] if p else 0,
            "compile_ms": p["compile_s"] * 1e3 if p else 0.0,
            "util": (_mean(p["utils"]) if p and p["utils"] else None),
        })
    return rows


def queue_report(events):
    """Admission waits plus per-tenant budget_skip / defer counts."""
    waits = defaultdict(list)
    skips = defaultdict(int)
    defers = defaultdict(int)
    for e in events:
        if e["ev"] == "admit":
            waits[e["tenant"]].append(e["wait_steps"])
        elif e["ev"] == "budget_skip":
            skips[e["tenant"]] += 1
        elif e["ev"] == "defer":
            defers[e["tenant"]] += 1
    return {t: {"admitted": len(w), "mean_wait_steps": _mean(w),
                "max_wait_steps": max(w) if w else 0.0,
                "budget_skips": skips.get(t, 0), "defers": defers.get(t, 0)}
            for t, w in sorted(waits.items())}


def fault_report(events):
    """Fault-injection and recovery tables from a chaos-replay trace.

    ``injected`` counts ``fault_inject`` events by kind; ``recoveries``
    counts ``recover`` events by (fault kind, recovery action); ``drops``
    is the subset of recoveries whose action was ``drop``. Empty dicts
    for fault-free traces."""
    injected = defaultdict(int)
    recoveries = defaultdict(int)
    drops = 0
    for e in events:
        if e["ev"] == "fault_inject":
            injected[e["kind"]] += 1
        elif e["ev"] == "recover":
            recoveries[(e["kind"], e["action"])] += 1
            drops += e["action"] == "drop"
    return {
        "injected": dict(sorted(injected.items())),
        "recoveries": [{"kind": k, "action": a, "n": n}
                       for (k, a), n in sorted(recoveries.items())],
        "drops": drops,
    }


def scale_report(events):
    """Elastic-reshape tables from a trace (serve/elastic.py).

    One row per ``scale_up`` / ``scale_down`` event — when, why, how many
    units moved, the capacity and mesh multiple after — plus migration
    totals from ``migrate`` events (blocks moved across physical pool
    growths, and the wall time spent migrating). Empty for traces without
    reshapes."""
    rows = [{"step": e["step"], "kind": e["ev"], "units": e["units"],
             "capacity": e["capacity"], "dmult": e["dmult"],
             "reason": e["reason"]}
            for e in events if e["ev"] in ("scale_up", "scale_down")]
    migs = [e for e in events if e["ev"] == "migrate"]
    return {
        "events": rows,
        "scale_ups": sum(r["kind"] == "scale_up" for r in rows),
        "scale_downs": sum(r["kind"] == "scale_down" for r in rows),
        "migrations": len(migs),
        "migrated_blocks": sum(e["blocks"] for e in migs),
        "grown_blocks": sum(e["added"] for e in migs),
        "migrate_wall_s": sum(e["dur_s"] for e in migs),
    }


def build_report(events, n_buckets: int = 8) -> dict:
    """The full analyzer output as one JSON-able dict."""
    meta = next((e for e in events if e["ev"] == "trace_meta"), None)
    run = next((e for e in events if e["ev"] == "run_start"), None)
    end = next((e for e in events if e["ev"] == "run_end"), None)
    body = [e for e in events if e["ev"] != "trace_meta"]
    return {
        "meta": {k: meta[k] for k in ("events", "dropped", "capacity")}
        if meta else None,
        "run": ({k: run[k] for k in sorted(EVENT_SCHEMA["run_start"])}
                if run else None),
        "steps": end["steps"] if end else None,
        "wall_s": end["wall_s"] if end else None,
        "slo_timeline": slo_timeline(body, n_buckets),
        "occupancy_shares": occupancy_shares(body),
        "preemptions": preemption_breakdown(body),
        "dispatches": dispatch_summary(body),
        "phase_costs": phase_costs(body),
        "queue": queue_report(body),
        "faults": fault_report(body),
        "scaling": scale_report(body),
    }


def _print_human(report: dict) -> None:
    run = report["run"] or {}
    print(f"run: backend={run.get('backend')} slots={run.get('n_slots')} "
          f"horizon={run.get('horizon')} requests={run.get('n_requests')} "
          f"steps={report['steps']} wall_s={report['wall_s'] or 0:.3f}")
    if report["meta"]:
        m = report["meta"]
        print(f"trace: {m['events']} events, {m['dropped']} dropped "
              f"(capacity {m['capacity']})")
    d = report["dispatches"]
    print(f"decode: {d['decode']['dispatches']} dispatches, "
          f"mean K {d['decode']['mean_k']:.1f}, "
          f"mean width {d['decode']['mean_width']:.1f}, "
          f"{d['decode']['wall_s']:.3f}s; "
          f"prefill: {d['prefill']['dispatches']} dispatches, "
          f"{d['prefill']['wall_s']:.3f}s; "
          f"{d['horizon_shrinks']} horizon shrinks")
    if report["phase_costs"]:
        print("\nphase costs:")
        print(f"  {'phase':<14} {'count':>5} {'total ms':>9} {'mean ms':>8} "
              f"{'compiles':>8} {'util':>6}")
        for row in report["phase_costs"]:
            util = f"{row['util']:.3g}" if row["util"] is not None else "—"
            print(f"  {row['phase']:<14} {row['count']:>5} "
                  f"{row['total_ms']:>9.1f} {row['mean_ms']:>8.2f} "
                  f"{row['compiles']:>8} {util:>6}")
    print("\noccupancy shares (step-weighted):")
    for t, s in report["occupancy_shares"].items():
        print(f"  {t:<10} {s['share']*100:5.1f}%  "
              f"({s['unit_steps']:.0f} unit-steps)")
    print("\nqueue:")
    for t, q in report["queue"].items():
        print(f"  {t:<10} admitted={q['admitted']} "
              f"mean_wait={q['mean_wait_steps']:.1f} "
              f"max_wait={q['max_wait_steps']:.0f} "
              f"budget_skips={q['budget_skips']} defers={q['defers']}")
    if report["preemptions"]:
        print("\npreemptions:")
        for row in report["preemptions"]:
            print(f"  {row['cause']:<16} {row['tenant']:<10} x{row['n']}")
    f = report.get("faults") or {}
    if f.get("injected"):
        print("\nfaults injected:")
        for kind, n in f["injected"].items():
            print(f"  {kind:<16} x{n}")
        print("recoveries:")
        for row in f["recoveries"]:
            print(f"  {row['kind']:<16} {row['action']:<12} x{row['n']}")
        print(f"requests dropped by chaos: {f['drops']}")
    s = report.get("scaling") or {}
    if s.get("events"):
        print("\nelastic reshapes:")
        print(f"  {'step':>6} {'kind':<12} {'units':>5} {'capacity':>8} "
              f"{'dmult':>5} reason")
        for row in s["events"]:
            print(f"  {row['step']:>6.0f} {row['kind']:<12} "
                  f"{row['units']:>5} {row['capacity']:>8} "
                  f"{row['dmult']:>5} {row['reason']}")
        if s["migrations"]:
            print(f"  migrations: {s['migrations']} "
                  f"({s['migrated_blocks']} blocks moved, "
                  f"{s['grown_blocks']} grown, "
                  f"{s['migrate_wall_s']*1e3:.1f} ms)")
    print("\nSLO timeline:")
    if not report["slo_timeline"]:
        print("  (no evictions in trace)")
    for t, buckets in report["slo_timeline"].items():
        cells = " ".join(
            f"[{b['step_lo']:.0f}-{b['step_hi']:.0f}) "
            f"{b['met']}/{b['n']}" for b in buckets)
        att = _mean(b["attainment"] for b in buckets)
        print(f"  {t:<10} {cells}  (mean bucket attainment {att:.2f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="analyze a serve trace (launch/serve.py --trace)")
    ap.add_argument("trace", help="JSONL trace path")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--buckets", type=int, default=8,
                    help="SLO-timeline resolution (step buckets)")
    ap.add_argument("--validate", action="store_true",
                    help="check every event against EVENT_SCHEMA first")
    ap.add_argument("--require-slo-timeline", action="store_true",
                    help="exit nonzero when the trace has no evictions")
    args = ap.parse_args(argv)

    events, truncated = read_trace(args.trace)
    if args.validate:
        if truncated:
            print("warning: final trace line is truncated (writer was "
                  "interrupted mid-record); it was skipped", file=sys.stderr)
        problems = validate_events(events)
        if problems:
            for p in problems[:20]:
                print(f"schema violation: {p}", file=sys.stderr)
            return 2
    report = build_report(events, n_buckets=args.buckets)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        _print_human(report)
    if args.require_slo_timeline and not report["slo_timeline"]:
        print("FAIL: trace produced no SLO timeline (no evict events)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
