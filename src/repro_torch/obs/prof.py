"""Dispatch-level profiling: measured per-dispatch cost + analytic roofline
(a copy of ``repro.obs.prof``, with the H100's peaks).

The measurement half of Synergy's optimistic-profiling loop, applied to the
serve engine: the tenant profiler (serve/tenant.py) fits sensitivity curves
from two probes and the allocator plans from the fits; ``DispatchProfiler``
measures what a dispatch actually costs. It wraps every captured hot path
(paged prefill rounds, K-step decode horizons, whose compaction gathers
and scatters ride inside the horizon program and are tagged by its
``full`` flag, and the contiguous per-request prefill) and records each
dispatch's duration with:

  * **compile-vs-execute attribution**: the engine captures one CUDA graph
    per static signature (phase, width bucket, horizon K, full/compacted,
    prompt length), so the first call carrying a new signature (an eager
    run plus the capture) is the compile and every later call a replay;
    the profiler keeps the seen-signature set across runs. A graph
    captured again after a pool growth drops the old graphs counts as an
    execute, since its signature was seen;
  * **an analytic roofline term per signature**: FLOPs and HBM bytes from
    the config shapes (2·N_active per token, plus per-position KV
    traffic), against the peaks of one NVIDIA H100 80GB HBM3, so every
    execute dispatch gets a measured-vs-roofline utilization ratio;
  * **per-tenant cost shares**: dispatch seconds split by lane/slot
    occupancy (a decode horizon whose bucket holds 3 rows of tenant A and
    1 of tenant B charges A 75% of the dispatch).

Records flow three ways: gauges + boundary-sampled series in the run's
``MetricsRegistry`` (``util[decode]`` etc.; the Chrome exporter renders
them as counter tracks), ``dispatch_profile`` events into the run's
``Tracer`` when one is attached, and aggregated per-(arch × phase ×
geometry) records into a ``ProfileStore``.

``ProfileStore`` persists to a JSONL file the caller names (one record per
line, keyed merge: re-runs supersede) and closes the loop: ``rate_fit``
regresses the decode records onto the tenant profiler's rate model
``dur = t_fixed + rows·K·t_tok``, so ``serve/tenant.py``'s
``profile_class(store=...)`` builds its knees from measured constants when
a store holds them (the analytic constants stay the fallback).

Profiling is read-only (tokens are identical with it on) and off is the
default: the engine holds the falsy ``NULL_PROFILER`` and every hook site
guards with one truthiness check (``if prof: ...``), as with
``NULL_TRACER``. The module imports neither torch nor numpy, so reports
and store tooling run anywhere the files land.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

# the roofline peaks of one NVIDIA H100 80GB HBM3: the dense BF16
# tensor-core rate, as the reference takes its chip's BF16 peak, and the
# HBM3 bandwidth
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16


_ACT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}

#: phases with an attention-KV read/write pattern (per-position cache
#: traffic); recurrent families carry O(1) state instead and their cache
#: traffic is folded into the (dominant) parameter-read term.
_ATTN_FAMILIES = ("dense", "vlm", "moe", "encdec")


def _dtype_bytes(name: str) -> int:
    return _ACT_BYTES.get(str(name), 4)


class NullDispatchProfiler:
    """The profiling-off profiler: falsy, every hook a no-op.

    The engine's default — ``if prof:`` short-circuits every hook site, so
    a run without profiling pays one truthiness check per site and nothing
    else (the same no-measurable-overhead contract as ``NULL_TRACER``).
    """
    enabled = False
    records: List[dict] = []
    tenant_s: Dict[str, float] = {}

    def __bool__(self) -> bool:
        return False

    def record(self, phase: str, dur_s: float, **kw) -> None:
        pass

    def summary(self) -> dict:
        return {}


NULL_PROFILER = NullDispatchProfiler()


class DispatchProfiler:
    """Per-dispatch wall-time recorder with roofline attribution.

    ``cfg`` (an ``ArchConfig``) supplies the shapes the analytic FLOP/byte
    model reads; without one the profiler still measures and attributes
    compile-vs-execute but reports no roofline terms. ``n_devices`` splits
    the analytic terms per device (the port serves on one).
    ``peak_flops`` / ``hbm_bw`` override the H100 peaks.
    """
    enabled = True

    def __init__(self, cfg=None, *, n_devices: int = 1,
                 peak_flops: Optional[float] = None,
                 hbm_bw: Optional[float] = None):
        self.cfg = cfg
        self.n_devices = max(int(n_devices), 1)
        self.peak_flops = float(peak_flops or PEAK_FLOPS_BF16)
        self.hbm_bw = float(hbm_bw or HBM_BW)
        self.records: List[dict] = []
        self.tenant_s: Dict[str, float] = {}
        self._seen: set = set()
        self._t0 = time.perf_counter()
        # config-derived constants, computed once (param_count walks the
        # whole arithmetic; the hot path should not)
        if cfg is not None:
            self._params_active = cfg.param_count(active_only=True)
            self._param_bytes = (cfg.param_count()
                                 * _dtype_bytes(cfg.param_dtype))
            if cfg.family in _ATTN_FAMILIES:
                self._kv_bytes_per_pos = (cfg.n_layers * 2 * cfg.n_kv_heads
                                          * cfg.resolved_head_dim
                                          * _dtype_bytes(cfg.dtype))
            else:
                self._kv_bytes_per_pos = 0
        else:
            self._params_active = 0
            self._param_bytes = 0
            self._kv_bytes_per_pos = 0

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.records)

    # -- analytic roofline ---------------------------------------------------
    def roofline_terms(self, phase: str, *, tokens: int, k: int = 1,
                       kv_pos_sum: int = 0) -> Tuple[float, float]:
        """(FLOPs, HBM bytes) one dispatch moves, from the config shapes.

        FLOPs use the model-FLOPs convention the dry-run records
        (2·N_active per token — attention's quadratic term is excluded on
        both sides of the comparison, so ratios stay consistent). HBM
        bytes: the parameters are re-read every scan step of a decode
        horizon (k times) and once per prefill chunk; the KV cache
        contributes ``kv_pos_sum`` read positions per step plus one write
        per computed token. Deliberately analytic — the point is a STABLE
        per-signature denominator, not a byte-exact trace."""
        if self.cfg is None:
            return 0.0, 0.0
        flops = 2.0 * self._params_active * tokens
        weight_reads = k if phase == "decode" else 1
        hbm = (weight_reads * self._param_bytes
               + (kv_pos_sum * weight_reads + tokens)
               * self._kv_bytes_per_pos)
        return flops, float(hbm)

    # -- the hook ------------------------------------------------------------
    def record(self, phase: str, dur_s: float, *, width: int = 1, k: int = 1,
               tokens: Optional[int] = None, kv_pos_sum: int = 0,
               full: Optional[bool] = None, seq: Optional[int] = None,
               tenants: Optional[Dict[str, int]] = None, obs=None) -> dict:
        """Record one captured dispatch.

        ``width``/``k``/``full``/``seq`` are the static half of the call:
        they name the captured program, so they form the signature whose
        first sighting is the compile. ``tokens`` defaults to ``width * k`` (the
        dispatched compute — padded rows compute too). ``kv_pos_sum`` is
        the summed KV positions of the dispatched rows (the cache-read
        term). ``tenants`` maps tenant id -> rows in this dispatch (cost
        shares). ``obs`` (a ``RunObs``) receives the utilization gauge and
        the ``dispatch_profile`` trace event when its tracer is live."""
        tokens = int(width * k) if tokens is None else int(tokens)
        sig = f"{phase}/W{width}/K{k}"
        if full is not None:
            sig += "/full" if full else "/gather"
        if seq is not None:
            sig += f"/S{seq}"
        first = sig not in self._seen
        self._seen.add(sig)
        flops, hbm = self.roofline_terms(phase, tokens=tokens, k=k,
                                         kv_pos_sum=kv_pos_sum)
        roof_s = max(flops / self.peak_flops, hbm / self.hbm_bw) \
            / self.n_devices
        util = (roof_s / dur_s) if (not first and dur_s > 0 and roof_s > 0) \
            else None
        rec = {"phase": phase, "sig": sig, "dur_s": float(dur_s),
               "compile": first, "tokens": tokens, "width": int(width),
               "k": int(k), "flops": flops, "hbm_bytes": hbm,
               "util": util, "t": time.perf_counter() - self._t0}
        self.records.append(rec)
        if tenants:
            total = sum(tenants.values())
            if total > 0:
                for tid, rows in tenants.items():
                    self.tenant_s[tid] = (self.tenant_s.get(tid, 0.0)
                                          + dur_s * rows / total)
        if obs is not None:
            if util is not None:
                obs.metrics.set(f"util[{phase}]", util)
            obs.inc(f"{'compile' if first else 'execute'}_s[{phase}]", dur_s)
            if obs.tracer:
                obs.tracer.emit("dispatch_profile", phase=phase, sig=sig,
                                dur_s=float(dur_s), compile=first,
                                tokens=tokens, flops=flops, hbm_bytes=hbm,
                                util=util)
        return rec

    # -- aggregation ---------------------------------------------------------
    def by_signature(self) -> "OrderedDict[str, dict]":
        """Per-signature aggregate: dispatch count, compile/execute wall
        split, mean execute seconds, mean utilization (execute-only)."""
        out: "OrderedDict[str, dict]" = OrderedDict()
        for r in self.records:
            g = out.setdefault(r["sig"], {
                "phase": r["phase"], "sig": r["sig"], "width": r["width"],
                "k": r["k"], "tokens": r["tokens"], "flops": r["flops"],
                "hbm_bytes": r["hbm_bytes"], "n": 0, "compiles": 0,
                "compile_s": 0.0, "execute_s": 0.0, "utils": []})
            g["n"] += 1
            if r["compile"]:
                g["compiles"] += 1
                g["compile_s"] += r["dur_s"]
            else:
                g["execute_s"] += r["dur_s"]
                if r["util"] is not None:
                    g["utils"].append(r["util"])
        for g in out.values():
            execs = g["n"] - g["compiles"]
            g["mean_execute_s"] = g["execute_s"] / execs if execs else 0.0
            g["util"] = (sum(g["utils"]) / len(g["utils"])
                         if g["utils"] else None)
            del g["utils"]
        return out

    def summary(self) -> dict:
        """Per-phase rollup + tenant cost shares (the launch JSON block)."""
        phases: Dict[str, dict] = {}
        for g in self.by_signature().values():
            p = phases.setdefault(g["phase"], {
                "dispatches": 0, "compiles": 0, "compile_s": 0.0,
                "execute_s": 0.0, "utils": []})
            p["dispatches"] += g["n"]
            p["compiles"] += g["compiles"]
            p["compile_s"] += g["compile_s"]
            p["execute_s"] += g["execute_s"]
            if g["util"] is not None:
                p["utils"].append(g["util"])
        for p in phases.values():
            p["util"] = (sum(p["utils"]) / len(p["utils"])
                         if p["utils"] else None)
            del p["utils"]
        total = sum(self.tenant_s.values())
        shares = {t: s / total for t, s in sorted(self.tenant_s.items())} \
            if total > 0 else {}
        return {"phases": phases, "tenant_seconds": dict(self.tenant_s),
                "tenant_shares": shares, "signatures": len(self._seen),
                "dispatches": len(self.records)}


# ---------------------------------------------------------------------------
# the profile store
# ---------------------------------------------------------------------------
def _store_key(rec: dict) -> tuple:
    return (rec.get("source"), rec.get("arch"), rec.get("backend"),
            rec.get("phase"), rec.get("sig"))


class ProfileStore:
    """Persisted per-(arch × phase × geometry) dispatch-cost records.

    One JSON record per line in a file the caller names (e.g.
    ``build/profiles_torch.jsonl``); records are keyed by (source, arch,
    backend, phase, sig), ``backend`` being the engine's cache kind
    (``contiguous`` or ``paged``), and the last write wins: re-profiled
    geometries supersede. Two sources feed it: ``add_run`` (a serve
    engine's ``DispatchProfiler``, measured) and ``add_dryrun_record`` (a
    dry-run record's analytic roofline terms). ``rate_fit`` is the read
    side the tenant profiler's measured path consumes.
    """

    def __init__(self, records: Optional[List[dict]] = None):
        self._recs: "OrderedDict[tuple, dict]" = OrderedDict()
        for r in records or []:
            self.add(r)

    def __len__(self) -> int:
        return len(self._recs)

    @property
    def records(self) -> List[dict]:
        return list(self._recs.values())

    def add(self, rec: dict) -> None:
        self._recs[_store_key(rec)] = dict(rec)

    @classmethod
    def load(cls, path: str) -> "ProfileStore":
        """Read a store from JSONL (a missing file is an empty store — the
        flag-gated measured-calibrate path falls back to analytic)."""
        store = cls()
        if not os.path.exists(path):
            return store
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    store.add(json.loads(line))
        return store

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for rec in self._recs.values():
                f.write(json.dumps(rec) + "\n")

    # -- writers -------------------------------------------------------------
    def add_run(self, prof: DispatchProfiler, *, arch: str, backend: str,
                mesh: Optional[str] = None) -> int:
        """Fold one profiled engine run in: one record per dispatch
        signature, measured means + roofline terms. Returns records added."""
        n = 0
        for g in prof.by_signature().values():
            execs = g["n"] - g["compiles"]
            self.add({
                "source": "serve", "arch": arch, "backend": backend,
                "mesh": mesh, "phase": g["phase"], "sig": g["sig"],
                "width": g["width"], "k": g["k"], "tokens": g["tokens"],
                "n": execs, "compiles": g["compiles"],
                "compile_s": g["compile_s"],
                "mean_s": g["mean_execute_s"],
                "flops": g["flops"], "hbm_bytes": g["hbm_bytes"],
                "util": g["util"],
            })
            n += 1
        return n

    def add_dryrun_record(self, rec: dict) -> None:
        """Convert one dry-run JSONL record (the reference's
        ``launch/dryrun.py`` format) into a store record: the analytic
        roofline terms per (arch × shape × mesh), read next to the
        measured serve records."""
        self.add({
            "source": "dryrun", "arch": rec["arch"], "backend": rec["mesh"],
            "mesh": rec["mesh"], "phase": rec["mode"],
            "sig": f"{rec['mode']}/{rec['shape']}",
            "width": None, "k": 1, "tokens": None,
            "n": 1, "compiles": 1, "compile_s": rec.get("compile_s", 0.0),
            "mean_s": max(rec.get("compute_s", 0.0),
                          rec.get("memory_s", 0.0),
                          rec.get("collective_s", 0.0)),
            "flops": rec.get("flops_per_chip"),
            "hbm_bytes": rec.get("bytes_per_chip"),
            "util": rec.get("useful_flop_ratio"),
            "bottleneck": rec.get("bottleneck"),
        })

    # -- the read side: measured rate constants ------------------------------
    def rate_fit(self, arch: str, backend: Optional[str] = None,
                 ) -> Optional[Tuple[float, float]]:
        """Fit the tenant rate model's constants from measured decode
        records: ``dur = t_fixed + rows·K·t_tok`` is linear in the
        dispatched token count, so weighted least squares over the
        per-signature (width·k, mean_s) points recovers (t_tok, t_fixed).
        Returns None without at least two distinct dispatch sizes or when
        the slope is non-positive (degenerate measurement) — the caller
        keeps its analytic constants then."""
        pts = []
        for r in self._recs.values():
            if (r.get("source") == "serve" and r.get("arch") == arch
                    and r.get("phase") == "decode" and r.get("n", 0) > 0
                    and (backend is None or r.get("backend") == backend)):
                pts.append((float(r["width"] * r["k"]),
                            float(r["mean_s"]), float(r["n"])))
        if len({x for x, _, _ in pts}) < 2:
            return None
        sw = sum(w for _, _, w in pts)
        mx = sum(x * w for x, _, w in pts) / sw
        my = sum(y * w for _, y, w in pts) / sw
        sxx = sum(w * (x - mx) ** 2 for x, _, w in pts)
        sxy = sum(w * (x - mx) * (y - my) for x, y, w in pts)
        if sxx <= 0:
            return None
        t_tok = sxy / sxx
        if t_tok <= 0:
            return None
        t_fixed = max(0.0, my - t_tok * mx)
        return t_tok, t_fixed
