"""Open-loop trace replay: Philly-derived arrivals through the serve engine
(a port of ``repro/serve/replay.py``).

``core.trace`` generates Synergy's §5.1 workload — the Philly GPU-demand
mix, heavy-tailed 10^x-minute durations, Poisson arrivals — and
``philly_requests`` maps those training jobs onto serving requests, as a
pure function of the seed (the reference's requests exactly):

  * arrival step: the job's Poisson arrival at ``jobs_per_hour = 3600 *
    load``, so one trace-second is one decode step and ``load`` requests
    arrive a step on average (open loop);
  * prompt length: scaled by the job's GPU demand, g in {1..16} mapping to
    [prompt_len / 2, prompt_len] by log2(g) / 4;
  * generation budget: scaled by the job's duration decade, 10^1.5..10^4
    minutes mapping onto [1, max_new].

``run_replay`` drives a built engine over the request set and, with
``verify=True``, serves every request that was not dropped (burst
arrivals included) again on the fault-free reference — a static
contiguous engine at ``decode_horizon=1`` on the same weights and device,
one slot a request, every arrival at 0 — and names the requests whose
tokens differ. Dropped requests produced no output and are reported
apart.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core import trace as core_trace
from repro_torch.serve.scheduler import ServeRequest


def philly_requests(vocab_size: int, n: int, load: float = 2.0,
                    seed: int = 7, prompt_len: int = 12, max_new: int = 8,
                    max_len: int = 64,
                    tenant_of=None) -> List[ServeRequest]:
    """The Philly-derived request set (module docstring). ``tenant_of``
    maps a ``core.job.Job`` to a tenant id (e.g. multi-GPU jobs to a batch
    tenant); by default every request is on the "default" tenant."""
    if load <= 0:
        raise ValueError("load must be > 0 requests/step")
    jobs = core_trace.philly_trace(n_jobs=n, seed=seed,
                                   jobs_per_hour=3600.0 * load)
    rng = np.random.default_rng(seed)
    cap = max(1, min(prompt_len, max_len - max_new))
    reqs: List[ServeRequest] = []
    for job in jobs:
        # GPU demand (1..16) -> prompt scale in [0.5, 1.0]
        scale = 0.5 + 0.5 * math.log2(max(job.gpu_demand, 1)) / 4.0
        p = max(1, min(cap, int(round(cap * scale))))
        # duration decade (10^1.5 .. 10^4 minutes) -> budget in [1, max_new]
        decade = math.log10(max(job.duration / 60.0, 1.0))
        m = max(1, min(max_new,
                       int(round(max_new * (decade - 1.5) / 2.5))))
        toks = rng.integers(1, max(2, vocab_size), size=p).astype(np.int32)
        reqs.append(ServeRequest(
            prompt=toks, max_new_tokens=m,
            arrival_time=float(job.arrival_time),
            tenant=tenant_of(job) if tenant_of is not None else "default"))
    return reqs


@dataclass
class ReplayResult:
    """One replay: the served requests (burst arrivals included), the run's
    stats, the injected-fault log and, when asked for, the verdict of the
    fault-free reference."""
    requests: List[ServeRequest]
    stats: object
    faults: List[tuple] = field(default_factory=list)
    verified: Optional[bool] = None
    mismatched: List[int] = field(default_factory=list)
    dropped: List[int] = field(default_factory=list)


def run_replay(engine, requests: List[ServeRequest], *,
               verify: bool = False, ref_cfg=None,
               ref_max_len: Optional[int] = None) -> ReplayResult:
    """Drive ``engine`` over ``requests``; with ``verify`` hold every
    request not dropped to the fault-free reference (module docstring),
    built from ``ref_cfg`` (required then) on the engine's full params
    (``ServeEngine.full_params``: gathered over the mesh when sharded)."""
    out, stats = engine.run(requests)
    res = ReplayResult(
        requests=out, stats=stats,
        faults=(list(engine.injector.injected)
                if getattr(engine, "injector", None) is not None else []),
        dropped=[r.job_id for r in out if r.dropped])
    if not verify:
        return res
    if ref_cfg is None:
        raise ValueError("verify=True needs ref_cfg (the unmodified arch "
                         "config for the reference engine)")
    from repro_torch.serve.engine import ServeEngine
    scored = [r for r in out if not r.dropped]
    ref_engine = ServeEngine(ref_cfg, params=engine.full_params(),
                             max_len=ref_max_len or engine.max_len,
                             decode_horizon=1, eos_token=engine.eos_token,
                             device=engine.device)
    refs = [ServeRequest(np.asarray(r.prompt).copy(),
                         max_new_tokens=r.max_new_tokens) for r in scored]
    refs, _ = ref_engine.run(refs)
    res.mismatched = [r.job_id for r, ref in zip(scored, refs)
                      if r.output != ref.output]
    res.verified = not res.mismatched
    return res
