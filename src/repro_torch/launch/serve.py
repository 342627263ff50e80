"""Serving CLI for the port: static or continuous batching over the
contiguous or the paged cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --preset full --engine continuous --cache paged --slots 8 \\
        --batch 16 --prompt-len 256 --shared-prefix 64 --max-new 64 \\
        --max-len 1024 --decode-horizon 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --preset full --engine continuous --cache contiguous --slots 4 \\
        --batch 8 --prompt-len 128 --max-new 16 --max-len 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --preset full --engine continuous --cache paged --slots 4 \\
        --batch 8 --prompt-len 128 --shared-prefix 32 --max-len 256
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi-3-vision-4.2b --preset full --engine continuous \\
        --cache paged --slots 4 --batch 8 --prompt-len 256 --max-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --preset full --engine continuous --slots 4 --batch 8 \
        --prompt-len 64 --max-new 32 --max-len 256 --verify
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --preset full --engine continuous \
        --slots 4 --batch 8 --prompt-len 64 --max-new 32 --max-len 448

Every attention family (dense, VLM, MoE) serves on both caches; the SSM,
hybrid (zamba2) and encoder-decoder (whisper) families on the contiguous
one. Serving is text-only for the VLM and for whisper, as in the
reference: whisper's cross K/V stay zero (no encoder runs).

The defaults are the reference CLI's (``repro/launch/serve.py``):
``--engine static --cache contiguous``, greedy decoding. ``--temperature``
and ``--top-k`` sample on per-slot lanes, ``--eos-token`` stops a request
early, and ``--verify`` re-runs the request set on a static contiguous
engine with ``decode_horizon=1`` and the same weights, and exits non-zero
naming the requests whose tokens differ (greedy only).

Multi-tenant serving (``serve/tenant.py``): ``--tenants N`` registers
tenants t0..tN-1 and tags the request set across them (``--tenant-mix``
ratios, interleaved); ``--slo`` / ``--slo-s`` give per-tenant latency SLOs
in decode steps / wall seconds (comma lists, ``none`` = no target) and
``--tenant-weights`` the fairness weights. ``--policy slo`` orders
admission by SLO slack, and the optimistic serve profiler and the
``TenantAllocator`` plan per-tenant block, lane and horizon budgets
(``--no-tenant-alloc`` keeps the tags, the SLO scoring and the slack
policy without budgets). ``--elastic`` installs an ``ElasticController``
(``--elastic-max-units``, ``--elastic-min-units``,
``--elastic-step-units``, ``--elastic-cooldown``). Tenant mechanisms and
reshapes reorder; they never change tokens, so ``--verify`` holds.

Observability (``repro_torch/obs``): ``--trace out.jsonl`` records every
scheduling decision, phase dispatch and block-pool transition as the
reference's structured events (``--trace-format chrome`` writes a
Perfetto-loadable Chrome trace instead; ``--trace-capacity`` bounds the
event ring); ``--metrics-every N`` sets the series' sampling cadence at
decode boundaries. Analyze a JSONL trace with
``python -m repro_torch.launch.trace_report out.jsonl``. ``--profile``
attaches the dispatch profiler (each dispatch timed to the end of its
device work, with compile-vs-execute attribution, utilization against the
H100's roofline and per-tenant cost shares: the summary's ``profile``
block). ``--profile-store PATH`` (e.g. ``build/profiles_torch.jsonl``)
reads measured rate constants into the tenant profiles when the store
holds a fit (the summary's ``calibrate_source`` says which path each
tenant took) and, with ``--profile``, merges this run's records back in.
``--min-hit-rate F`` exits non-zero when the prefix-cache hit rate falls
below F. Tracing and profiling are read-only: ``--verify`` holds with
them on.

Weights come from the port's ``init_params`` under a ``torch.Generator``
seeded with ``--seed`` (nothing is downloaded); the request set is the
reference driver's ``make_requests`` (``repro/launch/serve.py:98``) on the
same seed. ``--preset smoke`` is the reference's laptop-scale shape,
``full`` the published widths. ``--device`` defaults to ``cuda``; the CPU
runs the kernels' plain versions. Prints a JSON summary.

``--mesh host`` serves TP/DP-sharded (``serve/sharded.py``) over the
process group that ``torchrun`` starts, one process a rank, laid out as a
("data", "model") mesh of (world / 2, 2)
(``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh host
...``): NCCL on the card (one card a rank), gloo on the CPU; every rank
serves the same request set and rank 0 prints the summary. Without a
process group the flag raises, naming that command.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.obs import (DispatchProfiler, ProfileStore, Tracer,
                             write_chrome_trace)
from repro_torch.serve import (ElasticController, ServeEngine, ServeRequest,
                               ServeStats, Tenant, TenantRegistry,
                               plan_allocation, profiles_from_requests)


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  arrival_rate: float, seed: int = 0,
                  shared_prefix: int = 0) -> List[ServeRequest]:
    """Mixed-length request set (lengths uniform in [len/2, len]) with
    optional open-loop arrivals; ``shared_prefix`` prepends one common
    prefix to every prompt (a system-prompt workload for the prefix
    cache)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size,
                          size=shared_prefix).astype(np.int32)
    reqs = []
    for i in range(n):
        s = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        arrival = (i / arrival_rate) if arrival_rate > 0 else 0.0
        tail = rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
        reqs.append(ServeRequest(
            np.concatenate([prefix, tail]) if shared_prefix else tail,
            max_new_tokens=max_new, arrival_time=arrival))
    return reqs


def _csv(spec, n: int, flag: str):
    """A comma-list tenant flag as n values (``none`` or empty -> None)."""
    if not spec:
        return [None] * n
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) != n:
        raise SystemExit(f"{flag} needs {n} comma-separated values "
                         f"(got {len(parts)})")
    return [None if p.lower() in ("none", "") else float(p) for p in parts]


def tag_tenants(reqs, ids, mix) -> None:
    """Interleave the request set across tenants by the mix ratios:
    request i goes to the tenant with the largest deficit against its
    target share (a 2:1 mix tags t0, t0, t1, t0, t0, t1, ...)."""
    total = sum(mix)
    counts = [0] * len(ids)
    for i, r in enumerate(reqs):
        j = max(range(len(ids)),
                key=lambda k: (mix[k] * (i + 1) / total - counts[k], -k))
        r.tenant = ids[j]
        counts[j] += 1


def build_tenancy(args, reqs, n_slots, store=None):
    """(registry, allocation, profiles) for ``--tenants N``: the profiler
    reads each tenant's class shape off its tagged requests (its rates off
    ``store``, a ``ProfileStore``, when it holds a fit for the arch and
    cache) and the allocator plans budgets for the pool's geometry
    (allocation and profiles None under ``--no-tenant-alloc``)."""
    n = args.tenants
    slo = _csv(args.slo, n, "--slo")
    slo_s = _csv(args.slo_s, n, "--slo-s")
    wts = _csv(args.tenant_weights, n, "--tenant-weights")
    mix = _csv(args.tenant_mix, n, "--tenant-mix")
    ids = [f"t{i}" for i in range(n)]
    registry = TenantRegistry([
        Tenant(ids[i], weight=wts[i] if wts[i] is not None else 1.0,
               slo_steps=slo[i], slo_s=slo_s[i]) for i in range(n)])
    tag_tenants(reqs, ids, [m if m is not None else 1.0 for m in mix])
    if not args.tenant_alloc:
        return registry, None, None
    if args.cache == "paged":
        blocks_per_slot = -(-args.max_len // args.block_size)
        total_units = args.blocks or (n_slots or args.batch) * blocks_per_slot
        units_for = lambda r: -(-(len(r.prompt) + r.max_new_tokens)  # noqa: E731
                                // args.block_size)
        watermark_units = math.ceil(args.watermark * total_units)
    else:
        total_units = n_slots or args.batch
        units_for = lambda r: 1                                      # noqa: E731
        watermark_units = 0
    profiles = profiles_from_requests(
        registry, reqs, total_units=total_units, units_for=units_for,
        max_k=args.decode_horizon, store=store, arch=args.arch,
        backend=args.cache)
    allocation = plan_allocation(
        registry, profiles, total_units, total_lanes=args.prefill_lanes,
        max_k=args.decode_horizon, watermark_units=watermark_units)
    return registry, allocation, profiles


def elastic_controller(args) -> Optional[ElasticController]:
    """The ``--elastic*`` flags' controller (None without ``--elastic``)."""
    if not args.elastic:
        return None
    return ElasticController(step_units=args.elastic_step_units,
                             max_units=args.elastic_max_units,
                             min_units=args.elastic_min_units,
                             cooldown=args.elastic_cooldown)


def add_trace_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="dump a structured event trace of the run here "
                         "(analyze with repro_torch.launch.trace_report)")
    ap.add_argument("--trace-format", default="jsonl",
                    choices=["jsonl", "chrome"],
                    help="trace file format: jsonl (trace_report) or chrome "
                         "(load in ui.perfetto.dev)")
    ap.add_argument("--trace-capacity", type=int, default=1 << 16,
                    help="event ring-buffer capacity (oldest events drop "
                         "beyond this)")


def make_tracer(args) -> Optional[Tracer]:
    """The ``--trace*`` flags' tracer (None without ``--trace``)."""
    return Tracer(capacity=args.trace_capacity) if args.trace else None


def dump_trace(args, tracer: Optional[Tracer]) -> Optional[dict]:
    """Write the run's trace in ``--trace-format``; returns the summary's
    ``trace`` block (None without a tracer)."""
    if tracer is None:
        return None
    if args.trace_format == "chrome":
        write_chrome_trace(args.trace, tracer.events)
    else:
        tracer.dump_jsonl(args.trace)
    return {"path": args.trace, "format": args.trace_format,
            "events": len(tracer), "dropped": tracer.dropped}


def add_elastic_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--elastic", action="store_true",
                    help="install an ElasticController: the engine scales "
                         "the pool up/down at horizon boundaries from the "
                         "occupancy/queue/slack gauges, re-planning tenant "
                         "budgets at every reshape")
    ap.add_argument("--elastic-max-units", type=int, default=None,
                    help="proactive scale-up ceiling in cache units "
                         "(default: the constructed pool size)")
    ap.add_argument("--elastic-min-units", type=int, default=None,
                    help="proactive scale-down floor (default: no "
                         "proactive shrink)")
    ap.add_argument("--elastic-step-units", type=int, default=8,
                    help="cache units per proactive reshape")
    ap.add_argument("--elastic-cooldown", type=float, default=16.0,
                    help="decode steps between reshapes")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Static or continuous batching on the port, over the "
                    "contiguous or the paged KV cache.")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--engine", default="static",
                    choices=["static", "continuous"])
    ap.add_argument("--cache", default="contiguous",
                    choices=["contiguous", "paged"])
    ap.add_argument("--mesh", default="single", choices=["single", "host"],
                    help="host: TP/DP-sharded over the torchrun process "
                         "group")
    ap.add_argument("--policy", default="fcfs",
                    choices=["fcfs", "sjf", "slo"])
    ap.add_argument("--tenants", type=int, default=0,
                    help="register N tenants t0..tN-1 and tag the request "
                         "set across them (0 = single-tenant)")
    ap.add_argument("--slo", default="",
                    help="per-tenant latency SLO in decode steps, comma "
                         "list ('none' = no target), e.g. --slo 24,none")
    ap.add_argument("--slo-s", default="",
                    help="per-tenant wall-clock SLO in seconds (comma list; "
                         "scored in the stats, never scheduled on)")
    ap.add_argument("--tenant-weights", default="",
                    help="per-tenant fairness weights (comma list, default 1)")
    ap.add_argument("--tenant-mix", default="",
                    help="per-tenant request-count ratios (comma list, "
                         "default equal split), e.g. --tenant-mix 2,1")
    ap.add_argument("--no-tenant-alloc", dest="tenant_alloc",
                    action="store_false",
                    help="keep tenant tags + SLO scoring but drop the "
                         "profiler-planned budgets")
    ap.add_argument("--batch", type=int, default=8,
                    help="number of requests in the set")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous engine)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per block")
    ap.add_argument("--blocks", type=int, default=0,
                    help="pool size in blocks (0 = slots * ceil(max_len / "
                         "block_size))")
    ap.add_argument("--watermark", type=float, default=0.05,
                    help="fraction of blocks reserved at admission (paged)")
    ap.add_argument("--prefill-lanes", type=int, default=4,
                    help="joining requests prefilled per chunk-round")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable content-hashed prompt-block sharing (paged)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="max prompt length (lengths mixed in [len/2, len])")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="common prefix tokens prepended to every prompt")
    ap.add_argument("--min-hit-rate", type=float, default=None,
                    help="fail unless the prefix-cache hit rate reaches "
                         "this fraction")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="decode steps per captured dispatch (1 = the "
                         "classic per-token loop)")
    ap.add_argument("--eos-token", type=int, default=None,
                    help="stop a request early when it emits this token id")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop arrivals per decode step (0 = all at "
                         "once)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on per-slot lanes")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampling (0 = full vocab)")
    ap.add_argument("--verify", action="store_true",
                    help="check outputs against a static contiguous engine "
                         "with decode_horizon=1")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the request set")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_trace_flags(ap)
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="sample the metrics time series every N decode "
                         "boundaries (0 disables series sampling)")
    ap.add_argument("--profile", action="store_true",
                    help="attach a dispatch profiler: per-dispatch time "
                         "with compile/execute attribution, roofline "
                         "utilization, per-tenant cost shares (the summary "
                         "gains a 'profile' block; with --trace, "
                         "dispatch_profile events land in the trace)")
    ap.add_argument("--profile-store", default=None, metavar="PATH",
                    help="ProfileStore JSONL (e.g. build/profiles_torch."
                         "jsonl): read measured rate constants into the "
                         "tenant profiles when a fit exists; with "
                         "--profile, this run's per-signature costs are "
                         "merged back in")
    add_elastic_flags(ap)
    return ap


def requests(args) -> List[ServeRequest]:
    """The request set that ``args`` describe (the same on every call)."""
    cfg = get_config(args.arch, smoke=args.preset == "smoke")
    return make_requests(cfg, args.batch, args.prompt_len, args.max_new,
                         args.arrival_rate, seed=args.seed,
                         shared_prefix=args.shared_prefix)


def build(args, params=None, cfg=None) -> Tuple[ServeEngine,
                                               List[ServeRequest],
                                               Optional[dict]]:
    """The engine, the request set (tenant tags included) and the tenants'
    profiles (None without tenants) that ``args`` describe, with the
    tracer, profiler and profile store of the flags; the engine serves
    ``params`` when given, else weights drawn on its device, and runs
    ``cfg`` when given (a config of ``args.arch`` that the flags cannot
    name, such as a cut depth), else the arch at ``args.preset``."""
    cfg = cfg or get_config(args.arch, smoke=args.preset == "smoke")
    reqs = requests(args)
    n_slots = args.slots if args.engine == "continuous" else None
    store = (ProfileStore.load(args.profile_store) if args.profile_store
             else None)
    registry = allocation = profiles = None
    if args.tenants > 0:
        registry, allocation, profiles = build_tenancy(args, reqs, n_slots,
                                                       store=store)
    device, plan = host_plan(args, cfg, n_slots or args.batch)
    engine = ServeEngine(
        cfg, params=params, max_len=args.max_len, n_slots=n_slots,
        policy=args.policy, cache=args.cache, block_size=args.block_size,
        n_blocks=args.blocks or None, watermark=args.watermark,
        prefill_lanes=args.prefill_lanes, prefix_cache=args.prefix_cache,
        decode_horizon=args.decode_horizon, eos_token=args.eos_token,
        temperature=args.temperature, top_k=args.top_k,
        tenants=registry, allocation=allocation,
        elastic=elastic_controller(args), tracer=make_tracer(args),
        metrics_every=args.metrics_every,
        profiler=(DispatchProfiler(cfg, n_devices=plan.n_devices
                                   if plan is not None else 1)
                  if args.profile else None),
        profile_store=store, device=device, seed=args.seed, sharding=plan)
    return engine, reqs, profiles


def host_plan(args, cfg, n_slots: int):
    """(this rank's device, the sharding plan) for ``--mesh host`` (the
    process group joined, the host mesh laid over it); (``--device``,
    None) for ``--mesh single``."""
    if args.mesh != "host":
        return args.device, None
    from repro_torch.serve.sharded import make_serve_sharding
    device = init_distributed(args.device)
    plan = make_serve_sharding(cfg, n_slots, args.max_len, make_host_mesh(),
                               cache=args.cache, block_size=args.block_size,
                               n_blocks=args.blocks or None)
    return device, plan


def is_printer() -> bool:
    """Rank 0 of a process group prints the summary (every process when
    there is none)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def summary(args, engine: ServeEngine, out: List[ServeRequest],
            stats: ServeStats, profiles=None) -> dict:
    """The JSON summary of a run (``profiles``: the tenants' profiles, for
    ``calibrate_source``); writes the ``--trace`` file and, with
    ``--profile``, merges the run into the ``--profile-store`` file."""
    dev = engine.device
    record = {
        "arch": engine.cfg.arch_id,
        "preset": args.preset,
        "engine": args.engine,
        "cache": args.cache,
        "mesh": args.mesh,
        "policy": args.policy,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "slots": engine.n_slots or args.batch,
        "elastic": engine.elastic is not None,
        "graphs": "eager" if engine.graphs.is_eager else "captured",
        **dataclasses.asdict(stats),
        "sample_output": out[0].output[:8],
    }
    trace_info = dump_trace(args, engine.tracer or None)
    if trace_info is not None:
        record["trace"] = trace_info
    if engine._allocation0 is not None:
        record["tenant_budgets"] = {
            tid: dataclasses.asdict(s)
            for tid, s in sorted(engine._allocation0.shares.items())}
    if profiles is not None:
        record["calibrate_source"] = {
            tid: p.source for tid, p in sorted(profiles.items())}
    prof = engine.profiler
    if prof:
        record["profile"] = prof.summary()
        store = engine.profile_store
        if store is not None:
            store.add_run(prof, arch=args.arch, backend=args.cache)
            store.save(args.profile_store)
            record["profile"]["store"] = {"path": args.profile_store,
                                          "records": len(store)}
    return record


def verify(args, engine: ServeEngine, out: List[ServeRequest]) -> List[int]:
    """Re-run ``out``'s prompts and budgets on the classic loop — a static
    engine, contiguous cache, ``decode_horizon=1``, the same weights
    (``repro/launch/serve.py:405-425``). Returns the indices of the
    requests whose tokens differ."""
    ref_cfg = engine.cfg.replace(decode_attention="contiguous")
    ref_engine = ServeEngine(ref_cfg, params=engine.full_params(),
                             max_len=args.max_len, decode_horizon=1,
                             eos_token=args.eos_token, device=engine.device)
    ref = [ServeRequest(r.prompt.copy(), max_new_tokens=r.max_new_tokens)
           for r in out]
    ref, _ = ref_engine.run(ref)
    return [i for i, (a, b) in enumerate(zip(ref, out))
            if a.output != b.output]


def main(argv: Optional[List[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.verify and args.temperature > 0:
        ap.error("--verify is the greedy exactness path; drop --temperature")
    if args.policy == "slo" and args.tenants <= 0:
        ap.error("--policy slo needs --tenants N (slack comes from SLOs)")
    engine, reqs, profiles = build(args)
    out, stats = engine.run(reqs)
    record = summary(args, engine, out, stats, profiles)
    show = is_printer()
    if args.verify:
        mismatches = verify(args, engine, out)
        record["verified"] = not mismatches
        if mismatches:
            record["mismatched_requests"] = mismatches
            if show:
                print(json.dumps(record, indent=2))
            raise SystemExit(
                f"FAIL: request(s) {mismatches} diverged from the static "
                "contiguous engine")
    if (args.min_hit_rate is not None
            and stats.prefix_hit_rate < args.min_hit_rate):
        if show:
            print(json.dumps(record, indent=2))
        raise SystemExit(
            f"FAIL: prefix-cache hit rate {stats.prefix_hit_rate:.2f} below "
            f"the required {args.min_hit_rate:.2f}")
    if show:
        print(json.dumps(record, indent=2))


if __name__ == "__main__":
    main()
