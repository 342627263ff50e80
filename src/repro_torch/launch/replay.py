"""Open-loop trace replay with deterministic fault injection, on the port
(``repro/launch/replay.py``).

Feeds a Philly-derived arrival process (``serve/replay.py``) through the
serve engine at a load while a seeded ``FaultInjector``
(``serve/chaos.py``) applies a fault schedule keyed to the engine's
decode-step clock; with ``--verify`` every request not dropped must be
token-identical to the fault-free static contiguous engine at
``decode_horizon=1`` on the same weights (exit non-zero otherwise).

    PYTHONPATH=src python -m repro_torch.launch.replay --device cpu \\
        --arch qwen2-0.5b --cache paged --slots 4 --n 16 --load 2.0 \\
        --max-len 64 --prompt-len 12 --max-new 8 \\
        --faults "slot_kill@8,prefix_flush@12,pool_shrink@16:blocks=6" \\
        --trace build/replay_trace.jsonl --verify
    python -m repro_torch.launch.replay --preset full --arch qwen2-0.5b \\
        --cache paged --slots 8 --n 24 --max-len 256 --prompt-len 64 \\
        --max-new 32 --faults "pool_shrink@8:blocks=8:restore_after=16" \\
        --elastic --verify

Fault specs are ``kind@step[:key=val...]`` (comma-separated) or a JSON
schedule via ``--faults-file`` (``FaultSchedule.to_json``). Weights come
from a ``torch.Generator`` seeded with ``--seed`` (which also seeds the
workload). ``--device`` defaults to ``cuda``. ``--trace PATH`` dumps the
replay's event trace (``--trace-format``, ``--trace-capacity`` as in
``launch/serve.py``; analyze it with ``repro_torch.launch.trace_report``).
``--mesh host`` replays TP/DP-sharded over the ``torchrun`` process group
(as ``launch/serve.py``: ``torchrun --nproc-per-node 2 -m
repro_torch.launch.replay --mesh host ...``; rank 0 prints).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import (add_elastic_flags, add_trace_flags,
                                      dump_trace, elastic_controller,
                                      host_plan, is_printer, make_tracer)
from repro_torch.serve import (FaultInjector, FaultSchedule, ServeEngine,
                               philly_requests, run_replay)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.replay",
        description="Philly-derived open-loop replay with seeded fault "
                    "injection on the port's serve engine.")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--cache", default="paged",
                    choices=["contiguous", "paged"])
    ap.add_argument("--mesh", default="single", choices=["single", "host"])
    ap.add_argument("--policy", default="fcfs",
                    choices=["fcfs", "sjf", "slo"])
    ap.add_argument("--n", type=int, default=16,
                    help="number of Philly-derived requests in the replay")
    ap.add_argument("--load", type=float, default=2.0,
                    help="mean open-loop arrival rate in requests per "
                         "decode step (Poisson)")
    ap.add_argument("--seed", type=int, default=7,
                    help="workload seed (arrivals, prompts, budgets) and "
                         "weight seed")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-schedule seed: victim picks, burst contents")
    ap.add_argument("--faults", default="",
                    help="comma-separated fault specs, each "
                         "'kind@step[:key=val...]', e.g. "
                         "'slot_kill@8,pool_shrink@16:blocks=6'")
    ap.add_argument("--faults-file", default=None, metavar="PATH",
                    help="JSON fault schedule (overrides --faults)")
    ap.add_argument("--slots", type=int, default=4,
                    help="cache-pool slots (continuous engine)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per block (paged cache)")
    ap.add_argument("--blocks", type=int, default=0,
                    help="paged pool size in blocks "
                         "(0 = slots * ceil(max_len / block_size))")
    ap.add_argument("--watermark", type=float, default=0.05,
                    help="fraction of blocks reserved at admission (paged)")
    ap.add_argument("--prefill-lanes", type=int, default=4,
                    help="joining requests prefilled per chunk-round "
                         "(paged cache)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable content-hashed prompt-block sharing (paged)")
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="max prompt length (GPU demand scales in [len/2, "
                         "len])")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="decode steps per captured dispatch (the injector "
                         "caps this so faults land on their step)")
    ap.add_argument("--eos-token", type=int, default=None,
                    help="stop a request early when it emits this token id")
    ap.add_argument("--max-admit-retries", type=int, default=4,
                    help="admission retries with exponential backoff before "
                         "a request is dropped during pool_shrink")
    add_elastic_flags(ap)
    add_trace_flags(ap)
    ap.add_argument("--verify", action="store_true",
                    help="check every non-dropped output against the "
                         "fault-free static contiguous engine")
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="sample the metrics series every N decode "
                         "boundaries (0 disables series sampling)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.preset == "smoke")
    device, plan = host_plan(args, cfg, args.slots)
    if args.faults_file:
        schedule = FaultSchedule.from_json(args.faults_file)
    else:
        schedule = FaultSchedule.from_spec(args.faults, seed=args.chaos_seed)
    injector = FaultInjector(schedule, seed=args.chaos_seed)
    reqs = philly_requests(cfg.vocab_size, args.n, load=args.load,
                           seed=args.seed, prompt_len=args.prompt_len,
                           max_new=args.max_new, max_len=args.max_len)
    elastic = elastic_controller(args)
    tracer = make_tracer(args)
    engine = ServeEngine(
        cfg, max_len=args.max_len, n_slots=args.slots, policy=args.policy,
        cache=args.cache, block_size=args.block_size,
        n_blocks=args.blocks or None, watermark=args.watermark,
        prefill_lanes=args.prefill_lanes, prefix_cache=args.prefix_cache,
        decode_horizon=args.decode_horizon, eos_token=args.eos_token,
        injector=injector, elastic=elastic,
        max_admit_retries=args.max_admit_retries, tracer=tracer,
        metrics_every=args.metrics_every, device=device, seed=args.seed,
        sharding=plan)
    res = run_replay(engine, reqs, verify=args.verify, ref_cfg=cfg,
                     ref_max_len=args.max_len)
    dev = engine.device
    record = {
        "arch": cfg.arch_id,
        "cache": args.cache,
        "mesh": args.mesh,
        "policy": args.policy,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "slots": args.slots,
        "load": args.load,
        "n_requests": len(res.requests),
        "faults": [{"kind": k, "step": s} for k, s in res.faults],
        "dropped_ids": res.dropped,
        "elastic": bool(elastic),
        "graphs": "eager" if engine.graphs.is_eager else "captured",
        **dataclasses.asdict(res.stats),
    }
    trace_info = dump_trace(args, tracer)
    if trace_info is not None:
        record["trace"] = trace_info
    if args.verify:
        record["verified"] = bool(res.verified)
        record["mismatched"] = res.mismatched
    if is_printer():
        print(json.dumps(record, indent=2, default=float))
    if args.verify and not res.verified:
        raise SystemExit(
            f"FAIL: {len(res.mismatched)} non-dropped request(s) diverged "
            f"from the fault-free reference: {res.mismatched}")


if __name__ == "__main__":
    main()
