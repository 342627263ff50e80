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

Weights come from the port's ``init_params`` under a ``torch.Generator``
seeded with ``--seed`` (nothing is downloaded); the request set is the
reference driver's ``make_requests`` (``repro/launch/serve.py:98``) on the
same seed. ``--preset smoke`` is the reference's laptop-scale shape,
``full`` the published widths. ``--device`` defaults to ``cuda``; the CPU
runs the kernels' plain versions. Prints a JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.serve import ServeEngine, ServeRequest, ServeStats


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
    ap.add_argument("--batch", type=int, default=8,
                    help="number of requests in the set")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous engine)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per block")
    ap.add_argument("--blocks", type=int, default=0,
                    help="pool size in blocks (0 = slots * ceil(max_len / "
                         "block_size))")
    ap.add_argument("--prefill-lanes", type=int, default=4,
                    help="joining requests prefilled per chunk-round")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable content-hashed prompt-block sharing (paged)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="max prompt length (lengths mixed in [len/2, len])")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="common prefix tokens prepended to every prompt")
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
    return ap


def requests(args) -> List[ServeRequest]:
    """The request set that ``args`` describe (the same on every call)."""
    cfg = get_config(args.arch, smoke=args.preset == "smoke")
    return make_requests(cfg, args.batch, args.prompt_len, args.max_new,
                         args.arrival_rate, seed=args.seed,
                         shared_prefix=args.shared_prefix)


def build(args, params=None) -> Tuple[ServeEngine, List[ServeRequest]]:
    """The engine and the request set that ``args`` describe; the engine
    serves ``params`` when given, else weights drawn on its device."""
    cfg = get_config(args.arch, smoke=args.preset == "smoke")
    reqs = requests(args)
    engine = ServeEngine(
        cfg, params=params, max_len=args.max_len,
        n_slots=args.slots if args.engine == "continuous" else None,
        cache=args.cache, block_size=args.block_size,
        n_blocks=args.blocks or None, prefill_lanes=args.prefill_lanes,
        prefix_cache=args.prefix_cache,
        decode_horizon=args.decode_horizon, eos_token=args.eos_token,
        temperature=args.temperature, top_k=args.top_k, device=args.device,
        seed=args.seed)
    return engine, reqs


def run(args) -> Tuple[ServeEngine, List[ServeRequest], ServeStats]:
    """Build the engine and the request set from ``args`` and serve it."""
    engine, reqs = build(args)
    out, stats = engine.run(reqs)
    return engine, out, stats


def summary(args, engine: ServeEngine, out: List[ServeRequest],
            stats: ServeStats) -> dict:
    dev = engine.device
    return {
        "arch": engine.cfg.arch_id,
        "preset": args.preset,
        "engine": args.engine,
        "cache": args.cache,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "slots": engine.n_slots or args.batch,
        **dataclasses.asdict(stats),
        "sample_output": out[0].output[:8],
    }


def verify(args, engine: ServeEngine, out: List[ServeRequest]) -> List[int]:
    """Re-run ``out``'s prompts and budgets on the classic loop — a static
    engine, contiguous cache, ``decode_horizon=1``, the same weights
    (``repro/launch/serve.py:405-425``). Returns the indices of the
    requests whose tokens differ."""
    ref_engine = ServeEngine(engine.cfg, params=engine.params,
                             max_len=args.max_len, decode_horizon=1,
                             eos_token=args.eos_token, device=args.device)
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
    engine, out, stats = run(args)
    record = summary(args, engine, out, stats)
    if args.verify:
        mismatches = verify(args, engine, out)
        record["verified"] = not mismatches
        if mismatches:
            record["mismatched_requests"] = mismatches
            print(json.dumps(record, indent=2))
            raise SystemExit(
                f"FAIL: request(s) {mismatches} diverged from the static "
                "contiguous engine")
    print(json.dumps(record, indent=2))


if __name__ == "__main__":
    main()
