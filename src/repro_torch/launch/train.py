"""End-to-end training CLI for the port (``repro/launch/train.py``'s
flags and summary, plus ``--device``).

Trains the selected architecture at a chosen scale on the synthetic
pipeline with the full substrate (MinIO cache, checkpointing), on the card
unless ``--device cpu``. A checkpoint named by ``--ckpt`` is written every
quarter of the run and restored on the next start, in the reference's
layout (either package reads the other's).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --preset 100m --steps 300 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --preset 25m --steps 20 --ckpt build/train/m2.ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-0.5b --preset smoke --steps 4 --batch 2 --seq 16
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # name -> ArchConfig overrides (on top of the arch's family/topology)
    "smoke": dict(),                                   # the reduced smoke cfg
    "25m": dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=4,
                head_dim=64, d_ff=1536, vocab_size=8192),
    "100m": dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
    "full": None,                                      # the real config
}


def build_cfg(arch: str, preset: str):
    if preset == "full":
        return get_config(arch)
    cfg = get_config(arch, smoke=True)
    if preset != "smoke":
        over = dict(PRESETS[preset])
        if cfg.family == "moe":
            over.update(n_experts=8, top_k=2, d_ff=over["d_ff"] // 4)
        if cfg.family in ("ssm", "hybrid"):
            if cfg.family == "ssm":
                over.pop("d_ff", None)
            over.update(ssm_state=64, ssm_headdim=64)
        cfg = cfg.replace(**over)
    return cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--cache-gb", type=float, default=1.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs an NVIDIA GPU (or pass "
                         "--device cpu)")
    cfg = build_cfg(args.arch, args.preset)
    print(f"arch={cfg.arch_id} preset={args.preset} "
          f"params={cfg.param_count() / 1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    data = DataPipeline(
        DataConfig(n_samples=4096, seq_len=args.seq,
                   vocab_size=cfg.vocab_size, preprocess_cost_s=0.0),
        batch_size=args.batch, n_workers=args.workers)
    data.set_cache_gb(args.cache_gb)

    trainer = Trainer(cfg, TrainerConfig(
        peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(5, args.steps // 20), ckpt_path=args.ckpt,
        ckpt_every=max(1, args.steps // 4) if args.ckpt else 0),
        device=args.device)
    if trainer.maybe_restore():
        print(f"restored checkpoint at step {trainer.step}")

    t0 = time.time()
    hist = trainer.fit(data.batches(args.steps))
    wall = time.time() - t0
    data.close()
    steps = [h["step_seconds"] for h in hist[2:]] or [0.0]
    summary = {
        "arch": cfg.arch_id, "preset": args.preset,
        "params_m": cfg.param_count() / 1e6,
        "steps": len(hist), "wall_s": wall,
        "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
        "ms_per_step": float(np.mean(steps)) * 1e3,
        "tokens_per_s": args.batch * args.seq / max(np.mean(steps), 1e-9),
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "history": hist}, f)
    return summary


if __name__ == "__main__":
    main()
