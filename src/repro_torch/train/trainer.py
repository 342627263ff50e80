"""Training loop over the unified model API (a port of
``repro/train/trainer.py``).

Accepts any batch iterator — in particular the Synergy iterator
(``repro_torch.core.iterator``), which is how the scheduler's CPU / memory
leases reach the data pipeline. The weights come from ``Model.init`` on
``rng``, a ``torch.Generator`` (seed 0 on ``device`` when none is given);
the device defaults to the card, as the port's other entry points do.

The reference memoizes its jitted step in ``_STEP_FN_CACHE`` so many
trainers of one config (live profiling probes, restarted leases) share one
compiled program. PyTorch runs eagerly, so there is nothing to compile and
no such cache here: each trainer builds its step function, which costs
nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import state as state_lib
from repro_torch.train.optimizer import adamw, leaves, warmup_cosine


@dataclass
class TrainerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    log_every: int = 10
    ckpt_path: Optional[str] = None
    ckpt_every: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig = TrainerConfig(),
                 rng: Optional[torch.Generator] = None, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.model = build_model(cfg)
        self.optimizer = adamw(
            warmup_cosine(tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps),
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        rng = rng if rng is not None else \
            torch.Generator(device=device).manual_seed(0)
        params = self.model.init(rng)
        self.device = next(leaves(params)).device
        self.state = state_lib.create(params, self.optimizer)
        self._step_fn = state_lib.make_train_step(self.model.loss,
                                                  self.optimizer)
        self.history: List[Dict[str, float]] = []

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def maybe_restore(self) -> bool:
        p = self.tcfg.ckpt_path
        if p and ckpt_lib.exists(p):
            self.state = ckpt_lib.restore(p, self.state)
            return True
        return False

    def save(self) -> None:
        if self.tcfg.ckpt_path:
            ckpt_lib.save(self.tcfg.ckpt_path, self.state)

    def train_step(self, batch) -> Dict[str, float]:
        """One step on ``batch`` (host numpy arrays or tensors, moved to the
        trainer's device); reading the loss is the step's sync, as
        ``float(metrics["loss"])`` is in the reference."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        t0 = time.perf_counter()
        self.state, metrics = self._step_fn(self.state, batch)
        loss = float(metrics["loss"])
        rec = {"step": self.step, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]),
               "step_seconds": time.perf_counter() - t0}
        self.history.append(rec)
        return rec

    def fit(self, batches: Iterable[dict],
            max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = 0
        for batch in batches:
            self.train_step(batch)
            n += 1
            if (self.tcfg.ckpt_every and self.tcfg.ckpt_path
                    and n % self.tcfg.ckpt_every == 0):
                self.save()
            if max_steps is not None and n >= max_steps:
                break
        return self.history
