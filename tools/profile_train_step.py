#!/usr/bin/env python3
"""Profile one train step of phi-3-vision-4.2b and of mamba2-780m on one
NVIDIA GPU and group its device time.

    python3 tools/profile_train_step.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout of this repository,
e.g. an older commit unpacked with ``git archive``; its ``chip_smoke.py``
supplies the model, the trainer and the kernels (loaded as in
``tools/time_attention_kernels.py``). Run it on two checkouts in one call
to compare them on one card.

Steps, at full width with random weights from seed 0 and AdamW:
phi-3-vision-4.2b with remat "full" on [2, 1024] tokens and [2, 576, 3072]
patch embeddings (the ``synergy`` phase's job), and mamba2-780m with remat
"full" on [2, 4096] tokens (the ``train`` phase's), and phi-3-vision-4.2b
in bf16 (``dtype`` and ``param_dtype``, the ``train-bf16`` phase's job:
the flash forward with its log-sum-exp and the bf16 backward kernel; a
checkout from before that kernel raises there). Each is warmed up by
one step and timed over two more with CUDA events (``step_ms``); then one
step runs as ``state.make_train_step`` does, in three phases (the loss's
forward, ``backward()``, the optimizer update) with a marker kernel
between them, under torch.profiler. Each phase's device time is grouped by
kernel name: ``gemm`` (cuBLAS / CUTLASS products, Hopper's bf16
``nvjet_*`` ones too), ``port_backward`` (the
backward kernels: ``flash_bwd_*``, ``ssd_scan_bwd_*``, the backward's
reversed ``ssd_scan_*<.., true>``, and the parent's ``ssd_scan_dlog`` and
``flash_bwd_prep``), ``port_forward`` (``flash_attention_kernel`` and the
forward's ``ssd_scan_*`` kernels: in the backward phase the recomputed
forward, and in the parent's SSD backward also its forward-kernel
launches) and ``other`` (elementwise, reductions, copies). Prints one JSON
line with the card's name and power limit.
"""
import gc
import json
import os
import subprocess
import sys
import time

import torch

from time_attention_kernels import HERE, load

MARKER = "spin_kernel"


def category(name: str) -> str:
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "gemm"
    if "flash_bwd" in name or "ssd_scan_bwd" in name or \
            "ssd_scan_dlog" in name or \
            ("ssd_scan_" in name and "true>" in name):
        return "port_backward"
    if "flash_attention_kernel" in name or "ssd_scan_" in name:
        return "port_forward"
    return "other"


def phases(events, n_phases: int) -> list:
    """Split the device events at the marker kernels: the non-empty runs
    of events between two markers, in order (the window's first and last
    markers pad the ends, so losing one there loses no phase)."""
    evs = sorted(events, key=lambda e: e[1])
    out, cur = [], None
    for name, a, b in evs:
        if MARKER in name:
            if cur:
                out.append(cur)
            cur = {}
            continue
        if cur is None:
            continue
        us, n = cur.get(name, (0.0, 0))
        cur[name] = (us + (b - a) / 1e3, n + 1)
    if len(out) != n_phases:
        raise SystemExit(f"FAIL: {len(out)} phases between the markers, "
                         f"want {n_phases}")
    return out


def summarize(by_name: dict) -> dict:
    cats = {}
    for name, (us, _) in by_name.items():
        c = category(name)
        cats[c] = cats.get(c, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"ms": sum(us for us, _ in by_name.values()) / 1e3,
            "by_category_ms": cats,
            "top": [{"name": k[:90], "ms": us / 1e3, "count": n}
                    for k, (us, n) in top]}


def profiled_step(cs, trainer, batch) -> dict:
    """One step as ``state.make_train_step`` runs it, with a marker kernel
    before the forward, the backward, the optimizer and after it (two at
    each end)."""
    from torch.profiler import ProfilerActivity, profile
    opt = cs.optimizer
    state = trainer.state
    params = state["params"]

    def mark():
        torch.cuda._sleep(1000)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mark()
        mark()
        loss = trainer.model.loss(params, batch)
        mark()
        loss.backward()
        mark()
        grads = opt.tree_map(lambda p: p.grad if p.grad is not None
                             else torch.zeros_like(p), params)
        trainer.optimizer.update(grads, state["opt"], params, state["step"])
        for p in opt.leaves(params):
            p.grad = None
        state["step"] += 1
        mark()
        mark()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.1)   # the window must close after the last marker
    events = [(ev.name(), ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA]
    fwd, bwd, upd = phases(events, 3)
    return {"profiled_wall_ms": 1e3 * wall, "forward": summarize(fwd),
            "backward": summarize(bwd), "optimizer": summarize(upd)}


def step_ms(trainer, batch) -> float:
    trainer.train_step(batch)
    torch.cuda.synchronize()
    st, en = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    st.record()
    for _ in range(2):
        trainer.train_step(batch)
    en.record()
    en.synchronize()
    return st.elapsed_time(en) / 2


def run(cs, arch: str, dtype: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    if arch == "phi-3-vision-4.2b":
        cfg = cs.get_config(arch).replace(remat="full", dtype=dtype,
                                          param_dtype=dtype)
        b, s = cs.SYN_B, cs.PHI_S
    else:
        cfg = cs.train_cli.build_cfg(arch, "full").replace(remat="full")
        b, s = cs.TRAIN_B, cs.TRAIN_S
    trainer = cs.Trainer(cfg, cs.TrainerConfig(warmup_steps=2), rng=g)
    pipe = cs.DataPipeline(cs.DataConfig(n_samples=b, seq_len=s,
                                         vocab_size=cfg.vocab_size), b)
    host = next(pipe.batches(1))
    pipe.close()
    if arch == "phi-3-vision-4.2b":
        batch = cs.synergy_batch(cfg, host, 0)
    else:
        batch = {k: torch.as_tensor(v).to("cuda") for k, v in host.items()}
    with torch.enable_grad():
        rec = {"arch": arch, "dtype": dtype, "remat": cfg.remat,
               "batch": [b, s],
               "step_ms": step_ms(trainer, batch)}
        rec.update(profiled_step(cs, trainer, batch))
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs, _ = load(root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    steps = [run(cs, arch, dtype) for arch, dtype in (
        ("phi-3-vision-4.2b", "float32"), ("mamba2-780m", "float32"),
        ("phi-3-vision-4.2b", "bfloat16"))]
    print(json.dumps({"checkout": root, "card": card, "steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
