#!/usr/bin/env python3
"""Time the port's two backward kernels of one checkout on one NVIDIA GPU.

    python3 tools/time_backward_kernels.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout of this repository,
e.g. an older commit unpacked with ``git archive``; its ``chip_smoke.py``
supplies the kernels and this checkout's the timing, as in
``tools/time_attention_kernels.py`` (whose loader this reuses). Run it on
two checkouts in one call, in turns (old, new, new, old), to compare them
on one card.

Cases, float32 (the flash backward and its SDPA yardsticks in bfloat16
too; a checkout from before the bf16 backward raises there), each called
as the training step calls it:
  * the flash backward (``ops.flash_attention_backward`` with the forward's
    output, and its row log-sum-exp where the checkout's forward hands one
    over) at phi-3-vision-4.2b's train shape [2, 1024, 32, 96],
    olmoe-1b-7b's [1, 256, 16, 128] and whisper-large-v3's [1, 448, 20, 64]
    (causal), each beside SDPA's forward + ``autograd.grad`` and SDPA's
    forward alone on the same inputs, and, where the checkout's wrapper
    takes ``groups``, with each CTA shape forced (4 x 2 where D <= 96, and
    2 x 4);
  * the SSD backward (``ops.ssd_scan_backward`` with the forward's chunk
    states) at mamba2-780m's train shape [2, 4096, 48, 64], N 128, and
    zamba2-7b's [1, 4096, 112, 64], N 64 (chunk 256);
  * the flash forward at its serving shapes (olmoe [1, 256, 16, 128],
    phi-3-vision [1, 1024, 32, 96], whisper [1, 448, 20, 64]) under
    ``torch.no_grad``, where no log-sum-exp is asked for.
For each: ``ms``, the median of 50 CUDA-event times with the stream held
(``chip_smoke.time_ms``), and the profiler's device time and launches per
call of each kernel it runs. Prints one JSON line with the card's name and
power limit.
"""
import inspect
import json
import os
import subprocess
import sys

import torch

from time_attention_kernels import HERE, load

FLASH = {"phi-3-vision train": (2, 1024, 32, 96),
         "olmoe": (1, 256, 16, 128), "whisper": (1, 448, 20, 64)}
SSD = {"mamba2-780m train": (2, 4096, 48, 64, 128),
       "zamba2-7b": (1, 4096, 112, 64, 64)}
SERVE = {"olmoe": (1, 256, 16, 128), "phi-3-vision": (1, 1024, 32, 96),
         "whisper": (1, 448, 20, 64)}
Q = 256


def kernels_per_call(fn, flush, reps: int = 10) -> dict:
    """Each kernel ``fn`` launches: device us and launches per call (the L2
    flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us and ev.count % reps == 0 and "fill" not in ev.key:
            out[ev.key[:70]] = {"us": us / reps,
                                "launches": ev.count // reps}
    return out


def flash_cases(cs, dtype=torch.float32) -> dict:
    """The flash backward (with the forward's lse where the checkout's
    forward returns one), SDPA's forward + backward and SDPA's forward."""
    lse_ok = "return_lse" in inspect.signature(
        cs.fa.flash_attention_cuda).parameters
    shapes = "groups" in inspect.signature(
        cs.fa.flash_attention_backward_cuda).parameters
    cases = {}
    for what, (b, s, h, d) in FLASH.items():
        g = torch.Generator(device="cuda").manual_seed(s + h)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        if dtype is not torch.float32:
            what = f"{what} {str(dtype)[6:]}"
        if lse_ok:
            o, lse = cs.fa.flash_attention_cuda(q, k, v, return_lse=True)
            kw = {"lse": lse}
        else:
            o, kw = cs.fa.flash_attention_cuda(q, k, v), {}
        cases[f"flash_backward {what} {[b, s, h, d]}"] = (
            lambda q=q, k=k, v=v, o=o, do=do, kw=kw:
            cs.ops.flash_attention_backward(q, k, v, o, do, **kw))
        for groups in ((4, 2) if d <= 96 else (2,)) if shapes else ():
            cases[f"flash_backward {what} groups={groups}"] = (
                lambda q=q, k=k, v=v, o=o, do=do, kw=kw, groups=groups:
                cs.fa.flash_attention_backward_cuda(q, k, v, o, do,
                                                    groups=groups, **kw))
        cases[f"sdpa fwd+bwd {what}"] = cs.sdpa_backward(q, k, v, do)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        cases[f"sdpa fwd {what}"] = (
            lambda qt=qt, kt=kt, vt=vt:
            torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
    return cases


def ssd_cases(cs) -> dict:
    """The SSD backward with the forward's chunk states, as the autograd
    Function calls it (the parent took them as ``fwd=(y, states)``)."""
    params = inspect.signature(cs.ops.ssd_scan_backward).parameters
    cases = {}
    for what, (b, s, h, p, n) in SSD.items():
        x, a, bm, cm = cs.ssd_case(b, s, h, p, n, s + h + n + 1)
        dy = torch.randn_like(x)
        y, st = cs.ssd.ssd_scan_cuda(x, a, bm, cm, chunk=Q,
                                     return_states=True)
        kw = {"states": st} if "states" in params else {"fwd": (y, st)}
        cases[f"ssd_scan_backward {what} {[b, s, h, p]} N={n}"] = (
            lambda x=x, a=a, bm=bm, cm=cm, dy=dy, kw=kw:
            cs.ops.ssd_scan_backward(x, a, bm, cm, dy, chunk=Q, **kw))
    return cases


def serve_cases(cs) -> dict:
    cases = {}
    for what, (b, s, h, d) in SERVE.items():
        g = torch.Generator(device="cuda").manual_seed(s + d)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   for _ in range(3))
        cases[f"flash forward {what} {[b, s, h, d]}"] = (
            lambda q=q, k=k, v=v: cs.ops.flash_attention(q, k, v))
    return cases


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs, timing = load(root)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    out = {}
    with torch.no_grad():
        for cases in (flash_cases(cs), flash_cases(cs, torch.bfloat16),
                      ssd_cases(cs), serve_cases(cs)):
            for name, fn in cases.items():
                if name.startswith("sdpa fwd+bwd"):
                    with torch.enable_grad():
                        out[name] = {"ms": timing.time_ms(fn, flush,
                                                          reps=20)}
                    continue
                out[name] = {"ms": timing.time_ms(fn, flush),
                             "kernels": kernels_per_call(fn, flush)}
            del cases
            torch.cuda.empty_cache()
    print(json.dumps({"checkout": root, "card": card, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
