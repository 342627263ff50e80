#!/usr/bin/env python3
"""Time the port's attention kernels of one checkout on one NVIDIA GPU.

    python3 tools/time_attention_kernels.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout of this repository,
e.g. an older commit unpacked with ``git archive``; its own
``chip_smoke.py`` supplies the kernels and the inputs, and this checkout's
``chip_smoke.py`` the timing, so two checkouts are timed the same way. Run
it on two checkouts in one call, in turns (old, new, new, old), to compare
them on one card.

Cases, float32: flash attention at olmoe-1b-7b's prefill shape
([1, S, 16, 128], causal, S 128 and 256) beside torch's
scaled_dot_product_attention; the paged prefill at qwen2-0.5b's engine
shape ([4, 16] chunks, 14 q / 2 kv heads, D 64, block 16, MB 64) beside
SDPA on the gathered K/V; the paged decode at W 8 at the engine's
positions (192-383) and at a long context (960-1022, the table full at MB
64), each beside SDPA on the gathered K/V. For each: ``ms``, the
median of 50 CUDA-event times with the stream held (``chip_smoke.time_ms``);
``unheld_ms``, the same without the hold (PR 11-13's method, which takes in
the host's enqueue cost when it exceeds the L2 flush); ``host_ms``, the
host's enqueue time per call (``chip_smoke.host_ms``); and torch.profiler's
device time per kernel over 20 more calls. Prints one JSON line.
"""
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_us(fn, flush, reps: int = 20) -> dict:
    """Mean device time per call of each kernel ``fn`` launches (the L2
    flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us and ev.count == reps:
            out[ev.key[:60]] = us / reps
    return out


def load(root: str):
    """(the checkout's chip_smoke module, this checkout's): the first
    supplies the kernels and inputs, the second the timing functions (they
    use torch alone; its repro_torch imports resolve to the checkout's,
    loaded first). Builds the checkout's kernels."""
    sys.path.insert(0, root)
    import chip_smoke as cs            # the checkout's kernels and inputs
    timing = cs
    if os.path.realpath(root) != os.path.realpath(HERE):
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
        timing = importlib.util.module_from_spec(spec)
        path = list(sys.path)
        spec.loader.exec_module(timing)
        sys.path[:] = path
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build()
    return cs, timing


def time_cases(cases: dict, timing, flush) -> dict:
    """Each case's held and un-held event times, host enqueue time and
    profiler device time per kernel."""
    return {name: {"ms": timing.time_ms(fn, flush),
                   "unheld_ms": timing.time_ms(fn, flush, hold=False),
                   "host_ms": timing.host_ms(fn),
                   "device_us": device_us(fn, flush)}
            for name, fn in cases.items()}


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs, timing = load(root)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = {}
    for s in (128, 256):
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v = (torch.randn(1, s, 16, 128, generator=g, device="cuda")
                   for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        cases[f"flash S={s}"] = (
            lambda q=q, k=k, v=v: cs.ops.flash_attention(q, k, v))
        cases[f"sdpa S={s}"] = (
            lambda qt=qt, kt=kt, vt=vt:
            torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
    args = cs.make_case(4, 16, torch.float32, seed=21, pad_row=True)
    cases["paged_prefill [4, 16]"] = (
        lambda: cs.ops.paged_prefill_attention(*args, 0))
    cases["sdpa gathered [4, 16]"] = cs.sdpa_call(*args, 16, 0)
    for what, lo, hi in (("", 192, 384), (" long", 960, 1024)):
        dargs = cs.make_case(8, 1, torch.float32, seed=8, pad_row=True,
                             lo=lo, hi=hi)
        cases[f"paged_decode W=8{what}"] = (
            lambda dargs=dargs: cs.ops.paged_attention(*dargs, 0))
        cases[f"sdpa gathered W=8{what}"] = cs.sdpa_call(*dargs, 1, 0)
    print(json.dumps({"checkout": root,
                      "device": torch.cuda.get_device_name(0),
                      "kernels": time_cases(cases, timing, flush)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
