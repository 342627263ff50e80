#!/usr/bin/env python3
"""Probe how many device events torch.profiler keeps on one NVIDIA GPU.

    python3 tools/profiler_probe.py [N ...]

For each N (default 200000, 500000, 1000000, 2000000), N one-element
launches (an in-place add on a 16-float tensor) run eagerly inside one
profiler window with device activity only, then a marker kernel
(``torch.cuda._sleep``), and the window stays open 0.1 s past it, as
``chip_smoke.py:profile_call`` does. Prints, per N, the events the
profiler returned, the device events among them against the N + 1
launched, whether the marker was seen, and the seconds the run, the
events() call and one pass over the events took: what an exact count of
kernel events over an engine run of N launches can expect. The first line
is the card's name and power limit.
"""
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def probe(n: int, x: torch.Tensor) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    device = marker = 0
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device += 1
            marker += "spin_kernel" in ev.name()
    return {"launches": n + 1, "events": len(events), "device_events": device,
            "lost": n + 1 - device, "marker": marker,
            "run_s": t1 - t0, "events_s": t2 - t1,
            "scan_s": time.perf_counter() - t2}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sizes = [int(a) for a in sys.argv[1:]] or [200000, 500000, 1000000,
                                               2000000]
    x = torch.zeros(16, device="cuda")
    for n in sizes:
        print(json.dumps(probe(n, x)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
