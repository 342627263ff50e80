#!/usr/bin/env python3
"""Time the port's grouped matmul and SSD scan of one checkout on one GPU.

    python3 tools/time_gmm_ssd_kernels.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout of this repository,
e.g. an older commit unpacked with ``git archive``; its ``chip_smoke.py``
supplies the kernels and this checkout's the timing, as in
``tools/time_attention_kernels.py`` (whose loader and per-case readings
this reuses). Run it on two checkouts in one call, in turns (old, new, new,
old), to compare them on one card.

Cases: the grouped matmul at olmoe-1b-7b's expert shapes (64 experts x 40
rows, gate-up [2048, 2048] and down [1024, 2048]), every row valid, f32 and
bf16, each beside ``torch.bmm`` on the same inputs; the SSD scan at
mamba2-780m's forward shape ([2, 4096] tokens, 48 heads of 64, state 128,
chunk 256, f32). Prints one JSON line.
"""
import json
import os
import sys

import torch

from time_attention_kernels import HERE, load, time_cases

#: olmoe-1b-7b's experts, capacity at a 256-token prompt, d_model, expert
#: width; mamba2-780m's forward batch, sequence, heads, head dim, state,
#: chunk
E, C, DM, F = 64, 40, 2048, 1024
B, S, H, P, N, Q = 2, 4096, 48, 64, 128, 256


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs, timing = load(root)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, (k, n) in (("gate-up", (DM, 2 * F)), ("down", (F, DM))):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(E, C, k, generator=g, device="cuda").to(dtype)
            w = (torch.randn(E, k, n, generator=g, device="cuda")
                 / k ** 0.5).to(dtype)
            what = f"{name} {str(dtype)[6:]}"
            cases[f"grouped_matmul {what}"] = (
                lambda x=x, w=w: cs.ops.grouped_matmul(x, w))
            cases[f"bmm {what}"] = lambda x=x, w=w: torch.bmm(x, w)
    x = torch.randn(B, S, H, P, generator=g, device="cuda")
    a = -torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device="cuda"))
    bm, cm = (torch.randn(B, S, H, N, generator=g, device="cuda") * 0.5
              for _ in range(2))
    cases["ssd_scan [2, 4096, 48, 64]"] = (
        lambda: cs.ops.ssd_scan(x, a, bm, cm, chunk=Q))
    print(json.dumps({"checkout": root,
                      "device": torch.cuda.get_device_name(0),
                      "kernels": time_cases(cases, timing, flush)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
