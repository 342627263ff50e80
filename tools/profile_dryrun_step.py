#!/usr/bin/env python3
"""Hold the dry-run's byte count of one step against the card, op by op.

    python3 tools/profile_dryrun_step.py [N_LAYERS]

Builds the dry-run's program of qwen2-0.5b at decode_32k on the card's
host mesh (one GPU, bf16, 128 rows of a 32768-token cache;
``chip_smoke.py``'s ``dryrun`` phase), at ``N_LAYERS`` layers (default 4,
so the step stays short), and counts it on meta tensors with the bytes of
each aten op kept apart. Then it draws the arguments on the card from a
seeded generator, runs one step to warm up, one timed on CUDA events and
one under torch.profiler (CUDA activity). Prints the dry-run's bytes of
the largest aten ops beside their time at the HBM peak
(``launch/mesh.py``), the device time of the largest aten ops (their own
kernels) and of the largest kernels, one JSON line each, and one line
with the card's name and power limit, the step's ms, the profiled device
ms and the dry-run's memory term.
"""
import collections
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import HBM_BW  # noqa: E402
from repro_torch.models.api import materialize  # noqa: E402


class _ByOp(dryrun.CountingMode):
    """The counting mode with each op's bytes kept apart."""

    def __init__(self, args):
        super().__init__(args)
        self.by_op = collections.Counter()

    def _moved(self, func, args, kwargs, out):
        n = super()._moved(func, args, kwargs, out)
        self.by_op[func.overloadpacket.__name__] += n
        return n


def main() -> None:
    n_layers = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rec, prog = dryrun.lower_combo("qwen2-0.5b", "decode_32k", False,
                                   probe=False, mesh_kind="host", ranks=1,
                                   extra_cfg={"n_layers": n_layers})
    with prog.rules(), _ByOp(prog.args) as cm:
        prog.run(*prog.args)
    args = materialize(prog.args,
                       torch.Generator(device="cuda").manual_seed(0),
                       prog.cfg.vocab_size)
    from torch.profiler import ProfilerActivity, profile
    with prog.rules():
        prog.run(*args)
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        ev[0].record()
        prog.run(*args)
        ev[1].record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.run(*args)
            torch.cuda.synchronize()
    by_aten, by_kernel = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        into = by_aten if e.key.startswith("aten::") else by_kernel
        into[e.key] += e.self_device_time_total
    total_us = sum(by_kernel.values())
    for op, nbytes in cm.by_op.most_common(12):
        print(json.dumps({"dry_op": op, "dry_bytes": nbytes,
                          "bytes_over_hbm_ms": 1e3 * nbytes / HBM_BW}),
              flush=True)
    for key, us in by_aten.most_common(12):
        if us:
            print(json.dumps({"aten_op": key, "device_ms": us / 1e3}),
                  flush=True)
    for key, us in by_kernel.most_common(12):
        if us:
            print(json.dumps({"kernel": key[:120], "device_ms": us / 1e3}),
                  flush=True)
    print(json.dumps({
        "card": smi, "layers": n_layers, "step_ms": ev[0].elapsed_time(ev[1]),
        "profiled_device_ms": total_us / 1e3,
        "memory_s_ms": 1e3 * rec["memory_s"],
        "dry_bytes": rec["bytes_per_chip"]}), flush=True)


if __name__ == "__main__":
    main()
