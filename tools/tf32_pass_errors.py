#!/usr/bin/env python3
"""How far one TF32 pass and three miss f32 in the two backward kernels.

    PYTHONPATH=src python3 tools/tf32_pass_errors.py

Runs on the CPU, with the tests' packages: the emulations of
``tests/test_torch_backward.py`` (the kernels' decompositions, every
product as ``mma.sync`` TF32 computes it, one pass or three) against
autograd of the port's plain backwards in f32, at the train and serving
shapes' own S, D (flash) and S, P, N, Q (SSD) with 4 heads (the card's runs
have 16-112: more heads only add samples of the same error). Prints one
JSON line: each case's largest error relative to the largest gradient, for
one pass and for three, beside the card's tolerances (``chip_smoke.py``'s
FLASH_BWD_TOL and SSD_BWD_TOL).
"""
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from tests import test_torch_backward as tb  # noqa: E402

#: (b, s, heads, d, the CTA shape's groups that the kernel picks there)
FLASH = {"phi-3-vision train": (1, 1024, 4, 96, 4),
         "olmoe": (1, 256, 4, 128, 2), "whisper": (1, 448, 4, 64, 2)}
SSD = {"mamba2-780m train": (1, 4096, 4, 64, 128, 256),
       "zamba2-7b": (1, 4096, 4, 64, 64, 256)}
TOL = {"flash": 2e-5, "ssd": 5e-4}


def main() -> int:
    out = {}
    for what, (b, s, h, d, groups) in FLASH.items():
        arrays = tb._flash_case(b, s, h, h, d, np.float32, 3)
        want = fa.flash_attention_backward_plain(
            *map(torch.from_numpy, arrays), True, 0)
        out[f"flash {what} {[b, s, h, d]}"] = {
            f"{passes}_pass": max(tb._rel(
                tb._flash_emulate(arrays, True, 0, passes, groups=groups),
                want))
            for passes in (1, 3)} | {"card_tol": TOL["flash"]}
    for what, (b, s, h, p, n, q) in SSD.items():
        arrays = tb._ssd_case(b, s, h, p, n, np.float32, 3)
        want = ssd.ssd_scan_backward_plain(
            *map(torch.from_numpy, arrays[:4]), torch.from_numpy(arrays[4]),
            chunk=q)
        out[f"ssd {what} {[b, s, h, p]} N={n} Q={q}"] = {
            f"{passes}_pass": max(tb._rel(tb._ssd_emulate(arrays, q, passes),
                                          want))
            for passes in (1, 3)} | {"card_tol": TOL["ssd"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
