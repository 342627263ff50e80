#!/usr/bin/env python3
"""Run the kernel checks or the sharded phase of ``chip_smoke.py`` alone, on
one NVIDIA GPU.

    python3 tools/chip_phases.py [kernels] [backward] [offset-backward]
        [train-bf16] [sharded] [sharded-train]

Builds the kernels (with the build phase's tensor-core check), then, as
asked (both by default): ``kernels`` holds the paged kernels at the
engine's and the other engines' shapes, their partial mode, flash with a
query offset, flash and the SSD scan against their plain versions and
prints the
``kernels`` record of those timed cases (no launch counts: no engine runs);
``backward`` holds the flash and SSD backward kernels against autograd of
their plain versions (flash in f32 and bf16) and prints their timed
cases; ``offset-backward`` holds flash's backward at a query offset the
same way and prints its timed cases; ``train-bf16`` runs that phase
(phi-3-vision-4.2b trained in bf16 at full width, one step against f32); ``sharded`` draws the engine
phase's seed-0 qwen2-0.5b weights and runs
the sharded phase (two ranks on meshes (1, 2) and (2, 1): qwen2-0.5b paged
on both and contiguous on (2, 1), mamba2-780m on both, zamba2-7b, whisper
and mamba2-780m's forward on (1, 2); four on (1, 4)),
printing its lines and each kernel's launches by path; ``sharded-train``
runs the four-rank group's two train runs alone (qwen2-0.5b on (1, 4)
and (2, 2) against the single-process step), no engine. Prints the card's
name and power limit first. The functions are ``chip_smoke.py``'s, so a
reading here is the full script's, minus the phases before it.
"""
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(what) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tools/chip_phases.py needs an NVIDIA GPU")
    t0 = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib, ptxas = cs.build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cs.print_ptxas(ptxas)
    cs.check_tensor_cores(lib)
    cs.build.library()
    if "kernels" in what:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        rec = cs.check_kernels(flush)
        cs.check_engine_shapes(flush, rec)
        rec.update(cs.check_partial(flush))
        rec["flash_attention_offset"] = cs.check_flash_offset(flush)
        rec["flash_attention"] = cs.check_flash(flush)
        rec["ssd_scan"] = cs.check_ssd(flush)
        print(json.dumps({"kernels": list(rec.values())}), flush=True)
        del flush
        print(f"kernels done {time.perf_counter() - t0:.1f} s", flush=True)
    if "backward" in what:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        recs = [*cs.check_flash_backward(flush), cs.check_ssd_backward(flush)]
        print(json.dumps({"kernels": recs}), flush=True)
        del flush
        print(f"backward done {time.perf_counter() - t0:.1f} s", flush=True)
    if "offset-backward" in what:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        print(json.dumps({"kernels": [cs.check_flash_offset_backward(
            flush)]}), flush=True)
        del flush
        print(f"offset-backward done {time.perf_counter() - t0:.1f} s",
              flush=True)
    if "train-bf16" in what:
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(cs.run_train_bf16()), flush=True)
        print(f"train-bf16 done {time.perf_counter() - t0:.1f} s",
              flush=True)
    if "sharded" in what:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = cs.get_config("qwen2-0.5b")
        params = cs.build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0))
        print(json.dumps(cs.run_sharded({}, params)), flush=True)
        print(f"sharded done {time.perf_counter() - t0:.1f} s", flush=True)
    if "sharded-train" in what:
        gc.collect()
        torch.cuda.empty_cache()
        cs.SHARD_RUNS = {world: () for world in cs.SHARD_TRAIN}
        print(json.dumps(cs.run_sharded({}, None), default=str), flush=True)
        print(f"sharded-train done {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["kernels", "sharded"])
