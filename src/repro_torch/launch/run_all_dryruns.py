"""Drive the full dry-run sweep (``repro/launch/run_all_dryruns.py``):
every (arch x shape x mesh) combination.

Each combo runs in its own subprocess (``python -m
repro_torch.launch.dryrun``: isolation against a failing combination) and
appends a JSON line to the output file. Single-pod runs carry the
two-point probes (beside the full count); multi-pod runs and ``--mesh
host`` (``make_host_mesh``'s layout over ``REPRO_DRYRUN_DEVICES`` ranks)
skip them.

    PYTHONPATH=src python -m repro_torch.launch.run_all_dryruns \
        --out build/dryrun/dryrun.jsonl [--mesh pod|multipod|host|both]

``--archs``/``--shapes`` filter the sweep (comma lists) and ``--smoke``
swaps in each arch's smoke variant:

    python -m repro_torch.launch.run_all_dryruns --mesh host --smoke \
        --archs qwen2-0.5b,mamba2-780m --shapes decode_32k \
        --out build/dryrun/dryrun.jsonl

``--profile-store PATH`` folds the sweep's roofline terms (FLOPs/HBM
bytes per chip, bound times, bottleneck) into the port's
``obs.ProfileStore`` next to the serve engine's measured dispatch records:
the per-(arch x shape x mesh) placement profile of the steps the card can
run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config

SKIPS = {}  # (arch, shape) -> reason, filled below

for _arch in ARCH_IDS:
    _cfg = get_config(_arch)
    if not _cfg.supports_long_decode:
        SKIPS[(_arch, "long_500k")] = (
            "full-attention arch: long_500k requires sub-quadratic attention")


def combos(mesh_opt: str, archs=None, shapes=None):
    meshes = ["pod", "multipod"] if mesh_opt == "both" else [mesh_opt]
    for arch in (archs or ARCH_IDS):
        for shape in (shapes or INPUT_SHAPES):
            if (arch, shape) in SKIPS:
                continue
            for mesh in meshes:
                yield arch, shape, mesh


def _csv_filter(spec, universe, flag):
    if not spec:
        return None
    vals = [p.strip() for p in spec.split(",") if p.strip()]
    bad = [v for v in vals if v not in universe]
    if bad:
        raise SystemExit(f"{flag}: unknown entries {bad} "
                         f"(known: {sorted(universe)})")
    return vals


def store_from_jsonl(out_path: str, store_path: str) -> int:
    """Fold every dry-run record in ``out_path`` into the ProfileStore at
    ``store_path`` (keyed merge — re-runs supersede), but a record of a
    step the card cannot run (``not_runnable``), which would place a job
    that raises. Returns the store's record count."""
    from repro_torch.obs import ProfileStore

    store = ProfileStore.load(store_path)
    with open(out_path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rec = json.loads(line)
                    if not rec.get("not_runnable"):
                        store.add_dryrun_record(rec)
                except (json.JSONDecodeError, KeyError):
                    continue
    store.save(store_path)
    return len(store)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun/dryrun.jsonl")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "host", "both"])
    ap.add_argument("--archs", default=None,
                    help="comma list of arch ids to sweep (default: all)")
    ap.add_argument("--shapes", default=None,
                    help="comma list of input shapes to sweep (default: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="use each arch's smoke variant (CI-sized sweep)")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the two-point probes on every mesh (multipod "
                         "and host always skip them)")
    ap.add_argument("--profile-store", default=None, metavar="PATH",
                    help="also fold the sweep's roofline terms into this "
                         "obs.ProfileStore JSONL (placement profile)")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--resume", action="store_true",
                    help="skip combos already present in --out")
    args = ap.parse_args(argv)

    archs = _csv_filter(args.archs, set(ARCH_IDS), "--archs")
    shapes = _csv_filter(args.shapes, set(INPUT_SHAPES), "--shapes")

    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    todo = [c for c in combos(args.mesh, archs, shapes) if c not in done]
    print(f"{len(todo)} combos to run "
          f"({len(SKIPS)} documented skips: "
          f"{sorted(set(a for a, _ in SKIPS))})",
          flush=True)
    failures = []
    for i, (arch, shape, mesh) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", args.out]
        if mesh in ("multipod", "host") or args.no_probe:
            cmd.append("--no-probe")
        if args.smoke:
            cmd += ["--cfg-json", '{"smoke": true}']
        t0 = time.time()
        print(f"[{i + 1}/{len(todo)}] {arch} {shape} {mesh} ...",
              end=" ", flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            if r.returncode != 0:
                failures.append((arch, shape, mesh, r.stderr[-2000:]))
                print(f"FAIL ({time.time() - t0:.0f}s)", flush=True)
            else:
                print(f"ok ({time.time() - t0:.0f}s)", flush=True)
        except subprocess.TimeoutExpired:
            failures.append((arch, shape, mesh, "timeout"))
            print("TIMEOUT", flush=True)

    if args.profile_store and os.path.exists(args.out):
        n = store_from_jsonl(args.out, args.profile_store)
        print(f"profile store: {args.profile_store} now holds {n} records",
              flush=True)

    print(f"\ndone: {len(todo) - len(failures)} ok, {len(failures)} failed")
    for arch, shape, mesh, err in failures:
        print(f"--- FAIL {arch} {shape} {mesh}\n{err[:800]}")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
