"""Roofline report (``repro/launch/roofline.py``): reads the dry-run's
JSONL records and prints the per-(arch x shape) table, its times on the
H100 constants of ``launch/mesh.py``. A record whose step the card
cannot run (``not_runnable``: a kernel call the CUDA route refuses) is
marked in its row and listed under the table.

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        [--jsonl build/dryrun/dryrun.jsonl] [--mesh pod]
"""
from __future__ import annotations

import argparse
import json

#: the multipod mesh (``launch/mesh.py:make_production_mesh``)
MULTIPOD = "2x32x8"


def load(jsonl: str):
    recs = {}
    with open(jsonl) as f:
        for line in f:
            r = json.loads(line)
            key = (r["arch"], r["shape"], r["mesh"], r.get("tag"))
            recs[key] = r           # last write wins (re-runs supersede)
    return recs


def _num(v, spec: str, scale: float = 1.0) -> str:
    """Format a possibly-missing numeric field; ``None`` renders as an em
    dash (a record without FLOPs has no useful-FLOP ratio)."""
    return "—" if v is None else f"{v * scale:{spec}}"


def fmt_row(r) -> str:
    """One table row; a record of a step the card cannot run (a kernel call
    the CUDA route refuses, the record's ``not_runnable``) is marked at its
    arch."""
    c, m, k = r["compute_s"], r["memory_s"], r["collective_s"]
    dom = r["bottleneck"]
    ratio = r.get("useful_flop_ratio")
    mem = r.get("memory_stats") or {}
    peak = mem.get("peak_bytes") or mem.get("bytes_per_device") or 0
    args = r.get("args_gib_per_device", "")
    arch = r["arch"] + (" (not runnable)" if r.get("not_runnable") else "")
    return (f"| {arch} | {r['shape']} | {c * 1e3:.1f} | {m * 1e3:.1f} | "
            f"{k * 1e3:.1f} | **{dom}** | {_num(ratio, '.2f')} | "
            f"{_num(r.get('flops_per_chip'), '.2f', 1e-12)} | {args} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default="build/dryrun/dryrun.jsonl")
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    recs = load(args.jsonl)

    print("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
          "bottleneck | useful-FLOP ratio | TFLOP/chip | args GiB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    rows = [r for (a, s, m, t), r in sorted(recs.items())
            if m == args.mesh and t is None]
    for r in rows:
        print(fmt_row(r))

    doms = {}
    for r in rows:
        doms[r["bottleneck"]] = doms.get(r["bottleneck"], 0) + 1
    print(f"\n{len(rows)} combos; bottleneck counts: {doms}")
    for r in rows:
        for name, why in sorted((r.get("not_runnable") or {}).items()):
            print(f"not runnable on the card: {r['arch']} {r['shape']}: "
                  f"{name}: {why}")

    # multipod pass/fail summary
    mp = [r for (a, s, m, t), r in sorted(recs.items())
          if m == "multipod" and t is None]
    print(f"multipod ({MULTIPOD} = 512 GPUs) counted: {len(mp)} combos")


if __name__ == "__main__":
    main()
