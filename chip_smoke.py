#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. device    — require a CUDA device, print the card's name and power
                 limit, turn TF32 off;
  2. build     — compile the CUDA kernels from src/repro_torch/kernels/csrc
                 into build/kernels/ with nvcc for sm_90a;
  3. kernels   — hold each kernel against its plain PyTorch version on the
                 card at the serve path's shapes for qwen2-0.5b (f32 and
                 bf16, window 0 and 5, an all -1 table row), and time the
                 kernel, the plain version and, as a yardstick the port never
                 calls, torch's scaled_dot_product_attention on the gathered
                 K/V (each launch behind an L2 flush, as the serve loop
                 finds the cache cold after 23 other layers);
  4. reference — the paged prefill + decode path on the card against the
                 same path on the CPU (plain versions, which the CPU tests
                 hold against the JAX package) at the smoke shape;
  5. engine    — the full-width qwen2-0.5b paged engine (24 layers, random
                 weights from a seed) through repro_torch.launch.serve's own
                 run function: 16 requests of 128-256 tokens after a shared
                 64-token prefix, 64 new tokens each, 8 slots, 4 prefill
                 lanes, decode horizon 8, block 16, max_len 1024, float32.
                 Both kernels must launch in this run and the plain versions
                 must not run;
  6. profile   — torch.profiler over a shorter run at the same widths:
                 device busy share and device time by kernel.

The last two lines are the kernels record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

HQ, HKV, D, BS, MAX_LEN, SLOTS = 14, 2, 64, 16, 1024, 8
MB = MAX_LEN // BS
NB = SLOTS * MB
#: tests/test_kernels.py's tolerances
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: H100 SXM data-sheet peaks (bytes/s; f32 FLOP/s outside the tensor cores)
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
ENGINE_ARGS = ["--arch", "qwen2-0.5b", "--preset", "full", "--engine",
               "continuous", "--cache", "paged", "--slots", str(SLOTS),
               "--batch", "16", "--block-size", str(BS), "--prefill-lanes",
               "4", "--prompt-len", "256", "--shared-prefix", "64",
               "--max-new", "64", "--max-len", str(MAX_LEN),
               "--decode-horizon", "8", "--seed", "0", "--device", "cuda"]
KERNELS = {
    "paged_decode": dict(
        wrapper=ops.paged_attention, plain=pa.paged_attention_plain,
        replaces="src/repro/kernels/paged_attention.py:202"),
    "paged_prefill": dict(
        wrapper=ops.paged_prefill_attention,
        plain=pa.paged_prefill_attention_plain,
        replaces="src/repro/kernels/paged_attention.py:154"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# kernel inputs, bound, timing
# ---------------------------------------------------------------------------
def make_case(b: int, c: int, dtype, seed: int, pad_row: bool):
    """Inputs at the serve path's shapes: a [NB, BS, Hkv, D] pool, rows at
    positions 192..383 (prompt + decode of the engine phase) holding
    distinct scattered blocks, optionally a last all -1 (padding) row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(NB, BS, HKV, D, generator=g, device="cuda").to(dtype)
    vp = torch.randn(NB, BS, HKV, D, generator=g, device="cuda").to(dtype)
    start = torch.randint(192, 384 - c, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
    perm = torch.randperm(NB, generator=g, device="cuda").to(torch.int32)
    tables = torch.full((b, MB), -1, dtype=torch.int32, device="cuda")
    for i in range(b - 1 if pad_row else b):
        n = (int(start[i]) + c - 1) // BS + 1
        tables[i, :n] = perm[i * MB:i * MB + n]
    q = torch.randn(b, c, HQ, D, generator=g, device="cuda").to(dtype)
    return (q[:, 0] if c == 1 else q), kp, vp, tables, start


def bound_terms(q, kp, tables, start, c: int, window: int):
    """Least time for this call's work: every needed byte read once (q,
    the K/V blocks some query sees, tables, positions) and the output
    written once, over HBM bandwidth; the QK and PV flops of the visible
    (query, key) pairs over the f32 peak. Returns (bytes ms, ops ms)."""
    elem = q.element_size()
    tab, st = tables.cpu().numpy(), start.cpu().numpy()
    nbytes = 2 * q.numel() * elem + tables.numel() * 4 + start.numel() * 4
    pairs = 0
    for b in range(tab.shape[0]):
        s0 = int(st[b])
        for j in range(MB):
            k0 = j * BS
            if tab[b, j] < 0 or k0 > s0 + c - 1:
                continue
            if window and k0 + BS - 1 <= s0 - window:
                continue
            nbytes += 2 * BS * HKV * D * elem
            for qi in range(c):
                qpos = s0 + qi
                lo = qpos - window + 1 if window else 0
                pairs += max(0, min(qpos, k0 + BS - 1) - max(lo, k0) + 1)
    return 1e3 * nbytes / HBM_BPS, 1e3 * 4 * D * HQ * pairs / F32_FLOPS


def time_ms(fn, flush: torch.Tensor, reps: int = 50) -> float:
    """Median CUDA-event time of ``fn`` with the L2 flushed before each
    launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in ev)[reps // 2]


def sdpa_call(q, kp, vp, tables, start, c: int, window: int):
    """torch's scaled_dot_product_attention over the gathered K/V with the
    same mask: the library yardstick (gather and mask built outside)."""
    kg, vg, k_pos, assigned = pa.paged_kv_gather(kp, vp, tables)
    qq = (q[:, None] if c == 1 else q).transpose(1, 2)           # [B,Hq,C,D]
    g = HQ // HKV
    kk = kg.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vv = vg.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    q_pos = (start.long()[:, None]
             + torch.arange(c, device="cuda")[None, :])[:, :, None]
    mask = assigned[:, None, :] & (k_pos <= q_pos)
    if window:
        mask &= k_pos > q_pos - window
    mask = mask[:, None]                                         # [B,1,C,K]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask)


def check_kernels(flush: torch.Tensor) -> dict:
    """Every kernel against its plain version; time the main-path case
    (float32, window 0: decode W=8, prefill [4, 16])."""
    rec = {}
    for name, kern in KERNELS.items():
        shapes = [(1, 1), (8, 1)] if name == "paged_decode" else [(4, 16)]
        for (b, c) in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                for window in (0, 5):
                    args = make_case(b, c, dtype, seed=b * 131 + c + window,
                                     pad_row=b > 1)
                    out = kern["wrapper"](*args, window)
                    exp = kern["plain"](*args, window)
                    torch.cuda.synchronize()
                    err = (out.float() - exp.float()).abs().max().item()
                    tol = TOL[dtype]
                    ok = torch.allclose(out.float(), exp.float(), atol=tol,
                                        rtol=tol)
                    pad_ok = b == 1 or bool((out[-1] == 0).all())
                    print(f"{name} B={b} C={c} {str(dtype)[6:]} window="
                          f"{window}: max_abs_err={err:.3e} (tol {tol})"
                          f"{'' if pad_ok else ' PAD ROW NOT ZERO'}",
                          flush=True)
                    if not (ok and pad_ok):
                        raise SystemExit(f"FAIL: {name} disagrees with its "
                                         "plain version")
                    if dtype is torch.float32 and window == 0 and b > 1:
                        q, kp, vp, tables, start = args
                        ms = time_ms(lambda: kern["wrapper"](*args, 0), flush)
                        plain_ms = time_ms(lambda: kern["plain"](*args, 0),
                                           flush)
                        lib_ms = time_ms(sdpa_call(q, kp, vp, tables, start,
                                                   c, 0), flush)
                        bytes_ms, ops_ms = bound_terms(q, kp, tables, start,
                                                    c, 0)
                        bms = max(bytes_ms, ops_ms)
                        by = "bytes" if bytes_ms >= ops_ms else "operations"
                        rec[name] = dict(
                            name=name, route="cuda",
                            source="src/repro_torch/kernels/csrc/"
                                   "paged_attention.cu",
                            replaces=kern["replaces"], launches=0,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=lib_ms,
                            bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms,
                            shape=dict(B=b, C=c, Hq=HQ, Hkv=HKV, D=D, BS=BS,
                                       MB=MB, dtype="float32"))
                        print(f"{name} B={b} C={c} float32: kernel {ms:.4f} "
                              f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f}"
                              f" ms, bound {bms:.5f} ms ({by}; bytes "
                              f"{bytes_ms:.5f}, operations {ops_ms:.5f})",
                              flush=True)
    return rec


# ---------------------------------------------------------------------------
# reference: the card against the CPU at the smoke shape
# ---------------------------------------------------------------------------
def paged_logits(model, params, device):
    """Chained lane-batched prefill of two prompts through scattered block
    tables, then four decode steps; returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, model.cfg.vocab_size, (n,), generator=g)
               for n in (40, 27)]
    cache = model.init_paged_cache(16, BS, device=device)
    tables = torch.tensor([[9, 2, 14, 5], [3, 11, 7, -1]], dtype=torch.int32)
    outs = []
    for r in range(3):
        tok = torch.zeros((2, BS), dtype=torch.int32)
        nv = torch.zeros((2,), dtype=torch.int32)
        tb = torch.full_like(tables, -1)
        for i, p in enumerate(prompts):
            n = max(0, min(BS, len(p) - r * BS))
            tok[i, :n], nv[i] = p[r * BS:r * BS + n], n
            if n:
                tb[i] = tables[i]
        start = torch.full((2,), r * BS, dtype=torch.int32)
        logits, cache, _ = model.paged_prefill_chunk(
            params, cache, tok.to(device), start.to(device), tb.to(device),
            n_valid=nv.to(device))
        outs.append(logits.cpu())
    tok = torch.tensor([[5], [7]], dtype=torch.int32)
    pos = torch.tensor([40, 27], dtype=torch.int32)
    for _ in range(4):
        logits, cache = model.paged_decode_step(
            params, cache, tok.to(device), pos.to(device), tables.to(device))
        outs.append(logits.cpu())
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).cpu()
        pos += 1
    return outs


def check_reference() -> None:
    cfg = get_config("qwen2-0.5b", smoke=True)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu = {"emb": {k: v.cuda() for k, v in cpu["emb"].items()},
           "layers": [{g: ({k: v.cuda() for k, v in d.items()}
                           if isinstance(d, dict) else d.cuda())
                       for g, d in lp.items()} for lp in cpu["layers"]],
           "final_norm": cpu["final_norm"].cuda()}
    with torch.inference_mode():
        ref = paged_logits(model, cpu, "cpu")
        got = paged_logits(model, gpu, "cuda")
    # float32 on both, different summation orders (cuBLAS vs CPU BLAS, the
    # kernel's online softmax vs the plain version's single pass): logits
    # agree to ~1e-5; 1e-3 leaves margin without hiding a wrong mask.
    worst = max((a - b).abs().max().item() for a, b in zip(ref, got))
    print(f"card vs CPU, {len(ref)} logits tensors: max_abs_diff="
          f"{worst:.3e} (tol 1e-3)", flush=True)
    if not all(torch.allclose(a, b, atol=1e-3, rtol=1e-3)
               for a, b in zip(ref, got)):
        raise SystemExit("FAIL: the card's paged path disagrees with the CPU")


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def run_engine() -> dict:
    args = serve_cli.build_parser().parse_args(ENGINE_ARGS)
    for fn in (ops.paged_attention, ops.paged_prefill_attention):
        fn.launches = 0
    for fn in (pa.paged_attention_plain, pa.paged_prefill_attention_plain):
        fn.calls = 0
    torch.cuda.synchronize()
    engine, out, stats = serve_cli.run(args)
    torch.cuda.synchronize()
    launches = {"paged_decode": ops.paged_attention.launches,
                "paged_prefill": ops.paged_prefill_attention.launches}
    plain_calls = (pa.paged_attention_plain.calls
                   + pa.paged_prefill_attention_plain.calls)
    vocab = engine.cfg.vocab_size
    for r in out:
        if len(r.output) != args.max_new or not all(
                0 <= t < vocab for t in r.output):
            raise SystemExit(f"FAIL: request {r.job_id} holds {r.output}")
    audit = engine.pool.audit()
    finite = bool(torch.isfinite(engine.pool.buffers.k_buf).all()
                  and torch.isfinite(engine.pool.buffers.v_buf).all())
    keys = ("n_requests", "new_tokens", "wall_s", "tokens_per_s",
            "prefill_s", "decode_s", "prefill_dispatches",
            "decode_dispatches", "host_syncs", "steps", "preemptions",
            "prefix_hit_rate", "decode_rows_saved", "mean_latency_s")
    print(json.dumps({"engine": {k: getattr(stats, k) for k in keys},
                      "launches": launches, "plain_calls": plain_calls,
                      "audit": audit, "kv_finite": finite,
                      "sample_output": out[0].output[:8]}), flush=True)
    if not finite:
        raise SystemExit("FAIL: non-finite values in the KV pools")
    if stats.prefix_hit_rate <= 0:
        raise SystemExit("FAIL: the shared prefix never hit the cache")
    if min(launches.values()) <= 0 or plain_calls:
        raise SystemExit(f"FAIL: launches {launches}, plain calls "
                         f"{plain_calls}: the engine did not run the kernels")
    return launches


def profile_engine() -> None:
    """torch.profiler over a shorter engine run at the same widths (8
    requests, 16 new tokens): the device's busy share of the wall clock
    and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    args = serve_cli.build_parser().parse_args(
        ENGINE_ARGS + ["--batch", "8", "--max-new", "16"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = serve_cli.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_name[ev.key] = (by_name.get(ev.key, (0.0, 0))[0] + us,
                           by_name.get(ev.key, (0.0, 0))[1] + ev.count)
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    ours = sum(us for k, (us, _) in by_name.items() if "paged_" in k) / 1e6
    print(json.dumps({"profile": {
        "wall_s": wall, "prefill_s": stats.prefill_s,
        "decode_s": stats.decode_s, "steps": stats.steps,
        "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
        "paged_kernels_s": ours,
        "top_kernels": [{"name": k[:80], "s": us / 1e6, "count": n}
                        for k, (us, n) in top]}}), flush=True)
    if busy_s <= 0:
        raise SystemExit("FAIL: the profiler saw no device time")


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; chip_smoke.py needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind} x "
          f"{count}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    lib, ptxas = build.build()
    print(f"{lib} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(line.strip(), flush=True)
    build.library()

    phase("kernels")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rec = check_kernels(flush)
    del flush

    phase("reference")
    check_reference()

    phase("engine")
    launches = run_engine()
    for name, n in launches.items():
        rec[name]["launches"] = n

    phase("profile")
    profile_engine()

    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
