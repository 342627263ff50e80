#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. device    — require a CUDA device, print the card's name and power
                 limit, turn TF32 off;
  2. build     — compile every CUDA source of src/repro_torch/kernels/csrc
                 (one nvcc per source, all at once) into one library under
                 build/kernels/, for sm_90a; print each kernel's registers,
                 static shared memory and spills (ptxas -v), and fail unless
                 the SASS of the flash, paged-decode, paged-prefill,
                 grouped-matmul and the SSD scan's state and chunk kernels
                 holds tensor-core (HMMA) instructions (cuobjdump -sass);
  3. kernels   — hold each of the five kernels against its plain PyTorch
                 version on the card and time the kernel, the plain version
                 and a library yardstick the port never calls (each launch
                 behind an L2 flush): the paged kernels at qwen2-0.5b's serve
                 shapes (f32 and bf16, window 0 and 5, an all -1 table row;
                 torch's scaled_dot_product_attention on the gathered K/V),
                 then the paged decode and prefill at every split width
                 (1, 2, 4, 8, 16 and 64 table columns a split; f32 timed, f32
                 and bf16 with an all -1 row checked) at the engine's
                 positions and at a long context (positions near 1000, the
                 table full at MB 64), each beside SDPA; the paged decode
                 and prefill at the olmoe-1b-7b and phi-3-vision-4.2b paged
                 engines' shapes (16/16 heads of 128 and 32/32 heads of 96,
                 G 1; f32 and bf16, window 0 and 5, an all -1 row; the f32
                 call timed beside its plain version, SDPA and its bound);
                 flash attention at olmoe-1b-7b's prefill shape
                 ([1, S, 16, 128], S 128 and 256, causal), at
                 phi-3-vision-4.2b's forward shape ([1, 1024, 32, 96],
                 causal, timed) and at edge shapes (14/2 heads at D 64,
                 window 5, non-causal, ragged S 200, D 96 with window 5),
                 f32 and bf16 (scaled_dot_product_attention); grouped matmul
                 at olmoe-1b-7b's expert shapes (64 experts x 40 rows, gate-up
                 2048 x 2048 and down 1024 x 2048) with valid_rows None,
                 random and partly zero, f32 and bf16, each all-valid case
                 timed beside torch.bmm; the SSD
                 scan at mamba2-780m's forward shape ([2, 4096] tokens, 48
                 heads of 64, state 128, chunk 256), the smoke widths, a
                 chunk that halves (S 96), S 64 with chunk 128, a_log = -40
                 (memoryless) and B = H = 1 (tolerance 5e-4; no PyTorch
                 call computes it, so no library time), the full-width time
                 printed beside the SIMT kernel's it replaced;
  4. reference — the paged prefill + decode path (qwen2-0.5b smoke), the
                 MoE one-pass forward + contiguous decode steps
                 (olmoe-1b-7b smoke) and the mamba2 forward + decode chain
                 (mamba2-780m smoke) on the card against the same paths on
                 the CPU (plain versions, which the CPU tests hold against
                 the JAX package); the mamba2 decode chain also against
                 its forward's logits (2e-3);
  5. engine    — the full-width qwen2-0.5b paged engine (24 layers, random
                 weights from a seed) built by repro_torch.launch.serve's own
                 build function: 16 requests of 128-256 tokens after a shared
                 64-token prefix, 64 new tokens each, 8 slots, 4 prefill
                 lanes, decode horizon 8, block 16, max_len 1024, float32.
                 Every engine phase serves its request set three times on
                 one engine, every launch counter set to 0 before each run:
                 "captured" (each static signature's first call eager, then
                 captured as a CUDA graph; the main path's run, whose
                 launches the kernels line reads), "eager" (under
                 graphs.eager(): no graph) and "replayed" (graphs only);
                 the three must agree in tokens, every ServeStats counter
                 and every launch count, and each prints decode ms a step,
                 prefill ms a dispatch and a prompt token, and tokens/s.
                 Both paged kernels must launch and the plain versions must
                 not run; decode horizons and prefill rounds must be graphs;
  6. profile   — torch.profiler over the same request set on the same
                 engine, replayed and eager: device busy share (of the
                 profiled run's wall clock and of the unprofiled run's of
                 phase 5: the profiler slows the host) and device time by
                 kernel. Each profiled run zeroes the launch counters first
                 and fails unless the profiler saw as many events of each
                 hand-written kernel (and of the paged merge) as the
                 counters imply: under replay that is what shows the
                 graphs ran the kernels. A marker kernel ends each window
                 and must be seen (events lost at the end of a window
                 would go unnoticed otherwise). The profiler loses events
                 now and then: a window that lost any is printed as
                 discarded and the run profiled again, four times at most;
     sampled   — a second qwen2 engine at temperature 0.8, top-k 50: 8
                 requests of 128-256 tokens after the prefix, 16 new
                 tokens, served three times (capture, then replays), which
                 must draw the same tokens; between its replays the greedy
                 engine serves the same set, and the prefill ms a round and
                 decode ms a step of both print;
  7. olmoe     — with the qwen2 engines freed, the full-width olmoe-1b-7b
                 contiguous engine (16 layers, 64 experts top-8, ~6.9 B
                 float32 weights from a seed), its three runs as in phase 5:
                 8 requests of 64-128 tokens, 64 new tokens each, 4 slots,
                 decode horizon 8, max_len 256. Every layer of every prefill
                 (eager: each prompt at its exact length) must launch the
                 flash kernel (16 x prefills launches) and its plain version
                 must not run. The grouped matmul is an op no model calls
                 (the MoE layer contracts with einsum, as the JAX package's
                 does): it launches 0 times on both paths. Then the profile
                 of phase 6 over the same requests;
  8. olmoe paged — the full-width olmoe-1b-7b paged engine on the same
                 weights: 8 requests of 64-128 tokens after a shared
                 32-token prefix (two full blocks), 64 new tokens each, 4
                 slots, 4 prefill lanes, horizon 8, block 16, max_len 256;
                 its three runs as in phase 5 (both paged kernels, no plain
                 version, no flash), one profiled replayed run; then the
                 prefix cache against cold runs: gated at one slot and one
                 lane (16 new tokens; the same shapes in both runs), where
                 a block-aligned hit that resumes the expert counts must
                 give the cold tokens bit for bit, and reported at the
                 phase's 4 slots (another schedule: tokens may part at
                 near-ties of f32 logits); then each prompt's first-step
                 logits, chunked through the paged prefill, against a one-pass
                 forward (the contiguous engine's prefill): first-token
                 agreement and the largest logit gap, reported, not gated;
  9. phi-3-vision — with the olmoe engines freed, full-width
                 phi-3-vision-4.2b (32 layers, d_model 3072, 32 heads of 96,
                 ~4.2 B float32 weights from a seed): Model.forward on
                 [1, 1024] tokens with [1, 576, 3072] patch embeddings
                 (flash in all 32 layers, its plain version never) against
                 the same forward with the plain version in the kernel's
                 place (1e-3), Model.loss; then its paged engine on the same
                 weights (text-only, as in the reference): 8 requests of
                 128-256 tokens, 32 new tokens each, 4 slots, 4 lanes,
                 horizon 8, block 16, max_len 512, its three runs and a
                 profiled replayed run as in phase 8;
 10. mamba2    — with the phi-3-vision engine freed, full-width
                 mamba2-780m (48 layers, d_model 1536, 48 SSM heads of 64, state 128, ~780 M
                 float32 weights from a seed): Model.forward and Model.loss
                 on [2, 4096] random tokens, each launching the SSD kernel
                 exactly 48 times (its plain version never), then 256
                 recurrent decode steps on a [1, 256] prefix against the
                 forward's logits there (2e-3), then torch.profiler over one
                 more forward;
 11. mamba2 engine — the full-width mamba2-780m contiguous engine, its three
                 runs as in phase 5: 8 requests of 64-128 tokens, 32 new
                 tokens each, 4 slots, decode horizon 8, max_len 256. Its
                 prefill replays one captured batch-1 decode step per prompt
                 token, so the SSD kernel launches 0 times here, as in the
                 reference. Then the profile of phase 6 over the same
                 requests (~2000 kernel launches a step, ~1.7 M a run);
                 then the graphs_vs_eager summary line.

The last two lines are the kernels record (one entry per TPU kernel, its
launches summed over the paths that run it, by path in
``launches_by_path``, the new engines' shapes in ``other_shapes``) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import dataclasses
import gc
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402

HQ, HKV, D, BS, MAX_LEN, SLOTS = 14, 2, 64, 16, 1024, 8
MB = MAX_LEN // BS
NB = SLOTS * MB
#: tests/test_kernels.py's tolerances
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: H100 SXM data-sheet peaks: HBM bytes/s; f32 FLOP/s outside the tensor
#: cores; dense TF32 and bf16 FLOP/s on them
HBM_BPS, F32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12
ENGINE_ARGS = ["--arch", "qwen2-0.5b", "--preset", "full", "--engine",
               "continuous", "--cache", "paged", "--slots", str(SLOTS),
               "--batch", "16", "--block-size", str(BS), "--prefill-lanes",
               "4", "--prompt-len", "256", "--shared-prefix", "64",
               "--max-new", "64", "--max-len", str(MAX_LEN),
               "--decode-horizon", "8", "--seed", "0", "--device", "cuda"]
#: the sampled phase's request set
SAMPLED_ARGS = ENGINE_ARGS + ["--batch", "8", "--max-new", "16"]
OLMOE_ARGS = ["--arch", "olmoe-1b-7b", "--preset", "full", "--engine",
              "continuous", "--cache", "contiguous", "--slots", "4",
              "--batch", "8", "--prompt-len", "128", "--max-new", "64",
              "--max-len", "256", "--decode-horizon", "8", "--seed", "0",
              "--device", "cuda"]
KERNELS = {
    "paged_decode": dict(
        wrapper=ops.paged_attention, plain=pa.paged_attention_plain,
        replaces="src/repro/kernels/paged_attention.py:202"),
    "paged_prefill": dict(
        wrapper=ops.paged_prefill_attention,
        plain=pa.paged_prefill_attention_plain,
        replaces="src/repro/kernels/paged_attention.py:154"),
}
CSRC = "src/repro_torch/kernels/csrc/"
#: olmoe-1b-7b: q/k/v heads, head_dim, experts, expert capacity of a
#: 256-token prompt (moe.capacity), d_model, expert width
OL_H, OL_D, OL_E, OL_C, OL_DM, OL_F = 16, 128, 64, 40, 2048, 1024
#: phi-3-vision-4.2b: q = kv heads, head_dim; the forward phase's
#: sequence (576 patch positions, then text) and patch count
PHI_H, PHI_D, PHI_S, PHI_P = 32, 96, 1024, 576
#: the paged engines' kernel shapes: (path, Hq = Hkv, D, MB, slots, the
#: positions the engine's requests span)
PAGED_SHAPES = (("olmoe-1b-7b paged", OL_H, OL_D, 256 // BS, 4, 96, 224),
                ("phi-3-vision-4.2b paged", PHI_H, PHI_D, 512 // BS, 4, 128,
                 288))
#: mamba2-780m: SSM heads, head dim, state, chunk; the forward phase's
#: batch and sequence
M2_H, M2_P, M2_N, M2_Q, M2_B, M2_S = 48, 64, 128, 256, 2, 4096
#: the SSD scan's time at that shape before its tensor-core redesign (one
#: CTA per row and 32 columns of P walking the chunks in order, SIMT f32;
#: NVIDIA H100 80GB HBM3, 700 W, this script's kernels phase)
SIMT_SSD_MS = 4.7081
#: the olmoe paged engine's request set: 8 requests of 64-128 tokens after
#: a shared 32-token prefix (two full blocks)
OLMOE_PAGED_ARGS = ["--arch", "olmoe-1b-7b", "--preset", "full", "--engine",
                    "continuous", "--cache", "paged", "--slots", "4",
                    "--batch", "8", "--block-size", str(BS),
                    "--prefill-lanes", "4", "--prompt-len", "128",
                    "--shared-prefix", "32", "--max-new", "64", "--max-len",
                    "256", "--decode-horizon", "8", "--seed", "0",
                    "--device", "cuda"]
PHI3_ARGS = ["--arch", "phi-3-vision-4.2b", "--preset", "full", "--engine",
             "continuous", "--cache", "paged", "--slots", "4", "--batch",
             "8", "--block-size", str(BS), "--prefill-lanes", "4",
             "--prompt-len", "256", "--max-new", "32", "--max-len", "512",
             "--decode-horizon", "8", "--seed", "0", "--device", "cuda"]
MAMBA2_ARGS = ["--arch", "mamba2-780m", "--preset", "full", "--engine",
               "continuous", "--cache", "contiguous", "--slots", "4",
               "--batch", "8", "--prompt-len", "128", "--max-new", "32",
               "--max-len", "256", "--decode-horizon", "8", "--seed", "0",
               "--device", "cuda"]


def phase(name: str) -> None:
    print(f"== {name} ({time.strftime('%H:%M:%S')})", flush=True)


# ---------------------------------------------------------------------------
# build reports
# ---------------------------------------------------------------------------
#: the kernels redesigned for the tensor cores: their SASS must hold HMMA
MMA_KERNELS = ("flash_attention_kernel", "paged_decode_kernel",
               "paged_prefill_kernel",
               "grouped_matmul_kernel", "ssd_scan_state_kernel",
               "ssd_scan_chunk_kernel")


def print_ptxas(report: str) -> None:
    """One line per kernel of ``nvcc -Xptxas -v``: registers, static shared
    memory, stack and spills (the attention kernels' dynamic shared memory
    is in their sources: attention_mma.cuh smem_bytes)."""
    entry = spill = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            print(f"ptxas {entry}: {line.split(':', 1)[1].strip()}; "
                  f"{spill}", flush=True)
            entry = None


def check_tensor_cores(lib) -> None:
    """cuobjdump -sass of the built library: count the tensor-core (HMMA)
    instructions of each redesigned kernel; fail if one has none."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    for name in MMA_KERNELS:
        found = {f: n for f, n in counts.items() if name in f}
        print(f"HMMA instructions in {name}: {found}", flush=True)
        if not found or min(found.values()) == 0:
            raise SystemExit(f"FAIL: {name} runs no tensor-core instruction")


# ---------------------------------------------------------------------------
# kernel inputs, bound, timing
# ---------------------------------------------------------------------------
def make_case(b: int, c: int, dtype, seed: int, pad_row: bool,
              lo: int = 192, hi: int = 384, shape=None):
    """Inputs at a paged engine's shapes (``shape`` = (Hq, Hkv, D, MB, NB);
    default qwen2-0.5b's): a [NB, BS, Hkv, D] pool, rows at positions
    lo..hi-1 (default 192..383: prompt + decode of the engine phase)
    holding distinct scattered blocks, optionally a last all -1 (padding)
    row."""
    hq, hkv, d, mb, nb = shape or (HQ, HKV, D, MB, NB)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(nb, BS, hkv, d, generator=g, device="cuda").to(dtype)
    vp = torch.randn(nb, BS, hkv, d, generator=g, device="cuda").to(dtype)
    start = torch.randint(lo, hi - c, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
    perm = torch.randperm(nb, generator=g, device="cuda").to(torch.int32)
    tables = torch.full((b, mb), -1, dtype=torch.int32, device="cuda")
    for i in range(b - 1 if pad_row else b):
        n = (int(start[i]) + c - 1) // BS + 1
        tables[i, :n] = perm[i * mb:i * mb + n]
    q = torch.randn(b, c, hq, d, generator=g, device="cuda").to(dtype)
    return (q[:, 0] if c == 1 else q), kp, vp, tables, start


def ops_ms(flops: int, dtype, mma: bool) -> float:
    """Least time of ``flops`` at the rate of the units that run them: the
    f32 peak outside the tensor cores, or (``mma``) the tensor cores as the
    redesigned kernels use them, three TF32 passes for f32 and one pass for
    bf16."""
    if not mma:
        return 1e3 * flops / F32_FLOPS
    if dtype is torch.float32:
        return 1e3 * 3 * flops / TF32_FLOPS
    return 1e3 * flops / BF16_FLOPS


def bound_terms(q, kp, tables, start, c: int, window: int, mma: bool):
    """Least time for this call's work: every needed byte read once (q,
    the K/V blocks some query sees, tables, positions) and the output
    written once, over HBM bandwidth; the QK and PV flops of the visible
    (query, key) pairs at ``ops_ms``'s rate. Returns (bytes ms, ops ms)."""
    elem = q.element_size()
    _, bs, hkv, d = kp.shape
    tab, st = tables.cpu().numpy(), start.cpu().numpy()
    nbytes = 2 * q.numel() * elem + tables.numel() * 4 + start.numel() * 4
    pairs = 0
    for b in range(tab.shape[0]):
        s0 = int(st[b])
        for j in range(tab.shape[1]):
            k0 = j * bs
            if tab[b, j] < 0 or k0 > s0 + c - 1:
                continue
            if window and k0 + bs - 1 <= s0 - window:
                continue
            nbytes += 2 * bs * hkv * d * elem
            for qi in range(c):
                qpos = s0 + qi
                lo = qpos - window + 1 if window else 0
                pairs += max(0, min(qpos, k0 + bs - 1) - max(lo, k0) + 1)
    return (1e3 * nbytes / HBM_BPS,
            ops_ms(4 * d * q.shape[-2] * pairs, q.dtype, mma))


def time_ms(fn, flush: torch.Tensor, reps: int = 50,
            hold: bool = True) -> float:
    """Median CUDA-event time of ``fn`` with the L2 flushed before each
    launch. A ~0.1 ms device spin before the start event keeps the stream
    busy while the host enqueues ``fn``, so the events time the device
    work alone. With ``hold`` False (PR 11-13's method) the Python
    wrapper's enqueue cost falls inside the events whenever it exceeds the
    flush."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        flush.zero_()
        if hold:
            torch.cuda._sleep(200_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in ev)[reps // 2]


def host_ms(fn, reps: int = 50) -> float:
    """Host wall time per call of enqueuing ``fn`` (the wrapper's checks,
    allocations and launches), with the stream held by a ~10 ms device
    spin so that no call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def wrapper_times(fn, flush: torch.Tensor) -> dict:
    """The times of one kernel wrapper besides ``time_ms``'s: the events
    without the hold (PR 11-13's method) and the host's enqueue cost."""
    return dict(unheld_ms=time_ms(fn, flush, hold=False),
                host_ms=host_ms(fn))


def sdpa_call(q, kp, vp, tables, start, c: int, window: int):
    """torch's scaled_dot_product_attention over the gathered K/V with the
    same mask: the library yardstick (gather and mask built outside)."""
    kg, vg, k_pos, assigned = pa.paged_kv_gather(kp, vp, tables)
    qq = (q[:, None] if c == 1 else q).transpose(1, 2)           # [B,Hq,C,D]
    g = q.shape[-2] // kp.shape[2]
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
                    what = (f"{name} B={b} C={c} {str(dtype)[6:]} "
                            f"window={window}")
                    out = kern["wrapper"](*args, window)
                    err = _compare(what, out, kern["plain"](*args, window),
                                   dtype)
                    if b > 1 and not bool((out[-1] == 0).all()):
                        raise SystemExit(f"FAIL: {what}: the all -1 table "
                                         "row is not zero")
                    if dtype is torch.float32 and window == 0 and b > 1:
                        q, kp, vp, tables, start = args
                        ms = time_ms(lambda: kern["wrapper"](*args, 0), flush)
                        plain_ms = time_ms(lambda: kern["plain"](*args, 0),
                                           flush)
                        lib_ms = time_ms(sdpa_call(q, kp, vp, tables, start,
                                                   c, 0), flush)
                        rec[name] = _record(
                            name, "paged_attention.cu", kern["replaces"],
                            err, ms, plain_ms,
                            *bound_terms(q, kp, tables, start, c, 0, True),
                            lib_ms,
                            dict(B=b, C=c, Hq=HQ, Hkv=HKV, D=D, BS=BS, MB=MB,
                                 dtype="float32"),
                            bound_terms(q, kp, tables, start, c, 0,
                                        False)[1],
                            wrapper_times(lambda: kern["wrapper"](*args, 0),
                                          flush))
    return rec


def check_splits(flush: torch.Tensor, name: str) -> None:
    """The paged kernel ``name`` (decode: W 8 slots; prefill: [4, 16]
    chunks) at the engine's positions (192-383) and at a long context
    (960-1023: the table full at MB 64), at each split width (the module
    constant ``DECODE_SPLIT_KEYS`` or ``SPLIT_KEYS``, set here and restored)
    against the plain version in f32 and, with a last all -1 row that must
    come out zero, in f32 and bf16; the f32 call timed beside SDPA on the
    gathered K/V and the bound: the measurement behind the constant."""
    decode = name == "paged_decode"
    attr = "DECODE_SPLIT_KEYS" if decode else "SPLIT_KEYS"
    b, c = (SLOTS, 1) if decode else (4, 16)
    cuda = pa.paged_attention_cuda if decode else pa.paged_prefill_cuda
    plain = KERNELS[name]["plain"]
    keys = getattr(pa, attr)
    try:
        for what, lo, hi in (("engine", 192, 384), ("long context", 960,
                                                     MAX_LEN)):
            args = make_case(b, c, torch.float32, seed=lo, pad_row=False,
                             lo=lo, hi=hi)
            padded = [make_case(b, c, dtype, seed=lo + 1, pad_row=True,
                                lo=lo, hi=hi)
                      for dtype in (torch.float32, torch.bfloat16)]
            q, kp, vp, tables, start = args
            exp = plain(*args)
            lib_ms = time_ms(sdpa_call(q, kp, vp, tables, start, c, 0), flush)
            bound = max(bound_terms(q, kp, tables, start, c, 0, True))
            for cols in (1, 2, 4, 8, 16, MB):
                setattr(pa, attr, cols * BS)
                n = pa.split_plan(MB, BS, cols * BS)[1]
                run = lambda: cuda(*args, 0)  # noqa: E731
                what_cols = f"{name} {what} {cols} columns a split"
                _compare(what_cols, run(), exp, torch.float32)
                for pad in padded:
                    dtype = pad[0].dtype
                    out = cuda(*pad, 0)
                    what_pad = f"{what_cols} {str(dtype)[6:]}, all -1 last row"
                    _compare(what_pad, out, plain(*pad), dtype)
                    if not bool((out[-1] == 0).all()):
                        raise SystemExit(f"FAIL: {what_pad} is not zero")
                ms = time_ms(run, flush)
                print(f"{what_cols}, starts {sorted(start.tolist())} ({n} "
                      f"splits, {b * HKV * n} CTAs): kernel {ms:.4f} ms, "
                      f"SDPA {lib_ms:.4f} ms, kernel / library "
                      f"{ms / lib_ms:.3f}, bound {bound:.5f} ms", flush=True)
    finally:
        setattr(pa, attr, keys)


#: the kernels line's keys of a timed case that ``other_shapes`` keeps
SHAPE_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "max_abs_err")


def check_engine_shapes(flush: torch.Tensor, rec: dict) -> None:
    """The paged kernels at the shapes of the olmoe-1b-7b and
    phi-3-vision-4.2b paged engines (one q head a kv head: G 1; head_dim
    128 and 96): f32 and bf16, window 0 and 5, a last all -1 row that must
    come out zero, against the plain versions; the f32 window-0 call timed
    beside its plain version, SDPA on the gathered K/V and its bound, kept
    in the kernel's ``other_shapes``."""
    for path, hq, d, mb, slots, lo, hi in PAGED_SHAPES:
        shape = (hq, hq, d, mb, slots * mb)
        for name, kern in KERNELS.items():
            b, c = (slots, 1) if name == "paged_decode" else (slots, BS)
            for dtype in (torch.float32, torch.bfloat16):
                for window in (0, 5):
                    args = make_case(b, c, dtype, seed=hq + d + window,
                                     pad_row=True, lo=lo, hi=hi, shape=shape)
                    what = (f"{name} {path} shape B={b} C={c} Hq=Hkv={hq} "
                            f"D={d} {str(dtype)[6:]} window={window}")
                    out = kern["wrapper"](*args, window)
                    _compare(what, out, kern["plain"](*args, window), dtype)
                    if not bool((out[-1] == 0).all()):
                        raise SystemExit(f"FAIL: {what}: the all -1 table "
                                         "row is not zero")
            args = make_case(b, c, torch.float32, seed=hq + d, pad_row=False,
                             lo=lo, hi=hi, shape=shape)
            q, kp, vp, tables, start = args
            err = _compare(f"{name} {path} shape, f32, all rows",
                           kern["wrapper"](*args, 0), kern["plain"](*args, 0),
                           torch.float32)
            r = _record(
                name, "paged_attention.cu", kern["replaces"], err,
                time_ms(lambda: kern["wrapper"](*args, 0), flush),
                time_ms(lambda: kern["plain"](*args, 0), flush),
                *bound_terms(q, kp, tables, start, c, 0, True),
                time_ms(sdpa_call(q, kp, vp, tables, start, c, 0), flush),
                dict(path=path, B=b, C=c, Hq=hq, Hkv=hq, D=d, BS=BS, MB=mb,
                     positions=[lo, hi], dtype="float32"))
            rec[name].setdefault("other_shapes", []).append(
                {k: r[k] for k in SHAPE_KEYS})


def _record(name, source, replaces, err, ms, plain_ms, bytes_ms, ops_ms,
            lib_ms, shape, f32_simt_ms=None, times=None) -> dict:
    """The kernels-line entry of one timed case. ``launches`` is added by
    main from the engine run of the kernel's path. For a tensor-core kernel
    ``f32_simt_ms`` is its operations at the f32 peak outside the tensor
    cores, printed and kept for reference; ``times`` holds
    ``wrapper_times``'s readings."""
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    lib = ("none" if lib_ms is None else
           f"{lib_ms:.4f} ms (kernel / library {ms / lib_ms:.3f})")
    ref = ("" if f32_simt_ms is None else
           f", at the f32 peak outside the tensor cores {f32_simt_ms:.5f}")
    more = "".join(f", {k} {v:.4f}" for k, v in (times or {}).items())
    print(f"{name} {shape}: kernel {ms:.4f} ms{more}, plain {plain_ms:.4f} "
          f"ms, library {lib}, bound {max(bytes_ms, ops_ms):.5f} ms "
          f"({by}; bytes {bytes_ms:.5f}, operations {ops_ms:.5f}{ref})",
          flush=True)
    rec = dict(name=name, route="cuda", source=CSRC + source,
               replaces=replaces, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by=by, library_ms=lib_ms, bound_bytes_ms=bytes_ms,
               bound_ops_ms=ops_ms, shape=shape, **(times or {}))
    if f32_simt_ms is not None:
        rec["bound_ops_f32_simt_ms"] = f32_simt_ms
    return rec


def _compare(what: str, out, exp, dtype, tol=None) -> float:
    """Max abs error of a kernel against its plain version; exits unless
    they agree within the tolerance (the dtype's unless given)."""
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    err = diff.max().item()
    tol = tol or TOL[dtype]
    # allclose's test |out - exp| <= tol + tol |exp|: its worst ratio
    worst = (diff / (tol + tol * exp.float().abs())).max().item()
    ok = (out.shape == exp.shape and out.dtype == exp.dtype
          and torch.allclose(out.float(), exp.float(), atol=tol, rtol=tol))
    print(f"{what}: max_abs_err={err:.3e}, max |exp|="
          f"{exp.float().abs().max().item():.3e} (atol = rtol = {tol}; "
          f"worst ratio to the bound {worst:.3f})", flush=True)
    if not ok:
        raise SystemExit(f"FAIL: {what} disagrees with its plain version")
    return err


def flash_bound(s: int, hq: int, hkv: int, d: int, dtype, causal: bool,
                window: int, mma: bool = True):
    """Least time for one flash call (B = 1): q, k, v read once and the
    output written once over HBM bandwidth; the QK and PV flops of the
    visible (query, key) pairs at ``ops_ms``'s rate. (bytes ms, ops ms)."""
    pos = torch.arange(s)
    vis = torch.ones((s, s), dtype=torch.bool)
    if causal:
        vis &= pos[:, None] >= pos[None, :]
    if window:
        vis &= pos[:, None] - pos[None, :] < window
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * hq + 2 * hkv) * s * d * elem
    flops = 4 * d * hq * int(vis.sum())
    return 1e3 * nbytes / HBM_BPS, ops_ms(flops, dtype, mma)


def check_flash(flush: torch.Tensor) -> dict:
    """The flash kernel against its plain version at olmoe-1b-7b's prefill
    shape, at phi-3-vision-4.2b's forward shape ([1, 1024, 32, 96]) and
    at edge shapes; time the S = 256 f32 call (and, in ``other_shapes``,
    phi-3-vision's)."""
    cases = [(128, OL_H, OL_H, OL_D, True, 0),
             (256, OL_H, OL_H, OL_D, True, 0),
             (128, 14, 2, 64, True, 5), (128, 14, 2, 64, False, 0),
             (200, OL_H, OL_H, OL_D, True, 0),
             (PHI_S, PHI_H, PHI_H, PHI_D, True, 0),
             (200, PHI_H, PHI_H, PHI_D, True, 5)]
    rec = None
    for (s, hq, hkv, d, causal, window) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(s + hq + d)
            q, k, v = (torch.randn(1, s, h, d, generator=g,
                                   device="cuda").to(dtype)
                       for h in (hq, hkv, hkv))
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            exp = fa.flash_attention_plain(q, k, v, causal, window)
            err = _compare(f"flash S={s} Hq/Hkv={hq}/{hkv} D={d} causal="
                           f"{causal} window={window} {str(dtype)[6:]}",
                           out, exp, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if (s, hq, dtype) == (128, OL_H, torch.float32):
                ms = time_ms(lambda: ops.flash_attention(q, k, v), flush)
                lib_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush)
                print(f"flash_attention S=128 f32: kernel {ms:.4f} ms, SDPA "
                      f"{lib_ms:.4f} ms, kernel / library "
                      f"{ms / lib_ms:.3f}", flush=True)
            if (s, hq, dtype) == (256, OL_H, torch.float32):
                ms = time_ms(lambda: ops.flash_attention(q, k, v), flush)
                plain_ms = time_ms(
                    lambda: fa.flash_attention_plain(q, k, v), flush)
                lib_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush)
                rec = _record(
                    "flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:86", err, ms,
                    plain_ms, *flash_bound(s, hq, hkv, d, dtype, True, 0),
                    lib_ms,
                    dict(B=1, S=s, Hq=hq, Hkv=hkv, D=d, causal=True,
                         window=0, dtype="float32"),
                    flash_bound(s, hq, hkv, d, dtype, True, 0, False)[1],
                    wrapper_times(lambda: ops.flash_attention(q, k, v),
                                  flush))
            if (s, d, dtype) == (PHI_S, PHI_D, torch.float32):
                phi = _record(
                    "flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:86", err,
                    time_ms(lambda: ops.flash_attention(q, k, v), flush),
                    time_ms(lambda: fa.flash_attention_plain(q, k, v), flush,
                            reps=10),
                    *flash_bound(s, hq, hkv, d, dtype, True, 0),
                    time_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True),
                            flush),
                    dict(path="phi-3-vision-4.2b forward", B=1, S=s, Hq=hq,
                         Hkv=hkv, D=d, causal=True, window=0,
                         dtype="float32"))
    rec["other_shapes"] = [{k: phi[k] for k in SHAPE_KEYS}]
    return rec


def gmm_bound(x, w, valid, mma: bool = True):
    """Least time for one grouped matmul: the x rows and the weights of the
    experts that have a valid row read once, valid_rows read and the
    whole output written once, over HBM bandwidth; 2 K N flops per valid
    row at ``ops_ms``'s rate. (bytes ms, ops ms)."""
    g, c, k = x.shape
    n = w.shape[2]
    rows = (torch.full((g,), c) if valid is None
            else valid.cpu().long().clamp(0, c))
    elem = x.element_size()
    nbytes = (int(rows.sum()) * k * elem + int((rows > 0).sum()) * k * n * elem
              + g * c * n * elem + (0 if valid is None else 4 * g))
    return (1e3 * nbytes / HBM_BPS,
            ops_ms(2 * k * n * int(rows.sum()), x.dtype, mma))


def check_grouped_matmul(flush: torch.Tensor) -> dict:
    """The grouped matmul against its plain version at olmoe-1b-7b's
    expert shapes; time every case with all rows valid (the einsum of
    moe_ffn at a 256-token prompt's capacity) beside torch.bmm, f32 and
    bf16, gate-up and down, and the f32 random-rows cases; the gate-up f32
    call is the kernels-line entry."""
    rec = None
    for (k, n) in ((OL_DM, 2 * OL_F), (OL_F, OL_DM)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(k + n)
            x = torch.randn(OL_E, OL_C, k, generator=g, device="cuda")
            w = torch.randn(OL_E, k, n, generator=g, device="cuda") / k ** 0.5
            x, w = x.to(dtype), w.to(dtype)
            rand = torch.randint(0, OL_C + 1, (OL_E,), generator=g,
                                 device="cuda", dtype=torch.int32)
            part = rand.clone()
            part[::3] = 0
            for kind, valid in (("none", None), ("random", rand),
                                ("partly zero", part)):
                out = ops.grouped_matmul(x, w, valid)
                exp = gmm.grouped_matmul_plain(x, w, valid)
                err = _compare(f"grouped_matmul [{OL_E},{OL_C},{k}]x[{OL_E},"
                               f"{k},{n}] valid_rows={kind} "
                               f"{str(dtype)[6:]}", out, exp, dtype)
                if kind == "partly zero" or (
                        kind == "random" and dtype is not torch.float32):
                    continue
                ms = time_ms(lambda: ops.grouped_matmul(x, w, valid), flush)
                bms = max(gmm_bound(x, w, valid))
                what = f"grouped_matmul K={k} N={n} {str(dtype)[6:]}"
                if kind == "random":
                    print(f"{what} valid_rows=random: kernel {ms:.4f} ms, "
                          f"bound {bms:.5f} ms", flush=True)
                    continue
                lib_ms = time_ms(lambda: torch.bmm(x, w), flush)
                print(f"{what}: kernel {ms:.4f} ms, torch.bmm {lib_ms:.4f} "
                      f"ms, kernel / bmm {ms / lib_ms:.3f}, bound "
                      f"{bms:.5f} ms", flush=True)
                if (k, dtype) != (OL_DM, torch.float32):
                    continue
                plain_ms = time_ms(lambda: gmm.grouped_matmul_plain(x, w),
                                   flush)
                rec = _record(
                    "grouped_matmul", "grouped_matmul.cu",
                    "src/repro/kernels/grouped_matmul.py:48", err, ms,
                    plain_ms, *gmm_bound(x, w, None), lib_ms,
                    dict(G=OL_E, C=OL_C, K=k, N=n, valid_rows=None,
                         dtype="float32"),
                    gmm_bound(x, w, None, mma=False)[1])
            del x, w
    return rec


def ssd_bound(b: int, s: int, h: int, p: int, n: int, q: int,
              mma: bool = True):
    """Least time for one SSD scan: x, a, B and C read once and y written
    once over HBM bandwidth; the visible work per (row, chunk) — causal
    scores (2 N per pair j <= i), scores times x (2 P per pair), the
    inter-chunk term and the state update (2 Q N P each) — at ``ops_ms``'s
    rate for f32. (bytes ms, ops ms)."""
    nbytes = 4 * b * s * h * (2 * p + 2 * n + 1)
    pairs = q * (q + 1) // 2
    flops = b * h * (s // q) * (2 * pairs * (n + p) + 4 * q * n * p)
    return 1e3 * nbytes / HBM_BPS, ops_ms(flops, torch.float32, mma)


def ssd_case(b: int, s: int, h: int, p: int, n: int, seed: int):
    """The JAX kernel test's inputs (tests/test_kernels.py:126-130): x
    normal, decays -softplus(normal), B and C normal at half scale."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device="cuda")
    a = -torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=g, device="cuda"))
    bm = torch.randn(b, s, h, n, generator=g, device="cuda") * 0.5
    cm = torch.randn(b, s, h, n, generator=g, device="cuda") * 0.5
    return x, a, bm, cm


def check_ssd(flush: torch.Tensor) -> dict:
    """The SSD scan against its plain version at mamba2-780m's forward shape
    and at edge shapes (tolerance 5e-4, tests/test_kernels.py:134's); time
    the full-width call."""
    cases = [  # (B, S, H, P, N, chunk, what)
        (M2_B, M2_S, M2_H, M2_P, M2_N, M2_Q, "mamba2-780m forward"),
        (2, 256, 16, 32, 16, 32, "smoke widths"),
        (2, 96, 4, M2_P, M2_N, M2_Q, "S 96: the chunk halves to 32"),
        (2, 64, 4, M2_P, M2_N, 128, "S 64 with chunk 128"),
        (2, 128, 8, M2_P, M2_N, 64, "a_log = -40 (memoryless)"),
        (1, 512, 1, M2_P, M2_N, M2_Q, "B = H = 1"),
    ]
    rec = None
    for (b, s, h, p, n, chunk, what) in cases:
        x, a, bm, cm = ssd_case(b, s, h, p, n, s + h + n)
        if "memoryless" in what:
            a = torch.full_like(a, -40.0)
        q = chunk
        while s % q:
            q //= 2
        out = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
        err = _compare(f"ssd_scan [{b},{s},{h},{p}] N={n} chunk={chunk} "
                       f"(q={q}; {what})", out,
                       ssd.ssd_scan_plain(x, a, bm, cm, chunk=q),
                       torch.float32, tol=5e-4)
        if "memoryless" in what:
            want = (cm * bm).sum(-1, keepdim=True) * x
            _compare(f"ssd_scan {what} against (C.B) x", out, want,
                     torch.float32, tol=5e-4)
        if what.startswith("mamba2"):
            ms = time_ms(lambda: ops.ssd_scan(x, a, bm, cm, chunk=q), flush)
            plain_ms = time_ms(
                lambda: ssd.ssd_scan_plain(x, a, bm, cm, chunk=q), flush,
                reps=10)
            print(f"ssd_scan {what}: kernel {ms:.4f} ms against the "
                  f"{SIMT_SSD_MS} ms of the SIMT kernel it replaced "
                  f"({SIMT_SSD_MS / ms:.2f}x)", flush=True)
            rec = _record(
                "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:66",
                err, ms, plain_ms, *ssd_bound(b, s, h, p, n, q), None,
                dict(B=b, S=s, H=h, P=p, N=n, Q=q, dtype="float32"),
                ssd_bound(b, s, h, p, n, q, mma=False)[1])
        del x, a, bm, cm, out
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


def moe_logits(model, params, device):
    """One-pass MoE forward over two prompts (the contiguous prefill, flash
    attention in every layer), its K/V written into a 3-row contiguous
    cache, then four decode steps with per-row positions (row 2 idle and
    frozen); returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, model.cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32) for n in (37, 20)]
    cache = model.init_cache(3, 48, device=device)
    outs, tok = [], torch.zeros((3, 1), dtype=torch.int32)
    for i, p in enumerate(prompts):
        logits, (k, v) = moe.forward(model.cfg, params, p[None].to(device),
                                     return_cache=True)
        cache["k"][:, i, :len(p)] = k[:, 0]
        cache["v"][:, i, :len(p)] = v[:, 0]
        outs.append(logits.cpu())
        tok[i, 0] = int(logits[0, -1].argmax())
    pos = torch.tensor([37, 20, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    for _ in range(4):
        logits, cache = model.decode_step(params, cache, tok.to(device),
                                          pos.to(device),
                                          write_valid=valid.to(device))
        outs.append(logits[:2].cpu())
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).cpu()
        pos[:2] += 1
    return outs


def mamba2_logits(model, params, device):
    """The mamba2 forward over two 64-token rows (two chunks of 32: the scan
    kernel on the card), then the recurrent decode chain over the same
    tokens; returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    outs = [model.forward(params, {"tokens": toks.to(device)}).cpu()]
    cache = model.init_cache(2, 64, device=device)
    for t in range(64):
        logits, cache = model.decode_step(params, cache,
                                          toks[:, t:t + 1].to(device), t)
        outs.append(logits.cpu())
    return outs


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def check_reference() -> None:
    for arch, path in (("qwen2-0.5b", paged_logits),
                       ("olmoe-1b-7b", moe_logits),
                       ("mamba2-780m", mamba2_logits)):
        got = _check_reference(arch, path)
    # the decode chain against the forward on the card (the check of
    # tests/test_smoke_archs.py:82-95)
    full, steps = got[0], torch.cat(got[1:], dim=1)
    gap = (steps - full).abs().max().item()
    print(f"mamba2-780m smoke on the card, 64 decode steps vs forward: "
          f"max_abs_diff={gap:.3e} (tol 2e-3)", flush=True)
    if not torch.allclose(steps, full, atol=2e-3, rtol=1e-5):
        raise SystemExit("FAIL: the mamba2 decode chain disagrees with its "
                         "forward on the card")


def _check_reference(arch: str, path) -> list:
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu = _to_cuda(cpu)
    with torch.inference_mode():
        ref = path(model, cpu, "cpu")
        got = path(model, gpu, "cuda")
    # float32 on both, different summation orders (cuBLAS vs CPU BLAS, the
    # kernels' online softmax vs the plain versions' single pass): logits
    # agree to ~1e-5; 1e-3 leaves margin without hiding a wrong mask.
    worst = max((a - b).abs().max().item() for a, b in zip(ref, got))
    print(f"{arch} smoke, card vs CPU, {len(ref)} logits tensors: "
          f"max_abs_diff={worst:.3e} (tol 1e-3)", flush=True)
    if not all(torch.allclose(a, b, atol=1e-3, rtol=1e-3)
               for a, b in zip(ref, got)):
        raise SystemExit(f"FAIL: the card's {arch} path disagrees with the "
                         "CPU")
    return got


# ---------------------------------------------------------------------------
# engines: captured, eager and replayed runs of one request set
# ---------------------------------------------------------------------------
#: the three runs of every engine phase, in order: "captured" (the main
#: path's run: each static signature's first call eager, then captured;
#: the kernels line reads its launches), "eager" (under graphs.eager(): no
#: graph at all) and "replayed" (every signature captured already)
MODES = ("captured", "eager", "replayed")
#: ServeStats fields that are wall-clock times; every other is a counter
TIMES = {"wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
         "decode_s"}
COUNTER_NAMES = tuple(f.__name__ for f, _ in ops.COUNTERS)


def _mode(mode: str):
    return graphs.eager() if mode == "eager" else contextlib.nullcontext()


def serve_modes(engine, args, what: str) -> dict:
    """Serve ``args``' request set on ``engine`` once per mode (``MODES``),
    every launch counter set to 0 just before each run and read just
    after. Fails unless the three runs give the same tokens, counters and
    launches, and unless the replayed run captured nothing new. Prints one
    line a run and returns {mode: dict(out, stats, launches, replays)}."""
    res = {}
    for mode in MODES:
        reqs = serve_cli.requests(args)
        ops.set_counts((0,) * len(ops.COUNTERS))
        replays, keys = engine.graphs.replays, len(engine.graphs.keys)
        torch.cuda.synchronize()
        with _mode(mode):
            out, stats = engine.run(reqs)
        torch.cuda.synchronize()
        launches = dict(zip(COUNTER_NAMES, ops.counts()))
        res[mode] = dict(out=out, stats=stats, launches=launches,
                         replays=engine.graphs.replays - replays,
                         captured=len(engine.graphs.keys) - keys)
        prompt_tokens = sum(len(r.prompt) for r in out)
        print(json.dumps({"serve": what, "mode": mode, **{
            k: getattr(stats, k) for k in (
                "wall_s", "tokens_per_s", "prefill_s", "decode_s",
                "prefill_dispatches", "decode_dispatches", "steps",
                "host_syncs")},
            "decode_ms_per_step": 1e3 * stats.decode_s / stats.steps,
            "prefill_ms_per_dispatch":
                1e3 * stats.prefill_s / stats.prefill_dispatches,
            "prefill_ms_per_token": 1e3 * stats.prefill_s / prompt_tokens,
            "graphs_captured": res[mode]["captured"],
            "graph_replays": res[mode]["replays"],
            "launches": {k: v for k, v in launches.items() if v}}),
            flush=True)
    base = res["captured"]
    counters = [f.name for f in dataclasses.fields(base["stats"])
                if f.name not in TIMES]
    for mode in MODES[1:]:
        r = res[mode]
        if [x.output for x in r["out"]] != [x.output for x in base["out"]]:
            raise SystemExit(f"FAIL: {what}: the {mode} run's tokens differ "
                             "from the captured run's")
        diff = [n for n in counters
                if getattr(r["stats"], n) != getattr(base["stats"], n)]
        if diff or r["launches"] != base["launches"]:
            raise SystemExit(f"FAIL: {what}: the {mode} run differs from the "
                             f"captured run in {diff} / launches "
                             f"{r['launches']} vs {base['launches']}")
    if (res["eager"]["replays"] or not base["replays"]
            or not res["replayed"]["replays"] or res["replayed"]["captured"]):
        raise SystemExit(f"FAIL: {what}: replays "
                         f"{[res[m]['replays'] for m in MODES]}, captured "
                         f"{[res[m]['captured'] for m in MODES]}")
    print(f"{what}: captured, eager and replayed runs agree in tokens, "
          f"{len(counters)} counters and launches; graph signatures "
          f"{sorted(engine.graphs.keys, key=str)}", flush=True)
    return res


def _check_outputs(what: str, engine, out, max_new: int) -> None:
    vocab = engine.cfg.vocab_size
    for r in out:
        if len(r.output) != max_new or not all(0 <= t < vocab
                                               for t in r.output):
            raise SystemExit(f"FAIL: {what}: request {r.job_id} holds "
                             f"{r.output}")


def _kinds(engine) -> set:
    return {k[0] for k in engine.graphs.keys}


def run_engine(summary: dict) -> dict:
    """The full-width qwen2-0.5b paged engine (module docstring, phases 5
    and 6): ``run_paged_engine`` with a replayed and an eager profile,
    then the sampled phase. Returns each paged kernel's launches in the
    captured run."""
    args = serve_cli.build_parser().parse_args(ENGINE_ARGS)
    what = "qwen2-0.5b paged"
    engine, _, launches = run_paged_engine(summary, args, what, None,
                                           modes=("replayed", "eager"))
    phase("sampled")
    summary[what]["sampled_vs_greedy"] = run_sampled(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _summary(res: dict) -> dict:
    """Per mode: tokens/s, decode ms a step, prefill ms a dispatch and a
    prompt token."""
    rec = {}
    for mode, r in res.items():
        st = r["stats"]
        toks = sum(len(x.prompt) for x in r["out"])
        rec[mode] = {"tokens_per_s": st.tokens_per_s,
                     "decode_ms_per_step": 1e3 * st.decode_s / st.steps,
                     "prefill_ms_per_dispatch":
                         1e3 * st.prefill_s / st.prefill_dispatches,
                     "prefill_ms_per_token": 1e3 * st.prefill_s / toks}
    return rec


def _per_step(stats) -> dict:
    return {"prefill_ms_per_round":
                1e3 * stats.prefill_s / stats.prefill_dispatches,
            "decode_ms_per_step": 1e3 * stats.decode_s / stats.steps}


def run_sampled(greedy) -> dict:
    """qwen2-0.5b paged at temperature 0.8, top-k 50 on ``SAMPLED_ARGS``'
    request set: a new engine serves it three times (capture, then
    replays), which must draw the same tokens. Between its replays the
    greedy engine ``greedy`` serves the same set (after a run that captures
    its signatures), so the sampled pick's cost a prefill round and a
    decode step shows beside greedy's in one call. Returns the replayed
    runs' times, per kind."""
    args = serve_cli.build_parser().parse_args(SAMPLED_ARGS + [
        "--temperature", "0.8", "--top-k", "50"])
    greedy_args = serve_cli.build_parser().parse_args(SAMPLED_ARGS)
    engine, _ = serve_cli.build(args)
    greedy.run(serve_cli.requests(greedy_args))
    runs, times = [], {"sampled": [], "greedy": []}
    for kind in ("sampled", "sampled", "greedy", "sampled", "greedy"):
        if kind == "sampled":
            out, stats = engine.run(serve_cli.requests(args))
            runs.append([r.output for r in out])
            _check_outputs("sampled", engine, out, args.max_new)
        else:
            out, stats = greedy.run(serve_cli.requests(greedy_args))
        if len(runs) > 1 or kind == "greedy":      # not the capturing run
            times[kind].append(_per_step(stats))
    print(json.dumps({"sampled": {
        "temperature": args.temperature, "top_k": args.top_k,
        "requests": args.batch, "max_new": args.max_new,
        "prefill_dispatches": stats.prefill_dispatches, "steps": stats.steps,
        "graph_replays": engine.graphs.replays,
        "sample_output": runs[0][0][:8], **times}}), flush=True)
    if any(r != runs[0] for r in runs) or not engine.graphs.replays:
        raise SystemExit("FAIL: three sampled runs drew different tokens")
    print("sampled qwen2 run repeated exactly", flush=True)
    return times


def run_olmoe(summary: dict):
    """The full-width olmoe-1b-7b contiguous engine (module docstring,
    phase 7). Returns each counted wrapper's launches in the captured run
    and the engine's weights."""
    args = serve_cli.build_parser().parse_args(OLMOE_ARGS)
    engine, _ = serve_cli.build(args)
    res = serve_modes(engine, args, "olmoe-1b-7b contiguous")
    out, stats, counts = (res["captured"][k]
                          for k in ("out", "stats", "launches"))
    cfg = engine.cfg
    _check_outputs("olmoe", engine, out, args.max_new)
    launches = {"flash_attention": counts["flash_attention"],
                "grouped_matmul": counts["grouped_matmul"]}
    plain_calls = sum(v for k, v in counts.items() if k.endswith("_plain"))
    finite = all(bool(torch.isfinite(b).all())
                 for b in engine.pool.buffers.values())
    # every decode step reads every layer's weights (the expert einsum runs
    # all 64 experts) and the unembedding: its least time on the card
    step_bytes = 4 * (sum(t.numel() for lp in engine.params["layers"]
                          for t in _leaves(lp))
                      + engine.params["emb"]["lm_head"].numel())
    expert_bytes = 4 * sum(lp[n].numel() for lp in engine.params["layers"]
                           for n in ("we_gate_up", "we_down"))
    print(json.dumps({"olmoe_engine": {k: getattr(stats, k) for k in (
        "n_requests", "new_tokens", "decode_rows_saved", "max_active",
        "mean_latency_s")}, "launches": launches,
        "plain_calls": plain_calls, "kv_finite": finite,
        "decode_step_bytes_gb": step_bytes / 1e9,
        "expert_bytes_gb": expert_bytes / 1e9,
        "decode_step_floor_ms": 1e3 * step_bytes / HBM_BPS,
        "sample_output": out[0].output[:8]}), flush=True)
    if not finite:
        raise SystemExit("FAIL: non-finite values in the contiguous cache")
    want = cfg.n_layers * stats.prefill_dispatches
    if (stats.prefill_dispatches != args.batch
            or launches["flash_attention"] != want or plain_calls):
        raise SystemExit(
            f"FAIL: flash launches {launches['flash_attention']} (want "
            f"{want} = {cfg.n_layers} layers x {stats.prefill_dispatches} "
            f"prefills), plain calls {plain_calls}: the olmoe prefill did "
            "not run the flash kernel")
    if "contiguous" not in _kinds(engine):
        raise SystemExit(f"FAIL: olmoe graphs {engine.graphs.keys}")
    summary["olmoe-1b-7b contiguous"] = _summary(res)
    summary["olmoe-1b-7b contiguous"]["busy_share"] = profile_engine(
        engine, args, res, "flash_")
    return launches, engine.params


def run_paged_engine(summary: dict, args, what: str, params,
                     modes=("replayed",)) -> tuple:
    """A full-width paged engine on ``params`` (weights drawn from the seed
    when None; phases 5, 8 and 9): its three runs (``serve_modes``), its
    checks (outputs, finite pools, a shared prefix hit, both paged kernels
    launched and no plain version, no flash, decode horizons and prefill
    rounds as graphs) and profiled runs of ``modes``. Returns (the engine,
    its three runs' results, each paged kernel's launches in the captured
    run)."""
    engine, _ = serve_cli.build(args, params=params)
    res = serve_modes(engine, args, what)
    out, stats, counts = (res["captured"][k]
                          for k in ("out", "stats", "launches"))
    _check_outputs(what, engine, out, args.max_new)
    launches = {"paged_decode": counts["paged_attention"],
                "paged_prefill": counts["paged_prefill_attention"]}
    plain_calls = sum(v for k, v in counts.items() if k.endswith("_plain"))
    finite = bool(torch.isfinite(engine.pool.buffers.k_buf).all()
                  and torch.isfinite(engine.pool.buffers.v_buf).all())
    # a decode step reads every weight but the (untied) embedding table
    emb = engine.params["emb"]
    step_bytes = 4 * (sum(t.numel() for t in _leaves(engine.params))
                      - ("lm_head" in emb) * emb["tok_emb"].numel())
    print(json.dumps({"paged_engine": {"what": what, **{
        k: getattr(stats, k) for k in (
            "n_requests", "new_tokens", "preemptions", "prefix_hit_rate",
            "decode_rows_saved", "max_active", "mean_latency_s")}},
        "prompt_tokens": sum(len(r.prompt) for r in out),
        "launches": launches, "plain_calls": plain_calls,
        "flash_launches": counts["flash_attention"],
        "audit": engine.pool.audit(), "kv_finite": finite,
        "decode_step_bytes_gb": step_bytes / 1e9,
        "decode_step_floor_ms": 1e3 * step_bytes / HBM_BPS,
        "sample_output": out[0].output[:8]}), flush=True)
    if not finite:
        raise SystemExit(f"FAIL: {what}: non-finite values in the KV pools")
    if args.shared_prefix and stats.prefix_hit_rate <= 0:
        raise SystemExit(f"FAIL: {what}: the shared prefix never hit")
    if (min(launches.values()) <= 0 or plain_calls
            or counts["flash_attention"]):
        raise SystemExit(f"FAIL: {what}: launches {launches}, plain calls "
                         f"{plain_calls}, flash {counts['flash_attention']}: "
                         "the engine did not run the paged kernels alone")
    if not {"paged", "prefill"} <= _kinds(engine):
        raise SystemExit(f"FAIL: {what} graphs {engine.graphs.keys}")
    summary[what] = _summary(res)
    phase("profile")
    summary[what]["busy_share"] = profile_engine(engine, args, res, "paged_",
                                                 modes)
    return engine, res, launches


def run_olmoe_paged(summary: dict, params) -> dict:
    """The full-width olmoe-1b-7b paged engine on the contiguous engine's
    weights (module docstring, phase 8). Returns each paged kernel's
    launches in the captured run."""
    args = serve_cli.build_parser().parse_args(OLMOE_PAGED_ARGS)
    what = "olmoe-1b-7b paged"
    engine, res, launches = run_paged_engine(summary, args, what, params)
    out = res["captured"]["out"]
    summary[what]["prefix_cache"] = prefix_resume(
        params, out, res["captured"]["stats"])
    summary[what]["vs_contiguous"] = first_step_gap(engine, out)
    return launches


def _run_args(argv, params):
    """Serve ``argv``'s request set once on a new engine over ``params``."""
    args = serve_cli.build_parser().parse_args(argv)
    engine, _ = serve_cli.build(args, params=params)
    return engine.run(serve_cli.requests(args))


def prefix_resume(params, out, stats) -> dict:
    """Prefix-cache hits that resume the expert counts against cold runs.
    Exact (gated): one slot and one prefill lane, 16 new tokens, with and
    without the prefix cache — every chunk, round and decode step has the
    same shapes in both runs, so a block-aligned hit that resumes the
    counts gives the cold run's tokens bit for bit. Reported: the phase's
    own run (``out``, ``stats``: 4 slots, 4 lanes) against the same
    options without
    the prefix cache, whose schedule differs (deferrals behind a donor,
    other lane and decode widths) and so its f32 GEMMs' shapes: tokens may
    part where two logits nearly tie (the request and the first token
    that differs)."""
    cold, cold_stats = _run_args(OLMOE_PAGED_ARGS + ["--no-prefix-cache"],
                                 params)
    parted = {r.job_id: next(i for i, (a, b) in enumerate(
                  zip(r.output, c.output)) if a != b)
              for r, c in zip(out, cold) if r.output != c.output}
    one = OLMOE_PAGED_ARGS + ["--slots", "1", "--prefill-lanes", "1",
                              "--max-new", "16"]
    warm, warm_stats = _run_args(one, params)
    exact, exact_stats = _run_args(one + ["--no-prefix-cache"], params)
    same = sum(a.output == b.output for a, b in zip(warm, exact))
    rec = {"four_slots": {"identical_requests": len(out) - len(parted),
                          "requests": len(out),
                          "first_differing_token": parted,
                          "prefill_dispatches": [
                              stats.prefill_dispatches,
                              cold_stats.prefill_dispatches]},
           "one_slot": {"identical_requests": same, "requests": len(warm),
                        "prefix_hit_rate": warm_stats.prefix_hit_rate,
                        "prefill_dispatches": [
                            warm_stats.prefill_dispatches,
                            exact_stats.prefill_dispatches]}}
    print(json.dumps({"olmoe_paged_prefix_cache_on_vs_off": rec}),
          flush=True)
    if (same != len(warm) or warm_stats.prefix_blocks_hit <= 0
            or exact_stats.prefix_blocks_hit or cold_stats.prefix_blocks_hit):
        raise SystemExit(f"FAIL: olmoe paged, one slot: with the prefix "
                         f"cache {same} of {len(warm)} requests give the "
                         "cold run's tokens")
    return rec


def first_step_gap(engine, out) -> dict:
    """The paged engine's first tokens (``out``) against a one-pass MoE
    forward over each prompt (flash attention: the contiguous engine's
    prefill), and the largest gap between that forward's last logits and
    the block-chunked paged prefill's over the same prompt (one lane,
    counts carried, the engine's static capacity). Reported, not gated:
    the kernels differ."""
    cfg, params, model = engine.cfg, engine.params, engine.model
    bs, agree, gap = engine.block_size, 0, 0.0
    with torch.inference_mode():
        for r in out:
            n = len(r.prompt)
            prompt = torch.as_tensor(r.prompt, dtype=torch.int32,
                                     device="cuda")
            one_pass = moe.forward(cfg, params, prompt[None])[0, -1]
            nblk = -(-n // bs)
            cache = model.init_paged_cache(nblk, bs, device="cuda")
            tables = torch.arange(nblk, dtype=torch.int32,
                                  device="cuda")[None]
            state = model.paged_prefill_state(1, "cuda")
            caps = torch.tensor([moe.capacity(cfg, n)], dtype=torch.int32,
                                device="cuda")
            for s0 in range(0, n, bs):
                k = min(bs, n - s0)
                tok = torch.zeros((1, bs), dtype=torch.int32, device="cuda")
                tok[0, :k] = prompt[s0:s0 + k]
                logits, cache, state = model.paged_prefill_chunk(
                    params, cache, tok,
                    torch.tensor([s0], dtype=torch.int32, device="cuda"),
                    tables, state, engine.max_len,
                    n_valid=torch.tensor([k], dtype=torch.int32,
                                         device="cuda"),
                    cap_rows=caps)
            gap = max(gap, (logits[0, -1] - one_pass).abs().max().item())
            agree += int(one_pass.argmax()) == r.output[0]
    rec = {"first_token_agreement": agree, "requests": len(out),
           "max_first_step_logit_gap": gap}
    print(json.dumps({"olmoe_paged_vs_contiguous": rec}), flush=True)
    return rec


def run_phi3(summary: dict) -> dict:
    """Full-width phi-3-vision-4.2b (module docstring, phase 9): forward and
    loss on [1, 1024] tokens with [1, 576, 3072] patch embeddings (flash in
    all 32 layers) against the same forward with the flash kernel's plain
    version in its place, then the paged engine on the same weights.
    Returns {"forward": flash launches, "paged": paged launches}."""
    cfg = get_config("phi-3-vision-4.2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, PHI_S), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks,
             "labels": torch.randint(0, cfg.vocab_size, (1, PHI_S),
                                     generator=g, device="cuda",
                                     dtype=torch.int32),
             "patch_embeds": 0.02 * torch.randn(1, PHI_P, cfg.d_model,
                                                generator=g, device="cuda")}
    rec = {"params": sum(t.numel() for t in _leaves(params)),
           "tokens": PHI_S, "patches": PHI_P}
    with torch.inference_mode():
        model.forward(params, {k: v[:, :PHI_P + 64] if k == "tokens" else v
                               for k, v in batch.items()})      # warm-up
        ops.flash_attention.launches = fa.flash_attention_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
        rec["forward_ms"] = 1e3 * (time.perf_counter() - t0)
        launches = ops.flash_attention.launches
        if launches != cfg.n_layers or fa.flash_attention_plain.calls:
            raise SystemExit(f"FAIL: phi-3-vision forward: flash launches "
                             f"{launches} (want {cfg.n_layers}), plain "
                             f"calls {fa.flash_attention_plain.calls}")
        with plain_flash():
            ref = model.forward(params, batch)
        gap = (logits - ref).abs().max().item()
        rec.update(logits_shape=list(logits.shape),
                   plain_path_max_abs_diff=gap, finite=bool(torch.isfinite(logits).all()),
                   loss=model.loss(params, batch).item())
        print(json.dumps({"phi3_forward": rec}), flush=True)
        if (not rec["finite"] or tuple(logits.shape)
                != (1, PHI_S, cfg.vocab_size)):
            raise SystemExit("FAIL: phi-3-vision forward logits")
        if not torch.allclose(logits, ref, atol=1e-3, rtol=1e-3):
            raise SystemExit(f"FAIL: phi-3-vision forward differs from its "
                             f"plain path by {gap:.3e} (tol 1e-3)")
        del logits, ref
    args = serve_cli.build_parser().parse_args(PHI3_ARGS)
    _, _, paged = run_paged_engine(summary, args, "phi-3-vision-4.2b paged",
                                   params)
    return {"forward": launches, "paged": paged}


@contextlib.contextmanager
def plain_flash():
    """The model's flash calls take the kernel's plain version (on the
    card) while the context is open: the reference the forward is held to."""
    real = layers.kops.flash_attention

    def plain(q, k, v, *, causal=True, window=0):
        return fa.flash_attention_plain(q, k, v, causal, window)

    layers.kops.flash_attention = plain
    try:
        yield
    finally:
        layers.kops.flash_attention = real


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


#: profiled windows a run may take before incomplete ones fail it
#: (``profile_complete``)
PROFILE_ATTEMPTS = 4
#: each hand-written kernel's name fragment in a profile, and the launch
#: counter whose launches it is (the paged merge: see ``implied_events``)
KERNEL_EVENTS = {"flash_attention_kernel": "flash_attention",
                 "paged_decode_kernel": "paged_attention",
                 "paged_prefill_kernel": "paged_prefill_attention",
                 "grouped_matmul_kernel": "grouped_matmul",
                 "ssd_scan_chunk_kernel": "ssd_scan"}


def implied_events(engine, counts: dict) -> dict:
    """The device events of each hand-written kernel that the launch
    counters ``counts`` imply on ``engine``: one a launch, and one merge
    after each paged launch whose table walk is split (the split plan
    depends only on the pool's table width and block size)."""
    want = {frag: counts[name] for frag, name in KERNEL_EVENTS.items()}
    mb = getattr(engine.pool, "max_blocks", 0)

    def split(keys):
        return int(mb > 0 and pa.split_plan(mb, engine.block_size,
                                            keys)[1] > 1)

    want["paged_merge_kernel"] = (
        counts["paged_attention"] * split(pa.DECODE_SPLIT_KEYS)
        + counts["paged_prefill_attention"] * split(pa.SPLIT_KEYS))
    return want


def profile_engine(engine, args, res: dict, ours: str,
                   modes=("replayed", "eager")) -> dict:
    """torch.profiler over the engine phase's own request set (``args``) on
    ``engine``, whose signatures ``serve_modes`` captured: a replayed and an
    eager run, each profiled alone with every launch counter set to 0 just
    before. A window counts only when the profiler saw, of each
    hand-written kernel, the launches that the counters say
    (``implied_events``; under replay the counters are the capture's
    launches added back per replay, so this is what shows that a replay ran
    the kernels); else the run is profiled again (``profile_complete``),
    and fails after four. Fails too if the replayed run captured anything. The profiler slows the host (it records every launch),
    so the busy share is given twice: the device's busy seconds over the
    profiled run's wall clock, and over the wall clock of the unprofiled run
    of the same mode in ``res`` (same requests, same kernels). Prints the
    device time by kernel (``ours``: the name fragment of this path's
    kernels); returns {mode: both shares}. ``modes``: the runs to profile.
    """
    print(f"profile {args.arch} {args.cache} ({time.strftime('%H:%M:%S')})",
          flush=True)
    share = {}
    for mode in modes:
        runs, keys = [], len(engine.graphs.keys)

        def serve():
            ops.set_counts((0,) * len(ops.COUNTERS))
            runs.append(engine.run(serve_cli.requests(args)))

        def missing(rec):
            counts = dict(zip(COUNTER_NAMES, ops.counts()))
            want = implied_events(engine, counts)
            seen = {frag: sum(n for name, n in rec["events"].items()
                              if frag in name) for frag in want}
            rec["kernel_events"] = {k: v for k, v in seen.items() if v}
            if seen != want:
                return (f"kernel events {seen}, the launch counters imply "
                        f"{want}")
            return None

        with _mode(mode):
            rec = profile_complete(serve, ours, missing)
        del rec["events"]
        out, stats = runs[-1]
        share[mode] = {
            "profiled_wall": rec["device_busy_share"],
            "unprofiled_wall":
                rec["device_busy_s"] / res[mode]["stats"].wall_s}
        print(json.dumps({"profile": {
            "arch": args.arch, "cache": args.cache, "mode": mode,
            "requests": args.batch, "slots": args.slots,
            "prompt_tokens": sum(len(r.prompt) for r in out),
            "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
            "prefill_dispatches": stats.prefill_dispatches,
            "steps": stats.steps, "max_active": stats.max_active,
            "unprofiled_wall_s": res[mode]["stats"].wall_s,
            "busy_share_of_unprofiled_wall": share[mode]["unprofiled_wall"],
            **rec}}), flush=True)
        if len(engine.graphs.keys) != keys:
            raise SystemExit(f"FAIL: {args.arch} {mode}: the profiled run "
                             "captured new signatures")
    return share


def profile_complete(fn, ours: str, missing=lambda rec: None) -> dict:
    """``profile_call(fn, ours)`` until a window holds every event of its
    run: the marker seen and ``missing(rec)`` (what else the run's events
    must show) None. The profiler loses events now and then, at a window's
    end or inside it (``tools/profiler_probe.py``); an incomplete window is
    discarded, with a line saying why, and the run profiled again. Fails
    after ``PROFILE_ATTEMPTS`` incomplete windows in a row: a loss that
    repeats is the program's, not the profiler's."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        rec = profile_call(fn, ours)
        why = (missing(rec) if rec.pop("marker_seen")
               else "the marker kernel was lost")
        if why is None:
            rec["attempt"] = attempt
            return rec
        print(json.dumps({"profile_discarded": {
            "attempt": attempt, "device_events": rec["device_events"],
            "why": why}}), flush=True)
    raise SystemExit(f"FAIL: {PROFILE_ATTEMPTS} profiles in a row were "
                     f"incomplete: {why}")


def profile_call(fn, ours: str) -> dict:
    """torch.profiler over one call of ``fn``, device activity only: its
    wall clock, the device's busy seconds (the union of its kernel, copy
    and fill intervals) and share, the device time of the kernels whose
    names hold ``ours``, the top kernels by device time, and the number of
    events by name (``events``). The raw events are read directly: an
    eager engine run makes hundreds of thousands, and one Python object
    each (``key_averages``) made the profile phases most of the script's
    time. A marker kernel follows ``fn`` inside the window; ``marker_seen``
    says whether the profiler kept it, so whether it lost events at the
    window's end (the window stays open 0.1 s past the marker: closed at
    once, it dropped the marker more often). Fails if there was no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)                 # the marker: spin_kernel
        torch.cuda.synchronize()
        time.sleep(0.1)   # the window must close after the marker's end
    spans, by_name, marker = [], {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name()
        if "spin_kernel" in name:
            marker += 1
            continue
        a, b = ev.start_ns(), ev.end_ns()
        spans.append((a, b))
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + (b - a) / 1e3, n + 1)
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    busy_s = busy_ns / 1e9
    if busy_s <= 0:
        raise SystemExit("FAIL: the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    mine = sorted(((k, us, n) for k, (us, n) in by_name.items() if ours in k),
                  key=lambda x: -x[1])
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall, "device_events": len(spans),
            "marker_seen": marker > 0,
            f"{ours}kernels_s": sum(us for _, us, _ in mine) / 1e6,
            f"{ours}kernels": [{"name": k[:80], "s": us / 1e6, "count": n}
                               for k, us, n in mine],
            "top_kernels": [{"name": k[:80], "s": us / 1e6, "count": n}
                            for k, (us, n) in top],
            "events": {k: n for k, (_, n) in by_name.items()}}


def run_mamba2() -> int:
    """Full-width mamba2-780m forward and loss on [2, 4096] tokens, then the
    recurrent decode chain on a [1, 256] prefix against the forward's
    logits, then a profiled forward (module docstring, phase 8). Returns
    the SSD kernel's launches in one forward."""
    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params["emb"])) + sum(
        t.numel() for lp in params["layers"] for t in _leaves(lp))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (M2_B, M2_S), generator=g,
                         device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (M2_B, M2_S), generator=g,
                           device="cuda", dtype=torch.int32)
    rec = {"params": n_params, "tokens": M2_B * M2_S}
    with torch.inference_mode():
        model.forward(params, {"tokens": toks[:, :M2_Q]})       # warm-up
        launches = {}
        for name, fn in (("forward", lambda: model.forward(
                             params, {"tokens": toks})),
                         ("loss", lambda: model.loss(
                             params, {"tokens": toks, "labels": labels}))):
            ops.ssd_scan.launches = 0
            ssd.ssd_scan_plain.calls = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = ops.ssd_scan.launches
            if launches[name] != cfg.n_layers or ssd.ssd_scan_plain.calls:
                raise SystemExit(
                    f"FAIL: mamba2 {name}: ssd_scan launches "
                    f"{launches[name]} (want {cfg.n_layers}), plain calls "
                    f"{ssd.ssd_scan_plain.calls}")
            if not bool(torch.isfinite(out).all()):
                raise SystemExit(f"FAIL: mamba2 {name} is not finite")
            rec[f"{name}_ms"] = 1e3 * wall
            rec[f"{name}_tokens_per_s"] = M2_B * M2_S / wall
            if name == "forward":
                if tuple(out.shape) != (M2_B, M2_S, cfg.vocab_size):
                    raise SystemExit(f"FAIL: logits {tuple(out.shape)}")
                prefix = out[0, :M2_Q].clone()
            else:
                rec["loss"] = out.item()
            del out
        # the recurrent path at the published widths against the kernel's
        cache = model.init_cache(1, M2_Q, device="cuda")
        gap = 0.0
        t0 = time.perf_counter()
        for t in range(M2_Q):
            logits, cache = model.decode_step(params, cache,
                                              toks[:1, t:t + 1], t)
            gap = max(gap, (logits[0, 0] - prefix[t]).abs().max().item())
            if not torch.allclose(logits[0, 0], prefix[t], atol=2e-3,
                                  rtol=1e-5):
                raise SystemExit(f"FAIL: mamba2 decode step {t} differs from "
                                 f"the forward by {gap:.3e} (tol 2e-3)")
        rec["decode_steps"] = M2_Q
        rec["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / M2_Q
        rec["decode_vs_forward_max_abs_diff"] = gap
        rec["launches_per_forward"] = launches
        print(json.dumps({"mamba2_forward": rec}), flush=True)
        prof = profile_complete(
            lambda: model.forward(params, {"tokens": toks}), "ssd_scan_")
        del prof["events"]
        print(json.dumps({"profile": {"arch": cfg.arch_id,
                                      "call": "forward [2, 4096]", **prof}}),
              flush=True)
    return launches["forward"]


def run_mamba2_engine(summary: dict) -> None:
    """The full-width mamba2-780m contiguous engine (module docstring,
    phase 9); the SSD kernel must not launch."""
    args = serve_cli.build_parser().parse_args(MAMBA2_ARGS)
    engine, _ = serve_cli.build(args)
    res = serve_modes(engine, args, "mamba2-780m contiguous")
    out, stats, counts = (res["captured"][k]
                          for k in ("out", "stats", "launches"))
    _check_outputs("mamba2", engine, out, args.max_new)
    finite = all(bool(torch.isfinite(b).all())
                 for b in engine.pool.buffers.values())
    print(json.dumps({"mamba2_engine": {k: getattr(stats, k) for k in (
        "n_requests", "new_tokens", "decode_rows_saved", "max_active",
        "mean_latency_s")},
        "prompt_tokens": sum(len(r.prompt) for r in out),
        "ssd_scan_launches": counts["ssd_scan"],
        "ssd_scan_plain_calls": counts["ssd_scan_plain"],
        "state_finite": finite, "sample_output": out[0].output[:8]}),
        flush=True)
    print("ssd_scan launched 0 times in the mamba2 engine: serving prefills "
          "by stepping the recurrent state, as the reference does", flush=True)
    if not finite:
        raise SystemExit("FAIL: non-finite values in the recurrent state")
    if counts["ssd_scan"] or counts["ssd_scan_plain"] or \
            stats.prefill_dispatches != args.batch:
        raise SystemExit("FAIL: the mamba2 engine ran the SSD scan or missed "
                         "a prefill")
    if not {"contiguous", "recurrent_step"} <= _kinds(engine):
        raise SystemExit(f"FAIL: mamba2 graphs {engine.graphs.keys}")
    summary["mamba2-780m contiguous"] = _summary(res)
    summary["mamba2-780m contiguous"]["busy_share"] = profile_engine(
        engine, args, res, "ssd_scan_")


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
    print_ptxas(ptxas)
    check_tensor_cores(lib)
    build.library()

    phase("kernels")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rec = check_kernels(flush)
    check_splits(flush, "paged_decode")
    check_splits(flush, "paged_prefill")
    check_engine_shapes(flush, rec)
    rec["flash_attention"] = check_flash(flush)
    rec["grouped_matmul"] = check_grouped_matmul(flush)
    rec["ssd_scan"] = check_ssd(flush)
    del flush
    torch.cuda.empty_cache()

    phase("reference")
    check_reference()

    phase("engine")
    summary = {}
    #: each kernel's launches in the captured run of each path
    paths = {name: {} for name in rec}
    launches = run_engine(summary)  # and the profile and sampled phases
    for name, n in launches.items():
        paths[name]["qwen2-0.5b paged"] = n

    phase("olmoe")
    gc.collect()                    # the qwen2 engines are gone: free them
    torch.cuda.empty_cache()
    launches, params = run_olmoe(summary)
    for name in ("flash_attention", "grouped_matmul"):
        paths[name]["olmoe-1b-7b contiguous"] = launches[name]

    phase("olmoe paged")
    for name, n in run_olmoe_paged(summary, params).items():
        paths[name]["olmoe-1b-7b paged"] = n
    del params
    gc.collect()                    # the olmoe engines are gone: free them
    torch.cuda.empty_cache()

    phase("phi-3-vision")
    phi = run_phi3(summary)
    paths["flash_attention"]["phi-3-vision-4.2b forward"] = phi["forward"]
    for name, n in phi["paged"].items():
        paths[name]["phi-3-vision-4.2b paged"] = n
    gc.collect()                    # the phi-3-vision engine is gone
    torch.cuda.empty_cache()

    phase("mamba2")
    paths["ssd_scan"]["mamba2-780m forward"] = run_mamba2()
    gc.collect()
    torch.cuda.empty_cache()

    phase("mamba2 engine")
    run_mamba2_engine(summary)
    phase("summary")
    print(json.dumps({"graphs_vs_eager": summary}), flush=True)

    unread = [name for name, by_path in paths.items() if not by_path]
    if unread:
        raise SystemExit(f"FAIL: no engine run counted the launches of "
                         f"{unread}")
    for name, by_path in paths.items():
        rec[name]["launches"] = sum(by_path.values())
        rec[name]["launches_by_path"] = by_path
    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
