"""Public wrappers for the port's kernels (signatures of the JAX package's
``kernels/ops.py:36``, ``:64``, ``:85``, ``:107`` and ``:124``).

The route depends only on where the tensors lie: CPU tensors take the
plain PyTorch version, CUDA tensors launch the hand-written kernel (which
raises on anything it does not take — there is no fallback). Each wrapper
counts its kernel launches in a plain int attribute, ``launches``, and
each plain version its calls in ``calls``. A replayed CUDA graph runs no
Python, so ``serve/graphs.py`` reads these counters around a capture
(``counts``), puts them back (``set_counts``) and adds the capture's
difference on every replay (``add_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> [B, S, Hq, D]. Causal
    and/or sliding-window (0 = none) self-attention; a non-causal S must
    be a multiple of the JAX wrapper's block ``min(128, max(8, S))``, as
    there (on both routes)."""
    s = q.shape[1]
    if not causal and s % _fa.tpu_block(s):
        raise ValueError("non-causal flash attention requires S % block == 0")
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal, window)
    out = _fa.flash_attention_cuda(q, k, v, causal, window)
    flash_attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, tables, pos, window: int = 0):
    """q: [B, Hq, D]; k_pages, v_pages: [NB, BS, Hkv, D]; tables: [B, MB]
    int32 block ids (-1 = unassigned); pos: [B] int32; window: int (0 =
    full attention). Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pages, v_pages, tables, pos,
                                         window)
    out = _pa.paged_attention_cuda(q, k_pages, v_pages, tables, pos, window)
    paged_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, tables, start,
                            window: int = 0):
    """q: [B, C, Hq, D] — row b's query c at logical position
    ``start[b] + c``; pools, tables and window as in ``paged_attention``;
    start: [B] int32. The chunk's own K/V must already be written through
    the table. Returns [B, C, Hq, D]."""
    if q.device.type == "cpu":
        return _pa.paged_prefill_attention_plain(q, k_pages, v_pages, tables,
                                                 start, window)
    out = _pa.paged_prefill_cuda(q, k_pages, v_pages, tables, start, window)
    paged_prefill_attention.launches += 1
    return out


def ssd_scan(xdt, a_log, B, C, chunk: int = 128):
    """xdt: [B, S, H, P]; a_log: [B, S, H]; B, C: [B, S, H, N] -> y
    [B, S, H, P], always float32. Each input is cast to float32; the chunk
    halves until it divides S, as in the JAX wrapper. The CUDA kernel has
    no backward pass and raises when grad mode is on and an input requires
    grad."""
    s = xdt.shape[1]
    q = chunk
    while s % q != 0:
        q //= 2
    args = [t.to(torch.float32).contiguous() for t in (xdt, a_log, B, C)]
    if xdt.device.type == "cpu":
        return _ssd.ssd_scan_plain(*args, chunk=q)
    out = _ssd.ssd_scan_cuda(*args, chunk=q)
    ssd_scan.launches += 1
    return out


def grouped_matmul(x, w, valid_rows=None):
    """x: [G, C, K]; w: [G, K, N]; valid_rows: [G] int32 or None ->
    [G, C, N] in x's dtype, f32 accumulation; rows at or past
    ``valid_rows[g]`` come back as 0."""
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_plain(x, w, valid_rows)
    out = _gmm.grouped_matmul_cuda(x, w, valid_rows)
    grouped_matmul.launches += 1
    return out


flash_attention.launches = 0
paged_attention.launches = 0
paged_prefill_attention.launches = 0
ssd_scan.launches = 0
grouped_matmul.launches = 0

#: every counter above, as (function, attribute)
COUNTERS = tuple(
    [(f, "launches") for f in (flash_attention, paged_attention,
                               paged_prefill_attention, ssd_scan,
                               grouped_matmul)]
    + [(f, "calls") for f in (_fa.flash_attention_plain,
                              _pa.paged_attention_plain,
                              _pa.paged_prefill_attention_plain,
                              _ssd.ssd_scan_plain,
                              _gmm.grouped_matmul_plain)])


def counts() -> tuple:
    """The value of every launch and plain-call counter."""
    return tuple(getattr(f, a) for f, a in COUNTERS)


def set_counts(values) -> None:
    for (f, a), v in zip(COUNTERS, values):
        setattr(f, a, v)


def add_counts(delta) -> None:
    for (f, a), d in zip(COUNTERS, delta):
        setattr(f, a, getattr(f, a) + d)
