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

Gradients. On CPU tensors autograd runs through the plain versions. On
CUDA tensors ``flash_attention`` and ``ssd_scan`` run inside
``torch.autograd.Function``s whose backward launches a hand-written kernel
(``flash_attention_backward`` and ``ssd_scan_backward``, counted like the
forwards); the paged kernels and the grouped matmul have no backward and
raise when grad mode is on and an input requires grad, rather than return
a result without a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(what: str, *tensors) -> None:
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{what}'s CUDA kernel has no backward pass: call it under "
            "torch.no_grad() or torch.inference_mode(), or with inputs that "
            "do not require grad")


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _fa.flash_attention_cuda(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout,
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


class _SSDScan(torch.autograd.Function):
    """The SSD scan kernel with ``ssd_scan_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, xdt, a_log, B, C, chunk):
        y, states = _ssd.ssd_scan_cuda(xdt, a_log, B, C, chunk=chunk,
                                       return_states=True)
        ctx.save_for_backward(xdt, a_log, B, C, y, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xdt, a_log, B, C, y, states = ctx.saved_tensors
        return (*ssd_scan_backward(xdt, a_log, B, C, dy, chunk=ctx.chunk,
                                   fwd=(y, states)), None)


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
    if _needs_grad(q, k, v):
        out = _FlashAttention.apply(q, k, v, causal, window)
    else:
        out = _fa.flash_attention_cuda(q, k, v, causal, window)
    flash_attention.launches += 1
    return out


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: int = 0):
    """(dq, dk, dv) of flash attention for the upstream gradient ``dout``
    [B, S, Hq, D] and the forward's ``out``: autograd through the plain
    version on the CPU, the backward kernel (f32) on CUDA tensors."""
    if q.device.type == "cpu":
        return _fa.flash_attention_backward_plain(q, k, v, dout, causal,
                                                  window)
    grads = _fa.flash_attention_backward_cuda(q, k, v, out, dout, causal,
                                              window)
    flash_attention_backward.launches += 1
    return grads


def paged_attention(q, k_pages, v_pages, tables, pos, window: int = 0):
    """q: [B, Hq, D]; k_pages, v_pages: [NB, BS, Hkv, D]; tables: [B, MB]
    int32 block ids (-1 = unassigned); pos: [B] int32; window: int (0 =
    full attention). Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pages, v_pages, tables, pos,
                                         window)
    _refuse_grad("paged_attention", q, k_pages, v_pages)
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
    _refuse_grad("paged_prefill_attention", q, k_pages, v_pages)
    out = _pa.paged_prefill_cuda(q, k_pages, v_pages, tables, start, window)
    paged_prefill_attention.launches += 1
    return out


def ssd_scan(xdt, a_log, B, C, chunk: int = 128):
    """xdt: [B, S, H, P]; a_log: [B, S, H]; B, C: [B, S, H, N] -> y
    [B, S, H, P], always float32. Each input is cast to float32; the chunk
    halves until it divides S, as in the JAX wrapper. On CUDA tensors that
    need a gradient the kernel runs with ``ssd_scan_backward`` as its
    backward."""
    s = xdt.shape[1]
    q = chunk
    while s % q != 0:
        q //= 2
    args = [t.to(torch.float32).contiguous() for t in (xdt, a_log, B, C)]
    if xdt.device.type == "cpu":
        return _ssd.ssd_scan_plain(*args, chunk=q)
    if _needs_grad(*args):
        out = _SSDScan.apply(*args, q)
    else:
        out = _ssd.ssd_scan_cuda(*args, chunk=q)
    ssd_scan.launches += 1
    return out


def ssd_scan_backward(xdt, a_log, B, C, dy, chunk: int = 128, fwd=None):
    """(dxdt, da_log, dB, dC) of the SSD scan for the upstream gradient
    ``dy`` [B, S, H, P] (float32 inputs, contiguous; ``chunk`` dividing
    S): autograd through the plain version on the CPU; on CUDA tensors the
    forward kernel on the reversed and rearranged inputs and the
    decay-gradient kernel (``kernels/ssd_scan.py`` has the identity).
    ``fwd`` is the forward launch's ``(y, chunk states)``, recomputed with
    one more launch when not given."""
    if xdt.device.type == "cpu":
        return _ssd.ssd_scan_backward_plain(xdt, a_log, B, C, dy, chunk=chunk)
    grads = _ssd.ssd_scan_backward_cuda(xdt, a_log, B, C, dy, chunk, fwd=fwd)
    ssd_scan_backward.launches += 1
    return grads


def grouped_matmul(x, w, valid_rows=None):
    """x: [G, C, K]; w: [G, K, N]; valid_rows: [G] int32 or None ->
    [G, C, N] in x's dtype, f32 accumulation; rows at or past
    ``valid_rows[g]`` come back as 0."""
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_plain(x, w, valid_rows)
    _refuse_grad("grouped_matmul", x, w)
    out = _gmm.grouped_matmul_cuda(x, w, valid_rows)
    grouped_matmul.launches += 1
    return out


flash_attention.launches = 0
paged_attention.launches = 0
paged_prefill_attention.launches = 0
ssd_scan.launches = 0
grouped_matmul.launches = 0
flash_attention_backward.launches = 0
ssd_scan_backward.launches = 0

#: every counter above, as (function, attribute). The counts are plain
#: ``+=`` on a function attribute, not atomic across threads: where several
#: threads launch (the live runtime's jobs), read them as "some" and "none".
COUNTERS = tuple(
    [(f, "launches") for f in (flash_attention, paged_attention,
                               paged_prefill_attention, ssd_scan,
                               grouped_matmul, flash_attention_backward,
                               ssd_scan_backward)]
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
