"""Public wrappers for the port's kernels (signatures of the JAX package's
``kernels/ops.py:36``, ``:64``, ``:85``, ``:107`` and ``:124``).

The route depends only on where the tensors lie: CPU tensors take the
plain PyTorch version, CUDA tensors launch the hand-written kernel (which
raises on anything it does not take — there is no fallback), and tensors
without storage (meta: the dry-run's, ``launch/dryrun.py``) compute
nothing: they return an output of the kernel's shape and dtype and book
the kernel's ``kernels/cost.py`` terms into the dry-run's counting mode,
the innermost mode on the dispatch stack that takes kernel bookings, so a
dry-run counts the work the card runs. A call that the CUDA route would
refuse (the backward kernels' dtypes and limits) is booked with the
reason, so the dry-run marks its record as one the card cannot run. Each
wrapper
counts its kernel launches in a plain int attribute, ``launches``, and
each plain version its calls in ``calls``. A replayed CUDA graph runs no
Python, so ``serve/graphs.py`` reads these counters around a capture
(``counts``), puts them back (``set_counts``) and adds the capture's
difference on every replay (``add_counts``).

Partial launches. A rank of a sequence-sharded attention layer (kv-seq over
a position-split pool, q-seq over its block of query rows) calls its own
wrappers, ``paged_attention_partial``, ``paged_prefill_partial`` and
``flash_attention_offset``: the same kernels in their partial and query-offset
modes, counted apart from the whole-pool and self-attention launches so a
run shows which it took. Their CPU route counts its calls in
``plain_calls`` (the plain versions' ``calls`` count every mode).

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
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd


def _storage_less(t) -> bool:
    """A tensor without storage (meta): the dry-run's cost route."""
    return t.device.type == "meta"


def _book(name: str, terms, refused=None) -> None:
    """Book one kernel call's ``cost.py`` (flops, bytes) into the active
    counting mode (none: nothing counts); ``refused``: why the CUDA route
    would refuse the call."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "book_kernel"):
            mode.book_kernel(name, *terms, refused=refused)
            return


def _flash_forward(q, k, v, causal, window, return_lse=False):
    """The forward kernel; on tensors without storage its outputs' shapes
    (out, and the row log-sum-exp [B Hq, S] f32) and its cost booked."""
    if not _storage_less(q):
        return _fa.flash_attention_cuda(q, k, v, causal, window,
                                        return_lse=return_lse)
    b, s, hq, d = q.shape
    _book("flash_attention", cost.flash_attention(
        b, s, hq, k.shape[2], d, q.element_size(), causal, window))
    out = q.new_empty((b, s, hq, d))
    if return_lse:
        return out, q.new_empty((b * hq, s), dtype=torch.float32)
    return out


def _ssd_forward(xdt, a_log, B, C, chunk, return_states=False):
    """The SSD forward kernel; on tensors without storage its outputs'
    shapes (y, and the chunk states [B H, S / Q - 1, N, P]) and its cost
    booked."""
    if not _storage_less(xdt):
        return _ssd.ssd_scan_cuda(xdt, a_log, B, C, chunk=chunk,
                                  return_states=return_states)
    b, s, h, p = xdt.shape
    n = B.shape[3]
    _book("ssd_scan", cost.ssd_scan(b, s, h, p, n, chunk))
    y = xdt.new_empty((b, s, h, p))
    if return_states:
        return y, xdt.new_empty((b * h, s // chunk - 1, n, p))
    return y


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
        # the backward kernel takes the forward's row log-sum-exp (f32 for
        # f32 and bf16 inputs)
        out, lse = _flash_forward(q, k, v, causal, window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout,
                                              causal=ctx.causal,
                                              window=ctx.window, lse=lse)
        return dq, dk, dv, None, None


class _SSDScan(torch.autograd.Function):
    """The SSD scan kernel with ``ssd_scan_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, xdt, a_log, B, C, chunk):
        y, states = _ssd_forward(xdt, a_log, B, C, chunk,
                                 return_states=True)
        ctx.save_for_backward(xdt, a_log, B, C, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xdt, a_log, B, C, states = ctx.saved_tensors
        return (*ssd_scan_backward(xdt, a_log, B, C, dy, chunk=ctx.chunk,
                                   states=states), None)


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
        out = _flash_forward(q, k, v, causal, window)
    if not _storage_less(q):
        flash_attention.launches += 1
    return out


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: int = 0, lse=None):
    """(dq, dk, dv) of flash attention for the upstream gradient ``dout``
    [B, S, Hq, D] and the forward's ``out``: autograd through the plain
    version on the CPU, the backward kernel (f32 or bf16, the gradients in
    the inputs' dtype) on CUDA tensors, which also takes the forward's row
    log-sum-exp ``lse`` [B Hq, S] (f32)."""
    if q.device.type == "cpu":
        return _fa.flash_attention_backward_plain(q, k, v, dout, causal,
                                                  window)
    if _storage_less(q):
        b, s, hq, d = q.shape
        hkv = k.shape[2]
        refused = None
        if q.dtype not in _fa._DTYPES:
            refused = (f"the backward kernel takes float32 and bfloat16 "
                       f"only, got {q.dtype}")
        elif lse is None:
            refused = "the backward kernel needs the forward's log-sum-exp"
        _book("flash_attention_backward", cost.flash_attention_backward(
            b, s, hq, hkv, d, q.element_size(), causal, window), refused)
        dk = q.new_empty((b, s, hkv, d))
        return q.new_empty(q.shape), dk, torch.empty_like(dk)
    grads = _fa.flash_attention_backward_cuda(q, k, v, out, dout, lse,
                                              causal, window)
    flash_attention_backward.launches += 1
    return grads


def _paged_dry(name, q, k_pages, tables, c: int, window: int, pos_base=None):
    """A paged kernel on tensors without storage: the table holds no data,
    so the cost booked is a full table's (``cost.full_table``); a partial
    call (``pos_base``) also returns its rows' log-sum-exp."""
    _, bs, hkv, d = k_pages.shape
    b, mb = tables.shape
    bs_g = pos_base[0] if pos_base is not None else bs
    _book(name, cost.paged_attention(
        q.shape[-2], hkv, d, bs, q.element_size(), c, window,
        *cost.full_table(b, mb, bs_g, c), pos_base=pos_base,
        lse=pos_base is not None))
    out = q.new_empty(q.shape)
    if pos_base is None:
        return out
    return out, q.new_empty(q.shape[:-1], dtype=torch.float32)


def paged_attention(q, k_pages, v_pages, tables, pos, window: int = 0):
    """q: [B, Hq, D]; k_pages, v_pages: [NB, BS, Hkv, D]; tables: [B, MB]
    int32 block ids (-1 = unassigned); pos: [B] int32; window: int (0 =
    full attention). Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pages, v_pages, tables, pos,
                                         window)
    _refuse_grad("paged_attention", q, k_pages, v_pages)
    if _storage_less(q):
        return _paged_dry("paged_attention", q, k_pages, tables, 1, window)
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
    if _storage_less(q):
        return _paged_dry("paged_prefill_attention", q, k_pages, tables,
                          q.shape[1], window)
    out = _pa.paged_prefill_cuda(q, k_pages, v_pages, tables, start, window)
    paged_prefill_attention.launches += 1
    return out


def paged_attention_partial(q, k_pages, v_pages, tables, pos, window: int,
                            pos_base):
    """The decode kernel's partial mode: ``k_pages`` / ``v_pages`` hold
    in-block offsets ``[off, off + BS)`` of every block of ``BS_g``
    positions (``pos_base = (BS_g, off)``). Returns (out [B, Hq, D], each
    row's log-sum-exp [B, Hq] f32, -inf where the slice held no visible
    key), which ``sharding.merge_partials`` combines over the ranks."""
    if q.device.type == "cpu":
        paged_attention_partial.plain_calls += 1
        return _pa.paged_attention_plain(q, k_pages, v_pages, tables, pos,
                                         window, pos_base, return_lse=True)
    _refuse_grad("paged_attention_partial", q, k_pages, v_pages)
    if _storage_less(q):
        return _paged_dry("paged_attention_partial", q, k_pages, tables, 1,
                          window, pos_base)
    res = _pa.paged_attention_cuda(q, k_pages, v_pages, tables, pos, window,
                                   pos_base, return_lse=True)
    paged_attention_partial.launches += 1
    return res


def paged_prefill_partial(q, k_pages, v_pages, tables, start, window: int,
                          pos_base):
    """The prefill kernel's partial mode (``paged_attention_partial``'s
    pool slice): q [B, C, Hq, D] -> (out [B, C, Hq, D], log-sum-exp
    [B, C, Hq] f32)."""
    if q.device.type == "cpu":
        paged_prefill_partial.plain_calls += 1
        return _pa.paged_prefill_attention_plain(
            q, k_pages, v_pages, tables, start, window, pos_base,
            return_lse=True)
    _refuse_grad("paged_prefill_partial", q, k_pages, v_pages)
    if _storage_less(q):
        return _paged_dry("paged_prefill_partial", q, k_pages, tables,
                          q.shape[1], window, pos_base)
    res = _pa.paged_prefill_cuda(q, k_pages, v_pages, tables, start, window,
                                 pos_base, return_lse=True)
    paged_prefill_partial.launches += 1
    return res


def flash_attention_offset(q, k, v, q_offset: int, *, causal: bool = True,
                           window: int = 0):
    """Flash attention for a block of query rows: q [B, Sq, Hq, D] at
    positions ``q_offset .. q_offset + Sq - 1`` against k, v
    [B, Sk, Hkv, D] at ``0 .. Sk - 1`` (Sq <= Sk) -> [B, Sq, Hq, D]. The
    forward only: with grad mode on and an input that requires grad it
    raises, as the paged kernels do."""
    if q.device.type == "cpu":
        flash_attention_offset.plain_calls += 1
        return _fa.flash_attention_plain(q, k, v, causal, window, q_offset)
    _refuse_grad("flash_attention_offset", q, k, v)
    if _storage_less(q):
        b, s, hq, d = q.shape
        _book("flash_attention_offset", cost.flash_attention(
            b, s, hq, k.shape[2], d, q.element_size(), causal, window,
            q_offset=q_offset, sk=k.shape[1]))
        return q.new_empty(q.shape)
    out = _fa.flash_attention_cuda(q, k, v, causal, window,
                                   q_offset=q_offset)
    flash_attention_offset.launches += 1
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
        out = _ssd_forward(*args, q)
    if not _storage_less(xdt):
        ssd_scan.launches += 1
    return out


def ssd_scan_backward(xdt, a_log, B, C, dy, chunk: int = 128, states=None):
    """(dxdt, da_log, dB, dC) of the SSD scan for the upstream gradient
    ``dy`` [B, S, H, P] (float32 inputs, contiguous; ``chunk`` dividing
    S): autograd through the plain version on the CPU; on CUDA tensors the
    backward kernels (``csrc/ssd_scan_bwd.cu``), which also take the
    forward launch's chunk ``states``."""
    if xdt.device.type == "cpu":
        return _ssd.ssd_scan_backward_plain(xdt, a_log, B, C, dy, chunk=chunk)
    if _storage_less(xdt):
        b, s, h, p = xdt.shape
        n, q = B.shape[3], min(chunk, s)
        refused = None
        if q > _ssd._BWD_QMAX or n > _ssd._BWD_NMAX or \
                _ssd.bwd_smem_bytes(n, p, q) > _ssd._MAX_SMEM:
            refused = (f"the backward takes a chunk up to {_ssd._BWD_QMAX} "
                       f"and N up to {_ssd._BWD_NMAX} within "
                       f"{_ssd._MAX_SMEM} bytes of shared memory, got "
                       f"chunk {q}, N = {n}, P = {p}")
        _book("ssd_scan_backward", cost.ssd_scan_backward(b, s, h, p, n, q),
              refused)
        return tuple(torch.empty_like(t) for t in (xdt, a_log, B, C))
    grads = _ssd.ssd_scan_backward_cuda(xdt, a_log, B, C, dy, chunk,
                                        states=states)
    ssd_scan_backward.launches += 1
    return grads


def grouped_matmul(x, w, valid_rows=None):
    """x: [G, C, K]; w: [G, K, N]; valid_rows: [G] int32 or None ->
    [G, C, N] in x's dtype, f32 accumulation; rows at or past
    ``valid_rows[g]`` come back as 0."""
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_plain(x, w, valid_rows)
    _refuse_grad("grouped_matmul", x, w)
    if _storage_less(x):
        g, c, k = x.shape
        _book("grouped_matmul", cost.grouped_matmul(
            g, c, k, w.shape[2], x.element_size(),
            None if valid_rows is None else [c] * g))
        return x.new_empty((g, c, w.shape[2]))
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
paged_attention_partial.launches = 0
paged_prefill_partial.launches = 0
flash_attention_offset.launches = 0
#: the partial and query-offset wrappers' CPU calls (not in ``COUNTERS``:
#: a graph captures CUDA work only)
paged_attention_partial.plain_calls = 0
paged_prefill_partial.plain_calls = 0
flash_attention_offset.plain_calls = 0

#: every counter above, as (function, attribute). The counts are plain
#: ``+=`` on a function attribute, not atomic across threads: where several
#: threads launch (the live runtime's jobs), read them as "some" and "none".
COUNTERS = tuple(
    [(f, "launches") for f in (flash_attention, paged_attention,
                               paged_prefill_attention, ssd_scan,
                               grouped_matmul, flash_attention_backward,
                               ssd_scan_backward, paged_attention_partial,
                               paged_prefill_partial,
                               flash_attention_offset)]
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
