"""Public wrappers for the port's kernels (signatures of the JAX package's
``kernels/ops.py:64`` and ``:85``).

The route depends only on where the tensors lie: CPU tensors take the
plain PyTorch version, CUDA tensors launch the hand-written kernel (which
raises on anything it does not take — there is no fallback). Each wrapper
counts its kernel launches in a plain int attribute, ``launches``.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa


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


paged_attention.launches = 0
paged_prefill_attention.launches = 0
