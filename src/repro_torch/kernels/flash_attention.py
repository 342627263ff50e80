"""Flash attention: the CUDA launcher and its plain PyTorch version.

Ports ``flash_attention_bhsd`` of the JAX package's
``kernels/flash_attention.py`` (wrapper ``kernels/ops.py:36``):

  * ``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (design
    and bound in its header);
  * ``flash_attention_plain`` is the same function in plain PyTorch — the
    ``kernels/ref.py`` oracle with the kernel's edge rule for a row that
    sees no key (it outputs 0, the kernel's ``l == 0 -> 1``).

Layout is the JAX wrapper's: q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]``,
q head ``h`` attending kv head ``h // G``; out ``[B, S, Hq, D]`` in q's
dtype. ``kernels/ops.py`` routes by device and raises the JAX wrapper's
``ValueError`` for a non-causal S that is not a multiple of the block.

A query offset (``q_offset``, the forward only: a rank's block of query
rows under q-seq sharding) puts query i at position ``q_offset + i``
against keys ``0 .. Sk - 1`` of k/v ``[B, Sk, Hkv, D]``, ``Sq <= Sk``.

The backward has no TPU kernel to port (the JAX package trains through its
plain attention): ``flash_attention_backward_cuda`` launches
``csrc/flash_attention_bwd.cu`` (f32 or bf16) on the row log-sum-exp the
training forward hands over (``flash_attention_cuda(..., return_lse=True)``,
f32 in both dtypes), and
``flash_attention_backward_plain`` is autograd through the plain version,
the reference the kernel is held to.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the CUDA source instantiates
HEAD_DIMS = (32, 64, 96, 128)


def tpu_block(s: int) -> int:
    """The row block the JAX wrapper pads S to (``ops.py:44``)."""
    return min(128, max(8, s))


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """Plain version of the kernel: q [B, S, Hq, D], k/v [B, Sk, Hkv, D]
    (Sk == S unless ``q_offset`` places the queries at positions
    ``q_offset .. q_offset + S - 1`` of Sk keys) -> [B, S, Hq, D], f32
    arithmetic, q's dtype out."""
    flash_attention_plain.calls += 1
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q_pos = q_offset + torch.arange(s, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    qg = q.reshape(b, s, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(d)
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


#: calls of the plain version, so a device run can show it never ran there
flash_attention_plain.calls = 0


def _check(q, k, v, q_offset: int = 0) -> None:
    """Raise on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q dtype "
                             f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, S, Hq, D] and k, v [B, S, Hkv, D], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    sk_ok = (k.shape[1] >= s and q_offset >= 0 if q_offset
             else k.shape[1] == s)
    if k.shape[0] != b or not sk_ok or k.shape[3] != d or \
            hq % k.shape[2] or 0 in q.shape:
        raise ValueError(f"q {tuple(q.shape)} at offset {q_offset} does not "
                         f"group over k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim "
                             "(the kernel reads it in place through its "
                             "other strides)")


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0,
                         return_lse: bool = False, q_offset: int = 0):
    """Launch the kernel: q [B, S, Hq, D], k/v [B, S, Hkv, D] (read in
    place through their strides) -> contiguous [B, S, Hq, D]; with
    ``return_lse`` also each row's log-sum-exp [B Hq, S], float32 for
    either input dtype (1e30 for a row that sees no key), which the
    backward kernel takes.
    ``q_offset``: the queries sit at positions ``q_offset ..`` of k/v's
    Sk >= S keys (module docstring)."""
    _check(q, k, v, q_offset)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, s, hq, d = q.shape
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * hq, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, s, hq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(bool(causal)), int(window), k.shape[1],
            int(q_offset), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on(code, "flash_attention_forward")
    return (out, lse) if return_lse else out


def flash_attention_backward_plain(q, k, v, dout, causal: bool = True,
                                   window: int = 0):
    """The backward's plain version: (dq, dk, dv) of ``<out, dout>``
    through autograd of ``flash_attention_plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal, window)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_backward_cuda(q, k, v, out, dout, lse,
                                  causal: bool = True, window: int = 0,
                                  groups: int = 0):
    """Launch the backward kernel: q [B, S, Hq, D], k/v [B, S, Hkv, D] (read
    in place through their strides), the forward's ``out``, its gradient
    ``dout`` [B, S, Hq, D] and its row log-sum-exp ``lse`` [B Hq, S]
    (``flash_attention_cuda(..., return_lse=True)``) -> (dq, dk, dv),
    contiguous, in q's dtype: float32 or bfloat16 (the kernel's sums are
    f32 in both; ``_check`` raises on any other dtype). ``groups`` 0 lets
    the kernel pick its CTA shape; 4 (D <= 96) or 2 forces four 16-row
    groups of two warps or two of four."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, s, hq, d = q.shape
    if groups not in (0, 2, 4) or (groups == 4 and d > 96):
        raise ValueError(f"groups must be 0, 2 or (D <= 96) 4, got {groups} "
                         f"at D {d}")
    hkv = k.shape[2]
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)} and dtype {q.dtype}")
    if lse is None or tuple(lse.shape) != (b * hq, s) or \
            lse.dtype != torch.float32 or lse.device != q.device or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be the forward's contiguous float32 "
                         f"[{b * hq}, {s}] log-sum-exp on {q.device} "
                         f"(flash_attention_cuda(..., return_lse=True))")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty_like(lse)
    lib = build.library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), b, s, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), int(window), int(groups), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on(code, "flash_attention_backward")
    return dq, dk, dv
