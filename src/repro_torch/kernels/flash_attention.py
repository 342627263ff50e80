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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tpu_block(s: int) -> int:
    """The row block the JAX wrapper pads S to (``ops.py:44``)."""
    return min(128, max(8, s))


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """Plain version of the kernel: q [B, S, Hq, D], k/v [B, S, Hkv, D]
    -> [B, S, Hq, D], f32 arithmetic, q's dtype out."""
    flash_attention_plain.calls += 1
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
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


def _check(q, k, v) -> None:
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
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or \
            hq % k.shape[2] or 0 in q.shape:
        raise ValueError(f"q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)}")
    if d not in (32, 64, 128):
        raise ValueError(f"head_dim {d} not in (32, 64, 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim "
                             "(the kernel reads it in place through its "
                             "other strides)")


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0):
    """Launch the kernel: q [B, S, Hq, D], k/v [B, S, Hkv, D] (read in
    place through their strides) -> contiguous [B, S, Hq, D]."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, s, hq, d = q.shape
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(bool(causal)), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on(code, "flash_attention_forward")
    return out
