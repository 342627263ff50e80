"""Grouped (per-expert) matmul: the CUDA launcher and its plain version.

Ports ``grouped_matmul`` of the JAX package's
``kernels/grouped_matmul.py`` together with its wrapper's row mask
(``kernels/ops.py:124-137``): ``out[g] = x[g] @ w[g]`` for x ``[G, C, K]``
and w ``[G, K, N]``, f32 accumulation, x's dtype out, and every row at or
past ``valid_rows[g]`` (int32 ``[G]``, None = all rows) zero.

  * ``grouped_matmul_cuda`` launches ``csrc/grouped_matmul.cu`` (design
    and bound in its header);
  * ``grouped_matmul_plain`` is the ``kernels/ref.py`` oracle in PyTorch.

No model calls it: the MoE layer computes the same contraction with
``einsum``, as the JAX ``moe_ffn`` does. It is an op of its own
(``kernels/ops.py``), held at olmoe-1b-7b's expert shapes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grouped_matmul_plain(x, w, valid_rows=None):
    """Plain version: x [G, C, K], w [G, K, N] -> [G, C, N] (x's dtype)."""
    grouped_matmul_plain.calls += 1
    out = torch.einsum("gck,gkn->gcn", x.float(), w.float())
    if valid_rows is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        out = out * (rows[None, :] < valid_rows[:, None])[..., None]
    return out.to(x.dtype)


#: calls of the plain version, so a device run can show it never ran there
grouped_matmul_plain.calls = 0


def _check(x, w, valid_rows) -> None:
    """Raise on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if w.dtype != x.dtype:
        raise ValueError(f"w dtype {w.dtype} differs from x dtype {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or \
            w.shape[1] != x.shape[2] or 0 in x.shape or 0 in w.shape:
        raise ValueError(f"need x [G, C, K] and w [G, K, N], got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    if valid_rows is not None:
        if valid_rows.device != x.device or valid_rows.dtype != torch.int32 \
                or valid_rows.shape != (x.shape[0],):
            raise ValueError(f"valid_rows must be int32 [G] on {x.device}, "
                             f"got {valid_rows.dtype} "
                             f"{tuple(valid_rows.shape)} on "
                             f"{valid_rows.device}")
    for name, t in (("x", x), ("w", w), ("valid_rows", valid_rows)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def grouped_matmul_cuda(x, w, valid_rows=None):
    """Launch the kernel: x [G, C, K], w [G, K, N] -> [G, C, N]."""
    _check(x, w, valid_rows)
    g, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((g, c, n), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.grouped_matmul_forward(
            x.data_ptr(), w.data_ptr(),
            None if valid_rows is None else valid_rows.data_ptr(),
            out.data_ptr(), g, c, k, n, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on(code, "grouped_matmul_forward")
    return out
