"""Mamba2 SSD chunked scan: the CUDA launcher and its plain PyTorch version.

Ports ``ssd_scan_bhsp`` of the JAX package's ``kernels/ssd_scan.py``
(wrapper ``kernels/ops.py:107``):

  * ``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` (design and bound in
    its header);
  * ``ssd_scan_plain`` is the same function in plain PyTorch, with the
    arithmetic of the model's ``mamba2.ssd_chunked``
    (``repro/models/mamba2.py:102-159``): the intra-chunk dual form, the
    chunk states, the inter-chunk recurrence (a Python loop over chunks
    where the reference scans) and its ``_best_chunk`` rule.

Layout is the JAX wrapper's: xdt ``[B, S, H, P]`` (dt-scaled inputs),
a_log ``[B, S, H]`` (log decay), B and C ``[B, S, H, N]``, all float32;
y ``[B, S, H, P]`` float32. The kernel reads that layout in place (the
JAX wrapper's transposes to ``[B H, S, *]`` are not needed);
``kernels/ops.py`` routes by device.

The backward (the Pallas kernel has none; the JAX package trains through
``ssd_chunked``). On the card ``ssd_scan_backward_cuda`` launches
``csrc/ssd_scan_bwd.cu``: the reversed chunk states and their pass over the
chunks from the last down, then one fused pass over each chunk that gives
dx, dB, dC and the decays' gradient (its header has the decomposition;
the decays' gradient is summed over the pairs that cross each position,
which keeps f32 accuracy where the reverse cumulative sum of
``dy.y - x.dx`` loses it). It takes the states the training forward
computed (``ssd_scan_cuda(..., return_states=True)``).
``ssd_scan_backward_plain`` is autograd through the plain version, the
reference the kernel is held to.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: csrc/ssd_scan.cu: positions of a tile, state rows of a state-kernel CTA,
#: the widest P, and the most dynamic shared memory a block may take (227 KB)
_T, _NB, _PMAX, _MAX_SMEM = 64, 128, 64, 232448


def best_chunk(s: int) -> int:
    """The largest of 256, 128, ..., 1 that divides ``s``
    (``mamba2._best_chunk``)."""
    for q in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if s % q == 0:
            return q
    return 1


def ssd_scan_plain(xdt, a_log, B, C, chunk: int = 256,
                   return_states: bool = False):
    """Plain version: xdt [B, S, H, P], a_log [B, S, H], B/C [B, S, H, N]
    (float32) -> y [B, S, H, P] float32; with ``return_states`` also the
    state entering each chunk but the first, [B H, S / Q - 1, N, P] (the
    kernel's chunk-states scratch after its pass)."""
    ssd_scan_plain.calls += 1
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    q = chunk if (s % chunk == 0 and s >= chunk) else best_chunk(s)
    nc = s // q
    x = xdt.reshape(b, nc, q, h, p)
    a = a_log.reshape(b, nc, q, h)
    Bm = B.reshape(b, nc, q, h, n)
    Cm = C.reshape(b, nc, q, h, n)

    lc = torch.cumsum(a, dim=2)                      # [b,nc,q,h] within chunk
    l_last = lc[:, :, -1:, :]                        # total chunk decay

    # intra-chunk (dual / attention form); the clamp precedes the mask
    scores = torch.einsum("bcihn,bcjhn->bchij", Cm, Bm)
    li = lc.permute(0, 1, 3, 2)                      # [b,nc,h,q]
    decay = torch.exp(torch.clamp(li[..., :, None] - li[..., None, :],
                                  max=0.0))
    idx = torch.arange(q, device=xdt.device)
    mask = idx[:, None] >= idx[None, :]
    m = torch.where(mask, scores * decay, torch.zeros_like(scores))
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, x)

    # chunk states: S_c = sum_j exp(l_last - l_j) B_j (x) xdt_j
    w = torch.exp(l_last - lc)                       # [b,nc,q,h]
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bm, w, x)

    # inter-chunk recurrence T_c = gamma_c T_{c-1} + S_c; chunk c reads the
    # state entering it
    gamma = torch.exp(l_last[:, :, 0, :])            # [b,nc,h]
    t = torch.zeros((b, h, n, p), dtype=xdt.dtype, device=xdt.device)
    t_in = []
    for c in range(nc):
        t_in.append(t)
        t = gamma[:, c, :, None, None] * t + states[:, c]
    t_in = torch.stack(t_in, dim=1)                  # [b,nc,h,n,p]

    y_inter = torch.einsum("bcihn,bcih,bchnp->bcihp", Cm, torch.exp(lc),
                           t_in)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    if return_states:
        return y, t_in[:, 1:].transpose(1, 2).reshape(b * h, nc - 1, n, p)
    return y


#: calls of the plain version, so a device run can show it never ran there
ssd_scan_plain.calls = 0


def smem_bytes(n: int, p: int, q: int) -> int:
    """Dynamic shared memory of the larger of the state and chunk kernels
    (``state_smem`` and ``chunk_smem`` in the source)."""
    lc = (q + 3) // 4 * 4
    state = _T * (min(n, _NB) + 8) + 2 * _T * (p + 8) + _T + lc
    chunk = (_T * (n + 4) + max(n * (p + 8), _T * (n + 4) + 2 * _T * (p + 4))
             + lc)
    return 4 * max(state, chunk)


def _check(xdt, a_log, B, C, q: int) -> None:
    """Raise on anything the kernel does not take."""
    if xdt.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{xdt.device}")
    ts = (("xdt", xdt), ("a_log", a_log), ("B", B), ("C", C))
    for name, t in ts:
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype}: the kernel takes "
                             "float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xdt.dim() != 4 or 0 in xdt.shape:
        raise ValueError(f"need xdt [B, S, H, P], got {tuple(xdt.shape)}")
    b, s, h, _ = xdt.shape
    if tuple(a_log.shape) != (b, s, h) or B.dim() != 4 or \
            tuple(B.shape[:3]) != (b, s, h) or B.shape != C.shape or \
            B.shape[3] == 0:
        raise ValueError(f"need a_log [B, S, H] and B, C [B, S, H, N] for "
                         f"xdt {tuple(xdt.shape)}, got {tuple(a_log.shape)} "
                         f"/ {tuple(B.shape)} / {tuple(C.shape)}")
    if q <= 0 or s % q:
        raise ValueError(f"chunk {q} does not divide S = {s}")
    n, p = B.shape[3], xdt.shape[3]
    if p % 8 or p > _PMAX or n % 8:
        raise ValueError(f"the kernel takes P a multiple of 8 up to {_PMAX} "
                         f"and N a multiple of 8, got P = {p}, N = {n}")
    if smem_bytes(n, p, q) > _MAX_SMEM:
        raise ValueError(f"state size N = {n} with P = {p} and chunk {q} "
                         f"needs {smem_bytes(n, p, q)} bytes of shared "
                         f"memory, over the {_MAX_SMEM} a block may take")
    for name, t in (("xdt", xdt), ("B", B), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def ssd_scan_cuda(xdt, a_log, B, C, chunk: int = 128,
                  return_states: bool = False):
    """Launch the kernel with chunk ``min(chunk, S)`` (which must divide
    S): xdt [B, S, H, P], a_log [B, S, H], B/C [B, S, H, N], float32 and
    contiguous -> y [B, S, H, P] float32; with ``return_states`` also the
    state entering each chunk but the first, [B H, S / Q - 1, N, P] (the
    scratch the launch fills anyway)."""
    b, s, h, p = xdt.shape
    q = min(chunk, s)
    _check(xdt, a_log, B, C, q)
    n, nc = B.shape[3], s // q
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=xdt.device)
    # the chunk states (then the states entering each chunk) and decays
    states = torch.empty((b * h, nc - 1, n, p), dtype=torch.float32,
                         device=xdt.device)
    gamma = torch.empty((b * h, nc - 1), dtype=torch.float32,
                        device=xdt.device)
    lib = build.library()
    with torch.cuda.device(xdt.device):
        code = lib.ssd_scan_forward(
            xdt.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), gamma.data_ptr(), b, s, h, p, n,
            q, torch.cuda.current_stream(xdt.device).cuda_stream)
    build.raise_on(code, "ssd_scan_forward")
    return (y, states) if return_states else y


#: csrc/ssd_scan_bwd.cu: the longest chunk and the widest state it takes
_BWD_QMAX, _BWD_NMAX = 256, 128


def bwd_smem_bytes(n: int, p: int, q: int) -> int:
    """Dynamic shared memory of the backward's chunk kernel (``bwd_smem`` in
    the source)."""
    pair = _T * (n + 4) + _T * (p + 4)
    return 4 * (max(n * (p + 8), p * (n + 8)) + 3 * pair
                + 11 * ((q + 3) // 4 * 4) + 8)


def ssd_scan_backward_cuda(xdt, a_log, B, C, dy, chunk: int, states):
    """Launch the backward kernels with chunk ``min(chunk, S)`` (which must
    divide S): xdt [B, S, H, P], a_log [B, S, H], B/C [B, S, H, N] float32
    and contiguous, the upstream gradient ``dy`` [B, S, H, P] and the
    forward's states entering chunks 1.. [B H, S / Q - 1, N, P]
    (``ssd_scan_cuda(..., return_states=True)``) -> (dxdt, da_log, dB,
    dC), float32."""
    b, s, h, p = xdt.shape
    q = min(chunk, s)
    _check(xdt, a_log, B, C, q)
    n, nc = B.shape[3], s // q
    dy = dy.to(torch.float32).contiguous()
    if dy.shape != xdt.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have xdt's shape "
                         f"{tuple(xdt.shape)}")
    if q > _BWD_QMAX or n > _BWD_NMAX or \
            bwd_smem_bytes(n, p, q) > _MAX_SMEM:
        raise ValueError(f"the backward takes a chunk up to {_BWD_QMAX} and "
                         f"N up to {_BWD_NMAX} within {_MAX_SMEM} bytes of "
                         f"shared memory, got chunk {q}, N = {n}, P = {p}")
    want = (b * h, nc - 1, n, p)
    if states is None or tuple(states.shape) != want or \
            states.dtype != torch.float32 or states.device != xdt.device or \
            not states.is_contiguous():
        raise ValueError(f"states must be the forward's contiguous float32 "
                         f"{want} chunk states on {xdt.device} "
                         f"(ssd_scan_cuda(..., return_states=True))")
    dev = xdt.device
    dx, dyb = torch.empty_like(xdt), torch.empty_like(B)
    dC, da = torch.empty_like(C), torch.empty_like(a_log)
    # the reversed states (G_c after the pass) and chunk decays
    rst = torch.empty(want, dtype=torch.float32, device=dev)
    rgam = torch.empty((b * h, nc - 1), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.ssd_scan_backward(
            xdt.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            dy.data_ptr(), ptr(states), ptr(rst), ptr(rgam),
            dx.data_ptr(), da.data_ptr(), dyb.data_ptr(), dC.data_ptr(), b, s,
            h, p, n, q, torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(code, "ssd_scan_backward")
    return dx, da, dyb, dC


def ssd_scan_backward_plain(xdt, a_log, B, C, dy, chunk: int = 256):
    """Autograd of ``ssd_scan_plain``: (dxdt, da_log, dB, dC) of
    ``<y, dy>``, the reference of the backward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (xdt, a_log, B, C)]
        y = ssd_scan_plain(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy)
