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
``ssd_chunked``). With ``L = cumsum(a_log)``, ``y_i = sum_{j<=i} (C_i.B_j)
exp(L_i - L_j) x_j`` and ``rev`` the flip along S, its gradients are three
scans of the same kind plus a reverse cumulative sum (``ssd_scan_backward``):

    dx = rev(ssd(rev(dy), a', rev(C), rev(B)))     x-role dy, B-role C
    dB = rev(ssd(rev(C), a', rev(dy), rev(x)))     x-role C, B-role dy
    dC = ssd(B, a, x, dy)                          x-role B, B-role x
    da = reverse_cumsum_S(rowdot(dy, y) - rowdot(x, dx))

where ``a'[0] = 0, a'[t] = a[S - t]`` are the reversed decays shifted by
one. The x-role columns are independent, so an x-role wider than the
kernel's ``_PMAX`` runs in ``_PMAX``-wide calls. The last line is exact,
but a difference of large sums taken along different paths: in f32 it
loses the decays' gradient (A_log and dt_bias in the model). So da_t is
summed instead over the pairs that cross t, in four parts: those inside
t's chunk, from that chunk's pair weights; those with one end outside the
chunk, from the forward's state entering it and the reversed dx scan's
state at its end; those that span it, from the two states' dot product
(``ssd_scan_dlog_plain``; ``csrc/ssd_scan_bwd.cu`` has the derivation).
On the card the scans are the forward kernel and the decay gradient is
``csrc/ssd_scan_bwd.cu`` (``ssd_scan_backward_cuda``);
``ssd_scan_backward_plain`` is autograd through the plain version, the
reference both are held to.
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


def reversed_decays(a_log):
    """``a'``: ``a'[:, 0] = 0`` and ``a'[:, t] = a_log[:, S - t]``, so that
    the reversed sequence's cumulative decays span the same intervals."""
    return torch.cat([torch.zeros_like(a_log[:, :1]),
                      a_log[:, 1:].flip(1)], dim=1).contiguous()


def _by_columns(scan, x):
    """``scan`` over x [B, S, H, N] in column blocks of at most ``_PMAX``,
    the widest x-role the kernel takes (the columns are independent)."""
    n = x.shape[-1]
    if n <= _PMAX:
        return scan(x)
    return torch.cat([scan(x[..., i:i + _PMAX].contiguous())
                      for i in range(0, n, _PMAX)], dim=-1)


def ssd_scan_backward(xdt, a_log, B, C, dy, chunk: int, scan, dlog,
                      fwd=None):
    """(dxdt, da_log, dB, dC) of ``<y, dy>`` from ``scan(x, a, B, C,
    chunk=, return_states=)`` and ``dlog(x, B, C, dy, a, fwd_states,
    rev_states, chunk)`` (the module docstring's identity; every input
    float32 and contiguous, ``chunk`` dividing S). ``fwd`` is the forward's
    ``(y, states)``; its states are recomputed when not given."""
    def rev(t):
        return t.flip(1).contiguous()

    if fwd is None:
        fwd = scan(xdt, a_log, B, C, chunk=chunk, return_states=True)
    fst = fwd[1]
    ar, dyr, xr, Br, Cr = (reversed_decays(a_log), rev(dy), rev(xdt),
                           rev(B), rev(C))
    # dx's x-role is dy: P columns, one block (P <= _PMAX)
    dxr, rst = scan(dyr, ar, Cr, Br, chunk=chunk, return_states=True)
    dB = rev(_by_columns(lambda t: scan(t, ar, dyr, xr, chunk=chunk), Cr))
    dC = _by_columns(lambda t: scan(t, a_log, xdt, dy, chunk=chunk), B)
    return rev(dxr), dlog(xdt, B, C, dy, a_log, fst, rst, chunk), dB, dC


def ssd_scan_dlog_plain(x, B, C, dy, a_log, fst, rst, chunk: int):
    """The decay gradient's plain version -> da [B, S, H]: for t in chunk
    c, the pairs (i >= t > j) of ``W_ij = (C_i.B_j) e^(L_i - L_j)
    (dy_i.x_j)`` that cross t, in four parts (``csrc/ssd_scan_bwd.cu``):
    inside the chunk, the exclusive prefix sum over s < t of (column sum
    below the diagonal - row sum left of it) of the chunk's W; i in the
    chunk and j before it, the suffix sum of ``dy_i . y_inter_i``; i after
    the chunk and j in it, the prefix sum of ``x_j . dx_inter_j``; and
    ``e^Gamma_c <H_c, G_c>`` for the pairs that span the chunk. ``fst`` is
    the forward's states entering chunks 1.., ``rst`` the reversed dx
    scan's ([B H, S / Q - 1, N, P])."""
    b, s, h, p = x.shape
    n, q = B.shape[-1], chunk
    nc = s // q
    xr, dyr = (t.reshape(b, nc, q, h, p) for t in (x, dy))
    Br, Cr = (t.reshape(b, nc, q, h, n) for t in (B, C))
    lc = a_log.reshape(b, nc, q, h).cumsum(2)            # [b,nc,q,h]
    gam = lc[:, :, -1]                                   # [b,nc,h]
    li = lc.permute(0, 1, 3, 2)                          # [b,nc,h,q]
    idx = torch.arange(q, device=x.device)
    below = idx[:, None] > idx[None, :]
    w = (torch.einsum("bcihn,bcjhn->bchij", Cr, Br)
         * torch.einsum("bcihp,bcjhp->bchij", dyr, xr)
         * torch.where(below, torch.exp(torch.clamp(
             li[..., :, None] - li[..., None, :], max=0.0)), 0.0))
    diff = (w.sum(-2) - w.sum(-1)).transpose(2, 3)       # [b,nc,q,h]
    intra = diff.cumsum(2) - diff
    # the states at each chunk: H_c entering it, G_c entering its end from
    # the right (decayed to its last position)
    zeros = torch.zeros((b, h, 1, n, p), dtype=x.dtype, device=x.device)
    hs = torch.cat([zeros, fst.reshape(b, h, nc - 1, n, p)], dim=2)
    gs = rst.reshape(b, h, nc - 1, n, p).flip(2) * torch.exp(
        a_log[:, q::q]).transpose(1, 2)[..., None, None]
    gs = torch.cat([gs, zeros], dim=2)
    u = torch.einsum("bcihn,bhcnp,bcihp->bcih", Cr, hs, dyr) * torch.exp(lc)
    v = torch.einsum("bcjhn,bhcnp,bcjhp->bcjh", Br, gs, xr) * torch.exp(
        gam[:, :, None] - lc)
    kappa = torch.einsum("bhcnp,bhcnp->bch", hs, gs) * torch.exp(gam)
    da = (intra + u.flip(2).cumsum(2).flip(2) + (v.cumsum(2) - v)
          + kappa[:, :, None])
    return da.reshape(b, s, h)


#: csrc/ssd_scan_bwd.cu: the longest chunk, its tile of positions
_DLOG_QMAX, _DLOG_T = 256, 64


def dlog_smem_bytes(n: int, p: int) -> int:
    """Dynamic shared memory of the decay-gradient kernel (``smem_floats``
    in the source)."""
    tiles = 2 * _DLOG_T * (n + 1) + 2 * _DLOG_T * (p + 1) + _DLOG_T * (
        _DLOG_T + 1)
    return 4 * (5 * _DLOG_QMAX + max(tiles, 2 * n * (p + 1)))


def ssd_scan_dlog_cuda(x, B, C, dy, a_log, fst, rst, chunk: int):
    """Launch the decay-gradient kernel: x, dy [B, S, H, P], B, C [B, S, H,
    N], a_log [B, S, H], the forward's and the reversed dx scan's states
    [B H, S / Q - 1, N, P] (float32, contiguous) -> da [B, S, H] f32."""
    ts = (("x", x), ("B", B), ("C", C), ("dy", dy), ("a_log", a_log),
          ("fst", fst), ("rst", rst))
    for name, t in ts:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be float32 and contiguous")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dy.shape != x.shape or B.shape != C.shape or \
            tuple(B.shape[:3]) != (b, s, h) or \
            tuple(a_log.shape) != (b, s, h):
        raise ValueError(f"need dy [B, S, H, P], B, C [B, S, H, N] and a_log "
                         f"[B, S, H] for x {tuple(x.shape)}")
    if chunk <= 0 or chunk > _DLOG_QMAX or s % chunk:
        raise ValueError(f"the kernel takes a chunk dividing S up to "
                         f"{_DLOG_QMAX}, got {chunk} for S = {s}")
    want = (b * h, s // chunk - 1, n, p)
    if tuple(fst.shape) != want or tuple(rst.shape) != want:
        raise ValueError(f"states must be {want}, got {tuple(fst.shape)} / "
                         f"{tuple(rst.shape)}")
    if dlog_smem_bytes(n, p) > _MAX_SMEM:
        raise ValueError(f"N = {n} with P = {p} needs "
                         f"{dlog_smem_bytes(n, p)} bytes of shared memory, "
                         f"over the {_MAX_SMEM} a block may take")
    da = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.ssd_scan_dlog(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            a_log.data_ptr(), fst.data_ptr() if fst.numel() else None,
            rst.data_ptr() if rst.numel() else None, da.data_ptr(), b, s, h,
            p, n, chunk, torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on(code, "ssd_scan_dlog")
    return da


def ssd_scan_backward_cuda(xdt, a_log, B, C, dy, chunk: int, fwd=None):
    """The backward on the card: the forward kernel on the reversed and
    rearranged inputs (x-role blocks of ``_PMAX`` columns; and once more on
    the inputs for the forward's output and states when ``fwd`` is not
    given) and the decay-gradient kernel. Inputs float32 and contiguous,
    ``chunk`` dividing S."""
    dy = dy.to(torch.float32).contiguous()
    return ssd_scan_backward(xdt, a_log, B, C, dy, min(chunk, dy.shape[1]),
                             ssd_scan_cuda, ssd_scan_dlog_cuda, fwd=fwd)


def ssd_scan_backward_plain(xdt, a_log, B, C, dy, chunk: int = 256):
    """Autograd of ``ssd_scan_plain``: (dxdt, da_log, dB, dC) of
    ``<y, dy>``, the reference of the backward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (xdt, a_log, B, C)]
        y = ssd_scan_plain(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy)
