"""The arithmetic of the port's two backward kernels, emulated on the CPU
(the kernels themselves run only on the card: tests/test_torch_cuda_kernels.py).

* The SSD scan's backward is three scans of the forward's kind on reversed
  and rearranged inputs plus the decays' gradient
  (``kernels/ssd_scan.py``). ``ssd_scan_backward`` runs it here with the
  plain scan as the inner scan and the decay gradient's plain version,
  against autograd of ``ssd_scan_plain``: x-role column splits (N 96 and
  128, wider than the kernel's 64 columns), S not a multiple of the
  requested chunk, f64 (1e-12 relative to the largest gradient: the
  identity is exact) and f32 (2e-5). The decay gradient sums the pair
  weights that cross each position (inside its chunk from the chunk's W,
  across chunks from the two scans' states): at S 4096 that keeps f32
  autograd's accuracy where the cumulative sum of dy.y - x.dx loses it.
  The decay-gradient kernel's order (W by 64 x 64 tiles, column and row
  sums, the warp scans) is emulated against its plain version.
* The flash backward (``csrc/flash_attention_bwd.cu``): the prep kernel's
  online log-sum-exp over 64-key tiles and ``D_i = do.o``, the dk/dv
  kernel's walk over the G q heads of a kv head and the query tiles that
  see its key tile, the dq kernel's walk over the key tiles a query tile
  sees, with the kernel's tile ranges and edge rules (a row past S or with
  no visible key has L = 1e30, so P = 0), against autograd of
  ``flash_attention_plain`` (causal and not, window, GQA, ragged S) in f32
  at 2e-5 relative to the largest gradient (the plain version computes in
  f32 whatever its inputs, so there is no f64 reference).
* The CPU routes of ``ops.flash_attention_backward`` and
  ``ops.ssd_scan_backward`` are the plain backwards.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

REL = {torch.float64: 1e-12, torch.float32: 2e-5}


def _rel_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = (g - w).abs().max() / w.abs().max().clamp_min(1e-30)
        assert err <= REL[dtype], float(err)


def _ssd_case(b, s, h, p, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, dtype=dtype)
    a = -torch.nn.functional.softplus(torch.randn(b, s, h, generator=g,
                                                  dtype=dtype))
    B = torch.randn(b, s, h, n, generator=g, dtype=dtype) * 0.5
    C = torch.randn(b, s, h, n, generator=g, dtype=dtype) * 0.5
    dy = torch.randn(b, s, h, p, generator=g, dtype=dtype)
    return x, a, B, C, dy


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 32, 16, 16),          # one x-role block each
    (1, 96, 2, 16, 128, 64),         # N 128: two 64-column blocks; S 96
                                     # with chunk 64 halves to 32
    (1, 80, 2, 8, 96, 32),           # N 96: blocks of 64 and 32; chunk 32
                                     # halves to 16
    (1, 7, 1, 8, 8, 4),              # S 7: chunk 1
])
def test_ssd_backward_identity_matches_autograd(b, s, h, p, n, chunk, dtype):
    x, a, B, C, dy = _ssd_case(b, s, h, p, n, dtype, seed=s + n)
    q = chunk
    while s % q:
        q //= 2
    want = ssd.ssd_scan_backward_plain(x, a, B, C, dy, chunk=q)
    got = ssd.ssd_scan_backward(x, a, B, C, dy, q, ssd.ssd_scan_plain,
                                ssd.ssd_scan_dlog_plain)
    _rel_close(got, want, dtype)


def test_reversed_decays():
    a = torch.arange(1, 6, dtype=torch.float32).reshape(1, 5, 1)
    assert ssd.reversed_decays(a).flatten().tolist() == [0, 5, 4, 3, 2]


def _warp_scan(v, reverse, exclusive, lanes=32):
    """csrc/ssd_scan_bwd.cu's warp_scan: runs of ceil(n / 32) positions,
    the run sums scanned across the lanes, each run walked in order."""
    v = list(v.flip(0) if reverse else v)
    n = len(v)
    per = -(-n // lanes)
    out, before = [None] * n, 0.0
    for lane in range(lanes):
        k0, k1 = min(n, lane * per), min(n, lane * per + per)
        acc = before
        for k in range(k0, k1):
            if exclusive:
                out[k] = acc
                acc = acc + v[k]
            else:
                acc = acc + v[k]
                out[k] = acc
        before = before + sum(v[k0:k1], 0.0)
    out = torch.stack([torch.as_tensor(o, dtype=torch.float64)
                       for o in out]) if n else torch.zeros(0)
    return out.flip(0) if reverse else out


def _dlog_kernel_order(x, B, C, dy, a, fst, rst, q, tq=64):
    """The kernel's arithmetic for one (b, h) row at a time (f64): W by
    64 x 64 tiles of each chunk's lower triangle, its column and row sums,
    u and v, kappa, and the warp scans."""
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // q
    da = torch.zeros((b, s, h), dtype=torch.float64)
    f = fst.reshape(b, h, nc - 1, n, p)
    r = rst.reshape(b, h, nc - 1, n, p)
    for bi in range(b):
        for hh in range(h):
            for c in range(nc):
                sl = slice(c * q, c * q + q)
                xc, dc = x[bi, sl, hh], dy[bi, sl, hh]
                bc, cc = B[bi, sl, hh], C[bi, sl, hh]
                lc = _warp_scan(a[bi, sl, hh], False, False)
                rs, cs = torch.zeros(q, dtype=x.dtype), torch.zeros(
                    q, dtype=x.dtype)
                nt = -(-q // tq)
                for it in range(nt):
                    for jt in range(it + 1):
                        i = torch.arange(it * tq, min(q, it * tq + tq))
                        j = torch.arange(jt * tq, min(q, jt * tq + tq))
                        w = ((cc[i] @ bc[j].T) * (dc[i] @ xc[j].T)
                             * torch.exp(torch.clamp(lc[i][:, None]
                                                     - lc[j][None, :],
                                                     max=0.0)))
                        w = torch.where(i[:, None] > j[None, :], w, 0.0)
                        cs[j] += w.sum(0)
                        rs[i] += w.sum(1)
                intra = _warp_scan(cs - rs, False, True)
                hmat = f[bi, hh, c - 1] if c > 0 else torch.zeros(n, p)
                gmat = (r[bi, hh, nc - 2 - c] * torch.exp(a[bi, (c + 1) * q,
                                                            hh])
                        if c < nc - 1 else torch.zeros(n, p))
                u = torch.einsum("kn,np,kp->k", cc, hmat.to(x.dtype),
                                 dc) * torch.exp(lc)
                v = torch.einsum("kn,np,kp->k", bc, gmat.to(x.dtype),
                                 xc) * torch.exp(lc[-1] - lc)
                kappa = (hmat * gmat).sum() * torch.exp(lc[-1])
                da[bi, sl, hh] = (intra + _warp_scan(u, True, False)
                                  + _warp_scan(v, False, True) + kappa)
    return da


@pytest.mark.parametrize("s,q", [(7, 7), (300, 100), (384, 128), (96, 1)])
def test_ssd_dlog_kernel_order_matches_plain(s, q):
    x, a, B, C, dy = _ssd_case(1, s, 2, 8, 8, torch.float64, seed=s)
    _, fst = ssd.ssd_scan_plain(x, a, B, C, chunk=q, return_states=True)
    rst = torch.randn_like(fst)
    torch.testing.assert_close(
        _dlog_kernel_order(x, B, C, dy, a, fst, rst, q),
        ssd.ssd_scan_dlog_plain(x, B, C, dy, a, fst, rst, q),
        rtol=1e-12, atol=1e-10)


def test_ssd_decay_gradient_keeps_f32_accuracy_over_a_long_sequence():
    """At S 4096 the suffix sum of dL = dy.y - x.dx cancels to 0 at t = 0
    and in f32 loses the decays' gradient; summed over the crossing pairs
    it keeps f32 autograd's accuracy: the per-head sum of da (what A_log's
    gradient reads) against f64 autograd within 2e-4 of its size, as the
    plain version's f32 autograd is, where the dL cumsum misses by more
    than 1e-3."""
    x, a, B, C, dy = _ssd_case(1, 4096, 2, 16, 16, torch.float32, seed=9)
    want = ssd.ssd_scan_backward_plain(*(t.double() for t in (x, a, B, C)),
                                       dy.double(), chunk=256)[1].sum(1)
    got = ssd.ssd_scan_backward(x, a, B, C, dy, 256, ssd.ssd_scan_plain,
                                ssd.ssd_scan_dlog_plain)
    plain = ssd.ssd_scan_backward_plain(x, a, B, C, dy, chunk=256)[1]
    y = ssd.ssd_scan_plain(x, a, B, C, chunk=256)
    whole = (dy * y - x * got[0]).sum(-1).flip(1).cumsum(1).flip(1)

    def err(da):
        return float(((da.double().sum(1) - want).abs() / want.abs()).max())

    assert err(got[1]) < 2e-4 and err(plain) < 2e-4 < 1e-3 < err(whole), (
        err(got[1]), err(plain), err(whole))


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------
BT, NO_ROW = 64, 1e30


def _visible(i, j, s, causal, window):
    return ((i < s) & (j < s) & ((not causal) | (j <= i))
            & ((window == 0) | (i - j < window)))


def _flash_backward_emulated(q, k, v, o, do, causal, window):
    """The three kernels' arithmetic on [B, S, H, D] tensors."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    nt = -(-s // BT)
    pad = nt * BT - s

    def tiles(t):                     # [B, nt, BT, H, D], rows past S zero
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(b, nt, BT, t.shape[2], d)

    Q, K, V, O, dO = map(tiles, (q, k, v, o, do))
    rows = torch.arange(BT)

    def key_tiles(q0):
        q_last = min(q0 + BT, s) - 1
        lo, hi = 0, nt
        if causal:
            hi = min(hi, q_last // BT + 1)
        if window:
            lo = max(0, q0 - window + 1) // BT
        return lo, hi

    def vis(q0, k0):
        return _visible((q0 + rows)[:, None], (k0 + rows)[None, :], s,
                        causal, window)

    # 1. prep: online L over key tiles, D = do.o
    lse = torch.full((b, hq, nt * BT), NO_ROW, dtype=q.dtype)
    dsum = (dO * O).sum(-1).permute(0, 3, 1, 2).reshape(b, hq, nt * BT)
    for bi in range(b):
        for h in range(hq):
            for qt in range(nt):
                m = torch.full((BT,), -math.inf, dtype=q.dtype)
                l = torch.zeros(BT, dtype=q.dtype)
                lo, hi = key_tiles(qt * BT)
                for kt in range(lo, hi):
                    sc = Q[bi, qt, :, h] @ K[bi, kt, :, h // g].T * scale
                    sc = sc.masked_fill(~vis(qt * BT, kt * BT), -math.inf)
                    mn = torch.maximum(m, sc.amax(-1))
                    ms = torch.where(mn == -math.inf, torch.zeros_like(mn),
                                     mn)
                    l = l * torch.exp(m - ms) + torch.exp(
                        sc - ms[:, None]).sum(-1)
                    m = mn
                r = slice(qt * BT, qt * BT + BT)
                lse[bi, h, r] = torch.where(l > 0, m + torch.log(l),
                                            torch.full_like(l, NO_ROW))
    lse[:, :, s:] = NO_ROW
    # 2. dk, dv: a CTA per (kv head, key tile), over the group's heads and
    # the query tiles that see the tile
    dk = torch.zeros_like(K)
    dv = torch.zeros_like(V)
    for bi in range(b):
        for hk in range(hkv):
            for kt in range(nt):
                k0 = kt * BT
                k_last = min(k0 + BT, s) - 1
                qt_lo = k0 // BT if causal else 0
                qt_hi = (min(nt, (k_last + window - 1) // BT + 1) if window
                         else nt)
                for h in range(hk * g, (hk + 1) * g):
                    for qt in range(qt_lo, qt_hi):
                        r = slice(qt * BT, qt * BT + BT)
                        sc = Q[bi, qt, :, h] @ K[bi, kt, :, hk].T * scale
                        p = torch.where(vis(qt * BT, k0), torch.exp(
                            sc - lse[bi, h, r][:, None]), torch.zeros_like(sc))
                        dv[bi, kt, :, hk] += p.T @ dO[bi, qt, :, h]
                        dp = dO[bi, qt, :, h] @ V[bi, kt, :, hk].T
                        ds = p * (dp - dsum[bi, h, r][:, None])
                        dk[bi, kt, :, hk] += ds.T @ Q[bi, qt, :, h]
    # 3. dq: a CTA per (q head, query tile), over the key tiles it sees
    dq = torch.zeros_like(Q)
    for bi in range(b):
        for h in range(hq):
            for qt in range(nt):
                r = slice(qt * BT, qt * BT + BT)
                lo, hi = key_tiles(qt * BT)
                for kt in range(lo, hi):
                    sc = Q[bi, qt, :, h] @ K[bi, kt, :, h // g].T * scale
                    p = torch.where(vis(qt * BT, kt * BT), torch.exp(
                        sc - lse[bi, h, r][:, None]), torch.zeros_like(sc))
                    dp = dO[bi, qt, :, h] @ V[bi, kt, :, h // g].T
                    ds = p * (dp - dsum[bi, h, r][:, None])
                    dq[bi, qt, :, h] += ds @ K[bi, kt, :, h // g]

    def untile(t):
        return t.reshape(b, nt * BT, t.shape[3], d)[:, :s]

    return untile(dq * scale), untile(dk * scale), untile(dv)


@pytest.mark.parametrize("dtype", [torch.float32])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (1, 128, 4, 2, 16, True, 0),      # GQA G 2, two full tiles
    (2, 100, 3, 3, 8, True, 0),       # ragged S: rows past S are zero
    (1, 150, 4, 1, 8, True, 70),      # window across tiles, G 4
    (1, 128, 2, 1, 8, False, 0),      # non-causal
    (1, 130, 2, 2, 8, False, 40),     # non-causal window: keys after i
])
def test_flash_backward_emulation_matches_autograd(b, s, hq, hkv, d, causal,
                                                   window, dtype):
    g = torch.Generator().manual_seed(s + hq)
    q, k, v = (torch.randn(b, s, h, d, generator=g, dtype=dtype)
               for h in (hq, hkv, hkv))
    do = torch.randn(b, s, hq, d, generator=g, dtype=dtype)
    o = fa.flash_attention_plain(q, k, v, causal, window)
    want = fa.flash_attention_backward_plain(q, k, v, do, causal, window)
    got = _flash_backward_emulated(q, k, v, o, do, causal, window)
    _rel_close(got, want, dtype)


def test_prep_rule_for_a_row_that_sees_no_key():
    """L = 1e30 where a row sees no key, so exp(s - L) is 0 and the row
    gets no gradient (the forward's output-0 rule)."""
    sc = torch.tensor([[-math.inf, -math.inf]], dtype=torch.float64)
    m = sc.amax(-1)
    ms = torch.where(m == -math.inf, torch.zeros_like(m), m)
    l = torch.exp(sc - ms[:, None]).sum(-1)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, NO_ROW))
    assert float(lse) == NO_ROW
    assert float(torch.exp(torch.tensor(3.0, dtype=torch.float64) - lse)) == 0


def test_cpu_routes_are_the_plain_backwards():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, h, 16, generator=g) for h in (4, 2, 2))
    do = torch.randn(1, 40, 4, 16, generator=g)
    o = ops.flash_attention(q, k, v, window=9)
    for got, want in zip(
            ops.flash_attention_backward(q, k, v, o, do, window=9),
            fa.flash_attention_backward_plain(q, k, v, do, True, 9)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    x, a, B, C, dy = _ssd_case(1, 64, 2, 8, 8, torch.float32)
    for got, want in zip(ops.ssd_scan_backward(x, a, B, C, dy, chunk=16),
                         ssd.ssd_scan_backward_plain(x, a, B, C, dy, 16)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    before = ops.flash_attention_backward.launches, \
        ops.ssd_scan_backward.launches
    assert before == (ops.flash_attention_backward.launches,
                      ops.ssd_scan_backward.launches)


def test_cpu_autograd_runs_through_the_plain_versions():
    """On the CPU a loss through ops.flash_attention / ops.ssd_scan
    differentiates through the plain versions: the backward kernels'
    counters do not move."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 20, 2, 8, generator=g).requires_grad_()
               for _ in range(3))
    before = (ops.flash_attention_backward.launches,
              ops.ssd_scan_backward.launches)
    ops.flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert (ops.flash_attention_backward.launches,
            ops.ssd_scan_backward.launches) == before
    assert np.isfinite(q.grad.numpy()).all()
