"""The arithmetic of the port's two backward kernels, emulated on the CPU
(the kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py).

Both kernels run every product on mma.sync TF32 in three passes
(``kernels/csrc/mma.cuh``); ``tests/_torch_tf32.py`` computes the same
products here, one pass or three. Each emulation is held against autograd
of the port's plain version and against ``jax.grad`` of the JAX package's
functions (``repro.kernels.ref.attention``, ``repro.models.mamba2.
ssd_chunked``) on the same numpy inputs: in f64 with exact products (the
decomposition itself, 1e-10 relative to the largest gradient; the JAX
attention computes in f32 whatever its inputs, so flash's f64 reference is
f64 autograd of the plain attention's arithmetic) and in f32 with three
TF32 passes (2e-5 for flash, the card's tolerance; 5e-5 for the SSD scan,
a tenth of the card's 5e-4), where one pass misses.

* The flash backward (``csrc/flash_attention_bwd.cu``): the forward's row
  log-sum-exp handed over (a row that sees no key has L = 1e30 and no
  gradient), the dq kernel's walk over query tiles (64 rows in the 4 x 2
  shape, 32 in the 2 x 4) and the key tiles they see, each 64-key tile in
  shares (two of 32 keys, or four of 16) folded in order, and the dk/dv
  kernel's walk over key tiles of the same size, the G q heads of their
  kv head and the 64-row query tiles that see them, with transposed
  scores, the query shares folded in order. Its bf16 instantiation runs
  the same walks with one bf16 pass a product (inputs, P and dS rounded
  to bf16, f32 sums), held to f32 autograd of the plain version within
  the card's bf16 tolerance.
* The SSD backward (``csrc/ssd_scan_bwd.cu``): the reversed chunk states
  and their pass from the last chunk down, then the fused chunk pass (M1 =
  (C B^T) .* L and M2 = (dy x^T) .* L, the inter terms from the forward's
  state H_c and the reversed state G_c) and the decays' gradient in its
  four parts (W's column-minus-row sums, u, v, kappa). At S 4096 it keeps
  f32 autograd's accuracy where the reverse cumulative sum of dy.y - x.dx
  loses it.
* The CPU routes of ``ops.flash_attention_backward`` and
  ``ops.ssd_scan_backward`` are the plain backwards.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from tests._torch_tf32 import mm as tf32_mm

#: relative to the largest gradient: the f64 decomposition, three TF32
#: passes for flash (the card's tolerance) and for the SSD scan
EXACT, FLASH_TOL, SSD_TOL = 1e-10, 2e-5, 5e-5
#: the bf16 flash backward, relative to the largest gradient (the card's)
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several workers at once, whose default thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    """Each gradient's max abs error over its largest |value|."""
    return [float((g.double() - w.double()).abs().max()
                  / w.double().abs().max().clamp_min(1e-300))
            for g, w in zip(got, want)]


def _products(passes, lo_trunc=False):
    """The kernels' products: exact (f64) or TF32 in 1 or 3 passes."""
    if passes is None:
        return lambda a, b: a @ b
    return lambda a, b: tf32_mm(a.contiguous(), b.contiguous(), passes,
                                lo_trunc)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------
BK, NO_ROW = 64, 1e30


def _visible(s, causal, window):
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    vis = torch.ones((s, s), dtype=torch.bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    return vis


def _lse(q, k, vis):
    """The forward kernel's ``lse`` output: m + log(l) over the visible
    keys, 1e30 for a row that sees none. [B, Hq, S]."""
    b, s, hq, d = q.shape
    kk = k.repeat_interleave(hq // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(d)
    logits = logits.masked_fill(~vis, -math.inf)
    m = logits.amax(-1)
    ms = torch.where(m == -math.inf, torch.zeros_like(m), m)
    l = torch.exp(logits - ms[..., None]).sum(-1)
    return torch.where(l > 0, m + torch.log(l), torch.full_like(l, NO_ROW))


def _flash_backward_emulated(q, k, v, o, do, lse, vis, mm, groups=2):
    """The two kernels' decomposition on [B, S, H, D] tensors; ``vis`` the
    [S, S] visibility (query rows, key columns), ``mm`` the products,
    ``groups`` the CTA's 16-row groups (4 or 2: the kernel's 4 x 2 and
    2 x 4 shapes)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    Q, O, dO = (t.transpose(1, 2) for t in (q, o, do))        # [b, hq, s, d]
    K, V = (t.transpose(1, 2).repeat_interleave(g, 1) for t in (k, v))
    dsum = (dO * O).sum(-1)                                     # D_i
    span = lambda lo, hi: slice(lo, min(hi, s))                 # noqa: E731
    BR, SPLIT = 16 * groups, 8 // groups
    share = BK // SPLIT

    def pair(rows, keys):
        """P and dS of query rows x keys (row masks from vis)."""
        sc = mm(Q[:, :, rows], K[:, :, keys].transpose(-1, -2)) * scale
        p = torch.where(vis[rows, keys], torch.exp(
            sc - lse[:, :, rows, None]), torch.zeros_like(sc))
        dp = mm(dO[:, :, rows], V[:, :, keys].transpose(-1, -2))
        return p, p * (dp - dsum[:, :, rows, None])

    # 1. dq: a CTA per BR-row query tile, over its key tiles; each 64-key
    # tile's SPLIT shares accumulate apart and fold in order
    dq = torch.zeros_like(Q)
    for q0 in range(0, s, BR):
        rows = span(q0, q0 + BR)
        parts = [0.0] * SPLIT
        for k0 in range(0, s, BK):
            for part in range(SPLIT):
                keys = span(k0 + share * part, k0 + share * part + share)
                if keys.start >= s:
                    continue
                _, ds = pair(rows, keys)
                parts[part] = parts[part] + mm(ds, K[:, :, keys])
        dq[:, :, rows] = sum(parts[1:], parts[0]) * scale
    # 2. dk, dv: a CTA per BR-key tile over the G heads of its kv head and
    # the 64-row query tiles; transposed scores, SPLIT query shares
    dk = torch.zeros_like(K)
    dv = torch.zeros_like(V)
    for k0 in range(0, s, BR):
        keys = span(k0, k0 + BR)
        pk, pv = [0.0] * SPLIT, [0.0] * SPLIT
        for q0 in range(0, s, BK):
            for part in range(SPLIT):
                rows = span(q0 + share * part, q0 + share * part + share)
                if rows.start >= s:
                    continue
                p, ds = pair(rows, keys)
                pv[part] = pv[part] + mm(p.transpose(-1, -2),
                                         dO[:, :, rows])
                pk[part] = pk[part] + mm(ds.transpose(-1, -2),
                                         Q[:, :, rows])
        dk[:, :, keys] = sum(pk[1:], pk[0]) * scale
        dv[:, :, keys] = sum(pv[1:], pv[0])

    def heads(t):                      # [b, hq, s, d] -> [b, s, hkv, d]
        return t.reshape(b, hkv, g, s, d).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), heads(dk), heads(dv)


def _flash_case(b, s, hq, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(dtype)
            for h in (hq, hkv, hkv, hq)]          # q, k, v, do


def _flash_emulate(arrays, causal, window, passes, dtype=torch.float32,
                   groups=2):
    """The backward of attention over these inputs: the forward's output
    and log-sum-exp in ``dtype``, then the kernels' decomposition."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    b, s, hq, d = q.shape
    vis = _visible(s, causal, window)
    lse = _lse(q, k, vis)
    kk, vv = (t.repeat_interleave(hq // k.shape[2], dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(d)
    p = torch.where(vis, torch.exp(logits - lse[..., None]), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return _flash_backward_emulated(q, k, v, o, do, lse, vis,
                                    _products(passes, lo_trunc=True), groups)


FLASH_CASES = [
    (1, 128, 4, 2, 16, True, 0),      # GQA G 2, two full tiles
    (2, 100, 3, 3, 8, True, 0),       # ragged S: rows past S are zero
    (1, 150, 4, 1, 8, True, 70),      # window across tiles, G 4
    (1, 128, 2, 1, 8, False, 0),      # non-causal
    (1, 130, 2, 2, 8, False, 40),     # non-causal window: keys after i
    (1, 100, 2, 1, 128, True, 30),    # D 128: 32-row tiles, four shares
]


@pytest.mark.parametrize("dtype", [torch.float32])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,groups", [
    (*case, groups) for case in FLASH_CASES
    for groups in ((2,) if case[4] > 96 else (4, 2))])
def test_flash_backward_emulation_matches_autograd(b, s, hq, hkv, d, causal,
                                                   window, groups, dtype):
    """Three TF32 passes, in both CTA shapes where the head dim allows both
    (4 x 2 fits at D <= 96), against autograd of ``flash_attention_plain``
    (f32 whatever its inputs), within the card's 2e-5."""
    arrays = _flash_case(b, s, hq, hkv, d, np.float32, s + hq)
    q, k, v, do = map(torch.from_numpy, arrays)
    want = fa.flash_attention_backward_plain(q, k, v, do, causal, window)
    got = _flash_emulate(arrays, causal, window, 3, dtype, groups)
    assert max(_rel(got, want)) <= FLASH_TOL, _rel(got, want)


def _bf16(t):
    """Rounded to bf16 and back: a value the bf16 kernel holds."""
    return t.to(torch.bfloat16).float()


def _bf16_products(a, b):
    """The bf16 kernel's products: one m16n8k16 pass, both operands
    rounded to bf16 (P and dS where they enter), f32 sums."""
    return _bf16(a) @ _bf16(b)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,groups", [
    (*case, groups) for case in FLASH_CASES
    for groups in ((2,) if case[4] > 96 else (4, 2))])
def test_bf16_flash_backward_emulation_matches_autograd(b, s, hq, hkv, d,
                                                        causal, window,
                                                        groups):
    """The bf16 kernel's arithmetic: q, k, v, dO and the forward's output
    in bf16, the f32 log-sum-exp, every product one bf16 pass, f32 sums
    and the gradients written in bf16, against autograd of
    ``flash_attention_plain`` on the same inputs upcast to f32, within the
    card's bf16 tolerance (2e-2 of the largest gradient)."""
    arrays = _flash_case(b, s, hq, hkv, d, np.float32, s + hq)
    q, k, v, do = (_bf16(torch.from_numpy(a)) for a in arrays)
    want = fa.flash_attention_backward_plain(q, k, v, do, causal, window)
    vis = _visible(s, causal, window)
    o = _bf16(fa.flash_attention_plain(q, k, v, causal, window))
    got = _flash_backward_emulated(q, k, v, o, do, _lse(q, k, vis), vis,
                                   _bf16_products, groups)
    rel = _rel([_bf16(g) for g in got], want)
    assert max(rel) <= BF16_TOL, rel


def _jax_grads(fn, arrays):
    """``jax.vjp`` of fn over all but the last array, pulled back along the
    last, jitted (its eager dispatch takes seconds)."""
    def grads(*t):
        return jax.vjp(fn, *t[:-1])[1](t[-1])
    return [torch.from_numpy(np.array(g))
            for g in jax.jit(grads)(*map(jnp.asarray, arrays))]


def _jax_attention_grads(arrays, causal, window):
    return _jax_grads(lambda *t: jref.attention(*t, causal=causal,
                                                window=window), arrays)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (1, 96, 4, 2, 16, True, 0), (1, 130, 4, 1, 32, True, 40)])
def test_flash_backward_emulation_matches_jax(b, s, hq, hkv, d, causal,
                                              window):
    """Three TF32 passes against ``jax.vjp`` of the JAX package's attention
    (which computes in f32 whatever its inputs) on the same inputs."""
    arrays = _flash_case(b, s, hq, hkv, d, np.float32, s + d)
    want = _jax_attention_grads(arrays, causal, window)
    got = _flash_emulate(arrays, causal, window, 3)
    assert max(_rel(got, want)) <= FLASH_TOL, _rel(got, want)


def _plain_attention(q, k, v, vis):
    """``flash_attention_plain``'s arithmetic in the inputs' dtype under a
    given [S, S] visibility (its edge rules: m_safe, l == 0 -> 1)."""
    g = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(g, dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(q.shape[3])
    logits = logits.masked_fill(~vis, fa.NEG_INF)
    m = logits.amax(-1, keepdim=True)
    m = torch.where(m <= fa.NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m) * vis
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", FLASH_CASES)
def test_flash_backward_decomposition_is_exact_in_f64(b, s, hq, hkv, d,
                                                      causal, window):
    """The decomposition with exact products in f64 against f64 autograd
    of the plain attention: the tile walks, the quarters' folds and the
    handed-over log-sum-exp lose nothing."""
    arrays = _flash_case(b, s, hq, hkv, d, np.float64, s + hq)
    q, k, v, do = map(torch.from_numpy, arrays)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        _plain_attention(*leaves, _visible(s, causal, window)), leaves, do)
    got = _flash_emulate(arrays, causal, window, None, torch.float64)
    assert max(_rel(got, want)) <= EXACT, _rel(got, want)


def test_prep_rule_for_a_row_that_sees_no_key():
    """The forward hands over L = 1e30 for a row that sees no key (its
    output is 0): every P of that row is masked, so its dq is 0 and it adds
    nothing to dk and dv. Emulated with the row's keys masked away, against
    autograd of the plain softmax under the same mask and edge rules."""
    arrays = _flash_case(1, 64, 2, 1, 8, np.float64, 5)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    vis = _visible(64, True, 0)
    vis[17] = False                    # row 17 sees no key
    lse = _lse(q, k, vis)
    assert (lse[:, :, 17] == NO_ROW).all() and (lse[:, :, 16] < 1e3).all()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _plain_attention(*leaves, vis)
    want = torch.autograd.grad(o, leaves, do)
    got = _flash_backward_emulated(q, k, v, o.detach(), do, lse, vis,
                                   _products(None))
    assert (got[0][:, 17] == 0).all()
    assert max(_rel(got, want)) <= EXACT, _rel(got, want)


# ---------------------------------------------------------------------------
# SSD scan backward
# ---------------------------------------------------------------------------
def _ssd_case(b, s, h, p, n, dtype, seed):
    """x, a, B, C, dy: the JAX kernel tests' distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    a = -np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    B = 0.5 * rng.standard_normal((b, s, h, n))
    C = 0.5 * rng.standard_normal((b, s, h, n))
    dy = rng.standard_normal((b, s, h, p))
    return [t.astype(dtype) for t in (x, a, B, C, dy)]


def _reverse_states(a, C, dy, q, mm):
    """Launches 1 and 2: R_c = (C .* e^lc)^T dy of each chunk, then G_c =
    e^Gamma_{c+1} G_{c+1} + R_{c+1} from the last chunk down, by index
    (nothing flipped). a [b, h, nc, q]; C, dy [b, h, nc, q, *] -> G [b, h,
    nc, N, P] (G of the last chunk 0)."""
    lc = a.cumsum(-1)
    r = mm((C * torch.exp(lc)[..., None]).transpose(-1, -2), dy)
    gam = torch.exp(lc[..., -1])
    g = torch.zeros_like(r)
    t = torch.zeros_like(r[:, :, 0])
    for c in range(r.shape[2] - 2, -1, -1):
        t = gam[:, :, c + 1, None, None] * t + r[:, :, c + 1]
        g[:, :, c] = t
    return g


def _ssd_backward_emulated(x, a, B, C, dy, q, mm):
    """The three launches on [B, S, H, *] tensors with chunk q: the
    reversed states, their pass, and the fused chunk pass with the decays'
    four parts. The forward's states H_c are ``ssd_scan_plain``'s."""
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // q

    def chunks(t):                     # [b, s, h, *] -> [b, h, nc, q, *]
        return t.reshape(b, nc, q, h, -1).permute(0, 3, 1, 2, 4)

    X, Y, Bm, Cm = map(chunks, (x, dy, B, C))
    A = a.reshape(b, nc, q, h).permute(0, 3, 1, 2)
    _, fst = ssd.ssd_scan_plain(x, a, B, C, chunk=q, return_states=True)
    Hs = torch.cat([torch.zeros((b, h, 1, n, p), dtype=x.dtype),
                    fst.reshape(b, h, nc - 1, n, p)], dim=2)
    G = _reverse_states(A, Cm, Y, q, mm)
    lc = A.cumsum(-1)
    gam = lc[..., -1:]
    idx = torch.arange(q)
    L = torch.where(idx[:, None] >= idx[None, :], torch.exp(torch.clamp(
        lc[..., :, None] - lc[..., None, :], max=0.0)), 0.0)   # [.., i, j]
    S1 = mm(Cm, Bm.transpose(-1, -2))                         # C_i . B_j
    S2 = mm(Y, X.transpose(-1, -2))                           # dy_i . x_j
    M1, M2 = S1 * L, S2 * L
    eg = torch.exp(gam - lc)[..., None]                       # e^(G - lc_j)
    dx_inter = mm(Bm * eg, G)
    dB_inter = mm(X * eg, G.transpose(-1, -2))
    dC_inter = mm(Y * torch.exp(lc)[..., None], Hs.transpose(-1, -2))
    dx = mm(M1.transpose(-1, -2), Y) + dx_inter
    dB = mm(M2.transpose(-1, -2), Cm) + dB_inter
    dC = mm(M2, Bm) + dC_inter
    # the decays' gradient: the pairs crossing each position, four parts
    W = torch.where(idx[:, None] > idx[None, :], S1 * S2 * L, 0.0)
    diff = W.sum(-2) - W.sum(-1)       # column sums (i > s) - row sums (j < s)
    u = (Cm * dC_inter).sum(-1)
    v = (Bm * dB_inter).sum(-1)
    kappa = (Hs * G).sum((-1, -2)) * torch.exp(gam[..., 0])
    da = (diff.cumsum(-1) - diff + u.flip(-1).cumsum(-1).flip(-1)
          + v.cumsum(-1) - v + kappa[..., None])

    def back(t):                       # [b, h, nc, q, *] -> [b, s, h, *]
        return t.permute(0, 2, 3, 1, 4).reshape(b, s, h, -1)

    return (back(dx), da.permute(0, 2, 3, 1).reshape(b, s, h), back(dB),
            back(dC))


def _ssd_emulate(arrays, q, passes, dtype=torch.float32):
    x, a, B, C, dy = (torch.from_numpy(t).to(dtype) for t in arrays)
    return _ssd_backward_emulated(x, a, B, C, dy, q,
                                  _products(passes, lo_trunc=True))


SSD_CASES = [
    (2, 64, 3, 32, 16, 16),          # four chunks
    (1, 96, 2, 16, 128, 32),         # N 128: the widest state
    (1, 80, 2, 8, 96, 16),           # N 96
    (1, 7, 1, 8, 8, 1),              # S 7: chunk 1
    (1, 300, 2, 16, 24, 100),        # chunk not a multiple of 64
]


@pytest.mark.parametrize("dtype,passes,tol", [
    (torch.float64, None, EXACT), (torch.float32, 3, SSD_TOL)])
@pytest.mark.parametrize("b,s,h,p,n,q", SSD_CASES)
def test_ssd_backward_emulation_matches_autograd(b, s, h, p, n, q, dtype,
                                                 passes, tol):
    """The decomposition in f64 (exact products) and three TF32 passes in
    f32 against autograd of ``ssd_scan_plain`` in the same precision."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    arrays = _ssd_case(b, s, h, p, n, np_dtype, s + n)
    x, a, B, C, dy = map(torch.from_numpy, arrays)
    want = ssd.ssd_scan_backward_plain(x, a, B, C, dy, chunk=q)
    got = _ssd_emulate(arrays, q, passes, dtype)
    assert max(_rel(got, want)) <= tol, _rel(got, want)


@pytest.mark.parametrize("dtype,passes,tol", [
    (np.float64, None, EXACT), (np.float32, 3, SSD_TOL)])
@pytest.mark.parametrize("b,s,h,p,n,q", [(1, 128, 2, 16, 32, 32),
                                         (2, 64, 1, 8, 16, 64)])
def test_ssd_backward_emulation_matches_jax(b, s, h, p, n, q, dtype, passes,
                                            tol):
    """Against ``jax.vjp`` of the model's ``ssd_chunked`` on the same
    inputs, in the same precision."""
    arrays = _ssd_case(b, s, h, p, n, dtype, s + h)
    with jax.enable_x64(dtype == np.float64):
        want = _jax_grads(lambda *t: ssd_chunked(*t, chunk=q), arrays)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    got = _ssd_emulate(arrays, q, passes, tdtype)
    assert max(_rel(got, want)) <= tol, _rel(got, want)


@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_one_tf32_pass_misses_where_three_pass(kernel):
    """With one TF32 pass a product keeps ~1e-3 of f32's accuracy: the
    gradients miss the tolerance that three passes meet."""
    if kernel == "flash":
        arrays = _flash_case(1, 128, 4, 2, 64, np.float32, 3)
        q, k, v, do = map(torch.from_numpy, arrays)
        want = fa.flash_attention_backward_plain(q, k, v, do, True, 0)
        errs = [max(_rel(_flash_emulate(arrays, True, 0, passes), want))
                for passes in (1, 3)]
        tol = FLASH_TOL
    else:
        arrays = _ssd_case(1, 256, 2, 64, 64, np.float32, 3)
        want = ssd.ssd_scan_backward_plain(
            *map(torch.from_numpy, arrays[:4]), torch.from_numpy(arrays[4]),
            chunk=128)
        errs = [max(_rel(_ssd_emulate(arrays, 128, passes), want))
                for passes in (1, 3)]
        tol = SSD_TOL
    assert errs[1] <= tol < errs[0], errs


def test_ssd_reverse_pass_sums_the_later_chunks():
    """G_c from the reversed states and their pass equals its definition,
    the sum over every later position i of e^(L_i - L_end(c)) C_i dy_i^T."""
    b, s, h, p, n, q = 1, 40, 2, 3, 4, 8
    x, a, B, C, dy = map(torch.from_numpy,
                         _ssd_case(b, s, h, p, n, np.float64, 1))
    nc = s // q
    A = a.reshape(b, nc, q, h).permute(0, 3, 1, 2)
    Cm, Y = (t.reshape(b, nc, q, h, -1).permute(0, 3, 1, 2, 4)
             for t in (C, dy))
    got = _reverse_states(A, Cm, Y, q, _products(None))
    L = a.cumsum(1)                                   # [b, s, h]
    for c in range(nc):
        end = c * q + q - 1
        later = torch.arange(end + 1, s)
        w = torch.exp(L[:, later] - L[:, end, None])  # [b, later, h]
        want = torch.einsum("bih,bihn,bihp->bhnp", w, C[:, later],
                            dy[:, later])
        torch.testing.assert_close(got[:, :, c], want, rtol=1e-12,
                                   atol=1e-12)


def test_ssd_decay_gradient_keeps_f32_accuracy_over_a_long_sequence():
    """At S 4096 the suffix sum of dL = dy.y - x.dx cancels to 0 at t = 0
    and in f32 loses the decays' gradient; the fused pass sums the crossing
    pairs and keeps f32 autograd's accuracy, with three TF32 passes: the
    per-head sum of da (what A_log's gradient reads) against f64 autograd
    within 2e-4 of its size, as the plain version's f32 autograd is, where
    the dL cumsum misses by more than 1e-3."""
    arrays = _ssd_case(1, 4096, 2, 16, 16, np.float32, 9)
    x, a, B, C, dy = map(torch.from_numpy, arrays)
    want = ssd.ssd_scan_backward_plain(*(t.double() for t in (x, a, B, C)),
                                       dy.double(), chunk=256)[1].sum(1)
    got = _ssd_emulate(arrays, 256, 3)
    plain = ssd.ssd_scan_backward_plain(x, a, B, C, dy, chunk=256)[1]
    y = ssd.ssd_scan_plain(x, a, B, C, chunk=256)
    whole = (dy * y - x * got[0]).sum(-1).flip(1).cumsum(1).flip(1)

    def err(da):
        return float(((da.double().sum(1) - want).abs() / want.abs()).max())

    assert err(got[1]) < 2e-4 and err(plain) < 2e-4 < 1e-3 < err(whole), (
        err(got[1]), err(plain), err(whole))


# ---------------------------------------------------------------------------
# the CPU routes
# ---------------------------------------------------------------------------
def test_cpu_routes_are_the_plain_backwards():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, h, 16, generator=g) for h in (4, 2, 2))
    do = torch.randn(1, 40, 4, 16, generator=g)
    o = ops.flash_attention(q, k, v, window=9)
    for got, want in zip(
            ops.flash_attention_backward(q, k, v, o, do, window=9),
            fa.flash_attention_backward_plain(q, k, v, do, True, 9)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    x, a, B, C, dy = map(torch.from_numpy,
                         _ssd_case(1, 64, 2, 8, 8, np.float32, 0))
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
