"""The port's paged attention (repro_torch.kernels) against the JAX package.

On the CPU the port's wrappers run the plain PyTorch versions; they are
held against the JAX wrappers, which run the Pallas kernels in interpret
mode on the CPU (as tests/test_kernels.py runs them), and against the
pure-jnp oracles of ``repro.kernels.ref``. The sweep mirrors
tests/test_kernels.py (GQA groups, sliding windows, -1 table tails) and
adds G = 7 (qwen2-0.5b's 14 q heads over 2 kv heads) and an all -1 row,
whose output must be exactly 0 (the Pallas kernels' l == 0 -> 1 rule; the
oracle averages garbage there, so it is compared on the other rows).
Tolerances are tests/test_kernels.py's: 2e-5 in f32, 2e-2 in bf16.
tests/test_torch_cuda_kernels.py holds the CUDA kernels against these
plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from tests._torch_tf32 import mm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS = [(4, 4), (8, 2), (6, 1), (14, 2)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NB, BS, D, MB = 10, 8, 32, 4
#: -1 tails, a full row, and an all -1 (padding) row last
TABLES = np.array([[3, 7, -1, -1], [0, 1, 2, 9], [5, 6, -1, -1],
                   [-1, -1, -1, -1]], np.int32)


def _inputs(seed, hq, hkv, q_shape):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, BS, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, hkv, D)).astype(np.float32)
    q = rng.standard_normal(q_shape).astype(np.float32)
    return q, kp, vp


def _both(arrays, dtype):
    """The same numpy inputs for JAX and for torch, cast to ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _check(out, exp, dtype, rows=slice(None)):
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(exp, np.float32)[rows],
                               atol=tol, rtol=tol)


def _cases():
    for hq, hkv in HEADS:
        for window in (0, 5):
            yield pytest.param(hq, hkv, window, "float32",
                               id=f"{hq}x{hkv}-w{window}-f32")
    for window in (0, 5):
        yield pytest.param(14, 2, window, "bfloat16", id=f"14x2-w{window}-bf16")


@pytest.mark.parametrize("hq,hkv,window,dtype", list(_cases()))
def test_paged_attention_plain_vs_pallas_and_ref(hq, hkv, window, dtype):
    q, kp, vp = _inputs(hq * 31 + hkv + window, hq, hkv, (4, hq, D))
    pos = np.array([12, 30, 10, 5], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both([q, kp, vp], dtype)
    out = ops.paged_attention(tq, tk, tv, torch.from_numpy(TABLES),
                              torch.from_numpy(pos), window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _check(out, jops.paged_attention(jq, jk, jv, TABLES, pos, window), dtype)
    _check(out, jref.paged_attention(jq, jk, jv, jnp.asarray(TABLES),
                                     jnp.asarray(pos), window), dtype,
           rows=slice(0, 3))
    assert (out[3] == 0).all()                      # no visible key -> 0


@pytest.mark.parametrize("hq,hkv,window,dtype", list(_cases()))
def test_paged_prefill_plain_vs_pallas_and_ref(hq, hkv, window, dtype):
    c = 6
    q, kp, vp = _inputs(hq * 37 + hkv + window, hq, hkv, (4, c, hq, D))
    start = np.array([8, 24, 2, 0], np.int32)       # chunks mid-table
    (jq, jk, jv), (tq, tk, tv) = _both([q, kp, vp], dtype)
    out = ops.paged_prefill_attention(tq, tk, tv, torch.from_numpy(TABLES),
                                      torch.from_numpy(start), window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _check(out, jops.paged_prefill_attention(jq, jk, jv, TABLES, start,
                                             window), dtype)
    _check(out, jref.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(TABLES), jnp.asarray(start), window), dtype,
        rows=slice(0, 3))
    assert (out[3] == 0).all()


def test_paged_prefill_causal_inside_chunk():
    """A chunk's first query row equals single-token decode at its
    position: later in-chunk K/V is invisible to it."""
    q, kp, vp = _inputs(5, 14, 2, (1, 4, 14, D))
    tables = torch.tensor([[2, 0, -1, -1]], dtype=torch.int32)
    start = torch.tensor([4], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    chunk = ops.paged_prefill_attention(tq, tk, tv, tables, start)
    single = ops.paged_attention(tq[:, 0], tk, tv, tables, start)
    torch.testing.assert_close(chunk[:, 0], single, atol=2e-5, rtol=2e-5)


def test_cpu_tensors_never_launch_kernels():
    before = (ops.paged_attention.launches,
              ops.paged_prefill_attention.launches)
    q, kp, vp = _inputs(0, 14, 2, (4, 2, 14, D))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    pos = torch.tensor([12, 30, 10, 5], dtype=torch.int32)
    ops.paged_attention(tq[:, 0], tk, tv, torch.from_numpy(TABLES), pos)
    ops.paged_prefill_attention(tq, tk, tv, torch.from_numpy(TABLES), pos)
    assert (ops.paged_attention.launches,
            ops.paged_prefill_attention.launches) == before == (0, 0)


def test_non_cpu_tensors_go_to_the_kernel_or_raise(monkeypatch):
    """Tensors off the CPU never take the plain version: tensors without
    storage (meta, the dry-run's) take the cost route, which computes
    nothing and launches nothing, and a CUDA tensor goes to the kernel,
    which raises without its library instead of falling back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build

    def no_library():
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(build, "library", no_library)
    calls = pa.paged_attention_plain.calls
    launches = ops.paged_attention.launches
    q = torch.empty((2, 14, D), device="meta")
    kp = torch.empty((NB, BS, 2, D), device="meta")
    tables = torch.empty((2, MB), dtype=torch.int32, device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    out = ops.paged_attention(q, kp, kp, tables, pos)
    assert out.device.type == "meta" and out.shape == q.shape
    with FakeTensorMode():
        q, kp, tables, pos = (torch.zeros(t.shape, dtype=t.dtype,
                                          device="cuda")
                              for t in (q, kp, tables, pos))
        with pytest.raises(RuntimeError, match="no kernel library"):
            ops.paged_attention(q, kp, kp, tables, pos)
    assert pa.paged_attention_plain.calls == calls
    assert ops.paged_attention.launches == launches


# ---------------------------------------------------------------------------
# The prefill kernel's design on the CPU: three TF32 passes, a split walk
# ---------------------------------------------------------------------------
def _split_ranges(mb, bs):
    """The table-column range [j0, j1) of each split of the launcher's plan,
    as the kernel takes them (``split_plan``'s docstring)."""
    cps, n = pa.split_plan(mb, bs)
    return [(s * cps, min(mb, (s + 1) * cps)) for s in range(n)]


def _prefill_parts(q, kp, vp, tables, start, window, cols, passes=0):
    """The kernel's algorithm: the plain arithmetic restricted to table
    columns [j0, j1) gives one partial (m, l, acc) per row of q [B, C, Hq,
    D]; products in f32 (passes 0) or through ``_mm``. Rows come out as
    [B, Hkv, C G] in the kernel's r = c G + g order."""
    b, c, hq, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    g = hq // hkv
    j0, j1 = cols
    kg, vg, k_pos, assigned = pa.paged_kv_gather(kp, vp, tables)
    q_pos = start.long()[:, None] + torch.arange(c)[None, :]
    vis = (assigned[:, None, :] & (k_pos <= q_pos[:, :, None])
           & (k_pos >= j0 * bs) & (k_pos < j1 * bs))
    if window:
        vis &= k_pos > q_pos[:, :, None] - window
    qr = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, c * g, d)
    mask = vis.repeat_interleave(g, dim=1)[:, None]      # [B, 1, CG, K]
    kh, vh = kg.transpose(1, 2), vg.transpose(1, 2)      # [B, Hkv, K, D]
    prod = (lambda x, y: x @ y) if passes == 0 else (
        lambda x, y: mm(x, y, passes))
    s = prod(qr, kh.transpose(-1, -2)) / np.sqrt(d)
    s = s.masked_fill(~mask, pa.NEG_INF)
    m = s.amax(-1)
    m_safe = torch.where(m <= pa.NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None]) * mask
    return m, p.sum(-1), prod(p, vh)


def _merge(parts, q):
    """The merge kernel: partials rescaled to their common max, summed,
    l == 0 -> 1 after the merge; back to q's [B, C, Hq, D]."""
    b, c, hq, d = q.shape
    ms = torch.stack([m for m, _, _ in parts])
    ls = torch.stack([l for _, l, _ in parts])
    live = ls > 0
    big = ms.masked_fill(~live, pa.NEG_INF).amax(0)
    w = torch.where(live, torch.exp(ms - big), torch.zeros_like(ms))
    acc = sum(wi[..., None] * torch.where(li[..., None] > 0, a, 0.0)
              for wi, li, (_, _, a) in zip(w, ls, parts))
    L = (w * ls).sum(0)
    out = acc / torch.where(L == 0, torch.ones_like(L), L)[..., None]
    hkv = out.shape[1]
    return out.reshape(b, hkv, c, hq // hkv, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, hq, d)


def _split_case(seed):
    """Four rows over a 12-column table of 4-key blocks, chunk 6, G 3:
    row 0 has a -1 hole inside a split range, row 1 is all -1, row 2 is
    full, and row 3's chunk sits on -1 columns after a real prefix, so
    with a small window its rows see no key at all (output 0, not NaN)."""
    rng = np.random.default_rng(seed)
    nb, bs, hkv, d, mb, c, hq = 40, 4, 2, 32, 12, 6, 6
    kp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    q = torch.from_numpy(2 * rng.standard_normal((4, c, hq, d))
                         .astype(np.float32))
    perm = rng.permutation(nb).astype(np.int32)
    tables = np.full((4, mb), -1, np.int32)
    tables[0, :11] = perm[:11]
    tables[0, 5] = -1
    tables[2, :] = perm[11:23]
    tables[3, :5] = perm[23:28]              # positions 20-31 unassigned
    start = torch.tensor([36, 20, 42, 24], dtype=torch.int32)
    return q, kp, vp, torch.from_numpy(tables), start


@pytest.mark.parametrize("window", [0, 3, 9])
@pytest.mark.parametrize("cols", [1, 2, 4, 12])
def test_split_walk_merges_to_the_plain_result(monkeypatch, cols, window):
    """Splitting the table walk into column ranges of 1, 2, 4 and MB
    columns (the launcher's plan) and merging the partials gives
    ``paged_prefill_attention_plain``'s result: -1 holes inside a range,
    an all -1 row, a window that empties whole splits, and rows with no
    visible key, which come out 0."""
    q, kp, vp, tables, start = _split_case(cols + window)
    monkeypatch.setattr(pa, "SPLIT_KEYS", cols * kp.shape[1])
    ranges = _split_ranges(tables.shape[1], kp.shape[1])
    parts = [_prefill_parts(q, kp, vp, tables, start, window, r)
             for r in ranges]
    got = _merge(parts, q)
    exp = pa.paged_prefill_attention_plain(q, kp, vp, tables, start, window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)
    assert (got[1] == 0).all()
    if window == 3:
        assert (got[3] == 0).all()           # no row of the chunk sees a key
    if window and cols == 1:
        empty = sum(bool((l == 0).all()) for _, l, _ in parts)
        assert empty >= len(parts) // 2     # the window emptied whole splits


@pytest.mark.parametrize("passes", [1, 3])
def test_three_tf32_passes_keep_f32_accuracy(passes):
    """At the engine's prefill shape ([4, 16] chunks, 14 q heads over 2 kv
    heads, D 64, block 16, starts 192-368) three TF32 passes stay within
    the f32 tolerance of the plain version; one pass does not."""
    rng = np.random.default_rng(7)
    nb, bs, hkv, d, mb, c, hq = 120, 16, 2, 64, 64, 16, 14
    kp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, c, hq, d))
                         .astype(np.float32))
    start = torch.tensor([192, 250, 301, 368], dtype=torch.int32)
    tables = torch.full((4, mb), -1, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(nb).astype(np.int32))
    for i in range(4):
        n = (int(start[i]) + c - 1) // bs + 1
        tables[i, :n] = perm[i * 30:i * 30 + n]
    exp = pa.paged_prefill_attention_plain(q, kp, vp, tables, start)
    got = _merge([_prefill_parts(q, kp, vp, tables, start, 0, (0, mb),
                                 passes)], q)
    close = torch.allclose(got, exp, atol=2e-5, rtol=2e-5)
    assert close == (passes == 3), (passes, (got - exp).abs().max().item())


@pytest.mark.parametrize("mb", [1, 3, 64, 65])
def test_split_plan_covers_every_column_once(monkeypatch, mb):
    """The launcher's plan (fixed columns per split, host-known MB only)
    covers each table column exactly once, in order, with no empty range,
    at the default SPLIT_KEYS and at splits of 1, 2, 4 and MB columns (and
    fewer keys than a block); at qwen2-0.5b's engine shape it gives more
    CTAs than B x Hkv."""
    if mb == 64:
        assert 4 * 2 * pa.split_plan(mb, 16)[1] > 4 * 2
    for bs in (1, 8, 16, 32):
        for keys in (pa.SPLIT_KEYS, 1, bs, 2 * bs, 4 * bs, mb * bs):
            monkeypatch.setattr(pa, "SPLIT_KEYS", keys)
            cps, n = pa.split_plan(mb, bs)
            ranges = _split_ranges(mb, bs)
            assert len(ranges) == n
            assert all(j0 < j1 for j0, j1 in ranges)
            covered = [j for j0, j1 in ranges for j in range(j0, j1)]
            assert covered == list(range(mb))


def test_split_plan_rejects_empty_splits(monkeypatch):
    """A split width below one key is refused, not taken for the default."""
    monkeypatch.setattr(pa, "SPLIT_KEYS", 0)
    with pytest.raises(ValueError, match="SPLIT_KEYS"):
        pa.split_plan(64, 16)


# ---------------------------------------------------------------------------
# The decode kernel's design on the CPU: splits, four warps' key quarters,
# their fold, the merge and three TF32 passes
# ---------------------------------------------------------------------------
def _empty_state(shape, d):
    return (torch.full(shape, pa.NEG_INF), torch.zeros(shape),
            torch.zeros(*shape, d))


def _step(state, q, k, v, vis, scale, passes):
    """``WarpState::step``: one warp's keys k, v [..., K, D] of a tile for
    rows q [..., R, D]; vis [..., R, K] (False: masked)."""
    m, l, o = state
    s = mm(q, k.transpose(-1, -2), passes) * scale
    s = s.masked_fill(~vis, pa.NEG_INF)
    m_cur = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(m_cur <= pa.NEG_INF / 2, 0.0, m_cur)
    alpha = torch.where(m <= pa.NEG_INF / 2, 0.0, torch.exp(m - m_safe))
    p = torch.where(vis, torch.exp(s - m_safe[..., None]), 0.0)
    return (m_cur, alpha * l + p.sum(-1),
            alpha[..., None] * o + mm(p, v, passes))


def _fold(a, b):
    """``WarpState::merge``: another warp's state over other keys."""
    (m1, l1, o1), (m2, l2, o2) = a, b
    mx = torch.maximum(m1, m2)
    ms = torch.where(mx <= pa.NEG_INF / 2, 0.0, mx)
    a1 = torch.where(m1 <= pa.NEG_INF / 2, 0.0, torch.exp(m1 - ms))
    a2 = torch.where(m2 <= pa.NEG_INF / 2, 0.0, torch.exp(m2 - ms))
    return mx, a1 * l1 + a2 * l2, a1[..., None] * o1 + a2[..., None] * o2


def _decode_kernel(q, kp, vp, tables, pos, window, passes=3):
    """The decode kernel's arithmetic in its order, on q [B, Hq, D]: each
    split of ``split_plan(MB, BS, DECODE_SPLIT_KEYS)`` walks its columns
    max(1, 64 / BS) at a time as 64-key tiles; warp w of four steps keys
    16 w .. 16 w + 15 of every tile (a tile without a visible key changes
    no state, so the kernel's skipping it is not modelled); warps 1-3 fold
    into warp 0; with one split that state is the output, otherwise the
    splits' partials go through ``_merge``. Returns (output, partials)."""
    b, hq, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    g, mb = hq // hkv, tables.shape[1]
    cps, nsplit = pa.split_plan(mb, bs, pa.DECODE_SPLIT_KEYS)
    ncol = max(1, 64 // bs)
    kg, vg, k_pos, assigned = pa.paged_kv_gather(kp, vp, tables)
    kh, vh = kg.transpose(1, 2), vg.transpose(1, 2)      # [B, Hkv, K, D]
    p = pos.long()[:, None]
    vis = assigned & (k_pos <= p)                        # [B, K]
    if window:
        vis &= k_pos > p - window
    qr = q.reshape(b, hkv, g, d)
    parts = []
    for s in range(nsplit):
        j0, j1 = s * cps, min(mb, (s + 1) * cps)
        warps = [_empty_state((b, hkv, g), d) for _ in range(4)]
        for jt in range(j0, j1, ncol):
            k0, k_end = jt * bs, min(jt + ncol, j1) * bs
            for w in range(4):
                keys = slice(k0 + 16 * w, min(k0 + 16 * w + 16, k_end))
                if keys.start < k_end:
                    v_ = vis[:, None, None, keys].expand(b, hkv, g, -1)
                    warps[w] = _step(warps[w], qr, kh[:, :, keys],
                                     vh[:, :, keys], v_, 1 / np.sqrt(d),
                                     passes)
        state = warps[0]
        for other in warps[1:]:
            state = _fold(state, other)
        parts.append(state)
    if nsplit == 1:
        _, l, o = parts[0]
        out = o / torch.where(l == 0, 1.0, l)[..., None]
        return out.reshape(b, hq, d), parts
    return _merge(parts, q[:, None])[:, 0], parts


_JAX_DECODE = {}


def _jax_decode(q, kp, vp, tables, pos, window):
    """The JAX wrapper's Pallas decode kernel (interpret mode), once per
    input set: it does not depend on the port's split width."""
    key = (q.shape, window)
    if key not in _JAX_DECODE:
        _JAX_DECODE[key] = np.asarray(jops.paged_attention(
            *(jnp.asarray(t.numpy()) for t in (q, kp, vp)),
            tables.numpy(), pos.numpy(), window))
    return _JAX_DECODE[key]


def _decode_case(g):
    """Four slots over a 20-column table of 8-key blocks, G q heads over 2
    kv heads, D 32: row 0 has a -1 hole mid-walk and a -1 tail, row 1 is
    all -1, row 2's table is full and its position the last, row 3's
    position sits on -1 columns after a real prefix, so under a small
    window it sees no key (output 0, not NaN)."""
    rng = np.random.default_rng(g)
    nb, bs, hkv, d, mb = 80, 8, 2, 32, 20
    kp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    q = torch.from_numpy(2 * rng.standard_normal((4, g * hkv, d))
                         .astype(np.float32))
    perm = rng.permutation(nb).astype(np.int32)
    tables = np.full((4, mb), -1, np.int32)
    tables[0, :19] = perm[:19]
    tables[0, 9] = -1
    tables[2, :] = perm[19:39]
    tables[3, :10] = perm[39:49]             # positions 80-159 unassigned
    pos = torch.tensor([150, 40, 159, 100], dtype=torch.int32)
    return q, kp, vp, torch.from_numpy(tables), pos


@pytest.mark.parametrize("g", [1, 7, 16, 32])
@pytest.mark.parametrize("window", [0, 3, 9])
@pytest.mark.parametrize("cols", [1, 3, 8, 20])
def test_decode_kernel_emulation_matches_plain_and_pallas(monkeypatch, cols,
                                                          window, g):
    """The decode kernel's split walk (1, 3, 8 and all 20 columns a split:
    one to three 64-key tiles), its four warps' key quarters and their
    fold, the merge and three TF32 passes give
    ``paged_attention_plain``'s and the Pallas kernel's result: -1 holes
    and tails, an all -1 row, a window that empties whole splits, rows
    that see no key (0), and one or two m16 row tiles (G 1 to 32). Splits
    past the last one a row's position reaches are empty, so the merge may
    stop there."""
    q, kp, vp, tables, pos = _decode_case(g)
    bs = kp.shape[1]
    monkeypatch.setattr(pa, "DECODE_SPLIT_KEYS", cols * bs)
    got, parts = _decode_kernel(q, kp, vp, tables, pos, window)
    exp = pa.paged_attention_plain(q, kp, vp, tables, pos, window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(),
                               _jax_decode(q, kp, vp, tables, pos, window),
                               atol=2e-5, rtol=2e-5)
    assert (got[1] == 0).all()
    if window == 3:
        assert (got[3] == 0).all()           # no key visible at position 100
    reached = pos.long() // (cols * bs) + 1
    for s, (_, l, _) in enumerate(parts):
        assert (l[s >= reached] == 0).all()
    if window and cols == 1:
        empty = sum(bool((l == 0).all()) for _, l, _ in parts)
        assert empty >= len(parts) // 2      # the window emptied whole splits


@pytest.mark.parametrize("passes", [1, 3])
def test_decode_three_tf32_passes_keep_f32_accuracy(passes):
    """At the engine's decode shape (8 slots, 14 q heads over 2 kv heads,
    D 64, block 16, positions 192-383) and the default split width, three
    TF32 passes stay within the f32 tolerance of the plain version; one
    pass does not."""
    rng = np.random.default_rng(11)
    nb, bs, hkv, d, mb, hq = 240, 16, 2, 64, 64, 14
    kp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((8, hq, d)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(192, 384, 8).astype(np.int32))
    tables = torch.full((8, mb), -1, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(nb).astype(np.int32))
    for i in range(8):
        n = int(pos[i]) // bs + 1
        tables[i, :n] = perm[i * 30:i * 30 + n]
    exp = pa.paged_attention_plain(q, kp, vp, tables, pos)
    got, _ = _decode_kernel(q, kp, vp, tables, pos, 0, passes)
    close = torch.allclose(got, exp, atol=2e-5, rtol=2e-5)
    assert close == (passes == 3), (passes, (got - exp).abs().max().item())


def test_decode_split_plan_is_its_own(monkeypatch):
    """The decode walk's width is DECODE_SPLIT_KEYS, not the prefill's
    SPLIT_KEYS; at qwen2-0.5b's engine shape it gives more CTAs than one
    per (slot, kv head)."""
    monkeypatch.setattr(pa, "SPLIT_KEYS", 1)
    cps, n = pa.split_plan(64, 16, pa.DECODE_SPLIT_KEYS)
    assert cps == max(1, pa.DECODE_SPLIT_KEYS // 16)
    assert 8 * 2 * n > 8 * 2
    with pytest.raises(ValueError, match="DECODE_SPLIT_KEYS"):
        pa.split_plan(64, 16, 0)
