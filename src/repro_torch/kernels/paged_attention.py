"""Paged attention: the CUDA launchers and their plain PyTorch versions.

Two functions of the JAX package's ``kernels/paged_attention.py`` are
ported here:

  * ``paged_attention_bkgd`` (decode: one query token per slot) ->
    ``paged_attention_cuda`` / ``paged_attention_plain``;
  * ``paged_prefill_bkgd`` (a C-token chunk per slot, causal inside the
    chunk) -> ``paged_prefill_cuda`` / ``paged_prefill_attention_plain``.

The CUDA kernels live in ``csrc/paged_attention.cu`` (design and bound in
its header). Both read a few MB of K/V and do a few MFLOP a call at the
serve path's shapes, microseconds of work, so latency bounds them: the
longest walk one CTA makes down a block table, and how much of the card
the grid fills. Both split the table walk into ranges of a fixed number of
columns (``split_plan``; ``DECODE_SPLIT_KEYS`` and ``SPLIT_KEYS`` set the
width), one CTA per (slot, kv head, range), run both products on the
tensor cores and merge the ranges' partial softmax states in a second
kernel, all from one C call. The decode's 4 warps share its one m16 tile
of q heads and each takes a quarter of every 64-key tile.

The plain versions port ``kernels/ref.py`` — gather through the table,
mask, softmax in f32 — with the kernels' edge rule for a row that sees no
key: it outputs 0 (the kernel's ``l == 0 -> 1``), where the JAX oracle
would average garbage. ``kernels/ops.py`` routes by device.

Layouts are the JAX wrappers' (``kernels/ops.py``): q ``[B, Hq, D]``
(decode) or ``[B, C, Hq, D]`` (prefill) with q heads grouped per kv head
(head ``h`` reads kv head ``h // G``); pools ``[NB, BS, Hkv, D]``; tables
``[B, MB]`` int32 with -1 for an unassigned column; ``pos`` / ``start``
``[B]`` int32; ``window`` an int, 0 for full attention. The kernels read
the pools through their strides (a KV-head slice of a pool is a view),
with a unit stride along D and every key row 16-byte aligned.

Partial mode (``pos_base``, ``return_lse``): a rank whose pool holds only
in-block offsets ``[off, off + BS)`` of every block of the global block
size ``BS_g`` passes that slice with ``pos_base = (BS_g, off)``; local key
j of table column c sits at position ``c BS_g + off + j``. With
``return_lse`` the call also returns each row's log-sum-exp over the keys
it saw, f32 ``[B, Hq]`` (decode) or ``[B, C, Hq]`` (prefill), -inf for a
row that saw none: the ranks' partial outputs merge by it
(``dist/sharding.py:merge_partials``) into the whole pool's output.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the CUDA source instantiates
HEAD_DIMS = (32, 64, 96, 128)
#: keys a split of the prefill's table walk covers: 2 columns at block 16,
#: the fastest width at the qwen2-0.5b engine's shape (PERF.md, split width)
SPLIT_KEYS = 32
#: keys a split of the decode's table walk covers: 4 columns at block 16
#: (PERF.md, split width)
DECODE_SPLIT_KEYS = 64


def split_plan(mb: int, bs: int, keys: int | None = None):
    """(columns per split cps, number of splits) of a kernel's table walk
    over ``mb`` columns of ``bs`` keys, ``keys`` (default ``SPLIT_KEYS``)
    a split: split s owns columns [s cps, min(mb, (s + 1) cps)). A fixed
    number of columns per split, so the plan needs only host-known shapes
    (never ``pos`` / ``start``)."""
    keys = SPLIT_KEYS if keys is None else keys
    if keys < 1:
        raise ValueError(f"a split must cover >= 1 key (SPLIT_KEYS, "
                         f"DECODE_SPLIT_KEYS), got {keys}")
    cps = max(1, keys // bs)
    return cps, max(1, -(-mb // cps))


def paged_kv_gather(k_pages, v_pages, tables):
    """Materialize each row's pages: -> (k [B, MB*BS, Hkv, D], v likewise,
    k_pos [MB*BS] logical positions, assigned [B, MB*BS] mask). Unassigned
    table entries gather block 0 and are masked off by ``assigned``."""
    bs = k_pages.shape[1]
    b, mb = tables.shape
    safe = tables.clamp(min=0).long()
    kg = k_pages[safe].reshape(b, mb * bs, *k_pages.shape[2:])
    vg = v_pages[safe].reshape(b, mb * bs, *v_pages.shape[2:])
    k_pos = torch.arange(mb * bs, device=tables.device)
    assigned = (tables >= 0).repeat_interleave(bs, dim=1)
    return kg, vg, k_pos, assigned


def key_positions(mb: int, bs: int, pos_base, device) -> torch.Tensor:
    """[MB BS] positions of a gathered table's keys: column c's local key
    j at ``c BS_g + off + j`` (``pos_base = (BS_g, off)``; None: the whole
    pool, ``c BS + j``)."""
    bs_g, off = pos_base if pos_base is not None else (bs, 0)
    col = torch.arange(mb, device=device)[:, None] * bs_g + off
    return (col + torch.arange(bs, device=device)[None, :]).reshape(-1)


def _attend_plain(q, k_pages, v_pages, tables, start, window: int,
                  pos_base=None, return_lse: bool = False):
    """q [B, C, Hq, D] at positions start[b] + c -> [B, C, Hq, D] (and,
    with ``return_lse``, the rows' log-sum-exp [B, C, Hq] f32)."""
    b, c, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    kg, vg, _, assigned = paged_kv_gather(k_pages, v_pages, tables)
    k_pos = key_positions(tables.shape[1], k_pages.shape[1], pos_base,
                           q.device)
    q_pos = (start.long()[:, None]
             + torch.arange(c, device=q.device)[None, :])[:, :, None]
    valid = assigned[:, None, :] & (k_pos <= q_pos)            # [B, C, K]
    if window:
        valid &= k_pos > q_pos - window
    qg = q.reshape(b, c, hkv, g, d).float()
    logits = torch.einsum("bchgd,bkhd->bhgck", qg, kg.float()) / math.sqrt(d)
    mask = valid[:, None, None]                                # [B,1,1,C,K]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, -math.inf))
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgck,bkhd->bchgd", p / l, vg.float())
    out = out.reshape(b, c, hq, d).to(q.dtype)
    if not return_lse:
        return out
    # [B, Hkv, G, C, 1] -> [B, C, Hq]
    return out, lse[..., 0].permute(0, 3, 1, 2).reshape(b, c, hq)


def paged_attention_plain(q, k_pages, v_pages, tables, pos, window: int = 0,
                          pos_base=None, return_lse: bool = False):
    """Plain version of the decode kernel: q [B, Hq, D] -> [B, Hq, D]
    (with ``return_lse``, and the rows' log-sum-exp [B, Hq])."""
    paged_attention_plain.calls += 1
    res = _attend_plain(q[:, None], k_pages, v_pages, tables, pos, window,
                        pos_base, return_lse)
    if return_lse:
        return res[0][:, 0], res[1][:, 0]
    return res[:, 0]


def paged_prefill_attention_plain(q, k_pages, v_pages, tables, start,
                                  window: int = 0, pos_base=None,
                                  return_lse: bool = False):
    """Plain version of the prefill kernel: q [B, C, Hq, D] -> same (with
    ``return_lse``, and the rows' log-sum-exp [B, C, Hq])."""
    paged_prefill_attention_plain.calls += 1
    return _attend_plain(q, k_pages, v_pages, tables, start, window,
                         pos_base, return_lse)


#: calls of each plain version, so a device run can show it never fell
#: back to them
paged_attention_plain.calls = 0
paged_prefill_attention_plain.calls = 0


def _check(q, k_pages, v_pages, tables, start, qdim: int,
           pos_base=None) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != qdim or 0 in q.shape[1:]:
        raise ValueError(f"q must be a {qdim}-d tensor with non-empty "
                         f"trailing dims, got {tuple(q.shape)}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("start", start)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pages.dtype}/{v_pages.dtype} "
                         f"differs from q dtype {q.dtype}")
    if tables.dtype != torch.int32 or start.dtype != torch.int32:
        raise ValueError("tables and pos/start must be int32")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"pools must share one [NB, BS, Hkv, D] shape, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    nb, bs, hkv, d = k_pages.shape
    b, hq = q.shape[0], q.shape[-2]
    if q.shape[-1] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not group over pool "
                         f"{tuple(k_pages.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not 1 <= bs <= 32:
        raise ValueError(f"block_size {bs} not in [1, 32]")
    if tables.dim() != 2 or tables.shape[0] != b or start.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / start "
                         f"{tuple(start.shape)} do not match batch {b}")
    if pos_base is not None:
        bs_g, off = pos_base
        if off < 0 or off + bs > bs_g:
            raise ValueError(f"pos_base {tuple(pos_base)}: a slice of {bs} "
                             f"offsets at {off} must lie inside a block of "
                             f"{bs_g}")
    for name, t in (("q", q), ("tables", tables), ("start", start)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned, its base and "
                             f"its strides {t.stride()} (the kernels copy "
                             "a key row 16 bytes at a time)")


def _pool_args(k_pages, window: int):
    s_blk, s_tok, s_head, _ = k_pages.stride()
    return s_blk, s_tok, s_head, int(window)


def _launch(entry: str, q, k_pages, v_pages, tables, start, window: int,
            keys: int, pos_base=None, return_lse: bool = False):
    """Run the C entry ``entry`` on q [B, C, Hq, D] (decode: C is 1 and q
    passes as [B, Hq, D]) over a table walk split by ``split_plan``; with
    more than one split the partials go to f32 scratch allocated here and a
    second kernel merges them (both launched by one C call). ``pos_base``
    and ``return_lse``: the partial mode (module docstring)."""
    out = torch.empty_like(q)
    lib = build.library()
    _, bs, hkv, d = k_pages.shape
    bs_g, off = pos_base if pos_base is not None else (bs, 0)
    mb = tables.shape[1]
    cps, nsplit = split_plan(mb, bs, keys)
    acc = ml = None
    if nsplit > 1:
        rows = nsplit * q.numel() // d        # nsplit x B x Hkv x (C G) rows
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()              # [rows, D], then (m, l) [rows, 2]
        ml = acc + 4 * rows * d
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), start.data_ptr(), out.data_ptr(), acc, ml,
            None if lse is None else lse.data_ptr(),
            *q.shape[:-1], hkv, d, bs, int(bs_g), int(off), mb, cps,
            *_pool_args(k_pages, window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on(code, entry)
    return (out, lse) if return_lse else out


def paged_attention_cuda(q, k_pages, v_pages, tables, pos, window: int = 0,
                         pos_base=None, return_lse: bool = False):
    """Launch the decode kernel: q [B, Hq, D] -> [B, Hq, D] (q's dtype;
    with ``return_lse``, and the rows' log-sum-exp [B, Hq] f32), the table
    walk split every ``DECODE_SPLIT_KEYS`` keys."""
    _check(q, k_pages, v_pages, tables, pos, 3, pos_base)
    return _launch("paged_attention_decode", q, k_pages, v_pages, tables,
                   pos, window, DECODE_SPLIT_KEYS, pos_base, return_lse)


def paged_prefill_cuda(q, k_pages, v_pages, tables, start, window: int = 0,
                       pos_base=None, return_lse: bool = False):
    """Launch the prefill kernel: q [B, C, Hq, D] -> same (q's dtype; with
    ``return_lse``, and the rows' log-sum-exp [B, C, Hq] f32), the table
    walk split every ``SPLIT_KEYS`` keys."""
    _check(q, k_pages, v_pages, tables, start, 4, pos_base)
    return _launch("paged_attention_prefill", q, k_pages, v_pages, tables,
                   start, window, SPLIT_KEYS, pos_base, return_lse)
