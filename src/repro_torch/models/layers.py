"""Core layers, ported from ``repro/models/layers.py``: RMSNorm, RoPE and
sinusoidal positions, GQA attention with QKV bias (no cache, contiguous
cache, paged cache, cross attention), SwiGLU MLP, tied embeddings, the
cross-entropy loss.

Layers are plain functions over dicts of tensors, as in the reference. KV
writes, paged or contiguous, go into the cache in place instead of
returning a new cache.

Sharded (``dist/sharding.py``): a layer computes on whatever local blocks
its parameters hold and issues the collective that the reference's
``shard`` site implies where a leaf is split over 'model' — its local
shape says so, off the mesh every leaf is whole and nothing is issued.
``wq`` / ``wk`` / ``wv`` and their biases are column blocks of the flat
head dimension and ``wo`` its row block. Attention takes one of the
reference's schemes (``attention_scheme``):

  * head-sharded (``heads_sharded``): the rank's q heads are whole heads
    of its column block; its KV heads too where they divide 'model', else
    the rank gathers every KV head's columns, caches them all and attends
    over the ones its q heads read (``kv_heads_read``);
  * otherwise the rank gathers the q, k and v columns over 'model' into
    whole heads and attends over all of them: kv-seq where the decode
    cache's positions are split over a mesh axis (``cache_seq_axis``:
    each rank attends over its own keys, the partial outputs merged by
    ``sharding.merge_partials``), q-seq for a causal pass whose length
    'model' divides (a rank's block of query rows through flash with a
    query offset, the rows gathered back), and the whole attention
    elsewhere, as the reference's batch-only branch;

then ``wo`` multiplies the rank's columns of the output and the partial
sums are reduced over 'model', as ``w_down``'s are; the embedding is
vocab-parallel (a masked lookup, then a reduce) and the logits are
gathered over 'model' for serving, while the loss keeps them split over
the vocabulary (``unembed_cross_entropy``). Under grad the collectives
are autograd functions (``dist/sharding.py``, Gradients): each
column-parallel entry takes its input through ``fan_out``. Inside
``sharding.split_rows`` a decode step (or a paged prefill round) computes
this rank's rows: a contiguous pool split over 'data' holds just those
rows, so the write is local, while a paged K/V write first gathers every
'data' rank's rows, since each 'data' rank holds the whole paged pool.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
# shared with the kernels' plain versions, which gather the same way
from repro_torch.kernels.paged_attention import paged_kv_gather  # noqa: F401

NEG_INF = -1e30


def _init_dense(shape, dtype, generator, scale: Optional[float] = None):
    """Normal init scaled by 1/sqrt(fan_in) (or ``scale``), as the
    reference's ``_init_dense`` — same distribution, not the same bits."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Activation recomputation (ArchConfig.remat)
# ---------------------------------------------------------------------------
#: the 2-D products ``x @ W`` (aten's mm / addmm, as ``matmul`` lowers a
#: [B, S, D] x [D, F] product): the dots without batch dimensions that the
#: reference's ``dots_with_no_batch_dims_saveable`` keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg, fn: Callable, dots: bool = True) -> Callable:
    """``fn`` under ``cfg.remat`` (the reference's ``jax.checkpoint`` of a
    layer body): "none" returns it as it is; "full" recomputes everything
    but its inputs in the backward; "dots" saves the 2-D matmul outputs and
    recomputes the rest. ``dots=False`` marks a site where the reference
    checkpoints without a policy (``mamba2.py:233-234``, ``hybrid.py``,
    ``encdec.py``): there "dots" is "full". Without grad mode nothing is
    saved anyway, so ``fn`` runs as it is; recomputation never changes a
    value, only what the backward keeps."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, got "
                         f"{cfg.remat!r}")
    context = _ckpt.noop_context_fn
    if cfg.remat == "dots" and dots:
        context = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the recomputation runs in the backward, on autograd's thread for
        # CUDA tensors: under the mesh rules of this forward (thread-local)
        rules = shd.current_rules()

        def under_rules(*a):
            with shd.use_rules(rules):
                return fn(*a)
        return _ckpt.checkpoint(under_rules, *args, use_reentrant=False,
                                context_fn=context)
    return wrapped


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, weight, eps: float, width: Optional[int] = None):
    """RMSNorm over the last dimension in the (1 + w) form. ``width``: the
    full row width where ``x`` holds a column block of it over 'model'
    (the sum of squares then reduced over 'model', ``weight`` the block's
    slice); None or the last dimension's size: whole rows."""
    dtype = x.dtype
    x = x.float()
    if width is None or width == x.shape[-1]:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        # each rank normalizes its own block: the gradient is partial
        var = shd.reduce_over(x.square().sum(dim=-1, keepdim=True),
                              "model", grad="partial") / width
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)   # (1 + w) form


# ---------------------------------------------------------------------------
# Positional embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, D]; positions: [B, S] (int). Computed in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [D/2]
    angles = positions[..., None].float() * freqs             # [B, S, D/2]
    cos, sin = angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_at(positions, d: int) -> torch.Tensor:
    """The sinusoidal embeddings of integer ``positions`` (any shape) ->
    [..., d] float32: even columns sin(pos * div), odd columns cos, the
    arithmetic of one row of ``sinusoidal_pos_emb``."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / d))
    angles = positions.float()[..., None] * div
    return torch.stack([angles.sin(), angles.cos()], dim=-1).flatten(-2)


def sinusoidal_pos_emb(max_len: int, d: int, device=None) -> torch.Tensor:
    """[max_len, d] float32 table (``repro/models/layers.py:76``)."""
    return sinusoid_at(torch.arange(max_len, device=device), d)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def init_attention(cfg, dtype, generator) -> dict:
    """q / k / v / o projections (and biases). With ``cfg.pad_q_heads``
    the extra q heads go inside each KV group (head h reads kv head
    h // G), with zero ``wo`` rows, so the function is unchanged while
    the heads shard evenly (``layers.py:88-117``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, nhe = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads_eff
    dev = generator.device
    p = {
        "wq": _init_dense((d, nh * hd), dtype, generator),
        "wk": _init_dense((d, nkv * hd), dtype, generator),
        "wv": _init_dense((d, nkv * hd), dtype, generator),
        "wo": _init_dense((nh * hd, d), dtype, generator),
    }
    if nhe > nh:
        if nh % nkv or nhe % nkv:
            raise ValueError(f"pad_q_heads {nhe} must keep whole KV groups "
                             f"({nh} heads, {nkv} kv heads)")
        pad = nhe // nkv - nh // nkv
        wq = p["wq"].reshape(d, nkv, nh // nkv, hd)
        p["wq"] = F.pad(wq, (0, 0, 0, pad)).reshape(d, nhe * hd)
        wo = p["wo"].reshape(nkv, nh // nkv, hd, d)
        p["wo"] = F.pad(wo, (0, 0, 0, 0, 0, pad)).reshape(nhe * hd, d)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nhe * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
    return p


def _axis_ranks(axis: str) -> int:
    """The ranks of mesh ``axis`` under the installed rules (1 off the
    mesh)."""
    rules = shd.current_rules()
    return rules.sizes.get(axis, 1) if rules is not None else 1


def heads_sharded(cfg) -> bool:
    """Whether attention runs head-sharded under the installed rules: the
    layer's scheme (``plan_attention_scheme``, the reference's) splits the
    q heads over 'model', and each rank's q heads read a whole number of
    KV groups or one KV head (so the kernels see one G)."""
    m = _axis_ranks("model")
    if m <= 1 or not cfg.n_kv_heads:
        return False
    scheme = plan_attention_scheme(cfg, 1, 1, 1)
    if scheme is None or scheme["q"][2] != "model":
        return False
    per, g = cfg.n_heads_eff // m, cfg.n_heads_eff // cfg.n_kv_heads
    return cfg.n_kv_heads % m == 0 or per % g == 0 or g % per == 0


def _whole(ts, fulls):
    """Column blocks [B, S, w_i] of flat head projections -> all of each
    [B, S, full_i] (``ts`` as they are when whole): one gather over
    'model' of the blocks side by side, each cut back out in rank order.
    What follows differs by rank (its rows under q-seq, its heads, or
    ``row_parallel``'s columns of the output), so the gradient is partial:
    the backward reduce-scatters it, summing, for instance, the ranks' dk
    and dv of the keys before they reach the K/V projections."""
    if all(t.shape[-1] == f for t, f in zip(ts, fulls)):
        return ts
    widths = [t.shape[-1] for t in ts]
    parts = shd.gather_over(torch.cat(ts, dim=-1)[None], 0, "model",
                            grad="partial")
    out, c = [], 0
    for w in widths:                   # [m, B, S, w] -> [B, S, m w]
        out.append(parts[..., c:c + w].movedim(0, -2).flatten(-2))
        c += w
    return out


def whole_kv(cfg, heads: bool) -> bool:
    """Whether a layer's k / v columns are gathered into every KV head:
    when attention is not head-sharded (``heads`` False), or its KV heads
    do not divide 'model'."""
    return not heads or cfg.n_kv_heads % _axis_ranks("model") != 0


def _qkv(p, cfg, x, heads: bool):
    """x [B, S, D] -> q [B, S, Hq, D], k / v [B, S, Hkv, D]. ``heads``
    (the layer runs head-sharded): q on this rank's heads, k / v on its KV
    heads where they divide 'model', else every KV head (their columns
    gathered); otherwise every head of all three (gathered where the
    projections hold a column block). Off the mesh every leaf is whole;
    column blocks take x through ``fan_out``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if p["wq"].shape[1] != cfg.n_heads_eff * hd:
        x = shd.fan_out(x, "model")
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    full_kv = cfg.n_kv_heads * hd
    if not heads:
        q, k, v = _whole((q, k, v), (cfg.n_heads_eff * hd, full_kv, full_kv))
    elif whole_kv(cfg, heads):
        k, v = _whole((k, v), (full_kv, full_kv))
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


def plan_attention_scheme(cfg, b: int, s: int, kv_len: int):
    """The layer's attention scheme (``layers.py:126-140``): the reference's
    ``attention_scheme`` at the head count the score einsum contracts over
    (the KV heads under ``gqa_no_repeat`` with a group above 1, else the
    effective, padded q heads) and the attended length; None off the
    mesh."""
    nh, nkv = cfg.n_heads_eff, cfg.n_kv_heads
    heads = nkv if cfg.gqa_no_repeat and nh // max(nkv, 1) > 1 else nh
    return shd.attention_scheme(b, s, heads, kv_len)


def kv_heads_read(cfg, n_q: int, n_kv: int) -> Optional[slice]:
    """The KV heads this rank's ``n_q`` q heads read when its q heads are
    a 'model' shard but its ``n_kv`` KV heads are all of them (KV heads
    that do not divide 'model' stay whole, ``layers.py:160-170``); None
    when q and KV heads are both whole or both sharded."""
    if n_q == cfg.n_heads_eff or n_kv != cfg.n_kv_heads:
        return None
    g = cfg.n_heads_eff // cfg.n_kv_heads
    first = shd.axis_index("model") * n_q
    return slice(first // g, (first + n_q - 1) // g + 1)


def row_parallel(x, w, full: int):
    """``x @ w`` for a ``w`` [full | full / m, D] that may hold a row block
    over 'model': the partial sums reduced over 'model' (the reference's
    residual ``shard`` site); an ``x`` of every column against a row block
    multiplies this rank's columns of it."""
    n = w.shape[0]
    if x.shape[-1] != n:
        r = shd.axis_index("model")
        x = x[..., r * n:(r + 1) * n]
    y = x @ w
    if n != full:       # the residual stream: its gradient is replicated
        y = shd.reduce_over(y, "model", grad="replicated")
    return y


def _heads_sum(p, cfg, out):
    """``out @ wo`` of the local heads (``row_parallel``)."""
    return row_parallel(out, p["wo"], cfg.n_heads_eff * cfg.resolved_head_dim)


def _q_seq(cfg, b: int, s: int) -> bool:
    """Whether the layer's scheme for a causal pass of ``s`` positions is
    q-seq: the query sequence split over 'model' (``attention_scheme``),
    with or without gradients (flash's query offset has its backward)."""
    scheme = plan_attention_scheme(cfg, b, s, s)
    return scheme is not None and scheme["q"][1] == "model"


def _q_seq_attention(q, k, v, window: int):
    """Causal attention of every head, a block of query rows a 'model'
    rank: rank r's rows ``[r S/m, (r + 1) S/m)`` against keys
    ``[0, (r + 1) S/m)`` through flash with a query offset, the rows
    gathered over 'model' in rank order. Under grad the rank's backward
    gives dq of its rows and its rows' part of dk and dv of those keys;
    ``wo``'s row-parallel product reads a rank's columns of the gathered
    rows, so their gradient is partial and the gather reduce-scatters it
    (the keys' parts are summed by ``_whole``'s)."""
    n = q.shape[1] // _axis_ranks("model")
    r0 = shd.axis_index("model") * n
    out = kops.flash_attention_offset(q[:, r0:r0 + n], k[:, :r0 + n],
                                      v[:, :r0 + n], r0, causal=True,
                                      window=window)
    return shd.gather_over(out, 1, "model", grad="partial")


def _masked_logits(q, k, mask, no_repeat: bool):
    """``mha``'s scores in f32, NEG_INF where ``mask`` is False -> (logits,
    grouped): [B, Hkv, G, Sq, Sk] when ``grouped`` (``no_repeat`` and
    G > 1: q viewed as [B, Sq, Hkv, G, D], a 4-d mask gains the group
    axis), else [B, Hq, Sq, Sk] against the KV heads repeated."""
    b, sq, hq, d = q.shape
    g = hq // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    grouped = no_repeat and g > 1
    if grouped:
        qg = q.reshape(b, sq, k.shape[2], g, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
        if mask is not None and mask.dim() == 4:
            mask = mask[:, :, None]
    else:
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits, grouped


def _weighted_values(probs, v, grouped: bool, dtype):
    """``probs`` in ``_masked_logits``'s layout, cast to ``dtype``, times
    v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]."""
    probs = probs.to(dtype)
    if grouped:
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.flatten(2, 3)
    g = probs.shape[1] // v.shape[2]
    if g > 1:
        v = v.repeat_interleave(g, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha(q, k, v, mask, no_repeat: bool = False):
    """Grouped-query attention core. q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D],
    mask (True = attend) broadcastable to [B, Hq, Sq, Sk]. KV heads repeat
    to the q-head count (head h reads kv head h // G); with ``no_repeat``
    and G > 1 the score and value einsums contract each KV head against
    its group of q heads instead (``layers.py:216-238``): q is viewed as
    [B, Sq, Hkv, G, D] and the KV heads are never repeated; a 4-d mask
    [B, 1|H, 1|Q, K] gains the group axis."""
    logits, grouped = _masked_logits(q, k, mask, no_repeat)
    return _weighted_values(torch.softmax(logits, dim=-1), v, grouped,
                            q.dtype)


def mha_partial(q, k, v, mask, no_repeat: bool = False):
    """``mha`` over a slice of the keys (kv-seq: this rank's positions of
    a split cache) -> (out [B, Sq, Hq, D] normalized over the slice, each
    row's log-sum-exp over it [B, Sq, Hq] f32, -inf where the slice holds
    no visible key, whose output is 0): ``sharding.merge_partials``
    combines the ranks' into ``mha`` over every key."""
    b, sq, hq, _ = q.shape
    logits, grouped = _masked_logits(q, k, mask, no_repeat)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m)           # a masked key's NEG_INF gives 0
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, -math.inf))
    out = _weighted_values(p / torch.where(l == 0, torch.ones_like(l), l), v,
                           grouped, q.dtype)
    return out, lse.reshape(b, hq, sq).transpose(1, 2)


# ---------------------------------------------------------------------------
# Paged decode-attention backend
# ---------------------------------------------------------------------------
#: the decode-attention backends a layer selects between (``layers.py:263``)
DECODE_BACKENDS = ("contiguous", "paged")


class PagedKV(NamedTuple):
    """One layer's paged decode cache: block-pool K/V plus the block table.

    k_buf, v_buf: [NB + 1, BS, Hkv, D] — the layer's block pool plus one
    scratch block at index NB that takes every dropped write (torch has no
    ``mode="drop"`` scatter). No table names the scratch block and no
    attention reads it; ``k`` / ``v`` are the ``[NB, BS, Hkv, D]`` pool.
    tables: [B, MB] int32 — row b's position p lives in block
    ``tables[b, p // BS]`` at offset ``p % BS``; -1 marks an unassigned
    column (padding rows read nothing and write nowhere).
    """
    k_buf: torch.Tensor
    v_buf: torch.Tensor
    tables: torch.Tensor

    @property
    def k(self) -> torch.Tensor:
        return self.k_buf[:-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_buf[:-1]


def plan_decode_backend(cfg, kv_cache) -> str:
    """The decode-attention backend of one layer call (``layers.py:279-296``):
    the cache the caller threads in, which must agree with
    ``cfg.decode_attention`` — a paged cache reaching a layer whose config
    says contiguous (or the reverse) is a wiring fault, not a fallback.
    Raises ``ValueError`` on that and on an unknown backend."""
    if cfg.decode_attention not in DECODE_BACKENDS:
        raise ValueError(
            f"unknown decode_attention {cfg.decode_attention!r}; "
            f"known: {DECODE_BACKENDS}")
    backend = "paged" if isinstance(kv_cache, PagedKV) else "contiguous"
    if kv_cache is not None and backend != cfg.decode_attention:
        raise ValueError(
            f"decode cache is {backend} but cfg.decode_attention is "
            f"{cfg.decode_attention!r}")
    return backend


def paged_kv_write(pkv: PagedKV, k, v, positions, valid=None,
                   pos_base=None) -> None:
    """Write k/v [B, C, Hkv, D] at logical ``positions`` [B, C] through the
    block table, in place. A position whose table column is unassigned (or
    past the table), or whose ``valid`` [B, C] entry is False, is written to
    the scratch block instead — a redirect, not a boolean mask, so the write
    never syncs with the host. Inside ``sharding.split_rows`` the rows of
    every 'data' rank are gathered and written (each holds the whole
    paged pool).
    ``pos_base = (BS_g, off)``: the pool holds in-block offsets
    ``[off, off + BS)`` of blocks of ``BS_g`` positions (a position-split
    pool), and a position at another rank's offset goes to the scratch
    block too."""
    nb, bs = pkv.k_buf.shape[0] - 1, pkv.k_buf.shape[1]
    bs_g, off0 = pos_base if pos_base is not None else (bs, 0)
    mb = pkv.tables.shape[1]
    p = positions.long()
    blk = pkv.tables.long().gather(1, (p // bs_g).clamp(0, mb - 1))
    keep = (blk >= 0) & (p // bs_g < mb)
    off = p % bs_g - off0
    if pos_base is not None:           # another rank's slice holds it
        keep &= (off >= 0) & (off < bs)
        off = off.clamp(0, bs - 1)
    if valid is not None:
        keep &= valid
    blk = torch.where(keep, blk, torch.full_like(blk, nb))
    if shd.rows_split():
        at = shd.gather_rows(blk * bs + off)
        kv = shd.gather_rows(torch.stack([k, v], dim=1))
        blk, off, k, v = at // bs, at % bs, kv[:, 0], kv[:, 1]
    pkv.k_buf[blk, off] = k.to(pkv.k_buf.dtype)
    pkv.v_buf[blk, off] = v.to(pkv.v_buf.dtype)


def paged_decode_attention(cfg, q, k, v, pkv: PagedKV, positions, window: int,
                           valid=None, heads: Optional[slice] = None):
    """The paged backend: write this call's (post-RoPE) k/v [B, C, Hkv, D]
    at ``positions`` [B, C] through the block table (in place), then attend
    q over the pages. C == 1 is decode (``ops.paged_attention``); C > 1 is a
    lane-batched prefill chunk at contiguous positions
    (``ops.paged_prefill_attention``; ``valid`` [B, C] drops padded lane
    positions from the write, their query rows are discarded by the
    caller). CUDA tensors launch the kernels, CPU tensors take their plain
    versions. ``heads`` (``kv_heads_read``) attends over those KV heads of
    the pool only (a strided view of it). Both routes read each KV head
    once for its group of q heads, so ``cfg.gqa_no_repeat`` (the
    reference's grouped ``mha`` on its plain paged path, ``layers.py:374``)
    changes nothing here. A pool whose in-block positions are split over a
    mesh axis (``sharding.cache_seq_axis``) is this rank's slice: the
    write keeps the positions it holds, the kernels run in their partial
    mode over its keys and ``merge_partials`` combines the ranks' outputs
    (kv-seq). Returns the attention output [B, C, Hq, D]."""
    c = q.shape[1]
    axis = shd.cache_seq_axis()
    pos_base = None
    if axis is not None:
        bs = pkv.k_buf.shape[1]
        pos_base = (bs * _axis_ranks(axis), shd.axis_index(axis) * bs)
    paged_kv_write(pkv, k, v, positions, valid, pos_base)
    kp, vp = pkv.k, pkv.v
    if heads is not None:
        kp, vp = kp[:, :, heads], vp[:, :, heads]
    if pos_base is not None:
        if c == 1:
            o, lse = kops.paged_attention_partial(
                q[:, 0], kp, vp, pkv.tables, positions[:, 0], window,
                pos_base)
            return shd.merge_partials(o, lse, axis)[:, None]
        o, lse = kops.paged_prefill_partial(
            q, kp, vp, pkv.tables, positions[:, 0].contiguous(), window,
            pos_base)
        return shd.merge_partials(o, lse, axis)
    if c == 1:
        return kops.paged_attention(q[:, 0], kp, vp, pkv.tables,
                                    positions[:, 0], window)[:, None]
    return kops.paged_prefill_attention(q, kp, vp, pkv.tables,
                                        positions[:, 0].contiguous(), window)


def decode_positions(b: int, pos, device) -> torch.Tensor:
    """[B, 1] position matrix for a decode step on ``device``. ``pos`` is
    an int (every row at the same position) or an int32 [B] tensor
    (per-slot positions, continuous batching)."""
    if not torch.is_tensor(pos) or pos.dim() == 0:
        return torch.full((b, 1), int(pos), dtype=torch.int32, device=device)
    return pos.to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Contiguous decode cache
# ---------------------------------------------------------------------------
def update_kv_cache(ck, cv, k, v, cache_pos, valid=None,
                    first: Optional[int] = None):
    """Write one decode step's k/v [B, 1, H, D] into one layer's cache
    [B, S, H, D] at ``cache_pos`` (an int for every row, or an int32 [B]
    tensor of per-row positions), in place. Returns (ck, cv, k_pos, cpos)
    with k_pos [Sk] / cpos scalar for a shared position, k_pos [1, Sk] /
    cpos [B, 1] for per-row positions — the mask is ``k_pos <= cpos``.

    ``valid`` ([B] bool, per-row positions only) drops rows from the write:
    a frozen row of a multi-step decode horizon must stop writing KV. Torch
    has no ``mode="drop"`` scatter, so the write is *masked*: a dropped row
    writes back the value its cache row already holds at ``pos`` (positions
    of frozen rows are always inside the cache), which keeps the write free
    of host syncs and leaves the row untouched.

    ``first``: the cache holds positions ``[first, first + S)`` of a cache
    whose positions are split over a mesh axis (None: all of them). A row
    writes only where its position falls inside (the others keep the
    masked write's old value), and ``k_pos`` are global positions.
    """
    k_pos = torch.arange(ck.shape[1], device=ck.device)
    if first is not None:
        k_pos = k_pos + first
    if not torch.is_tensor(cache_pos) or cache_pos.dim() == 0:
        p = int(cache_pos)
        lp = p - (first or 0)
        if 0 <= lp < ck.shape[1]:
            ck[:, lp:lp + 1] = k.to(ck.dtype)
            cv[:, lp:lp + 1] = v.to(cv.dtype)
        return ck, cv, k_pos, p
    rows = torch.arange(ck.shape[0], device=ck.device)
    cpos = pos = cache_pos.long()
    new_k, new_v = k[:, 0], v[:, 0]
    if first is not None:               # another rank's slice holds it
        pos = pos - first
        inside = (pos >= 0) & (pos < ck.shape[1])
        valid = inside if valid is None else valid & inside
        pos = pos.clamp(0, ck.shape[1] - 1)
    new_k, new_v = new_k.to(ck.dtype), new_v.to(cv.dtype)
    if valid is not None:
        keep = valid[:, None, None]
        new_k = torch.where(keep, new_k, ck[rows, pos])
        new_v = torch.where(keep, new_v, cv[rows, pos])
    ck[rows, pos] = new_k
    cv[rows, pos] = new_v
    return ck, cv, k_pos[None, :], cpos[:, None]


def attention(p, cfg, x, positions, *, causal: bool = True, window: int = 0,
              kv_cache=None, cache_pos=None, cross_kv=None, kv_valid=None,
              flash: bool = True):
    """Full attention layer (``repro/models/layers.py:418-486``).

    Modes:
      * no cache (training / one-pass prefill): attend over x itself;
        causal attention runs ``ops.flash_attention`` (the hand-written
        kernel on CUDA tensors, its plain version on the CPU); the
        post-RoPE ``(k, v)`` is returned to seed a cache.
      * contiguous decode: ``kv_cache=(ck, cv)`` one layer's [B, S, Hkv, D]
        cache; the current token's k/v is written at ``cache_pos`` (in
        place) and attention spans the cache under the per-row mask.
      * paged: ``kv_cache`` a ``PagedKV`` — the paged backend
        (``paged_decode_attention``).
      * cross attention (encdec): ``cross_kv=(k, v)`` [B, Sk, Hkv, D]
        precomputed from the encoder output; q attends all of it on plain
        ``mha``, no position applied, and nothing is cached.
    Self-attention that is not causal (the encoder's) runs on plain
    ``mha``, as in the reference (``layers.py:481``).
    The cache must be of ``cfg.decode_attention``'s kind
    (``plan_decode_backend`` raises otherwise); ``cfg.gqa_no_repeat``
    contracts every plain ``mha`` call grouped, without the KV repeat.
    ``kv_valid`` masks K/V writes: [B, C] chunk validity for paged prefill
    lanes, or a [B, 1] per-row freeze mask for decode. ``flash=False``
    keeps the no-cache branch on plain ``mha``, as the reference's dense
    forward does (``transformer.py:107``), except under q-seq, whose
    block of query rows a rank always runs flash with a query offset.
    Returns (out, new_kv_cache).

    On the mesh the layer takes the reference's scheme (module
    docstring): head-sharded, kv-seq over a cache whose positions are
    split (``sharding.cache_seq_axis``), q-seq for a causal pass without a
    cache whose length 'model' divides (flash with a query offset, on
    either flag, and its backward under grad), else every head whole. The
    returned (k, v) hold this rank's KV heads head-sharded where they
    divide 'model', else every KV head, at every position of x. Cross
    attention runs head-sharded over cross K/V of the same layout, or
    gathers q into every head over whole cross K/V.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    no_repeat = cfg.gqa_no_repeat
    backend = plan_decode_backend(cfg, kv_cache)
    if cross_kv is not None:         # q only: k and v come precomputed
        if p["wq"].shape[1] != cfg.n_heads_eff * hd:
            x = shd.fan_out(x, "model")
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        if not heads_sharded(cfg):   # whole heads over whole cross K/V
            (q,) = _whole((q,), (cfg.n_heads_eff * hd,))
        q = q.reshape(b, s, -1, hd)
        ck, cv = cross_kv
        heads = kv_heads_read(cfg, q.shape[2], ck.shape[2])
        if heads is not None:
            ck, cv = ck[:, :, heads], cv[:, :, heads]
        out = mha(q, ck, cv, None, no_repeat)
        return _heads_sum(p, cfg, out.reshape(b, s, -1)), None
    seq_axis = shd.cache_seq_axis() if kv_cache is not None else None
    split = p["wq"].shape[1] != cfg.n_heads_eff * hd    # a column block
    # a cache split over 'model' by position holds every KV head: whole
    # heads; split over 'data' (long_500k) it keeps the head split
    q, k, v = _qkv(p, cfg, x, seq_axis != "model" and heads_sharded(cfg))
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    heads = kv_heads_read(cfg, q.shape[2], k.shape[2])
    if backend == "paged":
        out = paged_decode_attention(cfg, q, k, v, kv_cache, positions,
                                     window, valid=kv_valid, heads=heads)
        return (_heads_sum(p, cfg, out.reshape(b, s, -1)),
                (kv_cache.k, kv_cache.v))
    if kv_cache is not None:
        ck, cv = kv_cache
        first = (None if seq_axis is None
                 else shd.axis_index(seq_axis) * ck.shape[1])
        ck, cv, k_pos, cpos = update_kv_cache(
            ck, cv, k, v, cache_pos,
            valid=kv_valid[:, 0] if kv_valid is not None else None,
            first=first)
        valid = k_pos <= cpos
        if window:
            valid &= k_pos > cpos - window
        # [1, Sk] shared-position mask, or [B, 1, 1, Sk] per-row mask
        mask = valid[None, :] if valid.dim() == 1 else valid[:, None, None, :]
        if heads is not None:
            ck, cv = ck[:, :, heads], cv[:, :, heads]
        if seq_axis is not None:
            out = shd.merge_partials(*mha_partial(q, ck, cv, mask, no_repeat),
                                     seq_axis)
        else:
            out = mha(q, ck, cv, mask, no_repeat)
        return _heads_sum(p, cfg, out.reshape(b, s, -1)), (ck, cv)
    ka, va = (k, v) if heads is None else (k[:, :, heads].contiguous(),
                                           v[:, :, heads].contiguous())
    if (causal and split and q.shape[2] == cfg.n_heads_eff
            and _q_seq(cfg, b, s)):
        out = _q_seq_attention(q, ka, va, window)
    elif causal and flash:
        out = kops.flash_attention(q, ka, va, causal=True, window=window)
    else:
        pos = torch.arange(s, device=x.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[:, None] - pos[None, :] < window
        out = mha(q, ka, va, mask, no_repeat)
    return _heads_sum(p, cfg, out.reshape(b, s, -1)), (k, v)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(d: int, d_ff: int, dtype, generator) -> dict:
    return {
        "w_gate": _init_dense((d, d_ff), dtype, generator),
        "w_up": _init_dense((d, d_ff), dtype, generator),
        "w_down": _init_dense((d_ff, d), dtype, generator),
    }


def mlp(p, x, d_ff: int = 0):
    """SwiGLU; with ``d_ff`` (the full hidden width) a ``w_gate`` / ``w_up``
    column block takes x through ``fan_out`` and the ``w_down`` row block
    (``ffn`` over 'model') has its partial sum reduced over 'model'."""
    if d_ff and p["w_gate"].shape[1] != d_ff:
        x = shd.fan_out(x, "model")
    y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if d_ff and p["w_down"].shape[0] != d_ff:
        y = shd.reduce_over(y, "model", grad="replicated")
    return y


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------
def init_embeddings(cfg, dtype, generator) -> dict:
    # tied embeddings: 1/sqrt(d) init plus sqrt(d) input scaling, so tied
    # logits come out unit-scale (the reference's gemma-style choice)
    emb_scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    p = {"tok_emb": _init_dense((cfg.vocab_size, cfg.d_model), dtype,
                                generator, scale=emb_scale)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _init_dense((cfg.d_model, cfg.vocab_size), dtype,
                                   generator)
    return p


def embed(p, cfg, tokens):
    """Token embeddings; a vocab block of ``tok_emb`` (vocab over 'model')
    looks up the ids it holds, zeros the rest and reduces over 'model'."""
    emb = p["tok_emb"]
    n = emb.shape[0]
    if n == cfg.vocab_size:
        x = F.embedding(tokens, emb)
    else:
        local = tokens - shd.axis_index("model") * n
        held = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), emb) * held[..., None]
        x = shd.reduce_over(x, "model", grad="replicated")
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _vocab_block(p, cfg, x):
    """x [.., D] times this rank's block of the unembedding -> the logits
    of its vocab block [.., V / m] (all of them off the mesh); a block
    takes x through ``fan_out``."""
    w = p["tok_emb"].T if cfg.tie_embeddings else p["lm_head"]
    if w.shape[1] != cfg.vocab_size:
        x = shd.fan_out(x, "model")
    return x @ w


def unembed(p, cfg, x):
    """Logits over the whole vocabulary: a vocab block's logits are
    gathered over 'model' (what follows, the serving steps' selection or
    a loss, computes the same on every rank)."""
    logits = _vocab_block(p, cfg, x)
    if logits.shape[-1] != cfg.vocab_size:
        logits = shd.gather_over(logits, logits.dim() - 1, "model",
                                 grad="replicated")
    return logits


def _mean_nll(nll, mask=None):
    """The mean of ``nll`` [B, S], or its mean weighted by ``mask``."""
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def cross_entropy(logits, labels, mask=None):
    """Mean next-token cross entropy in f32. labels: int [B, S]; mask
    (optional) weights each position."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return _mean_nll(logz - gold, mask)


def unembed_cross_entropy(p, cfg, x, labels, mask=None):
    """``cross_entropy(unembed(p, cfg, x), labels, mask)`` of the final
    hidden states x [B, S, D], with the logits kept split over the
    vocabulary where the unembedding holds a vocab block, as the
    reference keeps them through its loss (``shard(logits, "batch", None,
    "vocab")``, ``layers.py:534, 537-546``): each rank's [B, S, V / m]
    block in f32, the row maximum and the sum of exponentials over its
    block combined over 'model' (``max_over``, ``reduce_over``), and the
    gold logit from the rank that holds the label. The whole vocabulary
    takes ``cross_entropy`` of ``unembed``."""
    logits = _vocab_block(p, cfg, x)
    n = logits.shape[-1]
    if n == cfg.vocab_size:
        return cross_entropy(logits, labels, mask)
    logits = logits.float()
    m = shd.max_over(logits.amax(dim=-1), "model")            # no gradient
    z = shd.reduce_over(torch.exp(logits - m[..., None]).sum(dim=-1),
                        "model", grad="replicated")
    local = labels.long() - shd.axis_index("model") * n
    held = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = shd.reduce_over(torch.where(held, gold, torch.zeros_like(gold)),
                           "model", grad="replicated")
    return _mean_nll(torch.log(z) + m - gold, mask)
