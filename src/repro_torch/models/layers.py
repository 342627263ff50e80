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
Attention runs on this rank's q heads (and KV heads when they divide
'model'; when they do not, the rank computes every KV head, caches them
all, and attends over the ones its q heads read); ``wo`` and ``w_down``
are row-parallel and their partial sums are reduced over 'model'; the
embedding is vocab-parallel (a masked lookup, then a reduce) and the
logits are gathered over 'model'. Inside ``sharding.split_rows`` a decode
step computes this rank's rows of the bucket, and every K/V write first
gathers the bucket's rows over 'data', since each 'data' rank holds the
whole pool.
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
        return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                context_fn=context)
    return wrapped


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, weight, eps: float):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
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


def _qkv(p, cfg, x):
    """x [B, S, D] -> q [B, S, Hq, D], k / v [B, S, Hkv, D] on this rank's
    heads (all of them off the mesh): the local head counts are the local
    projections' widths over the head dim."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


def plan_attention_scheme(cfg, b: int, s: int, kv_len: int):
    """The layer's attention scheme (``layers.py:126-140``): the reference's
    ``attention_scheme`` at the effective (padded) q head count and the
    attended length; None off the mesh."""
    return shd.attention_scheme(b, s, cfg.n_heads_eff, kv_len)


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


def _heads_sum(p, cfg, out):
    """``out @ wo`` of the local heads, summed over 'model' when ``wo``
    holds a row block (the reference's residual ``shard`` site)."""
    y = out @ p["wo"]
    if p["wo"].shape[0] != cfg.n_heads_eff * cfg.resolved_head_dim:
        y = shd.reduce_over(y, "model")
    return y


def mha(q, k, v, mask):
    """Grouped-query attention core. q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D],
    mask (True = attend) broadcastable to [B, Hq, Sq, Sk]. KV heads repeat
    to the q-head count (head h reads kv head h // G)."""
    d = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# Paged decode-attention backend
# ---------------------------------------------------------------------------
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


def paged_kv_write(pkv: PagedKV, k, v, positions, valid=None) -> None:
    """Write k/v [B, C, Hkv, D] at logical ``positions`` [B, C] through the
    block table, in place. A position whose table column is unassigned (or
    past the table), or whose ``valid`` [B, C] entry is False, is written to
    the scratch block instead — a redirect, not a boolean mask, so the write
    never syncs with the host. Inside ``sharding.split_rows`` the rows of
    every 'data' rank are gathered and written (each holds the pool)."""
    nb, bs = pkv.k_buf.shape[0] - 1, pkv.k_buf.shape[1]
    mb = pkv.tables.shape[1]
    p = positions.long()
    blk = pkv.tables.long().gather(1, (p // bs).clamp(0, mb - 1))
    keep = (blk >= 0) & (p // bs < mb)
    if valid is not None:
        keep &= valid
    blk = torch.where(keep, blk, torch.full_like(blk, nb))
    off = p % bs
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
    the pool only. Returns the attention output [B, C, Hq, D]."""
    c = q.shape[1]
    paged_kv_write(pkv, k, v, positions, valid)
    kp, vp = pkv.k, pkv.v
    if heads is not None:
        kp, vp = kp[:, :, heads], vp[:, :, heads]
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
def update_kv_cache(ck, cv, k, v, cache_pos, valid=None):
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

    Inside ``sharding.split_rows`` k, v, ``cache_pos`` and ``valid`` are
    this rank's rows of a bucket whose every row ``ck`` / ``cv`` hold: the
    rows of every 'data' rank are gathered and written, and the returned
    caches and positions are this rank's rows.
    """
    k_pos = torch.arange(ck.shape[1], device=ck.device)
    if not torch.is_tensor(cache_pos) or cache_pos.dim() == 0:
        p = int(cache_pos)
        ck[:, p:p + 1] = k.to(ck.dtype)
        cv[:, p:p + 1] = v.to(cv.dtype)
        return ck, cv, k_pos, p
    rows = torch.arange(ck.shape[0], device=ck.device)
    mine = pos = cache_pos.long()
    new_k, new_v = k[:, 0], v[:, 0]
    if shd.rows_split():
        if valid is not None:        # a dropped row travels as pos -1
            pos = shd.gather_rows(torch.where(valid, mine, -1))
            valid = pos >= 0
            pos = pos.clamp(min=0)
        else:
            pos = shd.gather_rows(mine)
        new = shd.gather_rows(torch.stack([new_k, new_v], dim=1))
        new_k, new_v = new[:, 0], new[:, 1]
    new_k, new_v = new_k.to(ck.dtype), new_v.to(cv.dtype)
    if valid is not None:
        keep = valid[:, None, None]
        new_k = torch.where(keep, new_k, ck[rows, pos])
        new_v = torch.where(keep, new_v, cv[rows, pos])
    ck[rows, pos] = new_k
    cv[rows, pos] = new_v
    return (shd.local_rows(ck), shd.local_rows(cv), k_pos[None, :],
            mine[:, None])


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
    ``kv_valid`` masks K/V writes: [B, C] chunk validity for paged prefill
    lanes, or a [B, 1] per-row freeze mask for decode. ``flash=False``
    keeps the no-cache branch on plain ``mha``, as the reference's dense
    forward does (``transformer.py:107``). Returns (out, new_kv_cache).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if cross_kv is not None:         # q only: k and v come precomputed
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        out = mha(q.reshape(b, s, -1, hd), *cross_kv, None)
        return _heads_sum(p, cfg, out.reshape(b, s, -1)), None
    q, k, v = _qkv(p, cfg, x)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    heads = kv_heads_read(cfg, q.shape[2], k.shape[2])
    if isinstance(kv_cache, PagedKV):
        out = paged_decode_attention(cfg, q, k, v, kv_cache, positions,
                                     window, valid=kv_valid, heads=heads)
        return (_heads_sum(p, cfg, out.reshape(b, s, -1)),
                (kv_cache.k, kv_cache.v))
    if kv_cache is not None:
        ck, cv = kv_cache
        ck, cv, k_pos, cpos = update_kv_cache(
            ck, cv, k, v, cache_pos,
            valid=kv_valid[:, 0] if kv_valid is not None else None)
        valid = k_pos <= cpos
        if window:
            valid &= k_pos > cpos - window
        # [1, Sk] shared-position mask, or [B, 1, 1, Sk] per-row mask
        mask = valid[None, :] if valid.dim() == 1 else valid[:, None, None, :]
        if heads is not None:
            ck, cv = ck[:, :, heads], cv[:, :, heads]
        out = mha(q, ck, cv, mask)
        return _heads_sum(p, cfg, out.reshape(b, s, -1)), (ck, cv)
    ka, va = (k, v) if heads is None else (k[:, :, heads].contiguous(),
                                           v[:, :, heads].contiguous())
    if causal and flash:
        out = kops.flash_attention(q, ka, va, causal=True, window=window)
    else:
        pos = torch.arange(s, device=x.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[:, None] - pos[None, :] < window
        out = mha(q, ka, va, mask)
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
    """SwiGLU; with ``d_ff`` (the full hidden width) a ``w_down`` row block
    (``ffn`` over 'model') has its partial sum reduced over 'model'."""
    y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if d_ff and p["w_down"].shape[0] != d_ff:
        y = shd.reduce_over(y, "model")
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
        x = shd.reduce_over(x, "model")
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(p, cfg, x):
    """Logits over the whole vocabulary: a vocab block's logits are
    gathered over 'model'."""
    logits = (x @ p["tok_emb"].T if cfg.tie_embeddings
              else x @ p["lm_head"])
    if logits.shape[-1] != cfg.vocab_size:
        logits = shd.gather_over(logits, logits.dim() - 1, "model")
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean next-token cross entropy in f32. labels: int [B, S]; mask
    (optional) weights each position."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
