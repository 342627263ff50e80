"""Core layers, ported from ``repro/models/layers.py``: RMSNorm, RoPE and
sinusoidal positions, GQA attention with QKV bias (no cache, contiguous
cache, paged cache, cross attention), SwiGLU MLP, tied embeddings, the
cross-entropy loss.

Layers are plain functions over dicts of tensors, as in the reference; the
sharding constraints of the reference are dropped (one device). KV writes,
paged or contiguous, go into the cache in place instead of returning a new
cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

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
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    dev = generator.device
    p = {
        "wq": _init_dense((d, nh * hd), dtype, generator),
        "wk": _init_dense((d, nkv * hd), dtype, generator),
        "wv": _init_dense((d, nkv * hd), dtype, generator),
        "wo": _init_dense((nh * hd, d), dtype, generator),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nh * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
    return p


def _qkv(p, cfg, x):
    b, s, _ = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd))


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
    never syncs with the host."""
    nb, bs = pkv.k_buf.shape[0] - 1, pkv.k_buf.shape[1]
    mb = pkv.tables.shape[1]
    p = positions.long()
    blk = pkv.tables.long().gather(1, (p // bs).clamp(0, mb - 1))
    keep = (blk >= 0) & (p // bs < mb)
    if valid is not None:
        keep &= valid
    blk = torch.where(keep, blk, torch.full_like(blk, nb))
    off = p % bs
    pkv.k_buf[blk, off] = k.to(pkv.k_buf.dtype)
    pkv.v_buf[blk, off] = v.to(pkv.v_buf.dtype)


def paged_decode_attention(cfg, q, k, v, pkv: PagedKV, positions, window: int,
                           valid=None):
    """The paged backend: write this call's (post-RoPE) k/v [B, C, Hkv, D]
    at ``positions`` [B, C] through the block table (in place), then attend
    q over the pages. C == 1 is decode (``ops.paged_attention``); C > 1 is a
    lane-batched prefill chunk at contiguous positions
    (``ops.paged_prefill_attention``; ``valid`` [B, C] drops padded lane
    positions from the write, their query rows are discarded by the
    caller). CUDA tensors launch the kernels, CPU tensors take their plain
    versions. Returns the attention output [B, C, Hq, D]."""
    c = q.shape[1]
    paged_kv_write(pkv, k, v, positions, valid)
    if c == 1:
        return kops.paged_attention(q[:, 0], pkv.k, pkv.v, pkv.tables,
                                    positions[:, 0], window)[:, None]
    return kops.paged_prefill_attention(q, pkv.k, pkv.v, pkv.tables,
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
    """
    k_pos = torch.arange(ck.shape[1], device=ck.device)
    if not torch.is_tensor(cache_pos) or cache_pos.dim() == 0:
        p = int(cache_pos)
        ck[:, p:p + 1] = k.to(ck.dtype)
        cv[:, p:p + 1] = v.to(cv.dtype)
        return ck, cv, k_pos, p
    rows = torch.arange(ck.shape[0], device=ck.device)
    pos = cache_pos.long()
    new_k, new_v = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if valid is not None:
        keep = valid[:, None, None]
        new_k = torch.where(keep, new_k, ck[rows, pos])
        new_v = torch.where(keep, new_v, cv[rows, pos])
    ck[rows, pos] = new_k
    cv[rows, pos] = new_v
    return ck, cv, k_pos[None, :], pos[:, None]


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
    if cross_kv is not None:         # q only: k and v come precomputed
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        out = mha(q.reshape(b, s, cfg.n_heads, -1), *cross_kv, None)
        return out.reshape(b, s, -1) @ p["wo"], None
    q, k, v = _qkv(p, cfg, x)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if isinstance(kv_cache, PagedKV):
        out = paged_decode_attention(cfg, q, k, v, kv_cache, positions,
                                     window, valid=kv_valid)
        return out.reshape(b, s, -1) @ p["wo"], (kv_cache.k, kv_cache.v)
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
        out = mha(q, ck, cv, mask)
        return out.reshape(b, s, -1) @ p["wo"], (ck, cv)
    if causal and flash:
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        pos = torch.arange(s, device=x.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[:, None] - pos[None, :] < window
        out = mha(q, k, v, mask)
    return out.reshape(b, s, -1) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(d: int, d_ff: int, dtype, generator) -> dict:
    return {
        "w_gate": _init_dense((d, d_ff), dtype, generator),
        "w_up": _init_dense((d, d_ff), dtype, generator),
        "w_down": _init_dense((d_ff, d), dtype, generator),
    }


def mlp(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


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
    x = F.embedding(tokens, p["tok_emb"])
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(p, cfg, x):
    if cfg.tie_embeddings:
        return x @ p["tok_emb"].T
    return x @ p["lm_head"]


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
