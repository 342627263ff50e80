"""Core layers of the dense family, ported from ``repro/models/layers.py``:
RMSNorm, RoPE, GQA attention with QKV bias, SwiGLU MLP, tied embeddings,
and the paged decode-attention backend.

Layers are plain functions over dicts of tensors, as in the reference; the
sharding constraints of the reference are dropped (one device). Paged KV
writes go into the pool in place instead of returning a new pool.
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


def decode_positions(pos) -> torch.Tensor:
    """[B, 1] position matrix for a decode step from per-slot positions
    ``pos`` [B] (the reference also takes one scalar for every row; the
    port's only caller, the paged engine, always has per-slot positions)."""
    return pos.to(torch.int32)[:, None]


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
