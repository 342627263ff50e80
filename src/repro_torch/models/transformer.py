"""Dense decoder-only transformer (qwen2 / llama3 / gemma3), ported from
``repro/models/transformer.py``.

Parameters are a dict with a list of per-layer dicts (the reference stacks
them along a leading axis for ``lax.scan``; here the scan is a Python loop).
Gemma3's local:global pattern is a per-layer window list (0 = global).
The contiguous cache is a ``{"k", "v"}`` dict of ``[L, B, S, Hkv, D]``
tensors and the paged cache a ``PagedCache``; the decode and prefill steps
update either in place.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_layer(cfg, dtype, generator) -> dict:
    dev = generator.device
    return {
        "attn": L.init_attention(cfg, dtype, generator),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator),
        "norm1": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights drawn from the reference's distributions (same shapes
    and scales, different bits) on ``generator``'s device — a generator on
    ``device`` seeded with 0 when none is given."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "emb": L.init_embeddings(cfg, dtype, generator),
        "layers": [init_layer(cfg, dtype, generator)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, generator.device),
    }


def layer_windows(cfg) -> List[int]:
    """Per-layer sliding window (0 = full/global attention)."""
    if cfg.sliding_window and cfg.global_every:
        return [0 if (i + 1) % cfg.global_every == 0 else cfg.sliding_window
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------
def _layer(cfg, p, x, positions, window: int, kv_cache=None, cache_pos=None,
           kv_valid=None):
    """One decoder layer -> (x, new_kv_cache). Attention takes the layer's
    window (``transformer.py:69-109``): the paged backend for a
    ``PagedKV``, contiguous decode for a ``(ck, cv)`` cache, else causal
    self-attention over x through plain ``mha`` — the dense forward never
    reaches the flash kernel (``transformer.py:107``)."""
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    attn_out, new_cache = L.attention(p["attn"], cfg, h, positions,
                                      window=window, kv_cache=kv_cache,
                                      cache_pos=cache_pos, kv_valid=kv_valid,
                                      flash=False)
    x = x + attn_out
    h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h), new_cache


# ---------------------------------------------------------------------------
# forward (one pass over a full sequence: training, one-pass prefill, and the
# reference for chunked paths)
# ---------------------------------------------------------------------------
def forward(cfg, params, tokens, return_cache: bool = False):
    """tokens: [B, S] int -> logits [B, S, V] (and, with ``return_cache``,
    the per-layer post-RoPE (k, v) stacked ``[L, B, S, Hkv, D]``)."""
    x = L.embed(params["emb"], cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    caches = []
    for p, w in zip(params["layers"], layer_windows(cfg)):
        x, kv = _layer(cfg, p, x, positions, w)
        if return_cache:
            caches.append(kv)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["emb"], cfg, x)
    if return_cache:
        return logits, stack_caches(caches)
    return logits


def stack_caches(caches):
    """Per-layer [(k, v)] -> (k, v) stacked ``[L, B, S, Hkv, D]``."""
    return (torch.stack([k for k, _ in caches]),
            torch.stack([v for _, v in caches]))


# ---------------------------------------------------------------------------
# contiguous cache
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """One ``[L, batch, max_len, Hkv, D]`` K and V row per slot (a dict
    ``{"k", "v"}``, the reference's pytree). ``device="meta"`` gives the
    shapes without allocating (``serve/cache.py``'s batch-axis probes)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg, params, cache: dict, tokens, pos,
                write_valid: Optional[torch.Tensor] = None):
    """One contiguous decode step (cache updated in place). tokens: [B, 1];
    pos: an int (every row at the same position) or int32 [B] (per-row
    positions, continuous batching); write_valid: [B] bool or None — False
    rows compute but write no KV (frozen rows of a decode horizon; needs
    per-row pos). Returns (logits [B, 1, V], cache)."""
    x = L.embed(params["emb"], cfg, tokens)
    positions = L.decode_positions(x.shape[0], pos, x.device)
    kv_valid = None if write_valid is None else write_valid[:, None]
    for i, (p, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        x, _ = _layer(cfg, p, x, positions, w,
                      kv_cache=(cache["k"][i], cache["v"][i]),
                      cache_pos=pos, kv_valid=kv_valid)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------
class PagedCache:
    """Block-pool decode cache for every layer.

    ``k_buf`` / ``v_buf`` are ``[L, NB + 1, BS, Hkv, D]``: block NB of each
    layer is the scratch block that takes dropped writes (see
    ``layers.PagedKV``). ``cache["k"]`` / ``cache["v"]`` are the
    ``[L, NB, BS, Hkv, D]`` pools, the shape of the reference's cache.
    """

    def __init__(self, k_buf: torch.Tensor, v_buf: torch.Tensor):
        self.k_buf, self.v_buf = k_buf, v_buf

    def __getitem__(self, name: str) -> torch.Tensor:
        return {"k": self.k_buf, "v": self.v_buf}[name][:, :-1]

    def layer(self, i: int, tables) -> L.PagedKV:
        return L.PagedKV(self.k_buf[i], self.v_buf[i], tables)


def init_paged_cache(cfg, n_blocks: int, block_size: int, dtype=None,
                     device="cuda") -> PagedCache:
    """``n_blocks`` blocks of ``block_size`` KV positions shared by all
    requests (``serve/paged.py``'s BlockManager carves them up)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return PagedCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


def paged_prefill_state(cfg, batch: int = 1):
    """Cross-chunk prefill carry (none for dense attention)."""
    return None


def prefill_chunk_layout(start, n_valid, b: int, c: int):
    """Per-token (positions [B, C] int32, valid [B, C] | None, last-index
    [B]) for a lane-batched prefill chunk. ``start`` is an int32 [B] tensor
    of per-lane first positions; ``n_valid`` (int32 [B] or None) counts
    each lane's real tokens — the tail of a short final chunk is padding
    whose K/V writes are dropped and whose logits are discarded."""
    ar = torch.arange(c, dtype=torch.int32, device=start.device)
    positions = start.to(torch.int32)[:, None] + ar[None, :]
    if n_valid is None:
        return positions, None, torch.full((b,), c - 1, dtype=torch.long,
                                           device=start.device)
    valid = ar[None, :] < n_valid[:, None]
    return positions, valid, (n_valid.long() - 1).clamp(0, c - 1)


def paged_prefill_chunk(cfg, params, cache: PagedCache, tokens, start, tables,
                        state=None, n_valid=None):
    """Prefill one prompt chunk per lane into the paged cache (in place).

    tokens: [P, C]; start: int32 [P] — each lane's first position;
    n_valid: int32 [P] or None — real tokens per lane; tables: int32
    [P, MB] — the blocks covering [0, start + n_valid) must be assigned.
    Returns (per-lane last-valid-position logits [P, 1, V], cache, state).
    Only the last valid position of each lane is unembedded.
    """
    x = L.embed(params["emb"], cfg, tokens)
    b, c, _ = x.shape
    positions, valid, last = prefill_chunk_layout(start, n_valid, b, c)
    for i, (p, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        x, _ = _layer(cfg, p, x, positions, w,
                      kv_cache=cache.layer(i, tables), kv_valid=valid)
    x = x[torch.arange(b, device=x.device), last][:, None]
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache, None


def paged_decode_step(cfg, params, cache: PagedCache, tokens, pos, tables,
                      write_valid: Optional[torch.Tensor] = None):
    """One paged decode step (cache updated in place). tokens: [B, 1]; pos:
    int32 [B] per-row positions; tables: int32 [B, MB] (padding rows are
    all -1 and decode inert garbage); write_valid: [B] bool or None — False
    rows compute but write no KV (frozen rows of a decode horizon).
    Returns (logits [B, 1, V], cache)."""
    x = L.embed(params["emb"], cfg, tokens)
    positions = L.decode_positions(x.shape[0], pos, x.device)
    kv_valid = None if write_valid is None else write_valid[:, None]
    for i, (p, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        x, _ = _layer(cfg, p, x, positions, w,
                      kv_cache=cache.layer(i, tables), kv_valid=kv_valid)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache
