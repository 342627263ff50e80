"""Dense decoder-only transformer (qwen2 / llama3 / gemma3 / phi-3-vision),
ported from ``repro/models/transformer.py``.

Parameters are a dict with a list of per-layer dicts (the reference stacks
them along a leading axis for ``lax.scan``; here the scan is a Python loop).
Gemma3's local:global pattern is a per-layer window list (0 = global);
``cfg.local_banded`` runs its local layers on banded scores instead.
The VLM family (phi-3-vision) is this model with a stub vision frontend:
``forward`` takes precomputed patch embeddings that replace the first
``n_patches`` positions; serving is text-only, as in the reference.
The contiguous cache is a ``{"k", "v"}`` dict of ``[L, B, S, Hkv, D]``
tensors and the paged cache a ``PagedCache``; the decode and prefill steps
update either in place.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.dist import sharding as shd
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
    self-attention over x. The dense forward attends through plain ``mha``,
    as the reference's does (``transformer.py:107``); the VLM forward,
    whose patch prefix makes every call a long causal pass, through the
    flash kernel (the same function)."""
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    attn_out, new_cache = L.attention(p["attn"], cfg, h, positions,
                                      window=window, kv_cache=kv_cache,
                                      cache_pos=cache_pos, kv_valid=kv_valid,
                                      flash=cfg.family == "vlm")
    x = x + attn_out
    h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg.d_ff), new_cache


# ---------------------------------------------------------------------------
# banded local attention (cfg.local_banded; transformer.py:113-226)
#
# A sliding-window layer never needs the full S x S scores: its queries are
# blocked into W-sized chunks, each attending to its own chunk and the one
# before, O(S * 2W) scores instead of O(S^2). The window must be static, so
# the layers run in groups of (every - 1) banded local layers and one
# global layer, then the trailing local layers, in the scanned order.
# ---------------------------------------------------------------------------
def _band_spec(b: int, h: int):
    """The reference's constraint on the blocked q and K/V
    (``transformer.py:146-154``): batch over 'batch', heads over
    'heads_flat' where they divide; None off the mesh (``shard_spec`` is
    a no-op in the port either way: local tensors hold their layout)."""
    rules = shd.current_rules()
    if rules is None:
        return None
    m_ax = rules.mesh_axes("heads_flat")
    if h % max(rules.axis_size(m_ax), 1):
        m_ax = None
    b_ax = rules.mesh_axes("batch")
    if b % max(rules.axis_size(b_ax), 1):
        b_ax = None
    return shd.Spec(b_ax, None, None, m_ax, None)


def _banded_attention(cfg, p, x, positions, window: int):
    """Causal attention within ``window`` over x [B, S, D], S a multiple of
    the window: query block n attends to blocks n - 1 and n of a K/V padded
    with one zero block in front ([B, nb, 2W, H, D]), under the band mask
    ``(a < c) & (c <= a + W)`` with block 0's padding excluded. KV heads
    repeat to the q heads, as in the reference."""
    b, s, _ = x.shape
    w = window
    nb = s // w
    q, k, v = L._qkv(p, cfg, x, L.heads_sharded(cfg))
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    heads = L.kv_heads_read(cfg, q.shape[2], k.shape[2])
    if heads is not None:
        k, v = k[:, :, heads], v[:, :, heads]
    h, hd = q.shape[2], q.shape[3]
    if h != k.shape[2]:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    qb = q.reshape(b, nb, w, h, hd)
    pad = k.new_zeros((b, w, h, hd))
    kp = torch.cat([pad, k], dim=1).reshape(b, nb + 1, w, h, hd)
    vp = torch.cat([pad, v], dim=1).reshape(b, nb + 1, w, h, hd)
    k2 = torch.cat([kp[:, :-1], kp[:, 1:]], dim=2)          # [b,nb,2w,h,hd]
    v2 = torch.cat([vp[:, :-1], vp[:, 1:]], dim=2)
    spec = _band_spec(b, h)
    if spec is not None:
        qb, k2, v2 = (shd.shard_spec(t, spec) for t in (qb, k2, v2))
    logits = (torch.einsum("bnqhd,bnkhd->bnhqk", qb, k2).float()
              * (1.0 / hd ** 0.5))
    a = torch.arange(w, device=x.device)[:, None]
    c = torch.arange(2 * w, device=x.device)[None, :]
    band = (a < c) & (c <= a + w)                           # causal + window
    blk = torch.arange(nb, device=x.device)[:, None, None]
    mask = band[None] & ((blk > 0) | (c[None] >= w))        # exclude padding
    logits = logits.masked_fill(~mask[:, None], L.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v2)
    return L._heads_sum(p, cfg, out.reshape(b, s, h * hd))


def _local_layer_banded(cfg, p, x, positions, window: int):
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + _banded_attention(cfg, p["attn"], h, positions, window)
    h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg.d_ff)


def _grouped_layout(cfg):
    """(n_groups, group_size, n_trailing) of the local / global split."""
    every = cfg.global_every
    groups = cfg.n_layers // every
    return groups, every, cfg.n_layers - groups * every


def forward_banded(cfg, params, tokens, patch_embeds=None,
                   unembed: bool = True):
    """The grouped forward (``transformer.py:193-226``): per group, every -
    1 banded local layers and one global layer, then the trailing local
    layers; the scanned path's layer order and function, with only the
    local layers' scores banded. ``cfg.remat`` wraps each group, as the
    reference checkpoints its group body; the trailing layers are not
    recomputed. ``unembed=False``: the final hidden states instead of the
    logits (``forward``)."""
    x = L.embed(params["emb"], cfg, tokens)
    if patch_embeds is not None:
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    groups, every, _ = _grouped_layout(cfg)
    w = cfg.sliding_window
    layers = params["layers"]

    def group_body(x, *group):
        for p in group[:-1]:
            x = _local_layer_banded(cfg, p, x, positions, w)
        return _layer(cfg, group[-1], x, positions, 0)[0]

    group_body = L.remat(cfg, group_body)
    for i in range(groups):
        x = group_body(x, *layers[i * every:(i + 1) * every])
    for p in layers[groups * every:]:
        x = _local_layer_banded(cfg, p, x, positions, w)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x) if unembed else x


# ---------------------------------------------------------------------------
# forward (one pass over a full sequence: training, one-pass prefill, and the
# reference for chunked paths)
# ---------------------------------------------------------------------------
def forward(cfg, params, tokens, patch_embeds=None,
            return_cache: bool = False, unembed: bool = True):
    """tokens: [B, S] int -> logits [B, S, V] (and, with ``return_cache``,
    the per-layer post-RoPE (k, v) stacked ``[L, B, S, Hkv, D]``).
    ``patch_embeds`` [B, P, D] (VLM) replace the embeddings of the first P
    positions (``transformer.py:231-246``). With ``cfg.local_banded``, a
    sliding window, ``global_every`` and S a multiple of the window, the
    grouped banded forward runs (``forward_banded``; it has no prefill
    cache: ``return_cache`` raises ``NotImplementedError``); otherwise
    every layer runs in order here. ``unembed=False`` returns the final
    (normed) hidden states [B, S, D] in place of the logits (the loss's
    input, ``loss_fn``)."""
    if (cfg.local_banded and cfg.sliding_window and cfg.global_every
            and tokens.shape[1] % cfg.sliding_window == 0):
        if return_cache:
            raise NotImplementedError("banded path has no prefill cache yet")
        return forward_banded(cfg, params, tokens, patch_embeds, unembed)
    x = L.embed(params["emb"], cfg, tokens)
    if patch_embeds is not None:
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    caches = []
    # transformer.py:255-259: the layer body under cfg.remat
    body = L.remat(cfg, lambda x, p, w: _layer(cfg, p, x, positions, w))
    for p, w in zip(params["layers"], layer_windows(cfg)):
        x, kv = body(x, p, w)
        if return_cache:
            caches.append(kv)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    out = L.unembed(params["emb"], cfg, x) if unembed else x
    if return_cache:
        return out, stack_caches(caches)
    return out


def loss_fn(cfg, params, batch):
    """Mean next-token cross entropy over ``batch`` (tokens, labels,
    optional loss_mask and patch_embeds); a VLM batch without a loss_mask
    scores only the text positions, ``>= n_patches``
    (``transformer.py:269-278``). The logits stay split over the
    vocabulary where the unembedding holds a vocab block
    (``layers.unembed_cross_entropy``)."""
    x = forward(cfg, params, batch["tokens"],
                patch_embeds=batch.get("patch_embeds"), unembed=False)
    mask = batch.get("loss_mask")
    labels = batch["labels"]
    if cfg.family == "vlm" and mask is None:
        pos = torch.arange(labels.shape[1], device=labels.device)
        mask = (pos >= cfg.n_patches)[None, :].expand(labels.shape)
    return L.unembed_cross_entropy(params["emb"], cfg, x, labels, mask)


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


def paged_prefill_state(cfg, batch: int = 1, device="cuda"):
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
                        state=None, cap_tokens: int = 0, n_valid=None,
                        cap_rows=None):
    """Prefill one prompt chunk per lane into the paged cache (in place).

    tokens: [P, C]; start: int32 [P] — each lane's first position;
    n_valid: int32 [P] or None — real tokens per lane; tables: int32
    [P, MB] — the blocks covering [0, start + n_valid) must be assigned.
    Returns (per-lane last-valid-position logits [P, 1, V], cache, state).
    Only the last valid position of each lane is unembedded. Dense
    attention carries no state across chunks: ``state``, ``cap_tokens``
    and ``cap_rows`` (the MoE family's) are accepted and unused.
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
