"""Zamba2-style hybrid (arXiv:2411.15242), ported from
``repro/models/hybrid.py``: a Mamba2 backbone and one *shared* attention
(+MLP) block.

``n_layers`` counts Mamba2 blocks. The shared block — one set of weights,
``transformer._layer`` — runs before each group of ``shared_attn_every``
Mamba2 blocks: G = n_layers // every groups, then the T remaining blocks
trail. Its attention stays on plain ``mha``, as the reference's does
(``transformer.py:107``); the Mamba2 blocks run ``mamba2.block_fwd`` (the
SSD scan through ``kernels.ops.ssd_scan``) and ``mamba2.block_decode``.

Parameters: ``{"emb", "shared": one layer dict, "groups": G lists of
every block dicts, "trailing": T block dicts, "final_norm"}`` (the
reference stacks the blocks ``[G, every, ...]`` and ``[T, ...]``). The
cache has the reference's keys and shapes: ``attn_k`` / ``attn_v``
``[G, B, S, Hkv, D]`` (each shared-block call keeps its own K/V),
``gconv`` ``[G, every, B, K-1, C]``, ``gssm`` ``[G, every, B, H, N, P]``
(float32), ``tconv`` ``[T, B, K-1, C]`` and ``tssm`` ``[T, B, H, N, P]``;
``decode_step`` updates it in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T


def _split(cfg):
    """(every, groups, trailing) of ``cfg``'s Mamba2 blocks."""
    every = cfg.shared_attn_every
    groups = cfg.n_layers // every if every else 0
    trailing = cfg.n_layers - groups * every
    return every, groups, trailing


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights on ``generator``'s device (the reference's shapes and
    scales, not its bits) — a generator on ``device`` seeded with 0 when
    none is given."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.param_dtype)
    every, groups, trailing = _split(cfg)
    return {
        "emb": L.init_embeddings(cfg, dtype, generator),
        "shared": T.init_layer(cfg, dtype, generator),
        "groups": [[M.init_block(cfg, dtype, generator) for _ in range(every)]
                   for _ in range(groups)],
        "trailing": [M.init_block(cfg, dtype, generator)
                     for _ in range(trailing)],
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, generator.device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _mamba_layer(cfg, p, x):
    return x + M.block_fwd(cfg, p, L.rmsnorm(x, p["norm"], cfg.norm_eps))


def forward(cfg, params, tokens):
    """tokens: [B, S] int -> logits [B, S, V]."""
    x = L.embed(params["emb"], cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for group in params["groups"]:
        x, _ = T._layer(cfg, params["shared"], x, positions, 0)
        for p in group:
            x = _mamba_layer(cfg, p, x)
    for p in params["trailing"]:
        x = _mamba_layer(cfg, p, x)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x)


def loss_fn(cfg, params, batch):
    logits = forward(cfg, params, batch["tokens"])
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """The reference's cache (module docstring): K/V and conv state in
    ``cfg.dtype``, SSM state in float32; zero-size leaves where there are
    no groups or no trailing blocks. ``device="meta"`` gives the shapes
    without allocating (``serve/cache.py``'s probes)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    every, groups, trailing = _split(cfg)
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    _, _, n, h, p, conv_ch = M._dims(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "attn_k": torch.zeros((groups, batch, max_len, nkv, hd), **kw),
        "attn_v": torch.zeros((groups, batch, max_len, nkv, hd), **kw),
        "gconv": torch.zeros((groups, every, batch, cfg.ssm_conv - 1,
                              conv_ch), **kw),
        "gssm": torch.zeros((groups, every, batch, h, n, p), **f32),
        "tconv": torch.zeros((trailing, batch, cfg.ssm_conv - 1, conv_ch),
                             **kw),
        "tssm": torch.zeros((trailing, batch, h, n, p), **f32),
    }


def _mamba_decode(cfg, p, x, conv, ssm):
    """One block's recurrent step; its conv and SSM state updated in
    place."""
    out, new_conv, new_ssm = M.block_decode(
        cfg, p, L.rmsnorm(x, p["norm"], cfg.norm_eps), conv, ssm)
    conv.copy_(new_conv)
    ssm.copy_(new_ssm)
    return x + out


def decode_step(cfg, params, cache: dict, tokens, pos):
    """One decode step for every row (cache updated in place). tokens:
    [B, 1]; pos: an int (every row at the same position) or int32 [B]
    (per-row positions) — where each shared-block call writes its K/V.
    Returns (logits [B, 1, V], cache)."""
    x = L.embed(params["emb"], cfg, tokens)
    positions = L.decode_positions(x.shape[0], pos, x.device)
    for g, group in enumerate(params["groups"]):
        x, _ = T._layer(cfg, params["shared"], x, positions, 0,
                        kv_cache=(cache["attn_k"][g], cache["attn_v"][g]),
                        cache_pos=pos)
        for j, p in enumerate(group):
            x = _mamba_decode(cfg, p, x, cache["gconv"][g, j],
                              cache["gssm"][g, j])
    for i, p in enumerate(params["trailing"]):
        x = _mamba_decode(cfg, p, x, cache["tconv"][i], cache["tssm"][i])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache
