"""Whisper-style encoder-decoder (arXiv:2212.04356), ported from
``repro/models/encdec.py``.

The mel-spectrogram and conv frontend is a stub, as in the reference: the
caller supplies ``enc_seq`` precomputed frame embeddings [B, enc_seq, D].
The transformer is whole: non-causal encoder layers, then decoder layers
with causal self-attention, cross attention over the encoder output and
an MLP. Positions are sinusoidal, added to the embeddings.

The decoder's no-cache causal self-attention runs ``ops.flash_attention``
(the hand-written kernel on CUDA tensors, its plain version on the CPU),
as the reference's does under ``use_pallas``; the encoder's non-causal
attention and the cross attention run plain ``mha``, as there.

Parameters: ``{"emb", "enc_layers": [...], "dec_layers": [...],
"enc_norm", "dec_norm"}`` (the reference stacks the layers). The cache is
the reference's ``{"k", "v": [L, B, S, Hkv, D], "ck", "cv": [L, B,
enc_seq, Hkv, D]}``: self-attention K/V and the cross K/V that
``prefill_cross_kv`` fills; both update in place. On the mesh the
layers compute tensor-parallel over 'model' as ``models/layers.py`` sets
out, and the serve plan builds the cache at a rank's KV heads (or
positions).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_dec_layer(cfg, dtype, generator) -> dict:
    dev = generator.device
    return {
        "self_attn": L.init_attention(cfg, dtype, generator),
        "cross_attn": L.init_attention(cfg, dtype, generator),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator),
        "norm1": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "norm3": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }


def init_enc_layer(cfg, dtype, generator) -> dict:
    dev = generator.device
    return {
        "attn": L.init_attention(cfg, dtype, generator),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator),
        "norm1": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights on ``generator``'s device (the reference's shapes and
    scales, not its bits) — a generator on ``device`` seeded with 0 when
    none is given."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.param_dtype)
    dev = generator.device
    return {
        "emb": L.init_embeddings(cfg, dtype, generator),
        "enc_layers": [init_enc_layer(cfg, dtype, generator)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [init_dec_layer(cfg, dtype, generator)
                       for _ in range(cfg.n_layers)],
        "enc_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "dec_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def encode(cfg, params, frames):
    """frames: [B, enc_seq, D] stub frontend embeddings -> [B, enc_seq, D]."""
    b, s, d = frames.shape
    x = frames + L.sinusoidal_pos_emb(s, d, frames.device).to(frames.dtype)
    positions = _positions(b, s, frames.device)

    def body(x, p):
        h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
        a, _ = L.attention(p["attn"], cfg, h, positions, causal=False)
        x = x + a
        h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.d_ff)

    body = L.remat(cfg, body, dots=False)        # encdec.py:71-72
    for p in params["enc_layers"]:
        x = body(x, p)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(cfg, p, enc_out):
    """One decoder layer's cross K/V [B, enc_seq, Hkv, D] from the encoder
    output (``p`` the layer's ``cross_attn``). On the mesh: this rank's KV
    heads where attention runs head-sharded and they divide 'model', else
    every KV head (a column block of ``wk`` / ``wv`` gathered), as the
    cross pool ``ck`` / ``cv`` holds them."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if L.whole_kv(cfg, L.heads_sharded(cfg)):
        full = cfg.n_kv_heads * hd
        k, v = L._whole((k, v), (full, full))
    return k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _dec_layer(cfg, p, x, positions, enc_out=None, cross_kv=None,
               kv_cache=None, cache_pos=None):
    """One decoder layer -> (x, new self-attention cache): causal
    self-attention (flash without a cache, the contiguous cache with one),
    cross attention over ``cross_kv`` (or K/V made from ``enc_out``), MLP."""
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    a, new_cache = L.attention(p["self_attn"], cfg, h, positions,
                               kv_cache=kv_cache, cache_pos=cache_pos)
    x = x + a
    h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    if cross_kv is None:
        cross_kv = _cross_kv(cfg, p["cross_attn"], enc_out)
    a, _ = L.attention(p["cross_attn"], cfg, h, positions, cross_kv=cross_kv)
    x = x + a
    h = L.rmsnorm(x, p["norm3"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg.d_ff), new_cache


def decode_train(cfg, params, tokens, enc_out):
    """tokens: [B, S] int, enc_out [B, enc_seq, D] -> logits [B, S, V]."""
    b, s = tokens.shape
    x = L.embed(params["emb"], cfg, tokens)
    x = x + L.sinusoidal_pos_emb(s, cfg.d_model, x.device).to(x.dtype)
    positions = _positions(b, s, x.device)
    body = L.remat(cfg, lambda x, p: _dec_layer(cfg, p, x, positions,
                                                enc_out=enc_out)[0],
                   dots=False)                   # encdec.py:116-117
    for p in params["dec_layers"]:
        x = body(x, p)
    x = L.rmsnorm(x, params["dec_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x)


def forward(cfg, params, tokens, frames):
    return decode_train(cfg, params, tokens, encode(cfg, params, frames))


def loss_fn(cfg, params, batch):
    logits = forward(cfg, params, batch["tokens"], batch["frames"])
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Self-attention K/V and the cross K/V (zero until
    ``prefill_cross_kv``), in ``cfg.dtype``. ``device="meta"`` gives the
    shapes without allocating (``serve/cache.py``'s probes)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    lshape = (cfg.n_layers, batch, max_len, nkv, hd)
    cshape = (cfg.n_layers, batch, cfg.enc_seq, nkv, hd)
    kw = dict(dtype=dtype, device=device)
    return {"k": torch.zeros(lshape, **kw), "v": torch.zeros(lshape, **kw),
            "ck": torch.zeros(cshape, **kw), "cv": torch.zeros(cshape, **kw)}


def prefill_cross_kv(cfg, params, frames, cache: dict) -> dict:
    """Run the encoder on ``frames`` [B, enc_seq, D] and fill every decoder
    layer's cross K/V (in place). Returns the cache."""
    enc_out = encode(cfg, params, frames)
    for i, p in enumerate(params["dec_layers"]):
        k, v = _cross_kv(cfg, p["cross_attn"], enc_out)
        cache["ck"][i].copy_(k)
        cache["cv"][i].copy_(v)
    return cache


def decode_step(cfg, params, cache: dict, tokens, pos):
    """One decode step for every row (self-attention K/V written in place).
    tokens: [B, 1]; pos: an int (every row at the same position) or int32
    [B] (per-row positions). Each row takes the sinusoid of its own
    position. Returns (logits [B, 1, V], cache)."""
    x = L.embed(params["emb"], cfg, tokens)
    positions = L.decode_positions(x.shape[0], pos, x.device)
    x = x + L.sinusoid_at(positions, cfg.d_model).to(x.dtype)
    for i, p in enumerate(params["dec_layers"]):
        x, _ = _dec_layer(cfg, p, x, positions,
                          cross_kv=(cache["ck"][i], cache["cv"][i]),
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          cache_pos=pos)
    x = L.rmsnorm(x, params["dec_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache
