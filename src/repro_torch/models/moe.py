"""Mixture-of-Experts decoder (OLMoE 64 experts / top-8), ported from
``repro/models/moe.py``.

Token-choice top-k routing with capacity-bounded dispatch: each batch row
routes on its own (the reference's ``vmap`` over rows is a batch dimension
written out), an expert takes at most ``capacity`` of a row's assignments
in arrival order, and the rest are dropped. The dispatch scatters the
feature rows into the expert buffers, or (``cfg.moe_gather_dispatch``)
scatters only int32 slot->token indices and gathers the rows; both give
the same buffers. The expert FFNs run as one batched contraction over the
expert axis (``[B, E, C, D] x [E, D, F]``) with ``einsum``, as the
reference does; the hand-written ``grouped_matmul`` kernel computes the
same contraction and is an op of its own (``kernels/ops.py``), not called
here.

Parameters are a dict with a list of per-layer dicts; caches are the
dense family's (``transformer.init_cache`` / ``init_paged_cache``),
updated in place. The paged prefill carries each layer's per-expert
assignment counts across chunks (``paged_prefill_state``), so chunked
routing drops the tokens a one-pass forward drops.

Sharded (``dist/sharding.py``, ``moe.py:137-144`` of the reference): the
experts split over 'model'. The router's expert logits are gathered over
'model', so every rank routes every token the same way; a rank runs its
own experts' FFNs on their dispatch buffers and the combined partial
output is reduced over 'model'. Where 'model' does not divide the
experts, the reference's sanitizer splits the expert FFNs by width
instead: ``we_gate_up`` [E, D, 2F] flat over its 2F columns (a rank's
block cuts across gate and up, as mamba2's fused ``in_proj``) and
``we_down`` [E, F, D] over its F rows. A rank then gathers the gate/up
block's columns into all 2F, multiplies its F rows' columns of the
activation by its ``we_down`` rows, and the combined partial output is
reduced over 'model'.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_moe_layer(cfg, dtype, generator) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = generator.device
    return {
        "attn": L.init_attention(cfg, dtype, generator),
        "router": L._init_dense((d, e), dtype, generator),
        "we_gate_up": L._init_dense((e, d, 2 * f), dtype, generator),
        "we_down": L._init_dense((e, f, d), dtype, generator),
        "norm1": L.init_rmsnorm(d, dtype, dev),
        "norm2": L.init_rmsnorm(d, dtype, dev),
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
        "layers": [init_moe_layer(cfg, dtype, generator)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, generator.device),
    }


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------
def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)          # round up to 8


def moe_ffn(cfg, p, x, *, counts=None, cap_tokens=None, token_valid=None,
            cap_rows=None):
    """x: [B, S, D] -> (y [B, S, D], aux_loss[, new_counts]).

    ``counts`` [B, E] int32 carries how many assignments each expert has
    already received from earlier chunks of the same sequence (a token's
    slot in its expert is its global arrival order, so drops land on the
    same tokens as a one-pass forward); ``cap_tokens`` pins the capacity to
    the full sequence length. With ``counts`` the updated counts are
    returned as a third output. ``token_valid`` [B, S] drops padded tokens
    from dispatch (they claim no slot and combine to zero); ``cap_rows``
    [B] int32 pins each row's effective capacity below the buffer's.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, cap_tokens if cap_tokens else s)
    dev = x.device

    if (p["router"].shape[1] != e or p["we_gate_up"].shape[0] != e
            or p["we_down"].shape[-2] != cfg.d_ff):
        x = shd.fan_out(x, "model")     # the experts' blocks differ by rank
    logits = x @ p["router"]
    if logits.shape[-1] != e:                  # a block of experts' logits
        logits = shd.gather_over(logits, logits.dim() - 1, "model",
                                 grad="replicated")     # routed alike
    logits = logits.float()                                      # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                  # [B, S, K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)              # renormalize

    # load-balance auxiliary loss (Switch-style): E * sum(frac_e * prob_e)
    onehot = F.one_hot(top_e, e).float()                         # [B,S,K,E]
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1))             # [E]
    mean_prob = probs.mean(dim=(0, 1))                           # [E]
    aux = e * (frac_tokens / k * mean_prob).sum()

    if token_valid is None:
        token_valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    if cap_rows is None:
        cap_rows = torch.full((b,), cap, dtype=torch.int32, device=dev)
    cnt0 = (counts if counts is not None
            else torch.zeros((b, e), dtype=torch.int32, device=dev))

    # dispatch: the reference's per-row vmap, batch dimension written out
    flat_e = top_e.reshape(b, s * k)                             # [B, S*K]
    flat_p = top_p.reshape(b, s * k)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(k)  # [S*K]
    flat_tv = token_valid.repeat_interleave(k, dim=1)            # [B, S*K]
    one = F.one_hot(flat_e, e).to(torch.int32) * flat_tv[..., None]
    pos_in_e = (cnt0.gather(1, flat_e)
                + one.cumsum(dim=1).gather(2, flat_e[..., None])[..., 0]
                - 1)
    keep = (pos_in_e < cap_rows[:, None]) & flat_tv
    safe_pos = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap - 1))
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    if cfg.moe_gather_dispatch:
        # the reference's .at[flat_e, safe_pos].max of int32 token ids:
        # kept slots are unique, dropped assignments offer -1 to cap - 1
        slot_tok = torch.full((b, e * cap), -1, dtype=torch.int32,
                              device=dev)
        slot_tok.scatter_reduce_(
            1, (flat_e * cap + safe_pos).long(),
            torch.where(keep, flat_tok.to(torch.int32), -1), reduce="amax")
        slot_tok = slot_tok.view(b, e, cap)
        buf = torch.where(
            slot_tok[..., None] >= 0,
            x[torch.arange(b, device=dev)[:, None, None],
              slot_tok.clamp(min=0).long()], zero)
    else:
        # the reference's .at[flat_e, safe_pos].add scatter: kept slots are
        # unique, dropped assignments add zeros into the slot cap - 1
        buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=dev)
        buf.index_put_((rows, flat_e, safe_pos),
                       torch.where(keep[..., None], x[:, flat_tok], zero),
                       accumulate=True)

    # expert computation: batched SwiGLU over the expert axis (this
    # rank's block of experts when they split over 'model')
    n_local = p["we_gate_up"].shape[0]
    if n_local != e:
        e0 = shd.axis_index("model") * n_local
        buf = buf[:, e0:e0 + n_local]
        flat_e = flat_e - e0
        keep = keep & (flat_e >= 0) & (flat_e < n_local)
        flat_e = flat_e.clamp(0, n_local - 1)
    gu = torch.einsum("becd,edf->becf", buf, p["we_gate_up"])
    f = cfg.d_ff
    gu, = L._whole((gu,), (2 * f,))       # a column block of gate/up
    g, u = gu.chunk(2, dim=-1)
    h = F.silu(g) * u
    f_local = p["we_down"].shape[-2]
    if f_local != f:                      # this rank's F rows: partial sums
        r = shd.axis_index("model")
        h = h[..., r * f_local:(r + 1) * f_local]
    out_buf = torch.einsum("becf,efd->becd", h, p["we_down"])

    # combine: the reference's segment_sum over each row's assignments; a
    # token's k assignments are adjacent, so a sum over them (in a fixed
    # order: index_add_'s atomics on the card sum in any order, and a
    # token's bits would change from run to run)
    w = torch.where(keep, flat_p, torch.zeros_like(flat_p))
    y = out_buf[rows, flat_e, safe_pos] * w[..., None].to(out_buf.dtype)
    out = y.view(b, s, k, d).sum(dim=2)
    if n_local != e or f_local != f:
        out = shd.reduce_over(out, "model", grad="replicated")
    if counts is not None:
        return out, aux, cnt0 + one.sum(dim=1, dtype=torch.int32)
    return out, aux


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------
def _layer(cfg, p, x, positions, kv_cache=None, cache_pos=None,
           kv_valid=None):
    """One MoE decoder layer -> (x, new_kv_cache, aux). The no-cache
    branch attends through ``ops.flash_attention``."""
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    attn_out, new_cache = L.attention(p["attn"], cfg, h, positions,
                                      kv_cache=kv_cache, cache_pos=cache_pos,
                                      kv_valid=kv_valid)
    x = x + attn_out
    h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    ffn_out, aux = moe_ffn(cfg, p, h)
    return x + ffn_out, new_cache, aux


def forward(cfg, params, tokens, return_aux: bool = False,
            return_cache: bool = False):
    """tokens: [B, S] int -> logits [B, S, V]; ``return_aux`` adds the
    mean load-balance loss over layers, ``return_cache`` the per-layer
    post-RoPE (k, v) stacked ``[L, B, S, Hkv, D]`` (one-pass prefill)."""
    x = L.embed(params["emb"], cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    # moe.py:189-193: the layer body under cfg.remat
    body = L.remat(cfg, lambda x, p: _layer(cfg, p, x, positions))
    for p in params["layers"]:
        x, kv, aux = body(x, p)
        aux_sum = aux_sum + aux
        if return_cache:
            caches.append(kv)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["emb"], cfg, x)
    aux = aux_sum / cfg.n_layers
    if return_aux and return_cache:
        return logits, aux, T.stack_caches(caches)
    if return_aux:
        return logits, aux
    if return_cache:
        return logits, T.stack_caches(caches)
    return logits


def loss_fn(cfg, params, batch):
    """Next-token cross entropy plus ``router_aux_coef`` times the mean
    load-balance loss (``moe.py:206-209``)."""
    logits, aux = forward(cfg, params, batch["tokens"], return_aux=True)
    ce = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + cfg.router_aux_coef * aux


init_cache = T.init_cache
init_paged_cache = T.init_paged_cache


def decode_step(cfg, params, cache: dict, tokens, pos,
                write_valid: Optional[torch.Tensor] = None):
    """One contiguous decode step (see ``transformer.decode_step``)."""
    x = L.embed(params["emb"], cfg, tokens)
    positions = L.decode_positions(x.shape[0], pos, x.device)
    kv_valid = None if write_valid is None else write_valid[:, None]
    for i, p in enumerate(params["layers"]):
        x, _, _ = _layer(cfg, p, x, positions,
                         kv_cache=(cache["k"][i], cache["v"][i]),
                         cache_pos=pos, kv_valid=kv_valid)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------
def paged_prefill_state(cfg, batch: int = 1, device="cuda") -> torch.Tensor:
    """Per-layer expert assignment counts carried across prefill chunks
    (int32 ``[L, batch, E]``), so capacity drops match the one-pass
    forward (see ``moe_ffn``)."""
    return torch.zeros((cfg.n_layers, batch, cfg.n_experts),
                       dtype=torch.int32, device=device)


def paged_prefill_chunk(cfg, params, cache: T.PagedCache, tokens, start,
                        tables, state=None, cap_tokens: int = 0,
                        n_valid=None, cap_rows=None):
    """MoE chunked prefill, lane-batched as the dense one
    (``transformer.paged_prefill_chunk``; ``moe.py:223-263``): attention
    pages through each lane's block table; the expert FFN routes with the
    carried counts ``state`` [L, P, E], drops lane-padding tokens from
    dispatch and pins each lane's effective capacity to ``cap_rows`` [P]
    (its own prompt's ``capacity(cfg, len)``); the static ``cap_tokens``
    only sizes the dispatch buffers. Returns (per-lane last-valid-position
    logits [P, 1, V], cache, the new counts [L, P, E])."""
    x = L.embed(params["emb"], cfg, tokens)
    b, c, _ = x.shape
    positions, valid, last = T.prefill_chunk_layout(start, n_valid, b, c)
    if state is None:
        state = paged_prefill_state(cfg, b, x.device)
    counts = []
    for i, p in enumerate(params["layers"]):
        h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
        attn_out, _ = L.attention(p["attn"], cfg, h, positions,
                                  kv_cache=cache.layer(i, tables),
                                  kv_valid=valid)
        x = x + attn_out
        h = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        ffn_out, _, cnt = moe_ffn(cfg, p, h, counts=state[i],
                                  cap_tokens=cap_tokens, token_valid=valid,
                                  cap_rows=cap_rows)
        x = x + ffn_out
        counts.append(cnt)
    x = x[torch.arange(b, device=x.device), last][:, None]
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache, torch.stack(counts)


def paged_decode_step(cfg, params, cache: T.PagedCache, tokens, pos, tables,
                      write_valid: Optional[torch.Tensor] = None):
    """One paged decode step (see ``transformer.paged_decode_step``)."""
    x = L.embed(params["emb"], cfg, tokens)
    positions = L.decode_positions(x.shape[0], pos, x.device)
    kv_valid = None if write_valid is None else write_valid[:, None]
    for i, p in enumerate(params["layers"]):
        x, _, _ = _layer(cfg, p, x, positions,
                         kv_cache=cache.layer(i, tables), kv_valid=kv_valid)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache
