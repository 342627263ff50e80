"""Mamba2 (SSD, state-space duality, arXiv:2405.21060), ported from
``repro/models/mamba2.py``.

The forward pass (training, one-pass prefill) runs the chunked SSD scan
through ``kernels.ops.ssd_scan``: the hand-written kernel on CUDA tensors,
its plain version (the reference's ``ssd_chunked`` arithmetic) on the CPU.
Decode carries the recurrent state directly — h <- a h + dt (B (x) x),
y = C.h + D x — O(1) per token; serving prefills by stepping it over the
prompt (``serve/engine.py``), so serving never reaches the scan kernel, as
in the reference.

Parameters are a dict with a list of per-layer dicts (the reference stacks
them for ``lax.scan``; here the layers are a Python loop). The cache is
``{"conv": [L, B, K-1, C], "ssm": [L, B, H, N, P]}``; ``decode_step``
updates it in place. On the mesh a block computes tensor-parallel over
'model' (the section below); the serve plan builds the cache at a rank's
conv channels and heads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _dims(cfg):
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, p = cfg.n_ssm_heads, cfg.ssm_headdim
    conv_ch = di + 2 * g * n
    return di, g, n, h, p, conv_ch


def init_block(cfg, dtype, generator) -> dict:
    """One layer: random projections and conv from ``generator`` (the
    reference's shapes and scales, not its bits) and the reference's
    deterministic leaves: A_log = log(linspace(1, 16, H)), dt_bias 0, D 1,
    norms 0 (the (1 + w) form)."""
    di, g, n, h, p, conv_ch = _dims(cfg)
    d = cfg.d_model
    dev = generator.device
    return {
        "in_proj": L._init_dense((d, 2 * di + 2 * g * n + h), dtype,
                                 generator),
        "conv_w": L._init_dense((cfg.ssm_conv, conv_ch), dtype, generator,
                                scale=0.3),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).to(dtype),
        "dt_bias": torch.zeros((h,), dtype=dtype, device=dev),
        "D": torch.ones((h,), dtype=dtype, device=dev),
        "gate_norm": L.init_rmsnorm(di, dtype, dev),
        "out_proj": L._init_dense((di, d), dtype, generator),
        "norm": L.init_rmsnorm(d, dtype, dev),
    }


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights on ``generator``'s device — a generator on ``device``
    seeded with 0 when none is given."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "emb": L.init_embeddings(cfg, dtype, generator),
        "layers": [init_block(cfg, dtype, generator)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, generator.device),
    }


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: [B, S, C]; w: [K, C]. The reference's sum
    of K shifted products (not ``F.conv1d``, which runs cuDNN in TF32 by
    default)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return y + b


def _project(cfg, p, x):
    """Input projection, split into z [.., di], xBC [.., conv_ch]
    (pre-conv) and dt [.., H]. An ``in_proj`` column block of the flat
    ``2 di + 2 G N + H`` (``inner_flat`` over 'model') is gathered into
    every column first."""
    di, g, n, h, _, conv_ch = _dims(cfg)
    (zxbcdt,) = L._whole((x @ p["in_proj"],), (2 * di + 2 * g * n + h,))
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_ch],
            zxbcdt[..., di + conv_ch:])


def _split_xbc(cfg, xBC):
    """xBC -> x [.., H, P], B and C [.., H, N] (groups repeated to
    heads)."""
    di, g, n, h, ph, _ = _dims(cfg)
    shp = xBC.shape[:-1]
    x = xBC[..., :di].reshape(*shp, h, ph)
    B = xBC[..., di:di + g * n].reshape(*shp, g, n)
    C = xBC[..., di + g * n:].reshape(*shp, g, n)
    rep = h // g
    return (x, B.repeat_interleave(rep, dim=-2),
            C.repeat_interleave(rep, dim=-2))


# ---------------------------------------------------------------------------
# tensor parallelism over 'model'
#
# The reference splits ``in_proj``'s flat columns, ``conv_w`` / ``conv_b``
# and the conv state over the flat conv channels, ``A_log`` / ``dt_bias`` /
# ``D`` and the SSM state over the heads and ``out_proj`` over its d_inner
# rows, each where 'model' divides it (``inner_flat`` / ``heads``). A rank
# gathers the projection, convolves its channel block (B and C live on the
# last channels, so the conv output is gathered too), runs the SSM on its
# heads, normalizes its d_inner columns with the sum of squares reduced over
# 'model' and multiplies ``out_proj``'s row block, the partial sums reduced.
# Each leaf's local shape says whether it is split: a whole leaf (off the
# mesh, or a split 'model' does not divide) is used whole.
# ---------------------------------------------------------------------------
def _blocks(cfg, p):
    """(c0, c, h0, nh): the first index and count of this rank's conv
    channels and SSM heads (0 and every one where the leaf is whole)."""
    _, _, _, h, _, conv_ch = _dims(cfg)
    c, nh = p["conv_w"].shape[-1], p["A_log"].shape[0]
    r = shd.axis_index("model")
    return (0 if c == conv_ch else r * c), c, (0 if nh == h else r * nh), nh


def _channels(x, c0: int, c: int):
    """Channels ``[c0, c0 + c)`` of ``x`` [.., C] (``x`` when all)."""
    return x if c == x.shape[-1] else x[..., c0:c0 + c]


def _local_heads(cfg, xBC, dt, z, h0: int, nh: int):
    """x [.., nh, P], B / C [.., nh, N], dt [.., nh] and z [.., nh P] of
    heads ``[h0, h0 + nh)`` from the whole conv output ``xBC``, the whole
    dt and z."""
    xs, B, C = _split_xbc(cfg, xBC)
    if nh == cfg.n_ssm_heads:
        return xs, B, C, dt, z
    ph = cfg.ssm_headdim
    hs = slice(h0, h0 + nh)
    return (xs[..., hs, :], B[..., hs, :], C[..., hs, :], dt[..., hs],
            z[..., h0 * ph:(h0 + nh) * ph])


def _gate_out(cfg, p, y, z):
    """``rmsnorm(y * silu(z)) @ out_proj`` over d_inner, ``y`` / ``z``
    this rank's block of its columns: the sum of squares reduced over
    'model' (the replicated ``gate_norm`` sliced to the block), then the
    row-parallel product."""
    di = cfg.d_inner
    v = y * F.silu(z)
    w, g = v.shape[-1], p["gate_norm"]
    if w != di:
        c0 = shd.axis_index("model") * w
        g = g[c0:c0 + w]
    v = L.rmsnorm(v, g, cfg.norm_eps, width=di)
    return L.row_parallel(v, p["out_proj"], di)


def _decay_inputs(p, dt):
    """dt (softplus of the raw dt plus its bias) and A = -exp(A_log), f32."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


# ---------------------------------------------------------------------------
# block forward / decode
# ---------------------------------------------------------------------------
def block_fwd(cfg, p, x):
    """x: [B, S, D] -> [B, S, D] (pre-norm residual applied by the caller).
    The scan runs ``ops.ssd_scan`` with ``chunk=cfg.ssm_chunk`` on this
    rank's heads (every head off the mesh)."""
    conv_ch = _dims(cfg)[-1]
    c0, c, h0, nh = _blocks(cfg, p)
    z, xBC, dt = _project(cfg, p, x)
    xBC = F.silu(causal_conv1d(_channels(xBC, c0, c), p["conv_w"],
                               p["conv_b"]))
    (xBC,) = L._whole((xBC,), (conv_ch,))
    xs, B, C, dt, z = _local_heads(cfg, xBC, dt, z, h0, nh)
    dt, A = _decay_inputs(p, dt)
    a_log = dt * A                                   # log decay, [B,S,H]
    xdt = xs.float() * dt[..., None]
    y = kops.ssd_scan(xdt, a_log, B.float(), C.float(), chunk=cfg.ssm_chunk)
    y = y + p["D"].float()[None, None, :, None] * xs.float()
    y = y.to(x.dtype).reshape(*x.shape[:-1], -1)
    return _gate_out(cfg, p, y, z)


def block_decode(cfg, p, x, conv_state, ssm_state):
    """Single-token recurrent step. x: [B, 1, D]; conv_state:
    [B, K-1, C] (this rank's conv channels); ssm_state: [B, H, N, P] (its
    heads). Returns (out [B, 1, D], new conv state, new ssm state)."""
    conv_ch = _dims(cfg)[-1]
    c0, c, h0, nh = _blocks(cfg, p)
    z, xBC, dt = _project(cfg, p, x)                 # [B,1,...]
    full = torch.cat([conv_state, _channels(xBC, c0, c)], dim=1)  # [B,K,C]
    y_conv = torch.einsum("bkc,kc->bc", full, p["conv_w"]) + p["conv_b"]
    new_conv = full[:, 1:, :]
    (xBC,) = L._whole((F.silu(y_conv)[:, None, :],), (conv_ch,))
    xs, B, C, dt, z = _local_heads(cfg, xBC, dt, z, h0, nh)
    dt, A = _decay_inputs(p, dt)
    a = torch.exp(dt * A)[:, 0]                      # [B,H]
    xdt = (xs.float() * dt[..., None])[:, 0]         # [B,H,P]
    Bv, Cv = B.float()[:, 0], C.float()[:, 0]        # [B,H,N]
    new_state = (a[..., None, None] * ssm_state
                 + torch.einsum("bhn,bhp->bhnp", Bv, xdt))
    y = torch.einsum("bhn,bhnp->bhp", Cv, new_state)
    y = y + p["D"].float()[None, :, None] * xs.float()[:, 0]
    y = y.to(x.dtype).reshape(x.shape[0], 1, -1)
    return (_gate_out(cfg, p, y, z), new_conv,
            new_state.to(ssm_state.dtype))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def forward(cfg, params, tokens):
    """tokens: [B, S] int -> logits [B, S, V]."""
    x = L.embed(params["emb"], cfg, tokens)
    # mamba2.py:233-234: jax.checkpoint with no policy when remat is on
    body = L.remat(cfg, lambda x, p: x + block_fwd(
        cfg, p, L.rmsnorm(x, p["norm"], cfg.norm_eps)), dots=False)
    for p in params["layers"]:
        x = body(x, p)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x)


def loss_fn(cfg, params, batch):
    logits = forward(cfg, params, batch["tokens"])
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """O(1) recurrent state per slot (``max_len`` is unused, as in the
    reference): conv in ``cfg.dtype``, ssm in float32. ``device="meta"``
    gives the shapes without allocating (``serve/cache.py``'s probes)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    _, _, n, h, p, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, n, p),
                           dtype=torch.float32, device=device),
    }


def decode_step(cfg, params, cache: dict, tokens, pos):
    """One recurrent step for every row (cache updated in place). tokens:
    [B, 1]; ``pos`` is unused (the state carries the position). Returns
    (logits [B, 1, V], cache)."""
    x = L.embed(params["emb"], cfg, tokens)
    for i, p in enumerate(params["layers"]):
        h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
        out, new_conv, new_ssm = block_decode(cfg, p, h, cache["conv"][i],
                                              cache["ssm"][i])
        cache["conv"][i].copy_(new_conv)
        cache["ssm"][i].copy_(new_ssm)
        x = x + out
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["emb"], cfg, x), cache
