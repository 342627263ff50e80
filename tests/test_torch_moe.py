"""The port's MoE family (repro_torch.models.moe) against the JAX package,
on the CPU, at olmoe-1b-7b's smoke shape (2 layers, 4 experts, top-2).

Weights go JAX ``init`` -> numpy -> ``params_from_jax``; inputs are made
with numpy from a seed and fed to both packages. Routing must agree
exactly — the same top-k experts, the same capacity drops — and the
hidden states within float32 summation-order noise: the expert
contraction, the scatter and the segment sum run in other orders in XLA
and ATen. Tolerance: 1e-4 on outputs and logits (the dense port's, in
tests/test_torch_model.py), 1e-6 on the load-balance loss.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "olmoe-1b-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
#: tight enough that an expert takes 8 of the 16 assignments a 32-token
#: row gives it on average: tokens are certainly dropped
TIGHT = 0.5


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_config(ARCH, smoke=True)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tparams


def _layer0(jparams, tparams):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    return jp, tparams["layers"][0]


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _hidden(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_smoke_variant_and_registry():
    cfg = get_config(ARCH, smoke=True)
    jcfg = jax_config(ARCH, smoke=True)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "n_experts", "top_k",
              "capacity_factor", "router_aux_coef", "tie_embeddings",
              "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full, jfull = get_config(ARCH), jax_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "n_experts", "top_k"):
        assert getattr(full, f) == getattr(jfull, f), f
    for n in (1, 8, 40, 128, 256, 1000):
        assert moe.capacity(cfg, n) == jmoe.capacity(jcfg, n)


def test_init_matches_jax_shapes_and_scales():
    """The port's own init draws every MoE leaf with the reference's
    shape, dtype and scale; the std of every leaf of >= 64k values lies
    within 5% of the reference's."""
    _, _, ref = _pair()
    mine = build_model(get_config(ARCH, smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert len(mine["layers"]) == len(ref["layers"])
    for lr, lm in zip(ref["layers"], mine["layers"]):
        for name in ("router", "we_gate_up", "we_down"):
            assert lm[name].shape == lr[name].shape, name
            if lr[name].numel() >= 1 << 16:
                ratio = float(lm[name].std()) / float(lr[name].std())
                assert abs(ratio - 1.0) < 0.05, (name, ratio)
    assert mine["emb"].keys() == ref["emb"].keys()


@pytest.mark.parametrize("cf", [TIGHT, 1.25], ids=["tight", "default"])
def test_moe_ffn_matches_jax(cf):
    jcfg, jparams, tparams = _pair()
    jcfg = jcfg.replace(capacity_factor=cf)
    cfg = get_config(ARCH, smoke=True, capacity_factor=cf)
    jp, tp = _layer0(jparams, tparams)
    x = _hidden((2, 32, cfg.d_model), seed=1)
    jy, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux, atol=1e-6, rtol=1e-6)
    if cf == TIGHT:
        # drops matter: the same tokens without capacity pressure differ
        loose, _ = moe.moe_ffn(cfg.replace(capacity_factor=8.0), tp,
                               torch.from_numpy(x))
        dropped = (loose - ty).abs().amax(dim=-1) > 1e-3
        assert 0 < int(dropped.sum()) < dropped.numel()


def test_chunked_counts_route_like_one_pass():
    """Chunks carrying the per-expert counts, capacity pinned to the full
    length, drop exactly the tokens a one-pass call drops (port and JAX
    alike)."""
    jcfg, jparams, tparams = _pair()
    jcfg = jcfg.replace(capacity_factor=TIGHT)
    cfg = get_config(ARCH, smoke=True, capacity_factor=TIGHT)
    jp, tp = _layer0(jparams, tparams)
    x = _hidden((2, 32, cfg.d_model), seed=2)
    one, _ = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
    cnt = torch.zeros((2, cfg.n_experts), dtype=torch.int32)
    jcnt = jnp.zeros((2, cfg.n_experts), jnp.int32)
    parts = []
    for lo, hi in ((0, 12), (12, 24), (24, 32)):
        y, _, cnt = moe.moe_ffn(cfg, tp, torch.from_numpy(x[:, lo:hi]),
                                counts=cnt, cap_tokens=32)
        jy, _, jcnt = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x[:, lo:hi]),
                                   counts=jcnt, cap_tokens=32)
        _close(y, jy)
        parts.append(y)
    _close(torch.cat(parts, dim=1), one)
    assert (cnt.numpy() == np.asarray(jcnt)).all()
    assert int(cnt.sum()) == 2 * 32 * cfg.top_k


def test_token_valid_and_cap_rows_match_jax():
    """Lane batching: padded tokens claim no slot and combine to zero, and
    each row routes under its own effective capacity."""
    jcfg, jparams, tparams = _pair()
    jcfg = jcfg.replace(capacity_factor=TIGHT)
    cfg = get_config(ARCH, smoke=True, capacity_factor=TIGHT)
    jp, tp = _layer0(jparams, tparams)
    x = _hidden((2, 24, cfg.d_model), seed=3)
    valid = np.arange(24)[None, :] < np.array([[24], [15]])
    cap_rows = np.array([moe.capacity(cfg, 24), moe.capacity(cfg, 15)],
                        np.int32)
    cnt = np.zeros((2, cfg.n_experts), np.int32)
    ty, _, tc = moe.moe_ffn(cfg, tp, torch.from_numpy(x),
                            counts=torch.from_numpy(cnt), cap_tokens=32,
                            token_valid=torch.from_numpy(valid),
                            cap_rows=torch.from_numpy(cap_rows))
    jy, _, jc = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x),
                             counts=jnp.asarray(cnt), cap_tokens=32,
                             token_valid=jnp.asarray(valid),
                             cap_rows=jnp.asarray(cap_rows))
    _close(ty, jy)
    assert (tc.numpy() == np.asarray(jc)).all()
    assert (ty[1, 15:] == 0).all()


@pytest.mark.parametrize("pallas", [False, True], ids=["mha", "pallas"])
def test_forward_return_cache_matches_jax(pallas):
    """One-pass forward with the aux loss and the per-layer post-RoPE K/V
    (the contiguous prefill); the JAX side attends with plain ``mha`` or
    its Pallas flash kernel in interpret mode, the port with the flash
    kernel's plain version."""
    jcfg, jparams, tparams = _pair()
    jcfg = jcfg.replace(use_pallas=pallas)
    tokens = np.random.default_rng(4).integers(
        1, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    jl, jaux, (jk, jv) = jmoe.forward(jcfg, jparams, jnp.asarray(tokens),
                                      return_aux=True, return_cache=True)
    cfg = get_config(ARCH, smoke=True)
    tl, taux, (tk, tv) = moe.forward(cfg, tparams, torch.from_numpy(tokens),
                                     return_aux=True, return_cache=True)
    assert tk.shape == (cfg.n_layers, 2, 40, cfg.n_kv_heads,
                        cfg.resolved_head_dim)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    _close(taux, jaux, atol=1e-6, rtol=1e-6)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    plain = build_model(cfg).forward(tparams,
                                     {"tokens": torch.from_numpy(tokens)})
    torch.testing.assert_close(plain, tl)


@pytest.mark.parametrize("pallas", [False, True], ids=["mha", "pallas"])
def test_contiguous_decode_steps_match_jax(pallas):
    """Prefill two prompts into a 3-row contiguous cache (row 2 idle),
    then four decode steps with per-row positions; step 2 freezes row 1's
    KV write."""
    jcfg, jparams, tparams = _pair()
    jcfg = jcfg.replace(use_pallas=pallas)
    cfg = get_config(ARCH, smoke=True)
    jm, tm = jax_build(jcfg), build_model(cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 7)]
    max_len = 24
    jcache = jm.init_cache(3, max_len)
    tcache = tm.init_cache(3, max_len, device="cpu")
    tok = np.zeros((3, 1), np.int32)
    for i, p in enumerate(prompts):
        jl, (jk, jv) = jmoe.forward(jcfg, jparams, jnp.asarray(p[None]),
                                    return_cache=True)
        tl, (tk, tv) = moe.forward(cfg, tparams, torch.from_numpy(p[None]),
                                   return_cache=True)
        _close(tl, jl)
        n = len(p)
        jcache = {"k": jcache["k"].at[:, i, :n].set(jk[:, 0]),
                  "v": jcache["v"].at[:, i, :n].set(jv[:, 0])}
        tcache["k"][:, i, :n] = tk[:, 0]
        tcache["v"][:, i, :n] = tv[:, 0]
        tok[i, 0] = int(np.asarray(jl)[0, -1].argmax())
    pos = np.array([len(p) for p in prompts] + [0], np.int32)
    for step in range(4):
        wv = np.array([True, step != 2, False])
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos),
                                    write_valid=jnp.asarray(wv))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    write_valid=torch.from_numpy(wv))
        _close(tl, jl)
        nxt = np.asarray(jl[:, -1]).argmax(-1)
        assert (tl[:, -1].argmax(-1).numpy() == nxt).all()
        tok[:, 0] = nxt
        pos[:2] += 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    assert (tcache["k"][:, 2] == 0).all()          # the frozen idle row


def test_decode_step_with_a_shared_position():
    """``pos`` as one int for every row (static batching's form)."""
    jcfg, jparams, tparams = _pair()
    cfg = get_config(ARCH, smoke=True)
    jm, tm = jax_build(jcfg), build_model(cfg)
    tok = np.array([[3], [9]], np.int32)
    jl, jc = jm.decode_step(jparams, jm.init_cache(2, 8), jnp.asarray(tok), 0)
    tl, tc = tm.decode_step(tparams, tm.init_cache(2, 8, device="cpu"),
                            torch.from_numpy(tok), 0)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
