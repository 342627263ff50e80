"""The port's SSM family (repro_torch.models.mamba2) against the JAX package,
on the CPU, at mamba2-780m's smoke shape (2 layers, d_model 256, d_inner
512, 16 heads of 32, state 16, chunk 32).

Weights go JAX ``init`` -> numpy -> ``params_from_jax``; inputs are made
with numpy from a seed and fed to both packages. The JAX model runs its
default path (``ssd_chunked``) and, with ``use_pallas``, its Pallas scan in
interpret mode; the port runs ``ops.ssd_scan``'s plain version. Tolerance
2e-3 on logits and losses, the check of ``tests/test_smoke_archs.py:82-95``
(decode against forward): the chunked and the recurrent sums run in other
orders; the pieces (conv, block) are held at 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import mamba2 as jm2
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models import mamba2
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "mamba2-780m"
TOL = dict(atol=2e-3, rtol=2e-3)
PIECE = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_config(ARCH, smoke=True)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tparams


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, 512, size=(b, s)).astype(np.int32)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def test_config_and_registry():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_config(ARCH, smoke=True)
    full, jfull = get_config(ARCH), jax_config(ARCH)
    for f in ("family", "n_layers", "d_model", "vocab_size", "ssm_state",
              "ssm_expand", "ssm_headdim", "ssm_conv", "ssm_chunk",
              "ssm_groups", "tie_embeddings", "norm_eps", "d_inner",
              "n_ssm_heads", "dtype", "param_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(full, f) == getattr(jfull, f), f
    assert (full.n_layers, full.d_model, full.d_inner, full.n_ssm_heads,
            full.ssm_state, full.ssm_chunk, full.vocab_size) == \
        (48, 1536, 3072, 48, 128, 256, 50280)


def test_init_leaves_match_jax():
    """Every leaf has the reference's shape and dtype; the deterministic
    leaves (dt_bias, D, conv_b, norms) equal the reference's, and A_log =
    log(linspace(1, 16, H)) to one f32 ulp (XLA's and ATen's f32 ``log``
    round 2 of the 16 values apart); the random ones have its scale."""
    jcfg, jparams, _ = _pair()
    cfg = get_config(ARCH, smoke=True)
    port = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert len(port["layers"]) == cfg.n_layers
    for name, jleaf in jparams["layers"].items():
        for i in range(cfg.n_layers):
            t = port["layers"][i][name]
            assert tuple(t.shape) == jleaf.shape[1:], name
            assert str(t.dtype).split(".")[1] == str(jleaf.dtype), name
        if name in ("dt_bias", "D", "conv_b", "gate_norm", "norm"):
            np.testing.assert_array_equal(port["layers"][0][name].numpy(),
                                          np.asarray(jleaf[0]), err_msg=name)
    np.testing.assert_array_max_ulp(port["layers"][0]["A_log"].numpy(),
                                    np.asarray(jparams["layers"]["A_log"][0]),
                                    maxulp=1)
    assert port["emb"]["tok_emb"].shape == jparams["emb"]["tok_emb"].shape
    for name, scale in (("in_proj", cfg.d_model ** -0.5), ("conv_w", 0.3),
                        ("out_proj", cfg.d_inner ** -0.5)):
        std = port["layers"][0][name].std().item()
        assert abs(std / scale - 1) < 0.05, (name, std, scale)


def test_causal_conv1d_matches_jax():
    _, jparams, tparams = _pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, tparams["layers"][0]["conv_w"].shape[1]))
    x = x.astype(np.float32)
    w, b = tparams["layers"][0]["conv_w"], tparams["layers"][0]["conv_b"]
    b = b + 0.1
    _close(mamba2.causal_conv1d(torch.from_numpy(x), w, b),
           jm2.causal_conv1d(jnp.asarray(x), jnp.asarray(w.numpy()),
                             jnp.asarray(b.numpy())), **PIECE)


@pytest.mark.parametrize("pallas", [False, True], ids=["chunked", "pallas"])
@pytest.mark.parametrize("s", [64, 40])
def test_block_fwd_matches_jax(pallas, s):
    """S = 64 (two chunks of 32) and 40 (chunk 8: the halving and the
    _best_chunk rule)."""
    jcfg, jparams, tparams = _pair()
    jcfg = jcfg.replace(use_pallas=pallas)
    cfg = get_config(ARCH, smoke=True)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"])
    _close(mamba2.block_fwd(cfg, tparams["layers"][1], torch.from_numpy(x)),
           jm2.block_fwd(jcfg, jp, jnp.asarray(x)), **PIECE)


@pytest.mark.parametrize("pallas", [False, True], ids=["chunked", "pallas"])
def test_forward_and_loss_match_jax(pallas):
    jcfg, jparams, tparams = _pair()
    jmodel = jax_build(jcfg.replace(use_pallas=pallas))
    model = build_model(get_config(ARCH, smoke=True))
    toks, labels = _tokens(2, 96, 3), _tokens(2, 96, 4)
    mask = (np.random.default_rng(5).random((2, 96)) < 0.7).astype(np.float32)
    logits = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (2, 96, 512) and logits.dtype == torch.float32
    _close(logits, jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}))
    for with_mask in (False, True):
        batch = {"tokens": toks, "labels": labels}
        if with_mask:
            batch["loss_mask"] = mask
        loss = model.loss(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        jloss = jmodel.loss(jparams, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        assert loss.dim() == 0
        _close(loss.item(), float(jloss))


def test_init_cache_shapes_and_dtypes():
    jcfg, _, _ = _pair()
    jc = jax_build(jcfg).init_cache(3, 16)
    tc = build_model(get_config(ARCH, smoke=True)).init_cache(3, 16,
                                                              device="cpu")
    assert set(tc) == set(jc) == {"conv", "ssm"}
    for name in ("conv", "ssm"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype), name
        assert not tc[name].any()
    meta = mamba2.init_cache(get_config(ARCH, smoke=True), 5, 16,
                             device="meta")
    assert meta["ssm"].device.type == "meta" and meta["ssm"].shape[1] == 5


def test_decode_chain_matches_forward_prefix():
    """Recurrent decode over the same tokens gives the chunked forward's
    logits at every position (the port's and the JAX package's)."""
    jcfg, jparams, tparams = _pair()
    model = build_model(get_config(ARCH, smoke=True))
    jmodel = jax_build(jcfg)
    toks = _tokens(2, 40, 6)
    full = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    cache = model.init_cache(2, 40, device="cpu")
    jcache = jmodel.init_cache(2, 40)
    for t in range(40):
        logits, cache = model.decode_step(
            tparams, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _close(logits[:, 0], full[:, t])
        _close(logits, jlogits)
    for name in ("conv", "ssm"):
        _close(cache[name], jcache[name])


def test_decode_step_takes_no_write_valid():
    """Recurrent state has no positional write to mask: the facade keeps
    the plain signature, as the reference's does."""
    _, _, tparams = _pair()
    model = build_model(get_config(ARCH, smoke=True))
    cache = model.init_cache(1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    model.decode_step(tparams, cache, tok, 0)
    with pytest.raises(TypeError):
        model.decode_step(tparams, cache, tok, 0,
                          write_valid=torch.ones(1, dtype=torch.bool))
