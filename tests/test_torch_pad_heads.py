"""``ArchConfig.pad_q_heads`` in the port, held to the JAX package
(``tests/test_perf_knobs.py:46-55``) on the CPU: padded q heads go inside
each KV group with zero ``wo`` rows, so qwen2's smoke model (4 heads, 2 kv
heads) padded to 6 or 8 heads gives the unpadded logits; the port's init
pads its own draw the reference's way, and the JAX package's padded
params cross through ``convert.params_from_jax`` to the same logits as
the JAX forward. Tolerances are the reference test's (2e-3) between a
padded and an unpadded model, 1e-4 between the packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

ARCH = "qwen2-0.5b"


def _tokens(seed=3):
    return np.random.default_rng(seed).integers(0, 512, (2, 32)).astype(
        np.int32)


def _forward(cfg, params, tokens):
    with torch.no_grad():
        return build_model(cfg).forward(
            params, {"tokens": torch.from_numpy(tokens)}).numpy()


@pytest.mark.parametrize("pad", [6, 8])
def test_pad_q_heads_keeps_the_logits(pad):
    cfg = get_config(ARCH, smoke=True)
    padded = cfg.replace(pad_q_heads=pad)
    assert (cfg.n_heads_eff, padded.n_heads_eff) == (4, pad)
    gen = lambda: torch.Generator().manual_seed(0)          # noqa: E731
    p0 = build_model(cfg).init(gen(), device="cpu")
    p1 = build_model(padded).init(gen(), device="cpu")
    a0, a1 = p0["layers"][0]["attn"], p1["layers"][0]["attn"]
    assert a1["wq"].shape == (256, pad * 64)
    assert a1["wo"].shape == (pad * 64, 256)
    assert a1["bq"].shape == (pad * 64,)
    # the first heads of each group are the unpadded draw, the rest zero
    # rows of wo
    g0, g1 = 2, pad // 2
    wq = a1["wq"].reshape(256, 2, g1, 64)
    assert torch.equal(wq[:, :, :g0], a0["wq"].reshape(256, 2, g0, 64))
    wo = a1["wo"].reshape(2, g1, 64, 256)
    assert torch.equal(wo[:, :g0], a0["wo"].reshape(2, g0, 64, 256))
    assert not wo[:, g0:].any()
    tokens = _tokens()
    np.testing.assert_allclose(_forward(padded, p1, tokens),
                               _forward(cfg, p0, tokens),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("pad", [6, 8])
def test_padded_jax_params_cross_and_match(pad):
    jcfg = jax_config(ARCH, smoke=True).replace(pad_q_heads=pad)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tokens = _tokens(4)
    want = np.asarray(jm.forward(jparams, {"tokens": jnp.asarray(tokens)}))
    cfg = get_config(ARCH, smoke=True).replace(pad_q_heads=pad)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    assert tparams["layers"][0]["attn"]["wq"].shape == (256, pad * 64)
    np.testing.assert_allclose(_forward(cfg, tparams, tokens), want,
                               atol=1e-4, rtol=1e-4)
    # and the padded function is the unpadded one
    base = jax_build(jax_config(ARCH, smoke=True))
    np.testing.assert_allclose(
        want, np.asarray(base.forward(base.init(jax.random.key(0)),
                                      {"tokens": jnp.asarray(tokens)})),
        atol=2e-3, rtol=2e-3)


def test_pad_q_heads_must_keep_whole_groups():
    cfg = get_config(ARCH, smoke=True).replace(pad_q_heads=7)
    with pytest.raises(ValueError, match="KV groups"):
        build_model(cfg).init(torch.Generator().manual_seed(0),
                              device="cpu")
