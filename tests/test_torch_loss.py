"""``Model.loss`` of the port against the JAX package's, on the CPU, for the
dense (qwen2-0.5b), MoE (olmoe-1b-7b) and VLM (phi-3-vision-4.2b) families
at their smoke shapes.

Weights go JAX ``init`` -> numpy -> ``params_from_jax``; tokens, labels,
loss masks and patch embeddings are made with numpy from a seed and fed to
both packages. The dense and VLM loss is the mean next-token cross entropy
(the VLM's, without a ``loss_mask``, over the text positions only: ``>=
n_patches``); the MoE loss adds ``router_aux_coef`` times the mean
load-balance loss. Tolerances are tests/test_torch_moe.py's: 1e-4 on the
loss, 1e-6 on the load-balance term.
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

ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "phi-3-vision-4.2b")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jax_config(arch, smoke=True)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tparams


def _batch(cfg, masked: bool, seed: int = 3) -> dict:
    """numpy tokens, labels and (``masked``) a random 0/1 loss mask; for a
    VLM, patch embeddings over the first ``n_patches`` positions."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    if masked:
        batch["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _both(arch, batch):
    jcfg, jparams, tparams = _pair(arch)
    jloss = jax_build(jcfg).loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = build_model(get_config(arch, smoke=True)).loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(jloss), tloss


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch, masked):
    cfg = get_config(arch, smoke=True)
    jloss, tloss = _both(arch, _batch(cfg, masked))
    assert tloss.shape == () and tloss.dtype == torch.float32
    assert np.isfinite(jloss)
    np.testing.assert_allclose(float(tloss), jloss, **TOL)


def test_moe_loss_adds_the_router_aux_term():
    """The MoE loss is CE + router_aux_coef x aux: the aux term matches the
    JAX package's at 1e-6, and the loss moves by the coefficient's change
    times it."""
    arch = "olmoe-1b-7b"
    jcfg, jparams, tparams = _pair(arch)
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg, masked=False)
    _, jaux = jmoe.forward(jcfg, jparams, jnp.asarray(batch["tokens"]),
                           return_aux=True)
    _, taux = moe.forward(cfg, tparams, torch.from_numpy(batch["tokens"]),
                          return_aux=True)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6,
                               rtol=1e-6)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    base = build_model(cfg).loss(tparams, tb)
    more = build_model(cfg.replace(router_aux_coef=1.01)).loss(tparams, tb)
    np.testing.assert_allclose(float(more - base), float(taux), atol=1e-5,
                               rtol=1e-4)


def test_vlm_loss_scores_only_text_positions():
    """Without a loss_mask the VLM loss is the loss under the mask
    ``position >= n_patches``; the patch positions' labels do not count."""
    arch = "phi-3-vision-4.2b"
    cfg = get_config(arch, smoke=True)
    _, _, tparams = _pair(arch)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, masked=False).items()}
    text = (torch.arange(S) >= cfg.n_patches).float().expand(B, S)
    default = model.loss(tparams, batch)
    torch.testing.assert_close(default,
                               model.loss(tparams, {**batch,
                                                    "loss_mask": text}))
    relabel = batch["labels"].clone()
    relabel[:, :cfg.n_patches] = (relabel[:, :cfg.n_patches] + 1) % \
        cfg.vocab_size
    torch.testing.assert_close(default,
                               model.loss(tparams, {**batch,
                                                    "labels": relabel}))
