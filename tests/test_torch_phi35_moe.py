"""phi3.5-moe-42b-a6.6b in the port at smoke size, held to the JAX package
on the CPU: the registry entry equals ``repro/configs/phi3_5_moe.py``, and
``Model.forward`` and ``Model.loss`` on JAX-initialized weights (through
numpy) match the reference's within the MoE tests' 1e-4. Its full width
(32 layers of 16 experts of 6400, ~166 GB in f32) does not fit one H100:
it waits for a cell of four cards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

ARCH = "phi3.5-moe-42b-a6.6b"
TOL = dict(atol=1e-4, rtol=1e-4)


def test_config_matches_reference():
    assert ARCH in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jax_config(ARCH,
                                                              smoke=smoke)
        for f in dataclasses.fields(cfg):
            if hasattr(jcfg, f.name):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    full = get_config(ARCH)
    assert (full.n_layers, full.n_experts, full.top_k, full.d_ff) == (
        32, 16, 2, 6400)
    assert full.param_count() == jax_config(ARCH).param_count()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_forward_and_loss_match_jax(masked):
    jcfg = jax_config(ARCH, smoke=True)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 32)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 32)).astype(
                 np.int32)}
    if masked:
        batch["loss_mask"] = (rng.random((2, 32)) < 0.6).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = build_model(get_config(ARCH, smoke=True))
    with torch.no_grad():
        logits = model.forward(tparams, tb)
        loss = model.loss(tparams, tb)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm.forward(jparams, jb)), **TOL)
    np.testing.assert_allclose(float(loss), float(jm.loss(jparams, jb)),
                               **TOL)
