"""bf16 training (``dtype`` and ``param_dtype`` "bfloat16", the dry-run's
train overrides) against the JAX package on the CPU.

* ``Model.loss``'s loss and gradients of olmoe-1b-7b, phi-3-vision-4.2b and
  phi3.5-moe at smoke size: the same numpy weights, cast to bf16, and the
  same batch through ``jax.value_and_grad(model.loss)`` and the port's
  ``Model.loss(...).backward()`` (on the CPU the flash wrapper takes its
  plain version; on the card the same graph runs the forward kernel with
  its log-sum-exp and the bf16 backward kernel).
* AdamW on bf16 leaves against the reference's update over three steps
  (params equal, moments at 1e-6), and one ``Trainer.train_step`` in bf16:
  the params stay bf16 and finite, the moments f32, as the reference's
  update keeps them.

Tolerances. bf16 rounds at other places in the two frameworks (XLA fuses
and keeps some intermediates in f32, PyTorch rounds every op's output),
so the packages agree on the loss and on each gradient's direction, not
element by element: the loss within ``LOSS_RTOL`` (2e-3 relative; the
measured gaps are ~3e-4) and every leaf's gradient cosine at least
``MIN_COS`` (0.99; the lowest measured is ~0.997, olmoe's expert
weights).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ("olmoe-1b-7b", "phi-3-vision-4.2b", "phi3.5-moe-42b-a6.6b")
BF16 = (("dtype", "bfloat16"), ("param_dtype", "bfloat16"))
B, S = 2, 32
LOSS_RTOL, MIN_COS = 2e-3, 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its models are small, and
    the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    """The reference's bf16 (params, loss, grads) at smoke size, jitted
    once an arch and shared by the tests."""
    cfg = jax_config(arch, smoke=True).replace(**dict(BF16))
    model = jax_build(cfg)
    params = model.init(jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    return _np(params), float(loss), _np(grads)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    den = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 if den == 0 else float(a @ b / den)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_match_jax(arch):
    jparams, jloss, jgrads = _jax_grads(arch)
    cfg = get_config(arch, smoke=True, **dict(BF16))
    params = params_from_jax(jparams, device="cpu")
    assert {p.dtype for p in opt.leaves(params)} == {torch.bfloat16}
    for p in opt.leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    before = fa.flash_attention_plain.calls
    loss = build_model(cfg).loss(params, batch)
    loss.backward()
    assert fa.flash_attention_plain.calls > before
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss), \
        (float(loss.detach()), jloss)
    assert all(p.grad.dtype == torch.bfloat16 for p in opt.leaves(params))
    grads = params_to_jax(opt.tree_map(lambda p: p.grad.float(), params))
    got = jax.tree_util.tree_leaves_with_path(grads)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    cos = {jax.tree_util.keystr(path): _cosine(np.asarray(g, np.float32),
                                               np.asarray(w, np.float32))
           for (path, g), (_, w) in zip(got, want)}
    assert min(cos.values()) >= MIN_COS, \
        {k: c for k, c in cos.items() if c < MIN_COS}


def test_adamw_on_bf16_leaves_matches_jax():
    """Three AdamW steps (clipping on) on a tree of bf16 params and bf16
    gradients against the reference's update and ``apply_updates``: f32
    moments at 1e-6, the bf16 params equal (each update is cast to the
    param's dtype before it is added, in both)."""
    from repro.train import optimizer as jopt
    rng = np.random.default_rng(4)

    def tree(scale):
        return {"a": (rng.standard_normal((3, 8)) * scale),
                "b": {"c": rng.standard_normal((16,)) * scale}}

    def bf16(t):
        return opt.tree_map(lambda a: torch.from_numpy(
            a.astype(np.float32)).to(torch.bfloat16), t)

    def np32(t):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x.float() if isinstance(x, torch.Tensor)
                                 else jnp.asarray(x, jnp.float32)), t)

    sched = (3e-3, 1, 10)
    ours, ref = (m.adamw(m.warmup_cosine(*sched)) for m in (opt, jopt))
    tp = bf16(tree(1.0))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy(),
                                                      jnp.bfloat16), tp)
    ts, js = ours.init(tp), ref.init(jp)
    for step in range(3):
        g = bf16(tree(2.0))
        jg = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), g)
        upd, js, jn = ref.update(jg, js, jp, jnp.int32(step))
        jp = jopt.apply_updates(jp, upd)
        tn = ours.update(g, ts, tp, step)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert all(x.dtype == torch.bfloat16 for x in opt.leaves(tp))
        for a, b in zip(opt.leaves(np32(tp)),
                        jax.tree_util.tree_leaves(np32(jp))):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(opt.leaves(np32(ts)),
                        jax.tree_util.tree_leaves(np32(js))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_trainer_step_keeps_bf16_params():
    """One AdamW step of the port's Trainer in bf16 (smoke phi-3-vision,
    remat full): params bf16, finite and moved, moments f32, a finite
    loss and gradient norm."""
    cfg = get_config("phi-3-vision-4.2b", smoke=True,
                     **dict(BF16)).replace(remat="full")
    tr = Trainer(cfg, TrainerConfig(warmup_steps=0, peak_lr=1e-3),
                 rng=torch.Generator().manual_seed(0), device="cpu")
    before = [p.detach().clone() for p in opt.leaves(tr.state["params"])]
    rec = tr.train_step(_batch(cfg))
    after = list(opt.leaves(tr.state["params"]))
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
    assert all(p.dtype == torch.bfloat16 and bool(torch.isfinite(p).all())
               for p in after)
    assert all(m.dtype == torch.float32
               for m in opt.leaves(tr.state["opt"]))
    assert sum(not torch.equal(a, b) for a, b in zip(before, after)) \
        > len(after) // 2
    assert tr.step == 1
