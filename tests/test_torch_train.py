"""Training (``repro_torch.train``, ``launch/train.py``) against the JAX
package's ``repro.train`` on the CPU.

* The optimizer: the three schedules at steps 0..N, ``global_norm``,
  ``clip_by_global_norm``, and ``adamw`` / ``sgdm`` updates on random
  trees over three steps, against the reference at 1e-6 (relative; the
  port updates in place, the reference returns new trees).
* Gradients: ``Model.loss``'s gradients for all six families at smoke size
  against ``jax.jit(jax.value_and_grad(model.loss))``, with the weights
  through ``params_from_jax``, for ``remat`` none, dots and full (one
  parametrised test). Tolerance 1e-5 absolute plus 1e-4 relative: the
  f32 sums run in other orders, and recomputation must change nothing.
* Checkpoints cross both ways: a JAX train state saved by the reference is
  restored by the port and a port state by ``repro.train.checkpoint``,
  leaf for leaf equal.
* The CLI trains at smoke size on ``--device cpu`` with a checkpoint and
  resumes from it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import state as jstate
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import train as train_cli
from repro_torch.models.api import build_model
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        state_from_jax, state_to_jax)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import state as state_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its models are small, and
    the suite runs several workers at once, whose default thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "phi-3-vision-4.2b", "mamba2-780m",
         "zamba2-7b", "whisper-large-v3")
B, S = 2, 32
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got: dict, want: dict, **tol):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-4, 5, 40)), ("warmup_cosine", (1e-3, 0, 10, 0.0)),
    ("warmup_linear", (3e-4, 5, 40)), ("constant", (2e-4,))])
def test_schedules_match_jax(name, args):
    ours, ref = getattr(opt, name)(*args), getattr(jopt, name)(*args)
    for step in range(45):
        got, want = ours(step), float(ref(jnp.int32(step)))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((5,)) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 3, 4)) * scale).astype(
                      np.float32)}}


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


@pytest.mark.parametrize("scale", [0.01, 3.0], ids=["unclipped", "clipped"])
def test_global_norm_and_clipping_match_jax(scale):
    g = _tree(np.random.default_rng(1), scale)
    np.testing.assert_allclose(float(opt.global_norm(_torch(g))),
                               float(jopt.global_norm(g)), rtol=1e-6)
    ours, norm = opt.clip_by_global_norm(_torch(g), 1.0)
    ref, rnorm = jopt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    _assert_trees_close(_np(jax.tree_util.tree_map(lambda t: t.numpy(),
                                                   ours)), _np(ref),
                        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("which", ["adamw", "adamw_noclip", "sgdm",
                                   "sgdm_clip"])
def test_optimizer_updates_match_jax(which):
    """Three steps on random trees (step 0, 1, 2), gradients large enough
    that clipping acts where it is on: params, moments and the gradient
    norm at 1e-6."""
    sched = (3e-3, 1, 10)
    make = {
        "adamw": lambda m: m.adamw(m.warmup_cosine(*sched)),
        "adamw_noclip": lambda m: m.adamw(m.warmup_linear(*sched),
                                          clip_norm=None, weight_decay=0.0),
        "sgdm": lambda m: m.sgdm(m.constant(1e-2)),
        "sgdm_clip": lambda m: m.sgdm(m.warmup_cosine(*sched),
                                      clip_norm=0.5),
    }[which]
    ours, ref = make(opt), make(jopt)
    rng = np.random.default_rng(7)
    jp = _tree(rng)
    tp = _torch(jp)
    js, ts = ref.init(jp), ours.init(tp)
    for step in range(3):
        g = _tree(rng, 2.0)
        upd, js, jn = ref.update(g, js, jp, jnp.int32(step))
        jp = jopt.apply_updates(jp, upd)
        tn = ours.update(_torch(g), ts, tp, step)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), tp),
                            _np(jp), rtol=1e-6, atol=1e-7)
        _assert_trees_close(
            jax.tree_util.tree_map(lambda t: t.numpy(), ts), _np(js),
            rtol=1e-6, atol=1e-7)


def test_apply_updates_adds_in_place():
    p = _torch(_tree(np.random.default_rng(2)))
    u = _torch(_tree(np.random.default_rng(3)))
    want = jopt.apply_updates(jax.tree_util.tree_map(lambda t: t.numpy(), p),
                              jax.tree_util.tree_map(lambda t: t.numpy(), u))
    a = p["a"]
    opt.apply_updates(p, u)
    assert p["a"] is a
    _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), p),
                        _np(want), rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _batch(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    cfg = jax_config(arch, smoke=True)
    model = jax_build(cfg)
    params = model.init(jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    return _np(params), float(loss), _np(grads)


def _plain_calls():
    return fa.flash_attention_plain.calls + ssd.ssd_scan_plain.calls


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch, remat):
    """The kernels' plain versions run once a layer per forward; under
    remat each runs again in the backward (recomputation), and the loss
    and every gradient stay the reference's."""
    jparams, jloss, jgrads = _jax_grads(arch)
    cfg = get_config(arch, smoke=True).replace(remat=remat)
    params = params_from_jax(jparams, device="cpu")
    for p in opt.leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    before = _plain_calls()
    loss = build_model(cfg).loss(params, batch)
    forward_calls = _plain_calls() - before
    loss.backward()
    recomputed = _plain_calls() - before - forward_calls
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    grads = params_to_jax(opt.tree_map(lambda p: p.grad, params))
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    assert recomputed == (0 if remat == "none" else forward_calls)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """A JAX train state after one step (nonzero moments, step 1) through
    the reference's save and the port's restore, and back through the
    port's save and the reference's restore: equal leaves both ways
    (zamba2's smoke config has hybrid groups and no trailing stack)."""
    jcfg = jax_config(arch, smoke=True)
    model = jax_build(jcfg)
    optimizer = jopt.adamw(jopt.warmup_cosine(1e-3, 1, 10))
    state = jstate.create(model.init(jax.random.key(0)), optimizer)
    step = jax.jit(jstate.make_train_step(model.loss, optimizer))
    state, _ = step(state, {k: jnp.asarray(v)
                            for k, v in _batch(jcfg).items()})
    want = _np(state)

    path = str(tmp_path / "jax.ckpt")
    jckpt.save(path, state)
    like = state_lib.create(build_model(get_config(arch, smoke=True)).init(
        torch.Generator().manual_seed(5), device="cpu"),
        opt.adamw(opt.constant(1e-3)))
    got = ckpt.restore(path, like)
    assert got["step"] == 1
    assert all(p.requires_grad for p in opt.leaves(got["params"]))
    _assert_trees_close(state_to_jax(got), want, rtol=0, atol=0)

    path2 = str(tmp_path / "port.ckpt")
    ckpt.save(path2, got)
    back = jckpt.restore(path2, state)
    _assert_trees_close(_np(back), want, rtol=0, atol=0)
    assert back["step"].dtype == jnp.int32

    with pytest.raises(ValueError, match="shape mismatch"):
        small = state_lib.create(build_model(get_config(
            arch, smoke=True).replace(d_model=128)).init(
            torch.Generator().manual_seed(5), device="cpu"),
            opt.adamw(opt.constant(1e-3)))
        ckpt.restore(path, small)


def test_state_from_jax_round_trip():
    jcfg = jax_config("mamba2-780m", smoke=True)
    state = jstate.create(jax_build(jcfg).init(jax.random.key(1)),
                          jopt.sgdm(jopt.constant(0.1)))
    ours = state_from_jax(_np(state), device="cpu")
    assert set(ours["opt"]) == {"mom"} and ours["step"] == 0
    assert all(p.requires_grad for p in opt.leaves(ours["params"]))
    _assert_trees_close(state_to_jax(ours), _np(state), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_train_cli_runs_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "cli.ckpt")
    argv = ["--device", "cpu", "--arch", "qwen2-0.5b", "--preset", "smoke",
            "--steps", "8", "--batch", "4", "--seq", "16", "--lr", "1e-3",
            "--ckpt", ck]
    first = train_cli.main(argv)
    assert first["steps"] == 8 and np.isfinite(first["loss_last"])
    assert set(first) == {"arch", "preset", "params_m", "steps", "wall_s",
                          "loss_first", "loss_last", "ms_per_step",
                          "tokens_per_s"}
    tr = Trainer(train_cli.build_cfg("qwen2-0.5b", "smoke"),
                 TrainerConfig(ckpt_path=ck), device="cpu")
    assert tr.maybe_restore() and tr.step == 8
    saved = [p.detach().clone() for p in opt.leaves(tr.state["params"])]
    train_cli.main(argv[:6] + ["--steps", "4"] + argv[8:])
    assert "restored checkpoint at step 8" in capsys.readouterr().out
    tr2 = Trainer(train_cli.build_cfg("qwen2-0.5b", "smoke"),
                  TrainerConfig(ckpt_path=ck), device="cpu")
    assert tr2.maybe_restore() and tr2.step == 12
    assert any(not torch.equal(a, b) for a, b in
               zip(saved, opt.leaves(tr2.state["params"])))


@pytest.mark.parametrize("arch,preset", [("olmoe-1b-7b", "25m"),
                                         ("mamba2-780m", "25m"),
                                         ("zamba2-7b", "100m")])
def test_build_cfg_matches_reference(arch, preset):
    from repro.launch.train import build_cfg as jax_build_cfg
    ours, ref = train_cli.build_cfg(arch, preset), jax_build_cfg(arch, preset)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "n_experts", "top_k", "ssm_state",
              "ssm_headdim", "remat"):
        assert getattr(ours, f) == getattr(ref, f), f
