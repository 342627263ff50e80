"""The sharded train step (``repro_torch.train.sharded``) on four gloo ranks
on the CPU, held to the JAX package's single-device
``state.make_train_step(model.loss, adamw(constant(lr)))`` from the same
weights (the reference's own sharded train step runs only under pjit,
whose constraints this JAX refuses: ``tests/test_sharding.py``).

One module-scoped spawn of four ranks (``tests/_torch_sharded_ranks.py``,
one torch thread each) runs two scenarios of smoke qwen2-0.5b on weights
converted from the JAX ``Model.init``, two AdamW steps each on [4, 16]
global batches, while the parent runs the JAX steps:

* mesh (1, 4) with 6 q heads: neither they nor the 2 KV heads divide
  'model', so every attention leaf is a column block gathered into whole
  heads and each rank attends its quarter of the rows (q-seq: flash with a
  query offset, its plain version here, and its backward through
  autograd); the logits stay split over the vocabulary through the loss;
* mesh (2, 2) with a loss mask that scores rows unevenly: heads split over
  'model', the rows over 'data', the global masked mean from each rank's
  sums, the gradients reduce-scattered to ZeRO-1 blocks (bias leaves
  ZeRO-1 cannot split all-reduced) and the updated blocks gathered back.

Held: every rank's loss and gradient norm at each step, within 1e-5 and
1e-4 relative of the JAX step's; the params after the two steps, gathered
whole: their distance from the JAX step's params within 1e-3 of the
distance those moved, and each element within a tenth of the two steps'
size, 2e-4 (AdamW divides each gradient element by its running magnitude,
so f32 sums in other orders move an element whose gradient is near its
rounding by up to ~lr a step; the single-process port's own step lands
as far from the JAX step's on these weights), but the key bias, whose
gradient is 0 in exact arithmetic and so rounding noise throughout:
within the two steps' size, 2e-3 (as ``tests/test_torch_runtime.py``
holds it).
"""
import functools
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train import state as jstate

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

LR = 1e-3
STEPS = 2
#: name -> (config overrides, mesh, masked)
SCENARIOS = {
    "q-seq-1x4": (dict(n_heads=6), (1, 4), False),
    "zero1-2x2": ({}, (2, 2), True),
}


def _batches(masked: bool):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, 512, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 512, (4, 16)).astype(np.int32)}
        if masked:      # the second 'data' rank's rows score 3x fewer
            mask = rng.random((4, 16)) < np.array([[0.9], [0.8], [0.3],
                                                   [0.2]])
            b["loss_mask"] = mask.astype(np.float32)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _params(name):
    cfg = jax_config("qwen2-0.5b", smoke=True, **SCENARIOS[name][0])
    return jax.tree_util.tree_map(
        np.asarray, jax_build(cfg).init(jax.random.key(0)))


def _jax_run(name):
    """(losses, gradient norms, final params) of the JAX steps."""
    cfg = jax_config("qwen2-0.5b", smoke=True, **SCENARIOS[name][0])
    optimizer = jopt.adamw(jopt.constant(LR))
    state = jstate.create(jax.tree_util.tree_map(jnp.asarray,
                                                 _params(name)), optimizer)
    step = jax.jit(jstate.make_train_step(jax_build(cfg).loss, optimizer))
    losses, norms = [], []
    for b in _batches(SCENARIOS[name][2]):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree_util.tree_map(np.asarray,
                                                 state["params"])


def _spec(port):
    scenarios = [dict(name=name, kind="train", arch="qwen2-0.5b",
                      params=name, overrides=over, mesh=mesh, lr=LR,
                      batches=_batches(masked))
                 for name, (over, mesh, masked) in SCENARIOS.items()]
    return dict(world=4, port=port, scenarios=scenarios,
                params={name: _params(name) for name in SCENARIOS})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    """(per-rank results, the JAX runs by scenario)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(_spec(_free_port()), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_sharded_ranks.py"),
             spec, tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            refs = {name: _jax_run(name) for name in SCENARIOS}
            log, _ = proc.communicate(timeout=240)
        finally:
            proc.kill()
        ranks = []
        for r in range(4):
            path = os.path.join(tmp, f"rank{r}.pkl")
            assert os.path.exists(path), log[-4000:]
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    for res in ranks:
        assert "error" not in res, res.get("error")
    return ranks, refs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_loss_and_grad_norm_match_jax(runs, name):
    ranks, refs = runs
    want_loss, want_norm, _ = refs[name]
    for res in ranks:
        np.testing.assert_allclose(res[name]["losses"], want_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(res[name]["norms"], want_norm,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_params_after_two_steps_match_jax(runs, name):
    ranks, refs = runs
    got, want = ranks[0][name]["params"], refs[name][2]
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        key = jax.tree_util.keystr(path)
        atol = STEPS * LR if key.endswith("['bk']") else STEPS * LR / 10
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)
    start = jax.tree_util.tree_leaves(_params(name))
    gap = sum(float(np.sum((g - w) ** 2)) for (_, g), (_, w) in zip(gl, wl))
    moved = sum(float(np.sum((w - p) ** 2))
                for (_, w), p in zip(wl, start))
    assert gap ** 0.5 < 1e-3 * moved ** 0.5


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_layouts_and_collectives(runs, name):
    """(1, 4): a quarter of ``wq``'s 384 columns and of the vocabulary a
    rank, q-seq through the offset flash (forward and backward: one call a
    layer a step each way, the plain version's CPU calls), collectives
    over 'model' only; (2, 2): half of each, and reduce-scatters over
    'data' (ZeRO-1)."""
    ranks, _ = runs
    _, mesh, _ = SCENARIOS[name]
    for res in ranks:
        r = res[name]
        wq, emb = r["local_shapes"]
        heads = SCENARIOS[name][0].get("n_heads", 4)
        assert wq == (256, heads * 64 // mesh[1])
        assert emb == (512 // mesh[1], 256)
        c = r["collectives"]
        assert c["all_reduce"] > 0 and c["all_gather"] > 0
        if mesh == (1, 4):
            # the forward's call a layer a step (2 layers, 2 steps); the
            # backward of the plain version runs through autograd
            assert r["offset_calls"] == 2 * STEPS
            assert c["reduce_scatter"] > 0       # the gathered rows' grads
        else:
            assert r["offset_calls"] == 0
            assert c["reduce_scatter"] > 0       # ZeRO-1 over 'data'


@pytest.mark.parametrize("coords", [dict(pod=0, data=0), dict(pod=0, data=3),
                                    dict(pod=1, data=2), dict(pod=1, data=3)])
def test_zero1_blocks_follow_the_opt_layout(coords):
    """On a shape-only (pod 2, data 4, model 2) mesh: each leaf's ZeRO-1
    block cut from the rank's param block (``zero_block``) and the rank's
    rows of a batch (``local_batch``) are the blocks ``local_block`` cuts
    under the opt layout and over the fused data axes ("pod", "data");
    with ``zero1=False`` the moments keep the param layout."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models.api import build_model
    from repro_torch.train import sharded as ts
    cfg = get_config("qwen2-0.5b", smoke=True)
    mesh = shd.Mesh((2, 4, 2), ("pod", "data", "model"),
                    coords=dict(coords, model=1))
    plan = ts.make_train_sharding(cfg, mesh)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    local = plan.shard_params(params)
    split = 0

    def check(path, full):
        nonlocal split
        want = shd.local_block(full, shd.leaf_at(plan.opt_layout, path),
                               mesh)
        got = plan.zero_block(path, shd.leaf_at(local, path))
        assert torch.equal(got, want), path
        split += plan.zero_dim(path) is not None
    shd.tree_map_with_path(check, params)
    assert split > 0
    batch = {"tokens": torch.arange(16 * 3).reshape(16, 3)}
    rows = shd.local_block(batch["tokens"], shd.P(("pod", "data")), mesh)
    assert torch.equal(plan.local_batch(batch)["tokens"], rows)
    whole = ts.make_train_sharding(cfg, mesh, zero1=False)
    assert whole.opt_layout == whole.param_layout
