"""The port's hybrid family (repro_torch.models.hybrid) and its contiguous
serving against the JAX package, on the CPU, at zamba2-7b's smoke shape
(d_model 256, 4 heads of 64, state 16, SSM head dim 32, chunk 32, the
shared attention block before every 2 Mamba2 blocks): ``n_layers`` 2 (one
group, no trailing block: zero-size trailing leaves) and 5 (two groups and
one trailing block).

Weights go JAX ``init`` -> numpy -> ``params_from_jax``; inputs are made
with numpy from a seed and fed to both packages. The JAX model runs its
default scan (``ssd_chunked``) and, with ``use_pallas``, its Pallas scan in
interpret mode; the port runs ``ops.ssd_scan``'s plain version. Tolerance
2e-3 on logits and losses and 1e-4 on the pieces
(``tests/test_torch_mamba2.py``'s); the engines token for token, with the
host-side counters exactly equal.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import hybrid as jhy
from repro.models import transformer as jtr
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro.serve.cache import CachePool as JaxCachePool
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import hybrid, transformer
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import CachePool, ServeEngine, ServeRequest

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-7b"
TOL = dict(atol=2e-3, rtol=2e-3)
PIECE = dict(atol=1e-4, rtol=1e-4)
#: Mamba2 blocks: one group and no trailing block; two groups and one
DEPTHS = [2, 5]
#: the engine's request set: prompt lengths, arrivals on the decode-step
#: clock, budgets
LENGTHS, ARRIVALS, BUDGETS = [5, 9, 7, 9, 6, 5], [0, 0, 1, 2, 4, 5], \
    [6, 3, 8, 5, 2, 7]


def _cfgs(n_layers):
    return (jax_config(ARCH, smoke=True, n_layers=n_layers),
            get_config(ARCH, smoke=True, n_layers=n_layers))


@functools.lru_cache(maxsize=None)
def _numpy_params(n_layers):
    jcfg, _ = _cfgs(n_layers)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build(jcfg).init)(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _pair(n_layers):
    jcfg, cfg = _cfgs(n_layers)
    npp = _numpy_params(n_layers)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, npp),
            params_from_jax(npp, device="cpu"))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, 512, size=(b, s)).astype(np.int32)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# config, init
# ---------------------------------------------------------------------------
def test_config_and_registry():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_config(ARCH, smoke=True)
    full, jfull = get_config(ARCH), jax_config(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "resolved_head_dim", "d_ff", "vocab_size", "ssm_state",
              "ssm_expand", "ssm_headdim", "ssm_conv", "ssm_chunk",
              "ssm_groups", "shared_attn_every", "tie_embeddings", "qkv_bias",
              "pos_emb", "rope_theta", "norm_eps", "d_inner", "n_ssm_heads",
              "dtype", "param_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(full, f) == getattr(jfull, f), f
    assert (full.n_layers, full.d_model, full.n_ssm_heads, full.ssm_headdim,
            full.ssm_state, full.shared_attn_every, full.resolved_head_dim) \
        == (81, 3584, 112, 64, 64, 6, 112)
    assert hybrid._split(full) == (6, 13, 3)
    assert hybrid._split(cfg) == (2, 1, 0)
    assert get_config("phi3.5-moe-42b-a6.6b").family == "moe"
    assert build_model(cfg).module is hybrid


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_init_leaves_match_jax(n_layers):
    """Every leaf has the reference's shape and dtype, per group block,
    trailing block and the shared layer; the random ones have its
    scale."""
    jcfg, cfg, jparams, _ = _pair(n_layers)
    port = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    every, groups, trailing = hybrid._split(cfg)
    assert len(port["groups"]) == groups and len(port["trailing"]) == trailing
    assert all(len(g) == every for g in port["groups"])
    for name, jleaf in jparams["groups"].items():
        for g in range(groups):
            for j in range(every):
                t = port["groups"][g][j][name]
                assert tuple(t.shape) == jleaf.shape[2:], name
                assert str(t.dtype).split(".")[1] == str(jleaf.dtype), name
    for name, jleaf in jparams.get("trailing", {}).items():
        assert tuple(port["trailing"][0][name].shape) == jleaf.shape[1:]
    flat = jax.tree_util.tree_flatten_with_path(jparams["shared"])[0]
    for path, jleaf in flat:
        t = port["shared"]
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == jleaf.shape, path
    assert port["emb"]["lm_head"].shape == jparams["emb"]["lm_head"].shape
    std = port["groups"][0][0]["in_proj"].std().item()
    assert abs(std / cfg.d_model ** -0.5 - 1) < 0.05


# ---------------------------------------------------------------------------
# pieces, forward, loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pallas", [False, True], ids=["chunked", "pallas"])
def test_blocks_match_jax(pallas):
    """A Mamba2 block of the backbone (pre-norm residual) and the shared
    attention block (plain mha), at S 40 (chunk 8)."""
    jcfg, cfg, jparams, tparams = _pair(5)
    jcfg = jcfg.replace(use_pallas=pallas)
    x = np.random.default_rng(7).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1, 0], jparams["groups"])
    jout, _ = jax.jit(functools.partial(jhy._mamba_layer, jcfg))(
        jp, jnp.asarray(x))
    _close(hybrid._mamba_layer(cfg, tparams["groups"][1][0],
                               torch.from_numpy(x)), jout, **PIECE)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40))
    jout, _ = jax.jit(functools.partial(jtr._layer, jcfg))(
        jparams["shared"], jnp.asarray(x), jnp.asarray(pos), jnp.int32(0))
    tout, _ = transformer._layer(cfg, tparams["shared"], torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()), 0)
    _close(tout, jout, **PIECE)


@pytest.mark.parametrize("pallas", [False, True], ids=["chunked", "pallas"])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_forward_and_loss_match_jax(n_layers, pallas):
    jcfg, cfg, jparams, tparams = _pair(n_layers)
    jmodel = jax_build(jcfg.replace(use_pallas=pallas))
    model = build_model(cfg)
    toks, labels = _tokens(2, 64, 3), _tokens(2, 64, 4)
    mask = (np.random.default_rng(5).random((2, 64)) < 0.7).astype(np.float32)
    batch = {"tokens": toks, "labels": labels}
    jlogits, jloss, jmasked = jax.jit(lambda p, b, m: (
        jmodel.forward(p, b), jmodel.loss(p, b),
        jmodel.loss(p, dict(b, loss_mask=m))))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(mask))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model.forward(tparams, tb)
    assert logits.shape == (2, 64, 512) and logits.dtype == torch.float32
    _close(logits, jlogits)
    loss = model.loss(tparams, tb)
    assert loss.dim() == 0
    _close(loss.item(), float(jloss))
    _close(model.loss(tparams, dict(tb, loss_mask=torch.from_numpy(mask)))
           .item(), float(jmasked))


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_decode_chain_matches_forward_prefix(n_layers):
    """Decode over the same tokens gives the forward's logits at every
    position, the JAX decode chain's logits, and its cache: every shared
    block call's K/V lands in its own ``attn_k[g]`` / ``attn_v[g]``."""
    jcfg, cfg, jparams, tparams = _pair(n_layers)
    model, jmodel = build_model(cfg), jax_build(jcfg)
    toks = _tokens(2, 20, 6)
    full = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    cache = model.init_cache(2, 20, device="cpu")
    jcache = jmodel.init_cache(2, 20)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(20):
        logits, cache = model.decode_step(
            tparams, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        jlogits, jcache = jstep(
            jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _close(logits[:, 0], full[:, t])
        _close(logits, jlogits)
    for name in jcache:
        _close(cache[name], jcache[name])
    assert cache["attn_k"].abs().min(dim=-1).values.amin() > 0   # all written


def test_per_row_positions_match_jax():
    """Per-row int32 [B] positions (continuous batching) against the JAX
    decode step, from a cache the rows filled at different depths."""
    jcfg, cfg, jparams, tparams = _pair(5)
    model, jmodel = build_model(cfg), jax_build(jcfg)
    rng = np.random.default_rng(8)
    init = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
            for k, v in model.init_cache(3, 16, device="meta").items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    jcache = {k: jnp.asarray(v.copy()) for k, v in init.items()}
    tok, pos = _tokens(3, 1, 9), np.array([3, 9, 0], np.int32)
    logits, cache = model.decode_step(tparams, cache, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
    jlogits, jcache = jax.jit(jmodel.decode_step)(
        jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    _close(logits, jlogits)
    for name in jcache:
        _close(cache[name], jcache[name], **PIECE)


# ---------------------------------------------------------------------------
# cache and pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_cache_and_pool_match_reference(n_layers):
    """The reference's keys, shapes and dtypes (zero-size trailing leaves
    at n_layers 2), the pool's batch axes (2 for the group state), and its
    slot writes, zero-size leaves included."""
    jcfg, cfg, _, _ = _pair(n_layers)
    jm, tm = jax_build(jcfg), build_model(cfg)
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16, device="cpu")
    assert set(tc) == set(jc) == {"attn_k", "attn_v", "gconv", "gssm",
                                  "tconv", "tssm"}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype), name
    assert (tc["tconv"].numel() == 0) == (n_layers == 2)
    meta = hybrid.init_cache(cfg, 5, 16, device="meta")
    assert meta["gssm"].device.type == "meta" and meta["gssm"].shape[2] == 5
    ref = JaxCachePool(jm, n_slots=3, max_len=16)
    port = CachePool(tm, n_slots=3, max_len=16, device="cpu")
    assert dict(ref.batch_axes) == port.batch_axes == {
        "attn_k": 1, "attn_v": 1, "gconv": 2, "gssm": 2, "tconv": 1,
        "tssm": 1}
    rng = np.random.default_rng(1)
    for _ in range(2):
        a, b = ref.alloc(), port.alloc()
        assert a == b
        row = {}
        for n, v in port.buffers.items():
            shape = list(v.shape)
            shape[port.batch_axes[n]] = 1
            row[n] = rng.standard_normal(shape).astype(np.float32)
        ref.write(a, {n: jnp.asarray(r) for n, r in row.items()})
        port.write(b, {n: torch.from_numpy(r) for n, r in row.items()})
    for name in port.buffers:
        np.testing.assert_array_equal(np.asarray(ref.buffers[name]),
                                      port.buffers[name].numpy())
        assert port.read_slot(0)[name].shape == tuple(
            np.asarray(ref.buffers[name]).take([0], port.batch_axes[name])
            .shape)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _requests(cls):
    rng = np.random.default_rng(13)
    return [cls(rng.integers(1, 512, size=n).astype(np.int32),
                max_new_tokens=b, arrival_time=float(a))
            for n, a, b in zip(LENGTHS, ARRIVALS, BUDGETS)]


def _run_both(n_layers=2, **kw):
    jcfg, cfg, jparams, tparams = _pair(n_layers)
    jeng = JaxEngine(jcfg, params=jparams, cache="contiguous", max_len=32,
                     **kw)
    ref, rst = jeng.run(_requests(JaxRequest))
    engine = ServeEngine(cfg, params=tparams, device="cpu", max_len=32, **kw)
    out, pst = engine.run(_requests(ServeRequest))
    assert [r.output for r in out] == [r.output for r in ref]
    for name in ("prefill_dispatches", "decode_dispatches", "host_syncs",
                 "decode_rows_saved", "steps", "new_tokens", "max_active",
                 "slot_utilization", "mean_occupancy", "max_occupancy",
                 "unfinished"):
        assert getattr(pst, name) == getattr(rst, name), name
    assert [r.finished_at for r in out] == [r.finished_at for r in ref]
    return engine, jeng, out, pst


@pytest.mark.parametrize("k,n_layers", [(1, 2), (8, 5)],
                         ids=["k1-zero-size-trailing", "k8-trailing"])
def test_continuous_engine_matches_jax_engine(k, n_layers):
    """Three slots for six requests, open-loop arrivals, staggered budgets
    (K 8 finishes rows mid-horizon and compacts the live rows; n_layers 2
    carries zero-size trailing leaves through the pool, the horizon's
    gather and scatter and the graphs). The recurrent prefill steps each
    prompt position through the shared block's K/V at that position; after
    the run the pool (shared-block K/V written through the horizon's
    gather and scatter, group state, trailing state) equals the JAX
    engine's. Serving never runs the scan."""
    calls = ssd.ssd_scan_plain.calls
    engine, jeng, out, st = _run_both(n_layers=n_layers, n_slots=3,
                                      decode_horizon=k)
    assert ssd.ssd_scan_plain.calls == calls
    assert st.prefill_dispatches == len(LENGTHS) and st.decode_rows_saved > 0
    assert len({t for r in out for t in r.output}) > 3
    if k == 8:
        assert st.decode_dispatches < st.steps
    assert ("recurrent_step",) in engine.graphs.keys
    for name, buf in engine.pool.buffers.items():
        _close(buf, jeng.pool.buffers[name], **PIECE)


def test_prefill_equals_the_decode_chain():
    """The engine's recurrent prefill leaves the cache and last logits of
    stepping ``decode_step`` by hand at positions 0, 1, ..., and of the
    JAX engine's prefill scan."""
    jcfg, cfg, jparams, tparams = _pair(5)
    engine = ServeEngine(cfg, params=tparams, device="cpu", max_len=32,
                         n_slots=2)
    prompt = np.random.default_rng(2).integers(1, 512, size=11).astype(
        np.int32)
    logits, row = engine._prefill(torch.from_numpy(prompt)[None, :])
    model = build_model(cfg)
    cache = model.init_cache(1, 32, device="cpu")
    for t in range(len(prompt)):
        want, cache = model.decode_step(
            tparams, cache, torch.from_numpy(prompt[None, t:t + 1]), t)
    torch.testing.assert_close(logits, want, atol=0, rtol=0)
    for name in cache:
        torch.testing.assert_close(row[name], cache[name], atol=0, rtol=0)
    jeng = JaxEngine(jcfg, params=jparams, cache="contiguous", max_len=32)
    jlogits, jrow = jeng._prefill_fn()(jeng.params,
                                       jnp.asarray(prompt)[None, :])
    _close(logits, jlogits)
    for name in cache:
        _close(row[name], jrow[name])


def test_paged_cache_is_refused():
    """As in the reference (``engine.py:363-367``)."""
    with pytest.raises(ValueError, match="attention family"):
        ServeEngine(get_config(ARCH, smoke=True), device="cpu",
                    cache="paged")
    with pytest.raises(ValueError, match="attention family"):
        JaxEngine(jax_config(ARCH, smoke=True), cache="paged")
    with pytest.raises(ValueError, match="no paged decode cache"):
        build_model(get_config(ARCH, smoke=True)).init_paged_cache(4, 4)


def test_cli_zamba2_contiguous_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--preset", "smoke", "--device", "cpu", "--engine", "continuous",
         "--batch", "4", "--slots", "2", "--prompt-len", "12", "--max-new",
         "6", "--max-len", "32", "--verify"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["arch"] == ARCH and rec["cache"] == "contiguous"
    assert rec["device"] == "cpu" and rec["n_requests"] == 4
    assert rec["new_tokens"] == 4 * 6 and rec["unfinished"] == 0
    assert rec["prefill_dispatches"] == 4 and rec["verified"] is True
