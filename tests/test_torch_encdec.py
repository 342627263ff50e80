"""The port's encoder-decoder family (repro_torch.models.encdec) and its
contiguous serving against the JAX package, on the CPU, at
whisper-large-v3's smoke shape (2 encoder and 2 decoder layers, d_model
256, 4 heads of 64 with QKV bias, sinusoidal positions, 64 frames).

Weights go JAX ``init`` -> numpy -> ``params_from_jax``; inputs are made
with numpy from a seed and fed to both packages. The JAX decoder's causal
self-attention runs plain ``mha`` and, with ``use_pallas``, its Pallas
flash kernel in interpret mode; the port runs ``ops.flash_attention``'s
plain version. Decoder length 37 is not a multiple of 8 (the JAX wrapper
pads it), 64 is. Tolerance 2e-3 on logits and losses and 1e-4 on the
pieces (``tests/test_torch_mamba2.py``'s); the engines token for token,
with the host-side counters exactly equal. The engines serve text only:
neither runs the encoder, so the cross K/V stay zero in both.
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
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro.serve.cache import CachePool as JaxCachePool
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import encdec, layers
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import CachePool, ServeEngine, ServeRequest

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-large-v3"
TOL = dict(atol=2e-3, rtol=2e-3)
PIECE = dict(atol=1e-4, rtol=1e-4)
#: the engine's request set: prompt lengths, arrivals on the decode-step
#: clock, budgets
LENGTHS, ARRIVALS, BUDGETS = [5, 9, 7, 9, 6, 5], [0, 0, 1, 2, 4, 5], \
    [6, 3, 8, 5, 2, 7]


@functools.lru_cache(maxsize=None)
def _numpy_params():
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_build(jax_config(ARCH, smoke=True)).init)(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _pair():
    npp = _numpy_params()
    return (jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True),
            jax.tree_util.tree_map(jnp.asarray, npp),
            params_from_jax(npp, device="cpu"))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, 512, size=(b, s)).astype(np.int32)


def _frames(b, seed, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# config, init
# ---------------------------------------------------------------------------
def test_config_and_registry():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_config(ARCH, smoke=True)
    full, jfull = get_config(ARCH), jax_config(ARCH)
    for f in ("family", "n_layers", "n_enc_layers", "enc_seq", "d_model",
              "n_heads", "n_kv_heads", "resolved_head_dim", "d_ff",
              "vocab_size", "qkv_bias", "pos_emb", "tie_embeddings",
              "norm_eps", "dtype", "param_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(full, f) == getattr(jfull, f), f
    assert (full.n_layers, full.n_enc_layers, full.d_model, full.n_heads,
            full.resolved_head_dim, full.vocab_size, full.enc_seq) == \
        (32, 32, 1280, 20, 64, 51866, 1500)
    assert (cfg.n_enc_layers, cfg.enc_seq) == (2, 64)
    assert build_model(cfg).module is encdec


def test_init_leaves_match_jax():
    """Every leaf of every encoder and decoder layer has the reference's
    shape and dtype; the random ones have its scale."""
    _, cfg, jparams, _ = _pair()
    port = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    for stack, n in (("enc_layers", cfg.n_enc_layers),
                     ("dec_layers", cfg.n_layers)):
        assert len(port[stack]) == n
        for path, jleaf in jax.tree_util.tree_flatten_with_path(
                jparams[stack])[0]:
            for i in range(n):
                t = port[stack][i]
                for key in path:
                    t = t[key.key]
                assert tuple(t.shape) == jleaf.shape[1:], (stack, path)
                assert str(t.dtype).split(".")[1] == str(jleaf.dtype), path
    for name in ("enc_norm", "dec_norm"):
        assert port[name].shape == jparams[name].shape
    assert port["emb"]["lm_head"].shape == jparams["emb"]["lm_head"].shape
    std = port["dec_layers"][0]["cross_attn"]["wq"].std().item()
    assert abs(std / cfg.d_model ** -0.5 - 1) < 0.05


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
def test_sinusoids_match_jax():
    """The table, and its rows at arbitrary positions (the decode step's),
    are the reference's (XLA's and ATen's f32 sin and cos part by up to
    ~1.5e-5 at angles of a few hundred radians), and a row is the table's
    row bit for bit."""
    table = layers.sinusoidal_pos_emb(448, 256)
    _close(table, jlayers.sinusoidal_pos_emb(448, 256), **PIECE)
    pos = torch.tensor([[0], [17], [447]])
    rows = layers.sinusoid_at(pos, 256)[:, 0]
    _close(rows, np.asarray(jlayers.sinusoidal_pos_emb(448, 256))[
        [0, 17, 447]], **PIECE)
    torch.testing.assert_close(rows, table[[0, 17, 447]], atol=0, rtol=0)


def test_encode_and_prefill_cross_kv_match_jax():
    """The non-causal encoder (plain mha) and the cross K/V it fills."""
    jcfg, cfg, jparams, tparams = _pair()
    frames = _frames(2, 1, cfg)
    enc = encdec.encode(cfg, tparams, torch.from_numpy(frames))
    _close(enc, jax.jit(functools.partial(jed.encode, jcfg))(
        jparams, jnp.asarray(frames)), **PIECE)
    model, jmodel = build_model(cfg), jax_build(jcfg)
    cache = encdec.prefill_cross_kv(cfg, tparams, torch.from_numpy(frames),
                                    model.init_cache(2, 16, device="cpu"))
    jcache = jax.jit(functools.partial(jed.prefill_cross_kv, jcfg))(
        jparams, jnp.asarray(frames), jmodel.init_cache(2, 16))
    for name in ("ck", "cv"):
        assert cache[name].abs().max() > 0
        _close(cache[name], jcache[name], **PIECE)
    assert not cache["k"].any() and not cache["v"].any()


def test_decoder_layer_matches_jax():
    """One decoder layer at S 37: causal self-attention (no cache), cross
    attention over K/V made from an encoder output, MLP."""
    jcfg, cfg, jparams, tparams = _pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(37)[None], (2, 37)).copy()
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["dec_layers"])
    jout, _ = jax.jit(lambda p, x, pos, e: jed._dec_layer(
        jcfg, p, x, pos, enc_out=e))(jp, jnp.asarray(x), jnp.asarray(pos),
                                     jnp.asarray(enc))
    out, _ = encdec._dec_layer(cfg, tparams["dec_layers"][1],
                               torch.from_numpy(x), torch.from_numpy(pos),
                               enc_out=torch.from_numpy(enc))
    _close(out, jout, **PIECE)


# ---------------------------------------------------------------------------
# forward, loss, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("s", [37, 64])
def test_forward_and_loss_match_jax(s, pallas):
    """Decoder lengths 37 (not a multiple of 8) and 64; the port's decoder
    self-attention runs the flash wrapper (its plain version here) once a
    layer a call."""
    jcfg, cfg, jparams, tparams = _pair()
    jmodel = jax_build(jcfg.replace(use_pallas=pallas))
    model = build_model(cfg)
    batch = {"tokens": _tokens(2, s, 3), "labels": _tokens(2, s, 4),
             "frames": _frames(2, 5, cfg)}
    mask = (np.random.default_rng(5).random((2, s)) < 0.7).astype(np.float32)
    jlogits, jloss, jmasked = jax.jit(lambda p, b, m: (
        jmodel.forward(p, b), jmodel.loss(p, b),
        jmodel.loss(p, dict(b, loss_mask=m))))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(mask))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = fa.flash_attention_plain.calls
    logits = model.forward(tparams, tb)
    assert fa.flash_attention_plain.calls - calls == cfg.n_layers
    assert logits.shape == (2, s, 512) and logits.dtype == torch.float32
    _close(logits, jlogits)
    loss = model.loss(tparams, tb)
    assert loss.dim() == 0
    _close(loss.item(), float(jloss))
    _close(model.loss(tparams, dict(tb, loss_mask=torch.from_numpy(mask)))
           .item(), float(jmasked))


def test_decode_chain_matches_forward_prefix():
    """``prefill_cross_kv``, then decode over the same tokens: the
    forward's logits at every position, the JAX decode chain's logits, and
    its cache."""
    jcfg, cfg, jparams, tparams = _pair()
    model, jmodel = build_model(cfg), jax_build(jcfg)
    toks, frames = _tokens(2, 19, 6), _frames(2, 7, cfg)
    full = model.forward(tparams, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(frames)})
    cache = model.init_cache(2, 19, device="cpu")
    cache = encdec.prefill_cross_kv(cfg, tparams, torch.from_numpy(frames),
                                    cache)
    jcache = jax.jit(functools.partial(jed.prefill_cross_kv, jcfg))(
        jparams, jnp.asarray(frames), jmodel.init_cache(2, 19))
    jstep = jax.jit(jmodel.decode_step)
    for t in range(19):
        logits, cache = model.decode_step(
            tparams, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        _close(logits[:, 0], full[:, t])
        _close(logits, jlogits)
    for name in jcache:
        _close(cache[name], jcache[name])


def test_per_row_positions_match_jax():
    """Per-row int32 [B] positions: each row's own sinusoid and K/V slot,
    against the JAX decode step, from a cache the rows filled at different
    depths."""
    jcfg, cfg, jparams, tparams = _pair()
    model, jmodel = build_model(cfg), jax_build(jcfg)
    rng = np.random.default_rng(8)
    init = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
            for k, v in model.init_cache(3, 16, device="meta").items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    jcache = {k: jnp.asarray(v.copy()) for k, v in init.items()}
    tok, pos = _tokens(3, 1, 9), np.array([3, 15, 0], np.int32)
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
def test_cache_and_pool_match_reference():
    """The reference's keys, shapes and dtypes, the pool's batch axes (1
    for the cross K/V too) and its slot writes."""
    jcfg, cfg, _, _ = _pair()
    jm, tm = jax_build(jcfg), build_model(cfg)
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16, device="cpu")
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv"}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype), name
    assert tc["ck"].shape[2] == cfg.enc_seq
    ref = JaxCachePool(jm, n_slots=3, max_len=16)
    port = CachePool(tm, n_slots=3, max_len=16, device="cpu")
    assert dict(ref.batch_axes) == port.batch_axes == {
        "k": 1, "v": 1, "ck": 1, "cv": 1}
    rng = np.random.default_rng(1)
    for _ in range(2):
        a, b = ref.alloc(), port.alloc()
        assert a == b
        row = {n: rng.standard_normal(
            (v.shape[0], 1) + tuple(v.shape[2:])).astype(np.float32)
            for n, v in port.buffers.items()}
        ref.write(a, {n: jnp.asarray(r) for n, r in row.items()})
        port.write(b, {n: torch.from_numpy(r) for n, r in row.items()})
    for name in port.buffers:
        np.testing.assert_array_equal(np.asarray(ref.buffers[name]),
                                      port.buffers[name].numpy())


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _requests(cls):
    rng = np.random.default_rng(13)
    return [cls(rng.integers(1, 512, size=n).astype(np.int32),
                max_new_tokens=b, arrival_time=float(a))
            for n, a, b in zip(LENGTHS, ARRIVALS, BUDGETS)]


@pytest.mark.parametrize("k", [1, 8])
def test_continuous_engine_matches_jax_engine(k):
    """Three slots for six requests, open-loop arrivals, staggered budgets
    (K 8 finishes rows mid-horizon and compacts the live rows): tokens and
    counters exactly the JAX engine's, and the pool after the run too
    (self-attention K/V written at each prompt position by the recurrent
    prefill and through the horizon's gather and scatter; the cross K/V
    still zero). Serving never runs flash: the prefill steps the decoder."""
    jcfg, cfg, jparams, tparams = _pair()
    kw = dict(n_slots=3, decode_horizon=k, max_len=32)
    jeng = JaxEngine(jcfg, params=jparams, cache="contiguous", **kw)
    ref, rst = jeng.run(_requests(JaxRequest))
    calls = fa.flash_attention_plain.calls
    engine = ServeEngine(cfg, params=tparams, device="cpu", **kw)
    out, st = engine.run(_requests(ServeRequest))
    assert fa.flash_attention_plain.calls == calls
    assert [r.output for r in out] == [r.output for r in ref]
    for name in ("prefill_dispatches", "decode_dispatches", "host_syncs",
                 "decode_rows_saved", "steps", "new_tokens", "max_active",
                 "slot_utilization", "mean_occupancy", "max_occupancy",
                 "unfinished"):
        assert getattr(st, name) == getattr(rst, name), name
    assert [r.finished_at for r in out] == [r.finished_at for r in ref]
    assert st.prefill_dispatches == len(LENGTHS) and st.decode_rows_saved > 0
    assert len({t for r in out for t in r.output}) > 3
    if k == 8:
        assert st.decode_dispatches < st.steps
    for name, buf in engine.pool.buffers.items():
        _close(buf, jeng.pool.buffers[name], **PIECE)
    assert not engine.pool.buffers["ck"].any()


def test_prefill_equals_the_decode_chain():
    """The engine's recurrent prefill leaves the cache and last logits of
    stepping ``decode_step`` by hand at positions 0, 1, ..., and of the
    JAX engine's prefill scan."""
    jcfg, cfg, jparams, tparams = _pair()
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


def test_cli_whisper_contiguous_on_cpu():
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
