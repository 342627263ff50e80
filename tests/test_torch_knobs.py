"""The model knobs of the port against the JAX reference, on the CPU.

``ArchConfig``'s ``local_banded``, ``gqa_no_repeat``, ``decode_attention``
and ``use_pallas`` (``repro/configs/base.py:67-83``): the banded local
attention path (``repro/models/transformer.py:113-226``) and the grouped
GQA einsum (``repro/models/layers.py:209-238``) held to the reference's on
the same weights (``params_from_jax``) and numpy inputs; the decode-backend
check (``layers.py:279-296``); ``plan_attention_scheme``'s head count.
Tolerances: f32 atol = rtol = 1e-4 (``tests/test_torch_model.py``), the
gradients ``tests/test_torch_train.py``'s, bf16 2e-2 of the largest
|logit| (``BF16_TOL``). Shapes are the reference's
``tests/test_perf_knobs.py``'s. Each JAX run is made once a module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.dist import sharding as jshd
from repro.models import layers as JL
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.serve import ServeEngine
from repro_torch.train import optimizer as opt

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
#: bf16: the largest gap within this share of the largest |logit|, and the
#: argmax equal wherever the reference's top-2 margin exceeds it (the
#: card's gemma3 checks); elementwise, bf16's rounding of values near 0
#: parts the packages by a few ulps of the logits' scale
BF16_TOL = 2e-2
#: the reference's banded shape (test_perf_knobs.py:22-26)
BANDED = dict(n_layers=4, sliding_window=16, global_every=2, vocab_size=512)
KNOBS = {"local_banded": True, "gqa_no_repeat": True,
         "decode_attention": "paged", "use_pallas": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the models are small, and the suite runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _weights(arch: str, overrides: tuple = ()):
    """(jax cfg, jax params, port params) of ``arch``'s smoke variant with
    ``overrides`` (a tuple of items)."""
    jcfg = jax_config(arch, smoke=True).replace(**dict(overrides))
    jparams = jax_build(jcfg).init(jax.random.key(0))
    return jcfg, jparams, params_from_jax(_np(jparams), device="cpu")


def _tokens(vocab: int, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, vocab, size=(b, s)).astype(np.int32)


def _jax_forward(jcfg, jparams, tokens):
    """The reference's ``Model.forward`` on numpy ``tokens``, jitted."""
    fwd = jax.jit(jax_build(jcfg).forward)
    return np.asarray(fwd(jparams, {"tokens": jnp.asarray(tokens)})
                      .astype(jnp.float32))


def _port_cfg(jcfg, **kw):
    """The port's config of the same arch and overrides as ``jcfg``."""
    cfg = get_config(jcfg.arch_id, smoke=True)
    fields = {f: getattr(jcfg, f) for f in (
        "n_layers", "sliding_window", "global_every", "vocab_size", "dtype",
        "param_dtype", "local_banded", "gqa_no_repeat", "decode_attention")}
    return cfg.replace(**{**fields, **kw})


# ---------------------------------------------------------------------------
# the fields
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field", sorted(KNOBS))
def test_knob_fields_cross_get_config_and_smoke_variant(field):
    """Each field defaults as the reference's, passes through
    ``get_config``'s overrides and ``smoke_variant``, and ``replace``."""
    value = KNOBS[field]
    assert (getattr(get_config("gemma3-27b"), field)
            == getattr(jax_config("gemma3-27b"), field))
    got = get_config("gemma3-27b", smoke=True, **{field: value})
    want = jax_config("gemma3-27b", smoke=True, **{field: value})
    assert getattr(got, field) == getattr(want, field) == value
    full = get_config("gemma3-27b").replace(**{field: value})
    assert getattr(smoke_variant(full), field) == value
    assert getattr(jax_smoke_variant(
        jax_config("gemma3-27b").replace(**{field: value})), field) == value


# ---------------------------------------------------------------------------
# banded local attention
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _banded_runs():
    """The reference's banded and scanned logits at its test shape, and
    the port's, on one set of weights and tokens [2, 64]."""
    jcfg, jparams, tparams = _weights("gemma3-27b", tuple(BANDED.items()))
    tokens = _tokens(jcfg.vocab_size, 2, 64)
    jband = _jax_forward(jcfg.replace(local_banded=True), jparams, tokens)
    jscan = _jax_forward(jcfg, jparams, tokens)
    cfg = _port_cfg(jcfg)
    tb = {"tokens": _t(tokens)}
    band = build_model(cfg.replace(local_banded=True)).forward(tparams, tb)
    scan = build_model(cfg).forward(tparams, tb)
    return jband, jscan, band, scan


def test_banded_matches_jax_banded():
    jband, _, band, _ = _banded_runs()
    _close(band, jband)
    assert (band.argmax(-1).numpy() == jband.argmax(-1)).all()


def test_banded_matches_the_scanned_path():
    """The banded rewrite is the scanned function: the port's two paths
    agree as the reference's two do, and the port's scanned path is the
    reference's."""
    jband, jscan, band, scan = _banded_runs()
    _close(scan, jscan)
    _close(band, scan)


def test_banded_runs_the_banded_layers(monkeypatch):
    """4 layers, global every 2: two groups of one banded local layer and
    one global layer, so the banded attention runs twice; the global
    layers take the dense attention."""
    calls = []
    real = T._banded_attention
    monkeypatch.setattr(T, "_banded_attention",
                        lambda *a: calls.append(a[-1]) or real(*a))
    jcfg, _, tparams = _weights("gemma3-27b", tuple(BANDED.items()))
    cfg = _port_cfg(jcfg, local_banded=True)
    build_model(cfg).forward(
        tparams, {"tokens": _t(_tokens(jcfg.vocab_size, 1, 32))})
    assert calls == [16, 16]
    assert T._grouped_layout(get_config("gemma3-27b")) == (10, 6, 2)


def test_banded_falls_back_when_the_window_does_not_divide_s(monkeypatch):
    """S 64, window 24 (test_perf_knobs.py:29-38): the scanned path runs
    and gives the reference's logits."""
    over = dict(n_layers=2, sliding_window=24, global_every=2,
                vocab_size=512, local_banded=True)
    jcfg, jparams, tparams = _weights("gemma3-27b", tuple(over.items()))
    tokens = _tokens(jcfg.vocab_size, 1, 64, seed=0)
    monkeypatch.setattr(T, "forward_banded", None)      # must not be called
    out = build_model(_port_cfg(jcfg)).forward(tparams,
                                               {"tokens": _t(tokens)})
    assert bool(torch.isfinite(out).all())
    _close(out, _jax_forward(jcfg, jparams, tokens))


def test_banded_return_cache_raises():
    jcfg, _, tparams = _weights("gemma3-27b", tuple(BANDED.items()))
    cfg = _port_cfg(jcfg, local_banded=True)
    tokens = _t(_tokens(jcfg.vocab_size, 1, 32))
    with pytest.raises(NotImplementedError):
        T.forward(cfg, tparams, tokens, return_cache=True)
    # the scanned path (S not a multiple of the window) still returns it
    logits, (k, v) = T.forward(cfg, tparams, tokens[:, :24],
                               return_cache=True)
    assert k.shape[:3] == (cfg.n_layers, 1, 24)


#: the gradient check's shape: 5 layers, so two groups and one trailing
#: banded layer, which remat does not wrap
GRAD = dict(BANDED, n_layers=5)


@functools.lru_cache(maxsize=None)
def _jax_banded_grads():
    """The reference's banded loss and gradients, under its group remat
    (remat changes what the backward keeps, never a value)."""
    jcfg, jparams, _ = _weights("gemma3-27b", tuple(GRAD.items()))
    jcfg = jcfg.replace(local_banded=True, remat="full")
    rng = np.random.default_rng(3)
    batch = {k: jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 32))
                            .astype(np.int32)) for k in ("tokens", "labels")}
    loss, grads = jax.jit(jax.value_and_grad(jax_build(jcfg).loss))(
        jparams, batch)
    return jcfg, _np(batch), float(loss), _np(grads)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_banded_loss_gradients_match_jax(remat, monkeypatch):
    """``Model.loss``'s gradients through the banded path under remat
    against ``jax.value_and_grad`` of the reference's banded loss; remat
    wraps each
    group, so the backward recomputes the groups' banded layers (2) and
    not the trailing one."""
    jcfg, batch, jloss, jgrads = _jax_banded_grads()
    _, _, tparams = _weights("gemma3-27b", tuple(GRAD.items()))
    params = opt.tree_map(lambda p: p.clone().requires_grad_(True), tparams)
    calls = []
    real = T._banded_attention
    monkeypatch.setattr(T, "_banded_attention",
                        lambda *a: calls.append(1) or real(*a))
    cfg = _port_cfg(jcfg, remat=remat)
    loss = build_model(cfg).loss(params, {k: _t(v) for k, v in
                                          batch.items()})
    forward = len(calls)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    grads = params_to_jax(opt.tree_map(lambda p: p.grad, params))
    assert (jax.tree_util.tree_structure(grads)
            == jax.tree_util.tree_structure(jgrads))
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    assert (forward, len(calls) - forward) == (3, 2)


@pytest.mark.parametrize("banded", [False, True])
def test_bf16_gemma3_forward_matches_jax(banded):
    """bf16 weights and activations (the smoke widths, window 32, S 64):
    the port casts where the reference casts (its gap to the reference is
    bf16 rounding, ~0.4% of the largest |logit| here)."""
    over = (("dtype", "bfloat16"), ("param_dtype", "bfloat16"))
    jcfg, jparams, tparams = _weights("gemma3-27b", over)
    jcfg = jcfg.replace(local_banded=banded)
    assert tparams["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    tokens = _tokens(jcfg.vocab_size, 2, 64)
    ref = _jax_forward(jcfg, jparams, tokens)
    out = build_model(_port_cfg(jcfg)).forward(tparams,
                                               {"tokens": _t(tokens)})
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= BF16_TOL * scale
    top2 = np.sort(ref, axis=-1)[..., -2:]
    held = top2[..., 1] - top2[..., 0] > BF16_TOL * scale
    assert held.mean() > 0.9
    assert (out.argmax(-1) == ref.argmax(-1))[held].all()


# ---------------------------------------------------------------------------
# no-repeat GQA
# ---------------------------------------------------------------------------
GQA_ARCH = "llama3.2-1b"              # smoke: 4 q heads, 2 kv heads (G 2)


def _gqa_forward(jcfg, jparams, tparams):
    tokens = _tokens(jcfg.vocab_size, 2, 32)
    out = build_model(_port_cfg(jcfg)).forward(tparams,
                                               {"tokens": _t(tokens)})
    return [(out, _jax_forward(jcfg, jparams, tokens))]


def _gqa_decode(jcfg, jparams, tparams):
    """Four contiguous decode steps at per-row positions, the first row
    frozen at step 2 (write_valid)."""
    jm, tm = jax_build(jcfg), build_model(_port_cfg(jcfg))
    jcache, tcache = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    tok = _tokens(jcfg.vocab_size, 2, 1, seed=5)
    pos = np.array([0, 3], np.int32)
    pairs = []
    for step in range(4):
        wv = np.array([step != 2, True])
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos),
                                    write_valid=jnp.asarray(wv))
        tl, tcache = tm.decode_step(tparams, tcache, _t(tok), _t(pos),
                                    write_valid=_t(wv))
        pairs.append((tl, jl))
        tok = np.asarray(jl[:, -1]).argmax(-1)[:, None].astype(np.int32)
        pos += 1
    return pairs + [(tcache["k"], jcache["k"])]


def _gqa_paged(jcfg, jparams, tparams):
    """Two chained prefill chunks of two prompts through scattered
    tables, then three decode steps: the paged backend's plain path."""
    jcfg = jcfg.replace(decode_attention="paged")
    jm, tm = jax_build(jcfg), build_model(_port_cfg(jcfg))
    bs, nb = 8, 8
    tables = np.array([[5, 2, 7], [1, 6, -1]], np.int32)
    jcache, tcache = (jm.init_paged_cache(nb, bs),
                      tm.init_paged_cache(nb, bs, device="cpu"))
    prompts = _tokens(jcfg.vocab_size, 2, 16, seed=2)
    nv = np.array([8, 8], np.int32)
    pairs = []
    for r in range(2):
        start = np.full((2,), r * bs, np.int32)
        chunk = prompts[:, r * bs:(r + 1) * bs]
        jl, jcache, _ = jm.paged_prefill_chunk(
            jparams, jcache, jnp.asarray(chunk), jnp.asarray(start),
            jnp.asarray(tables), n_valid=jnp.asarray(nv))
        tl, tcache, _ = tm.paged_prefill_chunk(
            tparams, tcache, _t(chunk), _t(start), _t(tables),
            n_valid=_t(nv))
        pairs.append((tl, jl))
    tok = np.asarray(jl[:, -1]).argmax(-1)[:, None].astype(np.int32)
    pos = np.array([16, 16], np.int32)
    for _ in range(3):
        jl, jcache = jm.paged_decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos),
                                          jnp.asarray(tables))
        tl, tcache = tm.paged_decode_step(tparams, tcache, _t(tok), _t(pos),
                                          _t(tables))
        pairs.append((tl, jl))
        tok = np.asarray(jl[:, -1]).argmax(-1)[:, None].astype(np.int32)
        pos += 1
    return pairs + [(tcache["k"], jcache["k"])]


GQA_PATHS = {"forward": _gqa_forward, "contiguous decode": _gqa_decode,
             "paged": _gqa_paged}


@pytest.mark.parametrize("no_repeat", [False, True])
@pytest.mark.parametrize("path", sorted(GQA_PATHS))
def test_gqa_no_repeat_matches_jax(path, no_repeat):
    """The forward, the contiguous decode chain and the paged chunks and
    decode steps with the knob on and off, each against the reference's
    with the same knob, on one set of weights."""
    jcfg, jparams, tparams = _weights(GQA_ARCH)
    jcfg = jcfg.replace(gqa_no_repeat=no_repeat)
    for got, want in GQA_PATHS[path](jcfg, jparams, tparams):
        _close(got, want)


def test_mha_no_repeat_is_the_repeated_function(monkeypatch):
    """``mha``'s grouped contraction against the repeated one and the
    reference's, with a 2-d causal mask, a 4-d per-row decode mask and
    none; the grouped path never repeats the KV heads."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
            for _ in range(2))
    causal = np.tril(np.ones((5, 7), bool), 2)
    rows = rng.random((2, 1, 1, 7)) < 0.7
    rows[..., 0] = True
    for mask in (None, causal, rows):
        tm = None if mask is None else _t(mask)
        jm = None if mask is None else jnp.asarray(mask)
        grouped = L.mha(_t(q), _t(k), _t(v), tm, no_repeat=True)
        _close(grouped, L.mha(_t(q), _t(k), _t(v), tm))
        _close(grouped, JL.mha(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jm, no_repeat=True))
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", None)
    L.mha(_t(q), _t(k), _t(v), _t(rows), no_repeat=True)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-27b", "llama3.2-1b"])
def test_plan_attention_scheme_heads_under_the_knob(arch):
    """The scheme of one layer call under one rules table, knob on and off,
    against the reference's: under the knob it is planned on the KV heads
    (qwen2 14/2, gemma3 32/16, llama 32/8 at full width)."""
    table = shd.production_rules_table(False)
    mesh_shape, names = (2, 4), ("data", "model")
    with shd.axis_rules(shd.Mesh(mesh_shape, names), table), \
            jshd.axis_rules(jax.make_mesh(mesh_shape, names), table):
        for no_repeat in (False, True):
            cfg = get_config(arch, gqa_no_repeat=no_repeat)
            jcfg = jax_config(arch, gqa_no_repeat=no_repeat)
            for b, s, kv_len in ((8, 1, 4096), (1, 512, 512), (2, 64, 64)):
                got = L.plan_attention_scheme(cfg, b, s, kv_len)
                want = JL.plan_attention_scheme(jcfg, b, s, kv_len)
                assert got == {k: tuple(v) for k, v in want.items()}, (
                    arch, no_repeat, b, s, kv_len)
        cfg = get_config(arch, gqa_no_repeat=True)
        assert (L.plan_attention_scheme(cfg, 8, 1, 64)
                == shd.attention_scheme(8, 1, cfg.n_kv_heads, 64))


# ---------------------------------------------------------------------------
# the decode-backend check
# ---------------------------------------------------------------------------
def _pools(b: int = 1):
    k = torch.zeros((3, 4, 2, 64))
    return L.PagedKV(k, k.clone(), torch.zeros((b, 2), dtype=torch.int32))


def _jax_pools():
    k = jnp.zeros((2, 4, 2, 64))
    return JL.PagedKV(k, k, jnp.zeros((1, 2), jnp.int32))


RAISES = {
    "unknown backend": (dict(decode_attention="ring"), None, None),
    "paged cache, contiguous cfg": (dict(), _pools, _jax_pools),
    "contiguous cache, paged cfg": (
        dict(decode_attention="paged"),
        lambda: (torch.zeros((1, 8, 2, 64)),) * 2,
        lambda: (jnp.zeros((1, 8, 2, 64)),) * 2),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_plan_decode_backend_raises(case):
    """Each of the reference's three raises, in the port and in the
    reference; the layer call raises before it computes."""
    over, port_cache, jax_cache = RAISES[case]
    cfg = get_config("qwen2-0.5b", smoke=True, **over)
    jcfg = jax_config("qwen2-0.5b", smoke=True, **over)
    with pytest.raises(ValueError):
        L.plan_decode_backend(cfg, port_cache and port_cache())
    with pytest.raises(ValueError):
        JL.plan_decode_backend(jcfg, jax_cache and jax_cache())
    _, _, tparams = _weights("qwen2-0.5b")
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError):
        L.attention(tparams["layers"][0]["attn"], cfg, x,
                    torch.zeros((1, 1), dtype=torch.int32),
                    kv_cache=port_cache and port_cache(), cache_pos=0)
    assert L.plan_decode_backend(get_config("qwen2-0.5b"), None) == \
        "contiguous"


def test_paged_engine_runs_on_a_paged_cfg():
    """The paged engine's model and every layer it calls carry
    ``decode_attention="paged"`` (``repro/serve/engine.py:363-368``); the
    contiguous engine keeps the caller's cfg."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    paged = ServeEngine(cfg, max_len=32, n_slots=2, cache="paged",
                        block_size=8, device="cpu")
    assert paged.cfg.decode_attention == "paged"
    assert paged.model.cfg.decode_attention == "paged"
    contiguous = ServeEngine(cfg, params=paged.params, max_len=32,
                             n_slots=2, device="cpu")
    assert contiguous.cfg is cfg
