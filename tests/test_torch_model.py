"""The port's dense model (repro_torch.models) against the JAX reference.

Weights go JAX ``init`` -> numpy -> ``params_from_jax``; inputs are made
with numpy from a seed and fed to both packages, on the CPU. Tolerance:
float32 on both sides, atol = rtol = 1e-4 — XLA and ATen sum in different
orders (and the port attends through the kernels' plain versions, which
normalise once at the end where the reference's ``mha`` runs a softmax),
so the logits drift by a few 1e-6 over two layers; 1e-4 leaves margin
without hiding a wrong mask or position. Greedy argmax must be equal.
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
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ("qwen2-0.5b", "llama3.2-1b", "gemma3-27b")   # gemma3: window 32
TOL = dict(atol=1e-4, rtol=1e-4)
BS, MB, NB = 8, 6, 16
LENGTHS = (37, 21)
#: scattered block homes per lane (lane 0 grows into block 12 at decode)
TABLES = np.array([[9, 2, 14, 5, 0, 12], [3, 11, 7, -1, -1, -1]], np.int32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jax_config(arch, smoke=True).replace(decode_attention="paged")
    jparams = jax_build(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tparams


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENGTHS]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_shapes_and_scales(arch):
    """The port's own init draws every leaf with the reference's shape,
    dtype and scale (a normal at 1/sqrt(fan_in), d^-0.5 for tied
    embeddings; zero biases and norms). The bits differ; the std of every
    leaf of >= 64k values lies within 5% of the reference's."""
    _, _, converted = _pair(arch)
    mine = build_model(get_config(arch, smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    ref, got = dict(_flat(converted)), dict(_flat(mine))
    assert ref.keys() == got.keys()
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if float(r.abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0, name
        else:
            ratio = float(g.std()) / float(r.std())
            assert abs(ratio - 1.0) < 0.05, (name, ratio)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jparams, tparams = _pair(arch)
    tokens = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    ref = jax_build(jcfg).forward(jparams, {"tokens": jnp.asarray(tokens)})
    out = build_model(get_config(arch, smoke=True)).forward(
        tparams, {"tokens": torch.from_numpy(tokens)})
    _close(out, ref)
    assert (out.argmax(-1).numpy() == np.asarray(ref).argmax(-1)).all()


def _chunk_rounds(prompts):
    """Lane-batched chunk rounds over both prompts: (tokens, start,
    n_valid, tables) per round; a finished lane is a padding lane."""
    rounds = -(-max(len(p) for p in prompts) // BS)
    for r in range(rounds):
        tok = np.zeros((len(prompts), BS), np.int32)
        start = np.zeros((len(prompts),), np.int32)
        nv = np.zeros((len(prompts),), np.int32)
        tables = np.full_like(TABLES, -1)
        for i, p in enumerate(prompts):
            n = min(BS, len(p) - r * BS)
            if n > 0:
                tok[i, :n] = p[r * BS:r * BS + n]
                start[i], nv[i], tables[i] = r * BS, n, TABLES[i]
        yield tok, start, nv, tables


def _prefill_both(arch):
    """Chain the chunk rounds through the JAX and the port paged caches.
    Returns (jax cache, port cache, per-lane final logits of each)."""
    jcfg, jparams, tparams = _pair(arch)
    jm = jax_build(jcfg)
    tm = build_model(get_config(arch, smoke=True, decode_attention="paged"))
    jcache = jm.init_paged_cache(NB, BS)
    tcache = tm.init_paged_cache(NB, BS, device="cpu")
    prompts = _prompts(jcfg.vocab_size)
    jlast, tlast = {}, {}
    for tok, start, nv, tables in _chunk_rounds(prompts):
        jl, jcache, _ = jm.paged_prefill_chunk(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(start),
            jnp.asarray(tables), n_valid=jnp.asarray(nv))
        tl, tcache, _ = tm.paged_prefill_chunk(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(start),
            torch.from_numpy(tables), n_valid=torch.from_numpy(nv))
        for i, p in enumerate(prompts):
            if nv[i] > 0:
                _close(tl[i], jl[i])
                if start[i] + nv[i] == len(p):
                    jlast[i], tlast[i] = np.asarray(jl[i, 0]), tl[i, 0]
    return jcache, tcache, jlast, tlast, prompts


@pytest.mark.parametrize("arch", ARCHS)
def test_chained_paged_prefill_matches_jax_and_one_pass(arch):
    jcache, tcache, jlast, tlast, prompts = _prefill_both(arch)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    _, _, tparams = _pair(arch)
    tm = build_model(get_config(arch, smoke=True))
    for i, p in enumerate(prompts):
        one_pass = tm.forward(tparams, {"tokens": torch.from_numpy(p[None])})
        _close(tlast[i], one_pass[0, -1])
        _close(tlast[i], jlast[i])
        assert int(tlast[i].argmax()) == int(jlast[i].argmax())


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_steps_match_jax(arch):
    """Four decode steps over the prefilled scattered tables plus an
    all--1 padding row; step 2 masks lane 1's KV write."""
    jcfg, jparams, tparams = _pair(arch)
    jm = jax_build(jcfg)
    tm = build_model(get_config(arch, smoke=True, decode_attention="paged"))
    jcache, tcache, jlast, _, prompts = _prefill_both(arch)
    tables = np.concatenate([TABLES, np.full((1, MB), -1, np.int32)])
    tok = np.array([[int(jlast[0].argmax())], [int(jlast[1].argmax())], [0]],
                   np.int32)
    pos = np.array([len(p) for p in prompts] + [0], np.int32)
    for step in range(4):
        wv = np.array([True, step != 2, True])
        jl, jcache = jm.paged_decode_step(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(tables), write_valid=jnp.asarray(wv))
        tl, tcache = tm.paged_decode_step(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(tables), write_valid=torch.from_numpy(wv))
        _close(tl[:2], jl[:2])                 # row 2 is padding garbage
        nxt = np.asarray(jl[:2, -1]).argmax(-1)
        assert (tl[:2, -1].argmax(-1).numpy() == nxt).all()
        tok[:2, 0] = nxt
        pos[:2] += 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
