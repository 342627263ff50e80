"""The port's VLM family (phi-3-vision-4.2b: the dense transformer with a
stub vision frontend) against the JAX package, on the CPU, at its smoke
shape (2 layers, 4 heads of 64, 16 patches).

``forward`` with precomputed patch embeddings over the first ``n_patches``
positions, its ``return_cache`` K/V, and serving (text-only, as in the
reference) on the paged and the contiguous engines, token for token and
counter for counter against the JAX engine, prefix-cache hits included;
the CLI's ``--verify``. Weights: the JAX init via numpy. Tolerance
atol = rtol = 1e-4 (tests/test_torch_model.py's).
"""
import dataclasses
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
from repro.models import transformer as jtransformer
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine, ServeRequest, ServeStats

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "phi-3-vision-4.2b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
TIMES = {"wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
         "decode_s"}
COUNTERS = [f.name for f in dataclasses.fields(ServeStats)
            if f.name not in TIMES]


@functools.lru_cache(maxsize=None)
def _numpy_params():
    return jax.tree_util.tree_map(
        np.asarray, jax_build(jax_config(ARCH, smoke=True)).init(
            jax.random.key(0)))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _inputs(b, s, seed=4):
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return toks, patches


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_the_reference(smoke):
    cfg, jcfg = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    assert ARCH in ARCH_IDS
    for f in ("family", "citation", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "rope_theta",
              "n_patches", "tie_embeddings", "qkv_bias", "norm_eps",
              "moe_gather_dispatch"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if not smoke:
        assert (cfg.resolved_head_dim, cfg.n_patches) == (96, 576)


@pytest.mark.parametrize("patches", [True, False], ids=["patches", "text"])
def test_forward_matches_jax(patches):
    """Model.forward with (or without) patch embeddings, and forward's
    return_cache K/V, equal the JAX package's."""
    toks, pe = _inputs(2, 40)
    jm = jax_build(jax_config(ARCH, smoke=True))
    jp = jax.tree_util.tree_map(jnp.asarray, _numpy_params())
    tp = params_from_jax(_numpy_params(), device="cpu")
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if patches:
        jbatch["patch_embeds"] = jnp.asarray(pe)
        tbatch["patch_embeds"] = torch.from_numpy(pe)
    cfg = get_config(ARCH, smoke=True)
    logits = build_model(cfg).forward(tp, tbatch)
    assert logits.shape == (2, 40, cfg.vocab_size)
    _close(logits, jm.forward(jp, jbatch))
    jl, jcache = jtransformer.forward(
        jm.cfg, jp, jbatch["tokens"], patch_embeds=jbatch.get("patch_embeds"),
        return_cache=True)
    tl, (k, v) = transformer.forward(
        cfg, tp, tbatch["tokens"], patch_embeds=tbatch.get("patch_embeds"),
        return_cache=True)
    _close(tl, jl)
    _close(k, jcache[0])
    _close(v, jcache[1])


def test_patch_embeddings_replace_the_prefix():
    """The logits depend on the patch embeddings and not on the tokens under
    them; the VLM forward attends through the flash kernel's route (its
    plain version on the CPU) in every layer, the dense forward does not."""
    cfg = get_config(ARCH, smoke=True)
    tp = params_from_jax(_numpy_params(), device="cpu")
    model = build_model(cfg)
    toks, pe = _inputs(1, 24)
    base = {"tokens": torch.from_numpy(toks),
            "patch_embeds": torch.from_numpy(pe)}
    calls = fa.flash_attention_plain.calls
    ref = model.forward(tp, base)
    assert fa.flash_attention_plain.calls == calls + cfg.n_layers
    other = toks.copy()
    other[:, :cfg.n_patches] = (other[:, :cfg.n_patches] + 7) % \
        cfg.vocab_size
    same = model.forward(tp, {**base, "tokens": torch.from_numpy(other)})
    torch.testing.assert_close(same, ref, atol=0, rtol=0)
    moved = model.forward(tp, {**base,
                               "patch_embeds": torch.from_numpy(pe * 2)})
    assert (moved - ref).abs().max() > 1e-3
    dense = get_config("qwen2-0.5b", smoke=True)
    calls = fa.flash_attention_plain.calls
    build_model(dense).forward(
        build_model(dense).init(torch.Generator().manual_seed(0),
                                device="cpu"),
        {"tokens": torch.from_numpy(toks)})
    assert fa.flash_attention_plain.calls == calls


def _requests(cls, common_len=12):
    """Six requests, the first four sharing a 12-token prefix (three full
    blocks of 4), arriving over the decode clock."""
    rng = np.random.default_rng(21)
    common = rng.integers(1, 512, size=common_len).astype(np.int32)
    reqs = []
    for i, (n, a, b) in enumerate(zip([3, 6, 2, 9, 11, 5], [0, 0, 1, 1, 3, 4],
                                      [5, 3, 6, 4, 2, 5])):
        tail = rng.integers(1, 512, size=n).astype(np.int32)
        reqs.append(cls(np.concatenate([common, tail]) if i < 4 else
                        np.concatenate([tail, tail]),
                        max_new_tokens=b, arrival_time=float(a)))
    return reqs


@pytest.mark.parametrize("cache", ["paged", "contiguous"])
def test_engine_matches_jax_engine(cache):
    """Greedy tokens and every ServeStats counter equal the JAX engine's;
    on the paged cache the shared prefix hits."""
    kw = dict(max_len=40, n_slots=3, decode_horizon=4, cache=cache)
    if cache == "paged":
        kw.update(block_size=4, prefill_lanes=2)
    jp = jax.tree_util.tree_map(jnp.asarray, _numpy_params())
    ref, rst = JaxEngine(jax_config(ARCH, smoke=True), params=jp,
                         **kw).run(_requests(JaxRequest))
    out, st = ServeEngine(get_config(ARCH, smoke=True),
                          params=params_from_jax(_numpy_params(),
                                                 device="cpu"),
                          device="cpu", **kw).run(_requests(ServeRequest))
    assert [r.output for r in out] == [r.output for r in ref]
    assert len({t for r in out for t in r.output}) > 3
    for name in COUNTERS:
        want = getattr(rst, name)
        got = getattr(st, name)
        if name == "block_report" and want is not None:
            want = {k: want[k] for k in got}   # the reference's A8 extras
        assert got == want, name
    if cache == "paged":
        assert st.prefix_blocks_hit > 0


def test_cli_verify_on_the_paged_cache():
    """``--verify`` re-serves on a static contiguous engine and agrees."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--preset", "smoke", "--device", "cpu", "--engine", "continuous",
         "--cache", "paged", "--batch", "4", "--slots", "2",
         "--prompt-len", "12", "--shared-prefix", "16", "--max-len", "48",
         "--max-new", "6", "--verify"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["arch"] == ARCH and rec["verified"] is True
    assert rec["new_tokens"] == 4 * 6 and rec["prefix_hit_rate"] > 0
