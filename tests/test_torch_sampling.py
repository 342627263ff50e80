"""Sampled decoding in the port (``repro_torch/serve/sampling.py`` and the
engine's use of it), on the CPU, and the serving CLI's ``--verify``.

Torch cannot reproduce JAX's RNG streams, so the sampled path is held to
properties, not to the reference's tokens (ROADMAP C): the hash's bits
equal a plain-int version's, seeded runs repeat, ``top_k=1`` is greedy, a
high temperature is not, ``decode_horizon`` 1, 2 and 8 give the same tokens
on both cache backends, a row's draw ignores the other rows' logits, and
20 000 draws from fixed logits follow ``softmax(logits / T)`` within a
total-variation distance of 0.02 (never leaving the top k under
``top_k``). The engine tests draw the port's own weights from seed 0 and
scale qwen2's layer matrices by 3, so greedy decoding does not repeat one
token.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serve import ServeEngine, ServeRequest, sampling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b"
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the pick function
# ---------------------------------------------------------------------------
def _fmix_int(h: int) -> int:
    """murmur3's 32-bit finalizer on Python ints (no overflow to mask)."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _hash_int(seed: int, step: int, lane: int, v: int) -> int:
    h = 0
    for x in (seed, step, lane, v):
        h = _fmix_int(((h ^ (x & M32)) + 0x9E3779B9) & M32)
    return h


def test_noise_bits_equal_the_plain_int_hash():
    """The int64-held 32-bit arithmetic gives the plain-int hash's bits,
    for negative (prefill, ``~step``) and large steps and lanes alike."""
    lanes = torch.tensor([0, 1, 7, 2 ** 31 - 1])
    for seed, step in ((0, 0), (7, 12), (3, ~5), (2 ** 32 - 1, 2 ** 31 - 1)):
        got = sampling.gumbel(seed, torch.tensor(step), lanes, 6)
        for i, lane in enumerate(lanes.tolist()):
            for v in range(6):
                u = ((_hash_int(seed, step, lane, v) >> 8) + 0.5) * 2.0 ** -24
                assert got[i, v].item() == -np.log(-np.log(u))
        assert torch.equal(got, sampling.gumbel(seed, step, lanes, 6))


def test_greedy_is_argmax():
    logits = torch.randn(5, 33, generator=torch.Generator().manual_seed(0))
    ids = sampling.pick(logits, torch.arange(5), 3)
    assert ids.dtype == torch.int32
    assert torch.equal(ids, logits.argmax(-1).to(torch.int32))


def _draws(logits, n, temperature, top_k, seed=1, step=9):
    rows = logits[None].expand(n, -1)
    ids = sampling.pick(rows, torch.arange(n), torch.tensor(step),
                        temperature=temperature, top_k=top_k, seed=seed)
    return ids.long()


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 0), (1.5, 3)])
def test_draws_follow_the_softmax(temperature, top_k):
    """20 000 draws (one lane each) from fixed logits: total-variation
    distance to softmax(logits / T) at most 0.02; with top_k, every draw
    is one of the k largest logits and the target is the truncated
    softmax."""
    logits = torch.tensor([1.2, -0.3, 0.4, 2.0, 0.0, -1.1, 0.9, 0.5])
    ids = _draws(logits, 20000, temperature, top_k)
    target = logits / temperature
    if top_k:
        top = set(torch.topk(logits, top_k).indices.tolist())
        assert set(ids.unique().tolist()) <= top
        target = target.masked_fill(
            ~torch.isin(torch.arange(8), torch.tensor(sorted(top))),
            float("-inf"))
    p = torch.softmax(target.double(), -1)
    emp = torch.bincount(ids, minlength=8).double() / ids.numel()
    tv = 0.5 * (emp - p).abs().sum().item()
    assert tv <= 0.02, (tv, emp.tolist(), p.tolist())


def test_seeded_and_independent_lanes():
    """Same (seed, step, lanes): same draws; another seed or step: other
    draws; a row's draw does not move when another row's logits change."""
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(6, 50, generator=g)
    lanes = torch.tensor([3, 0, 5, 1, 2, 4])
    kw = dict(temperature=1.3, top_k=10, seed=11)
    a = sampling.pick(logits, lanes, 2, **kw)
    assert torch.equal(a, sampling.pick(logits.clone(), lanes, 2, **kw))
    many = torch.randn(64, 50, generator=g)
    base = sampling.pick(many, torch.arange(64), 2, **kw)
    assert not torch.equal(base, sampling.pick(many, torch.arange(64), 3,
                                               **kw))
    assert not torch.equal(base, sampling.pick(
        many, torch.arange(64), 2, **dict(kw, seed=12)))
    changed = logits.clone()
    changed[1:] = torch.randn(5, 50, generator=g)
    b = sampling.pick(changed, lanes, 2, **kw)
    assert b[0] == a[0]
    assert not torch.equal(a[1:], b[1:])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _params():
    params = build_model(get_config(ARCH, smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    for lp in params["layers"]:
        for group in ("attn", "mlp"):
            for t in lp[group].values():
                if t.dim() == 2:
                    t.mul_(3.0)
    return params


def _run(**kw):
    engine = ServeEngine(get_config(ARCH, smoke=True), params=_params(),
                         device="cpu", max_len=32, block_size=4, **kw)
    rng = np.random.default_rng(5)
    reqs = [ServeRequest(rng.integers(1, 512, size=n).astype(np.int32),
                         max_new_tokens=b)
            for n, b in zip([5, 3, 8, 6], [7, 4, 9, 6])]
    out, _ = engine.run(reqs)
    return [r.output for r in out]


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_sampled_engine_properties(cache):
    """Seeded runs repeat, ``top_k=1`` is greedy whatever the temperature,
    a high temperature leaves greedy, another seed gives other tokens."""
    greedy = _run(cache=cache)
    assert len({t for o in greedy for t in o}) > 3
    assert _run(cache=cache, temperature=0.9, top_k=1) == greedy
    kw = dict(cache=cache, temperature=2.0, sample_seed=7)
    hot = _run(**kw)
    assert hot == _run(**kw)
    assert hot != greedy
    assert _run(**dict(kw, sample_seed=8)) != hot
    assert [len(o) for o in hot] == [7, 4, 9, 6]


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_sampled_tokens_do_not_depend_on_the_horizon(cache):
    """Static batching: each draw's (slot, step) lane is the same whether
    the engine runs 1, 2 or 8 steps a dispatch."""
    kw = dict(cache=cache, temperature=0.8, top_k=50, sample_seed=3)
    runs = [_run(decode_horizon=k, **kw) for k in (1, 2, 8)]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0] != _run(cache=cache)


def test_engine_repeats_a_sampled_run():
    """A second ``run`` on the same engine draws the same tokens."""
    engine = ServeEngine(get_config(ARCH, smoke=True), params=_params(),
                         device="cpu", max_len=32, n_slots=2, cache="paged",
                         block_size=4, temperature=0.8, top_k=50)

    def reqs():
        rng = np.random.default_rng(6)
        return [ServeRequest(rng.integers(1, 512, size=n).astype(np.int32),
                             max_new_tokens=5, arrival_time=float(a))
                for n, a in zip([5, 9, 4], [0, 0, 2])]

    first = [r.output for r in engine.run(reqs())[0]]
    assert [r.output for r in engine.run(reqs())[0]] == first


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--preset", "smoke", *argv],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)


def test_cli_verify_passes_on_the_smoke_preset():
    proc = _cli("--engine", "continuous", "--cache", "paged", "--verify")
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["verified"] is True and rec["unfinished"] == 0


def test_cli_rejects_verify_with_temperature():
    proc = _cli("--verify", "--temperature", "0.8")
    assert proc.returncode == 2
    assert "--verify" in proc.stderr and '"verified"' not in proc.stdout


def test_cli_samples_with_top_k_and_eos():
    proc = _cli("--engine", "continuous", "--cache", "paged", "--temperature",
                "0.8", "--top-k", "50", "--eos-token", "90")
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert "verified" not in rec and rec["unfinished"] == 0
    assert rec["new_tokens"] < 8 * 16     # the smoke model emits 90 early
