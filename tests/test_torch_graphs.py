"""The port's captured programs (``repro_torch/serve/graphs.py``) on the
CPU, where nothing is captured: the runner calls each function through its
static input buffers and copies its outputs into its static outputs, so
these tests hold that path — the one a replay takes on the card — to the
JAX engine.

For the six serving paths (paged dense, MoE and VLM, contiguous dense and
MoE, recurrent) greedy tokens and every ``ServeStats`` counter equal the JAX
engine's, a second ``run`` on the same engine (the pool's tensors kept and
reset, the static signatures reused) equals the first, and a run under
``graphs.eager()`` equals both. A later call runs the first call's
function and raises when it reads a tensor rebound since (on the card a
replay would read the old one). Weights: the JAX init via numpy, qwen2's
layer matrices scaled by 3 (at init scale its smoke model repeats one
token).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine, ServeRequest, ServeStats, graphs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: wall-clock fields; every other ServeStats field is a counter
TIMES = {"wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
         "decode_s"}
COUNTERS = [f.name for f in dataclasses.fields(ServeStats)
            if f.name not in TIMES]
#: prompt lengths, arrivals on the decode-step clock, and budgets: churn
#: through 3 slots, mid-horizon finishes, compacted buckets (two prompt
#: lengths: the JAX engine compiles one contiguous prefill per length)
LENGTHS, ARRIVALS, BUDGETS = [5, 9, 5, 9, 9], [0, 0, 1, 2, 4], \
    [6, 3, 8, 5, 2]
PATHS = {
    "paged-dense": ("qwen2-0.5b", "paged"),
    "contiguous-dense": ("qwen2-0.5b", "contiguous"),
    "contiguous-moe": ("olmoe-1b-7b", "contiguous"),
    "recurrent": ("mamba2-780m", "contiguous"),
    "paged-moe": ("olmoe-1b-7b", "paged"),
    "paged-vlm": ("phi-3-vision-4.2b", "paged"),
}


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build(jax_config(arch, smoke=True)).init(
            jax.random.key(0)))
    if arch == "qwen2-0.5b":
        for group in ("attn", "mlp"):
            for name, a in tree["layers"][group].items():
                if a.ndim == 3:                  # stacked [L, in, out]
                    tree["layers"][group][name] = a * np.float32(3.0)
    return tree


def _requests(cls):
    rng = np.random.default_rng(17)
    return [cls(rng.integers(1, 512, size=n).astype(np.int32),
                max_new_tokens=b, arrival_time=float(a))
            for n, a, b in zip(LENGTHS, ARRIVALS, BUDGETS)]


def _kw(cache):
    kw = dict(max_len=32, n_slots=3, decode_horizon=8, cache=cache)
    if cache == "paged":
        kw.update(block_size=4, prefill_lanes=2)
    return kw


def _run(engine):
    out, st = engine.run(_requests(ServeRequest))
    return [r.output for r in out], {n: getattr(st, n) for n in COUNTERS}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_runner_path_matches_jax_engine(path):
    """Tokens and counters equal the JAX engine's through the static
    buffers; a second run and an eager run equal the first; the runner
    holds the path's static signatures and the second run keeps the pool's
    tensors."""
    arch, cache = PATHS[path]
    kw = _kw(cache)
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_params(arch))
    ref, rst = JaxEngine(jax_config(arch, smoke=True), params=jparams,
                         **kw).run(_requests(JaxRequest))
    engine = ServeEngine(get_config(arch, smoke=True),
                         params=params_from_jax(_numpy_params(arch),
                                                device="cpu"),
                         device="cpu", **kw)
    toks, counters = _run(engine)
    assert toks == [r.output for r in ref]
    assert len({t for o in toks for t in o}) > 3    # not one repeated id
    for name in COUNTERS:
        want = getattr(rst, name)
        if name == "block_report" and want is not None:
            # the reference adds elastic serving's revoke counts (A8)
            want = {k: want[k] for k in counters[name]}
        assert counters[name] == want, name

    keys = engine.graphs.keys
    kinds = {k[0] for k in keys}
    assert cache in kinds
    assert ("prefill" in kinds) == (cache == "paged")
    assert (("recurrent_step",) in keys) == (arch == "mamba2-780m")
    assert any(k[3] for k in keys if k[0] == cache)         # a full bucket
    assert any(not k[3] for k in keys if k[0] == cache)     # a compacted one
    ptrs = [t.data_ptr() for t in engine.pool.buffers.values()] \
        if cache == "contiguous" else [engine.pool.buffers.k_buf.data_ptr()]

    assert _run(engine) == (toks, counters)
    assert engine.graphs.keys == keys
    assert ptrs == ([t.data_ptr() for t in engine.pool.buffers.values()]
                    if cache == "contiguous"
                    else [engine.pool.buffers.k_buf.data_ptr()])
    with graphs.eager():
        assert _run(engine) == (toks, counters)


def test_new_pool_shape_drops_the_graphs():
    """A run with another slot count allocates a new pool and decode state
    and recaptures; returning to the first shape gives the first tokens."""
    arch = "qwen2-0.5b"
    engine = ServeEngine(get_config(arch, smoke=True),
                         params=params_from_jax(_numpy_params(arch),
                                                device="cpu"),
                         device="cpu", **_kw("paged"))
    first = _run(engine)
    keys = engine.graphs.keys
    engine.n_slots = 2
    two = _run(engine)
    assert all(k[1] <= 2 for k in engine.graphs.keys if k[0] == "paged")
    assert two[0] == first[0]          # greedy tokens: schedule-free
    engine.n_slots = 3
    assert _run(engine) == first
    assert sorted(engine.graphs.keys) == sorted(keys)


@pytest.mark.parametrize("rebind", ["state.tok", "pool.buffers"])
def test_rebound_tensor_raises_on_the_cpu(rebind):
    """A tensor the captured programs read, rebound between runs (a new
    decode-state token row, a new pool leaf), would go stale on the card:
    a replay reads the old address. The CPU runner raises on it."""
    arch = "qwen2-0.5b"
    engine = ServeEngine(get_config(arch, smoke=True),
                         params=params_from_jax(_numpy_params(arch),
                                                device="cpu"),
                         device="cpu", **_kw("contiguous"))
    _run(engine)
    if rebind == "state.tok":
        engine._state.tok = torch.zeros_like(engine._state.tok)
    else:
        engine.pool.buffers["k"] = engine.pool.buffers["k"].clone()
    with pytest.raises(RuntimeError, match="rebound"):
        _run(engine)


def test_runner_keeps_the_first_function():
    """A later call runs the first call's function, as a replay would, and
    raises when it reads a tensor the first call did not."""
    runner = graphs.GraphRunner("cpu")
    held = {"w": torch.tensor([1.0, 2.0])}

    def first(x):
        return x * held["w"]

    assert runner("k", first, torch.tensor([3.0, 3.0])).tolist() == [3, 6]
    other = runner("k", lambda x: x + 100, torch.tensor([1.0, 1.0]))
    assert other.tolist() == [1, 2]
    held["w"].mul_(2)                     # in place: same storage
    assert runner("k", first, torch.tensor([1.0, 1.0])).tolist() == [2, 4]
    held["w"] = torch.tensor([5.0, 5.0])  # rebound: a new storage
    with pytest.raises(RuntimeError, match="rebound"):
        runner("k", first, torch.tensor([1.0, 1.0]))


def test_runner_copies_in_and_out():
    """First call: the function runs on fresh static buffers; later calls
    copy the inputs in and return the same static output tensor, updated;
    ``eager()`` runs on the caller's inputs."""
    runner = graphs.GraphRunner("cpu")
    seen = []

    def fn(x, y):
        seen.append((x.data_ptr(), y.data_ptr()))
        return x * 2 + y

    a, b = torch.arange(4), torch.tensor(1)
    first = runner("k", fn, a, b)
    assert first.tolist() == [1, 3, 5, 7]
    assert seen[0][0] != a.data_ptr()
    out = runner("k", fn, torch.arange(4) + 10, torch.tensor(5))
    assert out.tolist() == [25, 27, 29, 31]
    again = runner("k", fn, torch.zeros(4, dtype=torch.int64),
                   torch.tensor(-1))
    assert again is out and out.tolist() == [-1] * 4
    assert seen[1] == seen[2] == seen[0]
    with graphs.eager():
        assert runner("k", fn, a, b).tolist() == [1, 3, 5, 7]
    assert seen[3] == (a.data_ptr(), b.data_ptr())
    assert runner.keys == ["k"]
    runner.reset()
    assert runner.keys == []


def test_launch_counters_snapshot_and_add():
    """``ops.counts`` / ``set_counts`` / ``add_counts``: the runner's
    bookkeeping of a capture's launches, over every wrapper and plain
    version."""
    before = ops.counts()
    assert len(before) == 16
    try:
        ops.add_counts((1,) * 16)
        assert ops.paged_attention.launches == before[1] + 1
        assert ops.counts() == tuple(v + 1 for v in before)
    finally:
        ops.set_counts(before)
    assert ops.counts() == before
