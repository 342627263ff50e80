"""The port's contiguous serving backend (``ServeEngine(cache="contiguous")``
over ``serve/cache.py``'s ``CachePool``) against the JAX package, on the
CPU: pool bookkeeping on one slot stream, the engine's greedy tokens and
counters for the dense family (qwen2-0.5b smoke) and the MoE family
(olmoe-1b-7b smoke, whose one-pass prefill attends through the flash
kernel's plain version), the reference's defaults, and the CLI.

Host-side logic must match exactly (free lists, dispatch / sync counters,
compaction savings, finishing steps) and greedy tokens must be equal token
for token. qwen2's weights are the JAX init scaled by 3 in every layer
matrix (at init scale its smoke model repeats one token); olmoe's init
already gives varied tokens.
"""
import functools
import inspect
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
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro.serve.cache import CachePool as JaxCachePool
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import CachePool, ServeEngine, ServeRequest

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: prompt lengths (two distinct, so the JAX engine compiles two prefill
#: programs), arrivals on the decode-step clock, and budgets
LENGTHS, ARRIVALS, BUDGETS = [5, 9, 5, 9, 9, 5], [0, 0, 1, 2, 4, 5], \
    [6, 3, 8, 5, 2, 7]


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
    rng = np.random.default_rng(11)
    return [cls(rng.integers(1, 512, size=n).astype(np.int32),
                max_new_tokens=b, arrival_time=float(a))
            for n, a, b in zip(LENGTHS, ARRIVALS, BUDGETS)]


def _port_engine(arch, **kw):
    return ServeEngine(get_config(arch, smoke=True),
                       params=params_from_jax(_numpy_params(arch),
                                              device="cpu"),
                       device="cpu", max_len=32, **kw)


def _run_both(arch, pallas=False, **kw):
    jcfg = jax_config(arch, smoke=True).replace(use_pallas=pallas)
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_params(arch))
    ref, rst = JaxEngine(jcfg, params=jparams, cache="contiguous",
                         max_len=32, **kw).run(_requests(JaxRequest))
    out, pst = _port_engine(arch, **kw).run(_requests(ServeRequest))
    assert [r.output for r in out] == [r.output for r in ref]
    for name in ("prefill_dispatches", "decode_dispatches", "host_syncs",
                 "decode_rows_saved", "steps", "new_tokens", "max_active",
                 "slot_utilization", "mean_occupancy", "max_occupancy"):
        assert getattr(pst, name) == getattr(rst, name), name
    assert [r.finished_at for r in out] == [r.finished_at for r in ref]
    return out, pst


# ---------------------------------------------------------------------------
# CachePool: one slot stream through both pools
# ---------------------------------------------------------------------------
def _pool_state(pool):
    return (list(pool._free), sorted(pool.in_use), pool.n_free,
            pool.capacity, pool.utilization)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_cache_pool_matches_reference(arch):
    jm = jax_build(jax_config(arch, smoke=True))
    tm = build_model(get_config(arch, smoke=True))
    ref = JaxCachePool(jm, n_slots=3, max_len=16)
    port = CachePool(tm, n_slots=3, max_len=16, device="cpu")
    assert dict(ref.batch_axes) == port.batch_axes == {"k": 1, "v": 1}
    assert {k: tuple(v.shape) for k, v in ref.buffers.items()} == \
        {k: tuple(v.shape) for k, v in port.buffers.items()}
    rng = np.random.default_rng(1)
    for op, arg in (("alloc", None), ("alloc", None), ("alloc", None),
                    ("alloc", None), ("free", 1), ("alloc", None),
                    ("free", 0), ("free", 2)):
        a = getattr(ref, op)() if arg is None else getattr(ref, op)(arg)
        b = getattr(port, op)() if arg is None else getattr(port, op)(arg)
        assert a == b, op
        assert _pool_state(ref) == _pool_state(port), op
        if op == "alloc" and a is not None:
            row = {n: rng.standard_normal(
                (jm.cfg.n_layers, 1, 16, jm.cfg.n_kv_heads,
                 jm.cfg.resolved_head_dim)).astype(np.float32)
                for n in ("k", "v")}
            ref.write(a, {n: jnp.asarray(r) for n, r in row.items()})
            port.write(b, {n: torch.from_numpy(r) for n, r in row.items()})
    for slot in range(3):
        r, p = ref.read_slot(slot), port.read_slot(slot)
        for n in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(r[n]), p[n].numpy())
    for name in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(ref.buffers[name]),
                                      port.buffers[name].numpy())


def test_cache_pool_write_checks_like_reference():
    port = CachePool(build_model(get_config("qwen2-0.5b", smoke=True)),
                     n_slots=2, max_len=16, device="cpu")
    slot = port.alloc()
    row = port.model.init_cache(1, 16, device="cpu")
    short = port.model.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        port.write(slot, short)
    with pytest.raises(ValueError, match="dtype"):
        port.write(slot, {n: t.double() for n, t in row.items()})
    with pytest.raises(ValueError, match="not allocated"):
        port.write(1 - slot, row)
    port.write(slot, row)


# ---------------------------------------------------------------------------
# engine: token identity and counters against the JAX contiguous engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,k,pallas", [
    ("qwen2-0.5b", 1, False),
    ("qwen2-0.5b", 8, False),
    ("olmoe-1b-7b", 1, False),
    ("olmoe-1b-7b", 8, True),
], ids=["qwen2-k1", "qwen2-k8", "olmoe-k1", "olmoe-k8-pallas"])
def test_engine_matches_jax_engine(arch, k, pallas):
    """Continuous batching with fewer slots (3) than requests (6),
    open-loop arrivals, staggered budgets; K = 8 finishes rows
    mid-horizon and compacts the live rows."""
    _, st = _run_both(arch, pallas=pallas, n_slots=3, decode_horizon=k)
    assert st.decode_rows_saved > 0
    if k == 8:
        assert st.decode_dispatches < st.steps


def test_engine_matches_jax_engine_with_eos_stops():
    """An EOS token stops MoE rows mid-horizon on both engines alike (the
    token is one the first request emits mid-budget without it)."""
    free, _ = _port_engine("olmoe-1b-7b", n_slots=3,
                           decode_horizon=8).run(_requests(ServeRequest))
    eos = free[0].output[2]
    _, st = _run_both("olmoe-1b-7b", n_slots=3, decode_horizon=8,
                      eos_token=eos)
    assert st.new_tokens < sum(BUDGETS)


def test_static_engine_matches_jax_engine():
    """``n_slots=None``: one slot per request (static batching)."""
    _, st = _run_both("qwen2-0.5b", decode_horizon=4)
    assert st.unfinished == 0 and st.max_active > 3


# ---------------------------------------------------------------------------
# defaults and the CLI
# ---------------------------------------------------------------------------
def test_defaults_are_the_references():
    """``ServeEngine(cfg)`` builds the contiguous engine and the CLI
    defaults to ``--engine static --cache contiguous``, as the JAX package
    does (``engine.py:349``, ``launch/serve.py:192-195``)."""
    for engine in (ServeEngine, JaxEngine):
        params = inspect.signature(engine.__init__).parameters
        assert params["cache"].default == "contiguous"
    args = serve_cli.build_parser().parse_args([])
    assert (args.engine, args.cache) == ("static", "contiguous")
    assert serve_cli.build_parser().parse_args(
        ["--cache", "paged"]).cache == "paged"


def test_cli_olmoe_contiguous_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmoe-1b-7b", "--preset", "smoke", "--device", "cpu", "--cache",
         "contiguous", "--engine", "continuous", "--batch", "4", "--slots",
         "2", "--prompt-len", "12", "--max-new", "6", "--max-len", "32"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["arch"] == "olmoe-1b-7b" and rec["cache"] == "contiguous"
    assert rec["device"] == "cpu" and rec["n_requests"] == 4
    assert rec["new_tokens"] == 4 * 6 and rec["unfinished"] == 0
    assert rec["prefill_dispatches"] == 4
