"""The port's contiguous engine on the recurrent (SSM) family against the JAX
engine, on the CPU, at mamba2-780m's smoke shape.

Serving a recurrent family never runs the SSD scan: the prefill steps the
O(1) state through the prompt one ``decode_step`` per position, and the
decode horizon runs without a write mask (frozen rows recompute state that
slot reuse overwrites), as in the reference (``engine.py:470-484``,
``:553``). Greedy tokens must be equal token for token and the host-side
counters exactly equal. Weights: the JAX init via numpy.
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
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro.serve.cache import CachePool as JaxCachePool
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import CachePool, ServeEngine, ServeRequest

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-780m"
#: prompt lengths, arrivals on the decode-step clock, and budgets
LENGTHS, ARRIVALS, BUDGETS = [5, 9, 7, 9, 6, 5], [0, 0, 1, 2, 4, 5], \
    [6, 3, 8, 5, 2, 7]


@functools.lru_cache(maxsize=None)
def _numpy_params():
    return jax.tree_util.tree_map(
        np.asarray, jax_build(jax_config(ARCH, smoke=True)).init(
            jax.random.key(0)))


def _requests(cls):
    rng = np.random.default_rng(13)
    return [cls(rng.integers(1, 512, size=n).astype(np.int32),
                max_new_tokens=b, arrival_time=float(a))
            for n, a, b in zip(LENGTHS, ARRIVALS, BUDGETS)]


def _port_engine(**kw):
    return ServeEngine(get_config(ARCH, smoke=True),
                       params=params_from_jax(_numpy_params(), device="cpu"),
                       device="cpu", max_len=32, **kw)


def _run_both(**kw):
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_params())
    ref, rst = JaxEngine(jax_config(ARCH, smoke=True), params=jparams,
                         cache="contiguous", max_len=32,
                         **kw).run(_requests(JaxRequest))
    out, pst = _port_engine(**kw).run(_requests(ServeRequest))
    assert [r.output for r in out] == [r.output for r in ref]
    for name in ("prefill_dispatches", "decode_dispatches", "host_syncs",
                 "decode_rows_saved", "steps", "new_tokens", "max_active",
                 "slot_utilization", "mean_occupancy", "max_occupancy",
                 "unfinished"):
        assert getattr(pst, name) == getattr(rst, name), name
    assert [r.finished_at for r in out] == [r.finished_at for r in ref]
    return out, pst


# ---------------------------------------------------------------------------
# engine: token identity and counters against the JAX contiguous engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 8])
def test_continuous_engine_matches_jax_engine(k):
    """Three slots for six requests, open-loop arrivals, staggered budgets;
    K = 8 finishes rows mid-horizon and compacts the live rows. The scan
    kernel's plain version never runs: serving does not reach it."""
    calls = ssd.ssd_scan_plain.calls
    out, st = _run_both(n_slots=3, decode_horizon=k)
    assert ssd.ssd_scan_plain.calls == calls
    assert st.prefill_dispatches == len(LENGTHS)
    assert st.decode_rows_saved > 0
    assert len({t for r in out for t in r.output}) > 3   # not one repeated id
    if k == 8:
        assert st.decode_dispatches < st.steps


@pytest.mark.parametrize("k", [1, 8])
def test_static_engine_matches_jax_engine(k):
    """``n_slots=None``: one slot per request (static batching)."""
    _, st = _run_both(decode_horizon=k)
    assert st.unfinished == 0 and st.max_active > 3


def test_engine_matches_jax_engine_with_eos_stops():
    """An EOS token stops rows mid-horizon on both engines alike (a token
    the first request emits mid-budget without it)."""
    free, _ = _port_engine(n_slots=3, decode_horizon=8).run(
        _requests(ServeRequest))
    eos = free[0].output[2]
    _, st = _run_both(n_slots=3, decode_horizon=8, eos_token=eos)
    assert st.new_tokens < sum(BUDGETS)


def test_prefill_equals_the_decode_chain():
    """The engine's recurrent prefill leaves the state and last logits of
    stepping ``decode_step`` over the prompt by hand, and of the JAX
    engine's prefill scan."""
    engine = _port_engine(n_slots=2)
    prompt = np.random.default_rng(2).integers(1, 512, size=11).astype(
        np.int32)
    logits, row = engine._prefill(torch.from_numpy(prompt)[None, :])
    model = build_model(get_config(ARCH, smoke=True))
    cache = model.init_cache(1, 32, device="cpu")
    for t in range(len(prompt)):
        want, cache = model.decode_step(
            engine.params, cache, torch.from_numpy(prompt[None, t:t + 1]), t)
    torch.testing.assert_close(logits, want, atol=0, rtol=0)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(row[name], cache[name], atol=0, rtol=0)
    jeng = JaxEngine(jax_config(ARCH, smoke=True),
                     params=jax.tree_util.tree_map(jnp.asarray,
                                                   _numpy_params()),
                     cache="contiguous", max_len=32)
    jlogits, jrow = jeng._prefill_fn()(jeng.params,
                                       jnp.asarray(prompt)[None, :])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-3, rtol=2e-3)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(row[name].numpy(), np.asarray(jrow[name]),
                                   atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# CachePool over the recurrent state
# ---------------------------------------------------------------------------
def test_cache_pool_matches_reference():
    jm = jax_build(jax_config(ARCH, smoke=True))
    tm = build_model(get_config(ARCH, smoke=True))
    ref = JaxCachePool(jm, n_slots=3, max_len=16)
    port = CachePool(tm, n_slots=3, max_len=16, device="cpu")
    assert dict(ref.batch_axes) == port.batch_axes == {"conv": 1, "ssm": 1}
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
            ref.buffers.items()} == \
        {k: (tuple(v.shape), str(v.dtype).split(".")[1])
         for k, v in port.buffers.items()}
    rng = np.random.default_rng(1)
    for op, arg in (("alloc", None), ("alloc", None), ("alloc", None),
                    ("free", 1), ("alloc", None), ("free", 0), ("free", 2),
                    ("alloc", None)):
        a = getattr(ref, op)() if arg is None else getattr(ref, op)(arg)
        b = getattr(port, op)() if arg is None else getattr(port, op)(arg)
        assert a == b, op
        assert list(ref._free) == list(port._free), op
        if op == "alloc" and a is not None:
            row = {n: rng.standard_normal(
                (v.shape[0], 1) + tuple(v.shape[2:])).astype(np.float32)
                for n, v in port.buffers.items()}
            ref.write(a, {n: jnp.asarray(r) for n, r in row.items()})
            port.write(b, {n: torch.from_numpy(r) for n, r in row.items()})
    for name in ("conv", "ssm"):
        np.testing.assert_array_equal(np.asarray(ref.buffers[name]),
                                      port.buffers[name].numpy())


def test_paged_cache_is_refused_for_the_recurrent_family():
    """As in the reference (``engine.py:363-367``): recurrent state is O(1)
    and has nothing to page."""
    with pytest.raises(ValueError, match="attention family"):
        ServeEngine(get_config(ARCH, smoke=True), device="cpu",
                    cache="paged")
    with pytest.raises(ValueError, match="attention family"):
        JaxEngine(jax_config(ARCH, smoke=True), cache="paged")


def test_cli_mamba2_contiguous_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--preset", "smoke", "--device", "cpu", "--cache", "contiguous",
         "--engine", "continuous", "--batch", "4", "--slots", "2",
         "--prompt-len", "12", "--max-new", "6", "--max-len", "32"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["arch"] == ARCH and rec["cache"] == "contiguous"
    assert rec["device"] == "cpu" and rec["n_requests"] == 4
    assert rec["new_tokens"] == 4 * 6 and rec["unfinished"] == 0
    assert rec["prefill_dispatches"] == 4
