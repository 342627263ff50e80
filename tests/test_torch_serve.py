"""The port's serving stack (repro_torch.serve) against the JAX reference,
on the CPU: BlockManager bookkeeping on one request stream, the paged
engine's greedy tokens and counters, and the CLI.

Host-side logic must match exactly (tables, free lists, refcounts, prefix
hits, dispatch / sync / preemption counters) and greedy tokens must be
equal token for token. The weights are the JAX init scaled by 3 in every
layer matrix (the same arrays for both engines): at init scale the smoke
model repeats one token, which would make token identity a weak check.
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
from repro.serve import BlockManager as JaxBlockManager
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (BlockManager, ContinuousScheduler, ServeEngine,
                               ServeRequest)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "qwen2-0.5b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _numpy_params():
    jp = jax_build(jax_config(ARCH, smoke=True)).init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    for group in ("attn", "mlp"):
        for name, a in tree["layers"][group].items():
            if a.ndim == 3:                      # stacked [L, in, out]
                tree["layers"][group][name] = a * np.float32(3.0)
    return tree


# ---------------------------------------------------------------------------
# BlockManager: one request stream through both managers
# ---------------------------------------------------------------------------
def _pool_state(pool):
    entries = {h: (e.block, e.refs, e.ready) for h, e in pool._entries.items()}
    rep = pool.report()
    audit = pool.audit()
    return (pool.tables.tolist(), list(pool._free_blocks),
            list(pool._free_slots), entries, list(pool._evictable),
            pool.prefix_blocks_hit, pool.prefix_blocks_total,
            pool.deferred_last_alloc,
            {k: rep[k] for k in ("used_blocks", "free_blocks", "used_tokens",
                                 "evictable_blocks", "watermark_blocks")},
            {k: audit[k] for k in ("free", "in_table", "evictable",
                                   "capacity")})


def test_block_manager_matches_reference():
    """Admissions, a deferred sharer, shared prefixes, growth, frees,
    eviction of cached blocks and a preemption leave both managers in the
    same state after every operation."""
    kw = dict(n_slots=4, max_len=32, block_size=4, n_blocks=12,
              watermark=0.1, prefix_cache=True)
    ref = JaxBlockManager(jax_build(jax_config(ARCH, smoke=True)), **kw)
    port = BlockManager(build_model(get_config(ARCH, smoke=True)),
                        device="cpu", **kw)
    rng = np.random.default_rng(3)
    x = rng.integers(1, 512, size=14).astype(np.int32)
    prompts = [x, x.copy(), rng.integers(1, 512, size=9).astype(np.int32),
               np.concatenate([x[:8], rng.integers(1, 512, size=7)
                               .astype(np.int32)]),
               rng.integers(1, 512, size=22).astype(np.int32)]
    rq = [JaxRequest(p.copy(), max_new_tokens=6) for p in prompts]
    pq = [ServeRequest(p.copy(), max_new_tokens=6) for p in prompts]
    slots = {}

    def both(op, *args):
        a = getattr(ref, op)(*args[0]) if args else getattr(ref, op)()
        b = getattr(port, op)(*args[1]) if args else getattr(port, op)()
        assert a == b, (op, a, b)
        assert _pool_state(ref) == _pool_state(port), op
        return a

    for i in (0, 1, 2):                 # request 1 defers behind its donor
        slots[i] = both("alloc_for", (rq[i],), (pq[i],))
    assert slots[1] is None and port.deferred_last_alloc is False
    for j in range(3):
        both("commit_block", (slots[0], j), (slots[0], j))
    for i in (1, 3):                    # shared prefix hits
        slots[i] = both("alloc_for", (rq[i],), (pq[i],))
    assert port.prefix_blocks_hit == 5
    both("ensure", (slots[0], 20), (slots[0], 20))
    both("ensure", (slots[2], 16), (slots[2], 16))
    for i in (0, 1, 3):     # the donor leaves first; x's blocks park as
        both("free", (slots[i],), (slots[i],))  # evictable at refcount 0
    assert port.evictable_blocks == 3
    slots[4] = both("alloc_for", (rq[4],), (pq[4],))   # evicts one of them
    assert port.evictable_blocks == 2
    both("drain_dirty")

    # a preemption through the scheduler: the most recent admission bounces
    rs, ps = JaxScheduler(ref), ContinuousScheduler(port)
    for sched, req in ((rs, rq[4]), (ps, pq[4])):
        req.slot = slots[4]
        sched.active[slots[4]] = req
        sched.preempt(req)
    assert _pool_state(ref) == _pool_state(port)
    assert rq[4].n_preempted == pq[4].n_preempted == 1
    assert rs.admit() == [rq[4]] and ps.admit() == [pq[4]]
    assert rq[4].slot == pq[4].slot
    assert _pool_state(ref) == _pool_state(port)


# ---------------------------------------------------------------------------
# engine: token identity and counters against the JAX paged engine
# ---------------------------------------------------------------------------
CASES = {
    # decode horizon K = 1, churn (n_slots < batch), open-loop arrivals
    "k1": dict(engine=dict(decode_horizon=1), lengths=[5, 9, 3, 12, 7, 4],
               arrivals=[0, 0, 1, 2, 4, 5], budgets=[6, 3, 8, 5, 2, 7]),
    # K = 8: mid-horizon finishes, growth across horizon boundaries
    "k8": dict(engine=dict(decode_horizon=8), lengths=[5, 9, 3, 12, 7, 4],
               arrivals=[0, 0, 1, 2, 4, 5], budgets=[6, 3, 8, 5, 2, 7]),
    # a 12-token shared prefix: prefix-cache hits and deferred sharers
    "shared_prefix": dict(engine=dict(decode_horizon=8), prefix=12,
                          lengths=[3, 5, 2, 6, 4], arrivals=[0, 0, 0, 1, 3],
                          budgets=[5, 5, 5, 5, 5]),
    # a pool too tight for both requests: the horizon shrinks, then
    # preempts (prefix cache off: no prefix blocks are counted)
    "preempt": dict(engine=dict(decode_horizon=8, n_blocks=6, watermark=0.0,
                                prefix_cache=False),
                    slots=2, lengths=[8, 8], arrivals=[0, 0], budgets=[8, 8]),
    # shortest-remaining-work-first admission order
    "sjf": dict(engine=dict(decode_horizon=4, policy="sjf"),
                lengths=[12, 3, 9, 5, 2, 7], arrivals=[0] * 6,
                budgets=[6, 3, 8, 5, 2, 7]),
}


def _requests(cls, case):
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, 512, size=case.get("prefix", 0)).astype(np.int32)
    out = []
    for n, a, b in zip(case["lengths"], case["arrivals"], case["budgets"]):
        tail = rng.integers(1, 512, size=n).astype(np.int32)
        out.append(cls(np.concatenate([prefix, tail]), max_new_tokens=b,
                       arrival_time=float(a)))
    return out


def _run_both(case, pallas=False):
    kw = dict(max_len=32, n_slots=case.get("slots", 3), block_size=4,
              **case["engine"])
    tree = _numpy_params()
    jcfg = jax_config(ARCH, smoke=True).replace(use_pallas=pallas)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    ref, rst = JaxEngine(jcfg, params=jparams, cache="paged", **kw).run(
        _requests(JaxRequest, case))
    engine = ServeEngine(get_config(ARCH, smoke=True),
                         params=params_from_jax(tree, device="cpu"),
                         cache="paged", device="cpu", **kw)
    out, pst = engine.run(_requests(ServeRequest, case))
    assert [r.output for r in out] == [r.output for r in ref]
    for name in ("prefill_dispatches", "decode_dispatches", "host_syncs",
                 "preemptions", "prefix_hit_rate", "decode_rows_saved",
                 "steps", "new_tokens", "max_active"):
        assert getattr(pst, name) == getattr(rst, name), name
    assert [r.finished_at for r in out] == [r.finished_at for r in ref]
    engine.pool.audit()
    return pst


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_jax_engine(name):
    st = _run_both(CASES[name])
    if name == "shared_prefix":
        assert st.prefix_hit_rate > 0
    if name == "preempt":
        assert st.preemptions >= 1
    if name == "k8":
        assert st.decode_dispatches < st.steps


def test_engine_matches_jax_engine_with_eos_stops():
    """An EOS token stops rows mid-horizon on both engines alike (the
    token is one the first request emits mid-budget without it)."""
    case = CASES["k8"]
    free, _ = ServeEngine(get_config(ARCH, smoke=True),
                          params=params_from_jax(_numpy_params(),
                                                 device="cpu"),
                          cache="paged", device="cpu", max_len=32, n_slots=3,
                          block_size=4, decode_horizon=8).run(
        _requests(ServeRequest, case))
    eos = free[0].output[2]
    st = _run_both(dict(case, engine=dict(decode_horizon=8, eos_token=eos)))
    assert st.new_tokens < sum(case["budgets"])


def test_engine_matches_jax_engine_with_pallas_kernels():
    """The JAX engine with its Pallas kernels (interpret mode) still gives
    the port's tokens and counters."""
    _run_both(CASES["k8"], pallas=True)


def test_engine_rejects_unported_options():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg, device="cpu", sharding=object())
    with pytest.raises(ValueError):        # recurrent state is not paged
        ServeEngine(get_config("mamba2-780m", smoke=True), device="cpu",
                    cache="paged")
    with pytest.raises(ValueError):
        ServeEngine(cfg, device="cpu", cache="blocks")


def test_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--preset",
         "smoke", "--device", "cpu", "--engine", "continuous", "--cache",
         "paged", "--batch", "4", "--slots", "2",
         "--prompt-len", "12", "--shared-prefix", "16", "--max-len", "64"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["device"] == "cpu" and rec["n_requests"] == 4
    assert rec["new_tokens"] == 4 * 16 and rec["unfinished"] == 0
    assert rec["prefix_hit_rate"] > 0
