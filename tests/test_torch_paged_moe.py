"""The port's paged MoE path against the JAX package, on the CPU, at
olmoe-1b-7b's smoke shape (2 layers, 4 experts, top-2).

  * ``moe.paged_prefill_chunk`` lane-batched, with ragged ``n_valid``, a
    padding lane and per-lane ``cap_rows``, carrying the per-layer expert
    counts from chunk to chunk: its logits and counts equal the JAX
    chunk's, and each lane's last logits equal a one-pass forward over its
    prompt (capacity drops land on the same tokens);
  * ``moe.paged_decode_step`` over the prefilled tables;
  * the gather dispatch (``moe_gather_dispatch``): bit for bit the scatter
    dispatch, and the JAX package's within tolerance;
  * ``BlockManager.resume_state`` / ``commit_block(state)`` and the
    capacity-salted prefix hashes against ``repro/serve/paged.py``;
  * the paged engine against the JAX engine, token for token and counter
    for counter, with prefix hits that resume the counts, at the default
    and at a tight capacity factor (tokens dropped), scatter and gather;
    prefix cache on and off against static contiguous serving; the CLI's
    ``--verify``.

Weights: the JAX init via numpy. Tolerance: atol = rtol = 1e-4 on logits
(tests/test_torch_moe.py's); routing and counts exactly.
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
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build
from repro.serve import BlockManager as JaxBlockManager
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (BlockManager, ServeEngine, ServeRequest,
                               ServeStats)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "olmoe-1b-7b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
#: an expert takes at most 8 of the ~10-20 assignments a 20-40-token
#: prompt gives it: tokens are certainly dropped
TIGHT = 0.5
BS, MB, NB, MAX_LEN = 8, 6, 16, 48
LENGTHS = (37, 21)
#: scattered block homes per lane; lane 2 is a padding lane
TABLES = np.array([[9, 2, 14, 5, 0, 12], [3, 11, 7, -1, -1, -1],
                   [-1] * 6], np.int32)
TIMES = {"wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
         "decode_s"}
COUNTERS = [f.name for f in dataclasses.fields(ServeStats)
            if f.name not in TIMES]


@functools.lru_cache(maxsize=None)
def _numpy_params():
    return jax.tree_util.tree_map(
        np.asarray, jax_build(jax_config(ARCH, smoke=True)).init(
            jax.random.key(0)))


def _configs(cf=1.25, gather=False):
    over = dict(capacity_factor=cf, moe_gather_dispatch=gather)
    return (jax_config(ARCH, smoke=True).replace(decode_attention="paged",
                                                 **over),
            get_config(ARCH, smoke=True, **over))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(1, 512, size=n).astype(np.int32) for n in LENGTHS]


def _prefill_both(cf):
    """Chain lane-batched chunk rounds over both prompts (and a padding
    lane) through the JAX and the port caches, carrying the counts; check
    every round's logits and counts. Returns (jax cache, port cache, the
    lanes' last logits of each, the final counts of each)."""
    jcfg, cfg = _configs(cf)
    jm, tm = jax_build(jcfg), build_model(cfg.replace(
        decode_attention="paged"))
    jp = jax.tree_util.tree_map(jnp.asarray, _numpy_params())
    tp = params_from_jax(_numpy_params(), device="cpu")
    jcache = jm.init_paged_cache(NB, BS)
    tcache = tm.init_paged_cache(NB, BS, device="cpu")
    prompts = _prompts()
    caps = np.array([moe.capacity(cfg, len(p)) for p in prompts] + [0],
                    np.int32)
    jstate = jm.paged_prefill_state(3)
    tstate = tm.paged_prefill_state(3, "cpu")
    jlast, tlast = {}, {}
    for r in range(-(-max(LENGTHS) // BS)):
        tok = np.zeros((3, BS), np.int32)
        start = np.zeros((3,), np.int32)
        nv = np.zeros((3,), np.int32)
        tables = np.full_like(TABLES, -1)
        for i, p in enumerate(prompts):
            n = min(BS, len(p) - r * BS)
            if n > 0:
                tok[i, :n] = p[r * BS:r * BS + n]
                start[i], nv[i], tables[i] = r * BS, n, TABLES[i]
        jl, jcache, jstate = jm.paged_prefill_chunk(
            jp, jcache, jnp.asarray(tok), jnp.asarray(start),
            jnp.asarray(tables), jstate, MAX_LEN, n_valid=jnp.asarray(nv),
            cap_rows=jnp.asarray(caps))
        tl, tcache, tstate = tm.paged_prefill_chunk(
            tp, tcache, torch.from_numpy(tok), torch.from_numpy(start),
            torch.from_numpy(tables), tstate, MAX_LEN,
            n_valid=torch.from_numpy(nv), cap_rows=torch.from_numpy(caps))
        assert tstate.dtype == torch.int32
        np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
        for i, p in enumerate(prompts):
            if nv[i] > 0:
                _close(tl[i], jl[i])
                if start[i] + nv[i] == len(p):
                    jlast[i], tlast[i] = np.asarray(jl[i, 0]), tl[i, 0]
    return jcache, tcache, jlast, tlast, tstate


@pytest.mark.parametrize("cf", [TIGHT, 1.25], ids=["tight", "default"])
def test_lane_batched_chunks_match_jax_and_one_pass(cf):
    jcache, tcache, jlast, tlast, counts = _prefill_both(cf)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    _, cfg = _configs(cf)
    tp = params_from_jax(_numpy_params(), device="cpu")
    for i, p in enumerate(_prompts()):
        one_pass = moe.forward(cfg, tp, torch.from_numpy(p[None]))
        _close(tlast[i], one_pass[0, -1])
        _close(tlast[i], jlast[i])
        # every valid token made top_k assignments in every layer
        assert (counts[:, i].sum(-1) == len(p) * cfg.top_k).all()
    assert (counts[:, 2] == 0).all()                  # the padding lane
    if cf == TIGHT:      # the drops matter: without the cap the logits move
        loose = moe.forward(cfg.replace(capacity_factor=8.0), tp,
                            torch.from_numpy(_prompts()[0][None]))
        assert (loose[0, -1] - tlast[0]).abs().max() > 1e-3


def test_paged_decode_steps_match_jax():
    """Three decode steps over the prefilled tables and the padding row;
    step 1 masks lane 1's KV write."""
    jcfg, cfg = _configs()
    jm, tm = jax_build(jcfg), build_model(cfg.replace(
        decode_attention="paged"))
    jp = jax.tree_util.tree_map(jnp.asarray, _numpy_params())
    tp = params_from_jax(_numpy_params(), device="cpu")
    jcache, tcache, jlast, _, _ = _prefill_both(1.25)
    tok = np.array([[int(jlast[0].argmax())], [int(jlast[1].argmax())], [0]],
                   np.int32)
    pos = np.array(list(LENGTHS) + [0], np.int32)
    for step in range(3):
        wv = np.array([True, step != 1, True])
        jl, jcache = jm.paged_decode_step(
            jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(TABLES), write_valid=jnp.asarray(wv))
        tl, tcache = tm.paged_decode_step(
            tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(TABLES), write_valid=torch.from_numpy(wv))
        _close(tl[:2], jl[:2])                 # row 2 is padding garbage
        nxt = np.asarray(jl[:2, -1]).argmax(-1)
        assert (tl[:2, -1].argmax(-1).numpy() == nxt).all()
        tok[:2, 0] = nxt
        pos[:2] += 1
    _close(tcache["k"], jcache["k"])


@pytest.mark.parametrize("cf", [TIGHT, 1.25], ids=["tight", "default"])
def test_gather_dispatch_equals_scatter_and_jax(cf):
    """With carried counts, invalid tokens and per-row caps, the gather
    dispatch gives the scatter dispatch's outputs and counts bit for bit,
    and the JAX gather dispatch's within tolerance."""
    jcfg, cfg = _configs(cf, gather=True)
    tp = params_from_jax(_numpy_params(), device="cpu")["layers"][0]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                _numpy_params()["layers"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 24, cfg.d_model)).astype(np.float32)
    counts = rng.integers(0, 6, (3, cfg.n_experts)).astype(np.int32)
    valid = np.ones((3, 24), bool)
    valid[1, 17:] = valid[2, 5:] = False
    caps = np.array([moe.capacity(cfg, 40), 8, 16], np.int32)
    kw = dict(cap_tokens=40)
    tkw = dict(counts=torch.from_numpy(counts),
               token_valid=torch.from_numpy(valid),
               cap_rows=torch.from_numpy(caps), **kw)
    gy, gaux, gcnt = moe.moe_ffn(cfg, tp, torch.from_numpy(x), **tkw)
    sy, saux, scnt = moe.moe_ffn(cfg.replace(moe_gather_dispatch=False), tp,
                                 torch.from_numpy(x), **tkw)
    assert torch.equal(gy, sy) and torch.equal(gaux, saux)
    assert torch.equal(gcnt, scnt)
    jy, jaux, jcnt = jmoe.moe_ffn(
        jcfg, jp, jnp.asarray(x), counts=jnp.asarray(counts),
        token_valid=jnp.asarray(valid), cap_rows=jnp.asarray(caps), **kw)
    _close(gy, jy)
    np.testing.assert_allclose(float(gaux), float(jaux), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(jcnt))
    # some assignment was dropped, some slot left empty
    assert int(gcnt.sum() - torch.from_numpy(counts).sum()) > 0


def _manager_state(pool):
    return (pool.tables.tolist(), list(pool._free_blocks),
            {h: (e.block, e.refs, e.ready) for h, e in pool._entries.items()},
            list(pool._evictable), pool.prefix_blocks_hit,
            pool.deferred_last_alloc)


def test_block_manager_resume_state_matches_reference():
    """Committed blocks keep the state handed to commit_block; a prefix hit
    resumes from its last hit block's state; free and reset clear it; the
    prefix hashes fold in the MoE capacity, so equal tokens at another
    capacity do not hit (both managers alike)."""
    jcfg, cfg = _configs()
    kw = dict(n_slots=4, max_len=MAX_LEN, block_size=4, n_blocks=40,
              watermark=0.0, prefix_cache=True)
    ref = JaxBlockManager(jax_build(jcfg), **kw)
    port = BlockManager(build_model(cfg), device="cpu", **kw)
    rng = np.random.default_rng(5)
    x = rng.integers(1, 512, size=14).astype(np.int32)
    longer = np.concatenate([x, rng.integers(1, 512, size=30)
                             .astype(np.int32)])
    assert moe.capacity(cfg, len(longer)) != moe.capacity(cfg, len(x))

    def alloc(prompt):
        a = ref.alloc_for(JaxRequest(prompt.copy(), max_new_tokens=2))
        b = port.alloc_for(ServeRequest(prompt.copy(), max_new_tokens=2))
        assert a == b and _manager_state(ref) == _manager_state(port)
        return a

    def resume(slot):
        a, b = ref.resume_state(slot), port.resume_state(slot)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), a)
        return b

    s0 = alloc(x)
    assert resume(s0) is None
    snaps = [rng.integers(0, 9, (cfg.n_layers, 1, cfg.n_experts))
             .astype(np.int32) for _ in range(3)]
    for j, snap in enumerate(snaps):
        ref.commit_block(s0, j, snap.copy())
        port.commit_block(s0, j, torch.from_numpy(snap.copy()))
    assert _manager_state(ref) == _manager_state(port)
    s1 = alloc(x)                          # hits blocks 0..2
    assert port.cached_tokens(s1) == 12
    np.testing.assert_array_equal(resume(s1).numpy(), snaps[2])
    s2 = alloc(longer)                     # same tokens, other capacity
    assert port.cached_tokens(s2) == 0 and resume(s2) is None
    for slot in (s1, s0):
        ref.free(slot)
        port.free(slot)
        assert resume(slot) is None
    s3 = alloc(x)                          # revives the evictable blocks
    np.testing.assert_array_equal(resume(s3).numpy(), snaps[2])
    port.reset()
    assert port.resume_state(s3) is None


def _requests(cls, common_len=16):
    """Six requests, four sharing a 16-token prefix (four full blocks of 4,
    three of them hit: a hit never covers a prompt's last chunk), arriving
    over the decode clock; prompts of 19-36 tokens."""
    rng = np.random.default_rng(31)
    common = rng.integers(1, 512, size=common_len).astype(np.int32)
    reqs = []
    for i, (n, a, b) in enumerate(zip([3, 9, 5, 17, 20, 28],
                                      [0, 0, 1, 1, 3, 4],
                                      [5, 3, 6, 4, 2, 5])):
        tail = rng.integers(1, 512, size=n).astype(np.int32)
        reqs.append(cls(np.concatenate([common, tail]) if i < 4 else tail,
                        max_new_tokens=b, arrival_time=float(a)))
    return reqs


@pytest.mark.parametrize("cf,gather", [(1.25, False), (TIGHT, False),
                                       (TIGHT, True)],
                         ids=["default", "tight", "tight-gather"])
def test_engine_matches_jax_engine(cf, gather):
    """Greedy tokens and every ServeStats counter equal the JAX engine's
    on the paged cache, the shared prefix hitting the cache (the lanes
    resume the counts kept with the hit blocks)."""
    jcfg, cfg = _configs(cf, gather)
    kw = dict(max_len=MAX_LEN, n_slots=3, decode_horizon=4, cache="paged",
              block_size=4, prefill_lanes=2)
    jp = jax.tree_util.tree_map(jnp.asarray, _numpy_params())
    ref, rst = JaxEngine(jcfg, params=jp, **kw).run(_requests(JaxRequest))
    out, st = ServeEngine(cfg, params=params_from_jax(_numpy_params(),
                                                      device="cpu"),
                          device="cpu", **kw).run(_requests(ServeRequest))
    assert [r.output for r in out] == [r.output for r in ref]
    assert len({t for r in out for t in r.output}) > 3
    for name in COUNTERS:
        want, got = getattr(rst, name), getattr(st, name)
        if name == "block_report" and want is not None:
            want = {k: want[k] for k in got}   # the reference's A8 extras
        assert got == want, name
    assert st.prefix_blocks_hit >= 3


@pytest.mark.parametrize("cf", [TIGHT, 1.25], ids=["tight", "default"])
def test_prefix_hits_identical_to_cold(cf):
    """``tests/test_paged.py:452`` for the port: prefix hits that resume the
    counts give the tokens of the paged engine without the prefix cache and
    of static contiguous serving."""
    _, cfg = _configs(cf)
    params = params_from_jax(_numpy_params(), device="cpu")
    kw = dict(params=params, device="cpu", max_len=MAX_LEN)
    paged = dict(n_slots=4, cache="paged", block_size=4)
    cold, _ = ServeEngine(cfg, **kw).run(_requests(ServeRequest))
    warm, st = ServeEngine(cfg, **kw, **paged).run(_requests(ServeRequest))
    off, st_off = ServeEngine(cfg, **kw, **paged, prefix_cache=False).run(
        _requests(ServeRequest))
    assert [r.output for r in warm] == [r.output for r in cold]
    assert [r.output for r in off] == [r.output for r in cold]
    assert st.prefix_blocks_hit > 0 and st_off.prefix_blocks_hit == 0


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
