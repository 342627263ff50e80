"""Elastic serving on the port (``repro_torch.serve.elastic``, the pools'
reshape surface, the engine's reactive and proactive reshapes) against the
JAX package, on the CPU.

Held exactly: ``ScalePlan`` validation, ``ElasticController.decide`` over
a sequence of gauges (thresholds, caps, floors, cooldown, reset), the
``CachePool``'s shrink / expand, the ``BlockManager``'s growth (free list,
tables, ledger; the old blocks in the new pools' leading slice). Engine
runs that grow the pool mid-run (a ``device_join`` past the constructed
pool; the CPU ``GraphRunner`` raises if a program captured over the old
pool ran again), that scale proactively, and that re-plan tenants at each
reshape, and a shrink that drops, give the JAX engine's tokens, faults,
drops, counters and pool contents;
two runs of one engine agree after a shrink and a growth; the replay CLI
verifies.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.serve as J
from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.obs import MetricsRegistry as JaxMetrics
import repro_torch.serve as P
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.obs import MetricsRegistry
from repro_torch.serve.elastic import pool_capacity

from _torch_parity import (chaos_kw, chaos_requests, jax_engine,
                           port_engine, record)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b"


class _Pool:
    """Capacity-only pool stand-in for the controller's decisions."""

    def __init__(self, n_blocks, free_blocks=None):
        self.n_blocks = n_blocks
        self.free_blocks = n_blocks if free_blocks is None else free_blocks


# ---------------------------------------------------------------------------
# ScalePlan and the controller
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(kind="scale_up", units=4, reason="occupancy"),
    dict(kind="scale_up", units=0, reason="device_join", dmult=8),
    dict(kind="sideways", units=4, reason="occupancy"),
    dict(kind="scale_up", units=-1, reason="occupancy"),
    dict(kind="scale_down", units=0, reason="occupancy")])
def test_scale_plan_like_reference(kw):
    try:
        want = J.ScalePlan(**kw).__dict__
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.ScalePlan(**kw)
        assert str(got.value) == str(e)
    else:
        assert P.ScalePlan(**kw).__dict__ == want


#: (step, pool capacity, free blocks, gauges set before the decision)
GAUGES = [
    (0, 16, None, {}),                                  # nothing sampled
    (1, 16, None, {"occupancy": 0.95, "queue_depth": 0}),
    (2, 30, None, {}), (3, 32, None, {}),
    (4, 16, None, {"occupancy": 0.5, "queue_depth": 4}),
    (5, 16, None, {"queue_depth": 0, "slack[lat]": -2.0}),
    (6, 16, None, {"slack[lat]": 9.0, "occupancy": 0.05}),
    (7, 16, 2, {}), (8, 16, 0, {}), (9, 8, None, {}),
    (10, 16, None, {"queue_depth": 1}),
    (11, 12, 10, {"queue_depth": 0, "occupancy": 0.1}),
    (12, 20, 3, {"occupancy": 0.93}),
]


@pytest.mark.parametrize("ctl_kw", [
    dict(queue_hi=4, step_units=8, max_units=32, min_units=8, cooldown=0.0),
    dict(queue_hi=2, step_units=3, max_units=20, min_units=10, cooldown=3.0),
    dict(step_units=5, cooldown=2.0)])
def test_controller_decisions_like_reference(ctl_kw):
    """One gauge sequence through both controllers, each applied decision
    noted (the shared cooldown clock), then a reset and the sequence
    again: the same plans, decisions and pending units."""
    ref, port = J.ElasticController(**ctl_kw), P.ElasticController(**ctl_kw)
    jm, pm = JaxMetrics(), MetricsRegistry()
    for _ in range(2):
        for step, cap, free, gauges in GAUGES:
            for m in (jm, pm):
                for name, v in gauges.items():
                    m.gauge(name).set(v)
            pool = _Pool(cap, free)
            a, b = ref.decide(step, pool, jm), port.decide(step, pool, pm)
            assert (b.__dict__ if b else None) == (a.__dict__ if a else None)
            if a is not None:
                ref.note_scale(step, a)
                port.note_scale(step, b)
            assert port.pending_units(pool) == ref.pending_units(pool)
        assert port.decisions == ref.decisions
        assert (port.max_units, port.min_units) == (ref.max_units,
                                                    ref.min_units)
        ref.reset()
        port.reset()
    with pytest.raises(ValueError, match="occupancy_lo"):
        P.ElasticController(occupancy_lo=0.9, occupancy_hi=0.5)
    with pytest.raises(ValueError, match="step_units"):
        P.ElasticController(step_units=0)


# ---------------------------------------------------------------------------
# the pools' reshape surface
# ---------------------------------------------------------------------------
def test_cache_pool_shrink_expand_like_reference():
    ref = J.CachePool(jax_build(jax_config(ARCH, smoke=True)), 4, 32)
    port = P.CachePool(build_model(get_config(ARCH, smoke=True)), 4, 32,
                       device="cpu")

    def state(pool):
        return (list(pool._free), sorted(pool._in_use), list(pool._revoked),
                pool.capacity, pool_capacity(pool), pool.utilization)

    for op, arg in (("alloc", ()), ("alloc", ()), ("shrink", (5,)),
                    ("expand", (1,)), ("free", (0,)), ("shrink", (1,)),
                    ("alloc", ()), ("expand", (9,)), ("shrink", (2,)),
                    ("alloc", ()), ("alloc", ())):
        assert getattr(port, op)(*arg) == getattr(ref, op)(*arg), op
        assert state(port) == state(ref), op
    port.reset()
    assert state(port) == ([0, 1, 2, 3], [], [], 4, 4, 0.0)


def test_grow_physical_like_reference():
    """Blocks written, a shrink, a growth past the buffers: the same free
    list, ledger and capacity, every old block in the new pools' leading
    slice, the new blocks zero; a grown pool cannot be reset in place."""
    kw = dict(n_slots=3, max_len=32, block_size=4, n_blocks=10,
              watermark=0.1)
    ref = J.BlockManager(jax_build(jax_config(ARCH, smoke=True)), **kw)
    port = P.BlockManager(build_model(get_config(ARCH, smoke=True)),
                          device="cpu", **kw)
    rng = np.random.default_rng(0)
    k = rng.standard_normal(ref.buffers["k"].shape).astype(np.float32)
    ref.buffers = {"k": ref.buffers["k"] + k, "v": ref.buffers["v"] - k}
    port.buffers["k"].copy_(torch.from_numpy(k))
    port.buffers["v"].copy_(torch.from_numpy(-k))
    for pool, M in ((ref, J), (port, P)):
        pool.alloc_for(M.ServeRequest(np.arange(1, 10, dtype=np.int32),
                                      max_new_tokens=4))
        pool.shrink(8)
        assert pool.expand(3) == 3
        assert pool.grow_physical(0) == 0
        assert pool.grow_physical(5) == 5
    assert (list(port._free_blocks), list(port._revoked),
            port._revoke_deficit, port.n_blocks, port.watermark_blocks,
            port.tables.tolist()) == (
        list(ref._free_blocks), list(ref._revoked), ref._revoke_deficit,
        ref.n_blocks, ref.watermark_blocks, ref.tables.tolist())
    assert port.audit() == ref.audit()
    for name, sign in (("k", 1), ("v", -1)):
        got = port.buffers[name].numpy()
        assert got.shape == tuple(ref.buffers[name].shape)
        assert got.shape[1] == 15
        np.testing.assert_array_equal(got, np.asarray(ref.buffers[name]))
        np.testing.assert_array_equal(got[:, :10], sign * k)
        assert not got[:, 10:].any()
    assert port.grown
    with pytest.raises(ValueError, match="grew"):
        port.reset()


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------
GROW = dict(spec="device_join@3:blocks=8", n_blocks=8)


def _grow_kw(M):
    return chaos_kw(M, "paged", GROW["spec"], tenants=False, elastic=False,
                    n_blocks=GROW["n_blocks"])


def test_mid_run_growth_matches_jax_engine():
    """A join past the constructed pool migrates every live block into
    larger pools mid-run: the captured programs are dropped and captured
    anew over the new pools (the CPU runner raises if an old one ran
    again), and tokens, counters and the pool contents equal the JAX
    engine's."""
    ref = jax_engine(ARCH, **_grow_kw(J))
    want = record(ref, *ref.run(chaos_requests(J)))
    eng = port_engine(ARCH, **_grow_kw(P))
    out, st = eng.run(chaos_requests(P))
    got = record(eng, out, st)
    for key in want:
        assert got[key] == want[key], key
    assert st.migrated_blocks > 0 and st.scale_ups == 1
    (mig,) = eng.migrations
    assert mig["added"] == 8 and mig["blocks"] == st.migrated_blocks
    assert mig["graphs_dropped"] > 0 and mig["bytes"] > 0
    assert eng.pool.n_blocks == 16 and eng.pool.audit()["capacity"] == 16
    for name in ("k", "v"):
        # f32 K/V of two implementations (the hybrid tests' per-piece
        # tolerance)
        np.testing.assert_allclose(eng.pool.buffers[name].numpy(),
                                   np.asarray(ref.pool.buffers[name]),
                                   rtol=1e-4, atol=1e-4)
    # the second run builds a new pool at the constructed size
    again = record(eng, *eng.run(chaos_requests(P)))
    assert again == got
    assert eng.pool.n_blocks == 16 and eng.pool._blocks0 == 8


def test_proactive_and_reactive_reshapes_match_jax_engine():
    """Tenants, SLO ordering, an allocation, an elastic controller that
    reclaims revoked capacity, a ``device_fail`` with its auto-join and a
    shrink with its restore: every reshape re-plans the tenants, and the
    JAX engine's record holds; the re-planned reserves fit the pool."""
    spec = ("device_fail@2:blocks=6:restore_after=6,"
            "pool_shrink@4:blocks=4:restore_after=8")
    ctl = dict(queue_hi=2, step_units=4, cooldown=2.0)
    runs = []
    for M, mk in ((J, jax_engine), (P, port_engine)):
        kw = chaos_kw(M, "paged", spec, elastic=False, n_blocks=20)
        kw["elastic"] = M.ElasticController(**ctl)
        eng = mk(ARCH, **kw)
        runs.append((eng, record(eng, *eng.run(chaos_requests(M)))))
    (ref, want), (eng, got) = runs
    for key in want:
        assert got[key] == want[key], key
    assert eng.elastic.decisions == ref.elastic.decisions
    st = got["counters"]
    assert st["replans"] == st["scale_ups"] + st["scale_downs"] >= 2
    assert ({t: s.__dict__ for t, s in eng.allocation.shares.items()}
            == {t: s.__dict__ for t, s in ref.allocation.shares.items()})
    assert sum(eng.pool.tenant_reserves.values()) <= eng.pool.n_blocks
    eng.pool.audit()


def test_shrink_drops_match_jax_engine():
    """A shrink that never returns: late arrivals drop after their bounded
    retries, an oversized burst at once; both engines drop the same
    requests for the same causes, which count in ``dropped``, not in
    ``unfinished``."""
    spec = ("slot_kill@2,pool_shrink@3:blocks=64,arrival_burst@4:n=2:"
            "prompt_len=40:max_new=8")
    runs = []
    for M, mk in ((J, jax_engine), (P, port_engine)):
        kw = chaos_kw(M, "paged", spec, tenants=False, elastic=False,
                      n_blocks=16)
        eng = mk(ARCH, max_admit_retries=2, **kw)
        out, st = eng.run(chaos_requests(M))
        runs.append((record(eng, out, st), out, st))
    (want, _, _), (got, out, st) = runs
    for key in want:
        assert got[key] == want[key], key
    assert st.dropped >= 2 and st.unfinished == 0
    assert {c for _, c in got["dropped"]} == {"pool_shrink",
                                              "burst_unservable"}
    assert all(r.output == [] for r in out if r.dropped)


def test_two_runs_agree_after_shrink_and_growth():
    """One engine, two runs: the shrink's revoked ledger, the deficit and
    the grown pool are gone at the second run's start, which repeats the
    first exactly; a contiguous engine with a slot revoked at the first
    boundary repeats too."""
    spec = ("pool_shrink@1:blocks=12:restore_after=3,"
            "device_join@6:blocks=6,slot_kill@5")
    eng = port_engine(ARCH, **chaos_kw(P, "paged", spec, n_blocks=16))
    first = record(eng, *eng.run(chaos_requests(P)))
    assert first["counters"]["migrated_blocks"] > 0
    assert record(eng, *eng.run(chaos_requests(P))) == first
    eng = port_engine(ARCH, **chaos_kw(P, "contiguous",
                                       "device_fail@0:blocks=1:"
                                       "restore_after=4", k=2))
    first = record(eng, *eng.run(chaos_requests(P)))
    assert first["counters"]["scale_downs"] == 1
    assert record(eng, *eng.run(chaos_requests(P))) == first
    assert eng.pool.capacity == 3


def test_hold_until_restore_drops_nothing():
    """A device_fail that leaves the pool too small for the late arrivals,
    with a join scheduled: they wait for it instead of dropping (the
    reference's ``test_hold_until_restore_drops_nothing``), and every
    request verifies against the fault-free engine."""
    rng = np.random.default_rng(5)
    reqs = [P.ServeRequest(rng.integers(1, 512, size=n).astype(np.int32),
                           max_new_tokens=4, arrival_time=a)
            for n, a in zip([9, 12, 10, 11], [0, 0, 6, 6])]
    inj = P.FaultInjector(P.FaultSchedule.from_spec(
        "device_fail@2:blocks=10:restore_after=4"))
    eng = port_engine(ARCH, max_len=32, n_slots=3, cache="paged",
                      block_size=8, n_blocks=12, decode_horizon=4,
                      injector=inj, max_admit_retries=2)
    res = P.run_replay(eng, reqs, verify=True,
                       ref_cfg=get_config(ARCH, smoke=True))
    assert res.stats.dropped == 0 and not res.dropped and res.verified
    assert res.stats.scale_ups == res.stats.scale_downs == 1
    assert any(r.n_retries == 0 and r.arrival_time == 6 for r in reqs)
    eng.pool.audit()


def test_replay_cli_verifies_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", "--device", "cpu",
         "--cache", "paged", "--slots", "3", "--n", "8", "--max-len", "32",
         "--prompt-len", "12", "--max-new", "6", "--block-size", "4",
         "--blocks", "16", "--faults",
         "slot_kill@3,prefix_flush@4,pool_shrink@5:blocks=4:restore_after=3",
         "--elastic", "--verify"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["verified"] and rec["device"] == "cpu"
    assert [f["kind"] for f in rec["faults"]][:2] == ["slot_kill",
                                                      "prefix_flush"]
    from repro_torch.launch import replay
    assert replay.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(NotImplementedError, match="item 10"):
        replay.main(["--mesh", "host", "--device", "cpu"])


@pytest.mark.parametrize("name,item", [("tracer", 9), ("profiler", 9),
                                       ("profile_store", 9),
                                       ("sharding", 10)])
def test_unported_engine_options_name_their_item(name, item):
    """``sharding=`` (item 10) still raises naming its item; item 9's
    options are ported and the engine holds what it is given."""
    cfg = get_config(ARCH, smoke=True)
    if item == 10:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            P.ServeEngine(cfg, device="cpu", **{name: object()})
        return
    from repro_torch import obs
    given = {"tracer": obs.Tracer(), "profiler": obs.DispatchProfiler(cfg),
             "profile_store": obs.ProfileStore()}[name]
    eng = P.ServeEngine(cfg, device="cpu", **{name: given})
    assert getattr(eng, name) is given
