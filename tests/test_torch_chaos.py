"""Fault injection and trace replay on the port (``repro_torch.serve.chaos``,
``serve.replay``, ``core.trace``) against the JAX package, on the CPU.

Host-side results are held exactly: the fault-spec grammar and its errors,
the schedule's JSON, the injector's due faults, restores, holds, victim
picks and burst prompts from one seed, the ``BlockManager``'s shrink /
expand / flush / audit sequences, the Philly trace and request set. Engine
runs under all eight fault kinds (qwen2 on both caches with tenants and an
elastic controller; olmoe on the paged cache with tenants; a pool shrink
that drops) give the JAX engine's tokens, injected faults, dropped ids and
causes, counters and steps-based per-tenant stats (``_torch_parity``); the
JAX runs are shared through module-scoped fixtures.
"""
import json

import numpy as np
import pytest
import torch

import repro.serve as J
from repro.configs import get_config as jax_config
from repro.core import trace as jax_trace
from repro.models.api import build_model as jax_build
import repro_torch.serve as P
from repro_torch.configs import get_config
from repro_torch.core import trace as port_trace
from repro_torch.models.api import build_model

from _torch_parity import (ALL_KINDS, TAILS, TAILS2, chaos_kw,
                            chaos_requests, jax_engine, port_engine, record)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "qwen2-0.5b"
# ---------------------------------------------------------------------------
# spec grammar, schedule JSON, injector
# ---------------------------------------------------------------------------
SPECS = ["pool_shrink@12:blocks=6:restore_after=20", " slot_kill@8 ",
         "arrival_burst@4:n=2:tenant=t1:prompt_len=9:max_new=2",
         "defer_storm@2:duration=3", "tenant_slowdown@3:tenant=a",
         "device_fail@5:blocks=3:restore_after=7", "device_join@1:blocks=2",
         "prefix_flush@0.5", "pool_restore@9:blocks=1", "slot_kill@2:slot=1"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_like_reference(spec):
    assert P.Fault.from_spec(spec).__dict__ == J.Fault.from_spec(spec).__dict__


@pytest.mark.parametrize("spec", ["gamma_ray@3", "slot_kill",
                                  "slot_kill@3:bogus=1", "tenant_slowdown@3",
                                  "slot_kill@x", "pool_shrink@1:blocks=q"])
def test_fault_spec_errors_like_reference(spec):
    with pytest.raises(ValueError) as ref:
        J.Fault.from_spec(spec)
    with pytest.raises(ValueError) as port:
        P.Fault.from_spec(spec)
    assert str(port.value) == str(ref.value)


def test_schedule_json_equals_reference(tmp_path):
    spec = ",".join(s.strip() for s in SPECS)
    ref, port = (M.FaultSchedule.from_spec(spec, seed=3) for M in (J, P))
    assert json.dumps(port.to_json()) == json.dumps(ref.to_json())
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(ref.to_json()))
    back = P.FaultSchedule.from_json(str(path))
    assert back.seed == 3 and back.faults == port.faults
    assert back.to_json() == ref.to_json()


def _injectors(spec, seed=9):
    out = []
    for M in (J, P):
        inj = M.FaultInjector(M.FaultSchedule.from_spec(spec, seed=seed))
        inj.bind(vocab_size=97, max_len=32, n_slots=4)
        out.append(inj)
    return out


def test_injector_due_restores_and_pending_capacity():
    spec = ("slot_kill@8,prefix_flush@4,pool_shrink@8:blocks=2,"
            "device_fail@6:blocks=3:restore_after=2")
    ref, port = _injectors(spec)
    kinds = lambda fs: [(f.kind, f.step, f.blocks) for f in fs]  # noqa: E731
    for inj in (ref, port):
        inj.defer_restore(J.Fault("pool_shrink", step=8, blocks=4,
                                  restore_after=6) if inj is ref else
                          P.Fault("pool_shrink", step=8, blocks=4,
                                  restore_after=6), 9.0, 3)
        inj.defer_restore(J.Fault("device_fail", 6, blocks=3,
                                  restore_after=2) if inj is ref else
                          P.Fault("device_fail", 6, blocks=3,
                                  restore_after=2), 6.0, 2)
    for step in (0, 3, 4, 7, 8, 9, 14, 15, 100):
        assert port.next_fault_step(step) == ref.next_fault_step(step)
        assert port.pending_capacity(step) == ref.pending_capacity(step)
        assert kinds(port.due(step)) == kinds(ref.due(step))
    port.reset()
    ref.reset()
    assert port.next_fault_step(0) == ref.next_fault_step(0) == 4


def test_injector_holds_like_reference():
    ref, port = _injectors("")
    reqs = {M: M.ServeRequest(np.zeros(4, np.int32), max_new_tokens=1,
                              tenant="t1") for M in (J, P)}
    for inj, M in ((ref, J), (port, P)):
        inj.hold("t1", until=5.0)
        inj.hold(None, until=8.0)
        inj.hold("t1", until=4.0)          # never shortens a window
    for step in (0, 3, 4.5, 5, 6, 7.9, 8, 9):
        assert port.hold_cause(reqs[P], step) == ref.hold_cause(reqs[J], step)
        assert port.release_step(step) == ref.release_step(step)
        assert port.has_holds(step) == ref.has_holds(step)


def test_injector_seeded_choices_like_reference():
    spec = "arrival_burst@2:n=3:prompt_len=20:max_new=5:tenant=b"
    ref, port = _injectors(spec, seed=13)
    for live, want in (([0, 2, 3], None), ([3, 1], None), ([0, 2, 3], 2),
                       ([], None), ([5], 7), ([1, 2, 3, 4], None)):
        assert port.pick_slot(live, want) == ref.pick_slot(live, want)
    for _ in range(2):
        fr = ref.burst_requests(ref.schedule.faults[0])
        fp = port.burst_requests(port.schedule.faults[0])
        assert [(r.prompt.tolist(), r.max_new_tokens, r.tenant)
                for r in fp] == [(r.prompt.tolist(), r.max_new_tokens,
                                  r.tenant) for r in fr]
        assert all(r.prompt.dtype == np.int32 for r in fp)


# ---------------------------------------------------------------------------
# BlockManager: shrink / expand / flush / audit against the reference
# ---------------------------------------------------------------------------
def _pool_state(pool):
    entries = {h: (e.block, e.refs, e.ready, e.retired)
               for h, e in pool._entries.items()}
    return (pool.tables.tolist(), list(pool._free_blocks),
            list(pool._revoked), pool._revoke_deficit, pool.n_blocks,
            pool.watermark_blocks, entries, list(pool._evictable),
            pool.prefix_blocks_hit, pool.audit(), pool.report())


def test_block_manager_reshapes_like_reference():
    """Admissions with shared prefixes, a shrink past the idle blocks (a
    deficit), a flush at nonzero refcount (retired entries), frees that
    pay the deficit, an expand, a shrink to one block, a restore and a
    newcomer that must miss the retired prefix leave both managers in the
    same state after every operation."""
    kw = dict(n_slots=4, max_len=32, block_size=4, n_blocks=14,
              watermark=0.25, prefix_cache=True)
    ref = J.BlockManager(jax_build(jax_config(ARCH, smoke=True)), **kw)
    port = P.BlockManager(build_model(get_config(ARCH, smoke=True)),
                          device="cpu", **kw)
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, 50, size=8).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 50, size=n)
                               .astype(np.int32)]) for n in (3, 2, 5, 1)]
    rq = [J.ServeRequest(p.copy(), max_new_tokens=3) for p in prompts]
    pq = [P.ServeRequest(p.copy(), max_new_tokens=3) for p in prompts]

    def both(op, *args):
        a = getattr(ref, op)(*args)
        b = getattr(port, op)(*args)
        assert a == b, (op, a, b)
        assert _pool_state(port) == _pool_state(ref), op
        return a

    s0 = ref.alloc_for(rq[0])
    assert port.alloc_for(pq[0]) == s0
    for j in range(2):
        both("commit_block", s0, j)
    s1 = ref.alloc_for(rq[1])
    assert port.alloc_for(pq[1]) == s1 and port.prefix_blocks_hit == 2
    assert _pool_state(port) == _pool_state(ref)
    both("ensure", s0, 16)
    both("shrink", 12)                      # more than the idle blocks
    assert port._revoke_deficit > 0
    both("flush_prefix")                    # retires the held entries
    both("free", s0)                        # pays the deficit first
    both("expand", 3)
    for _ in range(2):                      # the second after a full
        s2 = ref.alloc_for(rq[2])           # restore, if the first waits
        assert port.alloc_for(pq[2]) == s2
        assert _pool_state(port) == _pool_state(ref)
        if s2 is not None:
            break
        both("expand", 100)
    assert s2 is not None
    both("free", s1)                        # the last holder: retired go
    both("shrink", 100)                     # one block of capacity stays
    assert port.n_blocks == 1
    both("expand", 100)
    both("free", s2)
    hits = port.prefix_blocks_hit
    s3 = ref.alloc_for(rq[3])               # misses the flushed prefix
    assert port.alloc_for(pq[3]) == s3 is not None
    assert port.prefix_blocks_hit == hits
    assert _pool_state(port) == _pool_state(ref)
    both("drain_dirty")


def test_audit_catches_corruption():
    port = P.BlockManager(build_model(get_config(ARCH, smoke=True)),
                          n_slots=2, max_len=32, block_size=8, n_blocks=6,
                          watermark=0.0, device="cpu")
    slot = port.alloc_for(P.ServeRequest(np.zeros(9, np.int32),
                                         max_new_tokens=2))
    port.audit()
    port._free_blocks.append(int(port.tables[slot, 0]))  # free and held
    with pytest.raises(RuntimeError, match="block audit failed"):
        port.audit()
    port._free_blocks.pop()
    port._revoked.append(99)
    with pytest.raises(RuntimeError, match="capacity arithmetic"):
        port.audit()


# ---------------------------------------------------------------------------
# the Philly trace and request set
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,load", [(7, 2.0), (3, 0.5), (11, 8.0)])
def test_philly_requests_like_reference(seed, load):
    tenant_of = lambda j: "batch" if j.gpu_demand > 1 else "lat"  # noqa
    kw = dict(load=load, seed=seed, prompt_len=64, max_new=32, max_len=256,
              tenant_of=tenant_of)
    ref = J.philly_requests(151936, 24, **kw)
    port = P.philly_requests(151936, 24, **kw)
    assert [(r.prompt.tolist(), r.arrival_time, r.max_new_tokens, r.tenant)
            for r in port] == [(r.prompt.tolist(), r.arrival_time,
                                r.max_new_tokens, r.tenant) for r in ref]
    assert {r.tenant for r in port} == {"lat", "batch"} or seed != 7
    with pytest.raises(ValueError, match="load"):
        P.philly_requests(257, 4, load=0.0)


def test_philly_trace_like_reference():
    fields = ("job_id", "model_name", "gpu_demand", "arrival_time",
              "duration")
    for kw in (dict(n_jobs=200, seed=7, jobs_per_hour=64.0),
               dict(n_jobs=50, seed=1, jobs_per_hour=7200.0,
                    split=(0, 50, 50))):
        ref = jax_trace.philly_trace(**kw)
        port = port_trace.philly_trace(**kw)
        assert ([tuple(getattr(j, f) for f in fields) for j in port]
                == [tuple(getattr(j, f) for f in fields) for j in ref])
    cfg = dict(n_jobs=20, arrival="static", multi_gpu=False, seed=2)
    static = port_trace.generate(port_trace.TraceConfig(**cfg))
    assert ([tuple(getattr(j, f) for f in fields) for j in static]
            == [tuple(getattr(j, f) for f in fields)
                for j in jax_trace.generate(jax_trace.TraceConfig(**cfg))])
    assert all((j.gpu_demand, j.arrival_time) == (1, 0.0) for j in static)


# ---------------------------------------------------------------------------
# engine runs against the JAX engine
# ---------------------------------------------------------------------------
SCENARIOS = {
    # all eight kinds, tenants, elastic; grows the pool three times
    "paged": ("qwen2-0.5b", "paged", ALL_KINDS.format(fail=9, fail_units=4),
              {}),
    # all eight kinds on slots: the shrink / flush no-ops are still logged
    "contiguous": ("qwen2-0.5b", "contiguous",
                   ALL_KINDS.format(fail=0, fail_units=1),
                   dict(tails=TAILS2, k=2)),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Each scenario's JAX engine run, computed once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            arch, kind, spec, opt = SCENARIOS[name]
            kw = chaos_kw(J, kind, spec, **opt)
            eng = jax_engine(arch, **kw)
            out, st = eng.run(chaos_requests(J, opt.get("tails", TAILS)))
            cache[name] = record(eng, out, st)
        return cache[name]
    return get


def _port_run(name):
    arch, kind, spec, opt = SCENARIOS[name]
    kw = chaos_kw(P, kind, spec, **opt)
    eng = port_engine(arch, **kw)
    out, st = eng.run(chaos_requests(P, opt.get("tails", TAILS)))
    if kind == "paged":
        eng.pool.audit()
    return eng, out, st


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chaos_engine_matches_jax_engine(jax_runs, name):
    eng, out, st = _port_run(name)
    got = record(eng, out, st)
    want = jax_runs(name)
    for key in want:
        assert got[key] == want[key], key
    assert set(P.FAULT_KINDS) <= {k for k, _ in got["injected"]}
    assert st.recoveries >= 1
    assert st.preemptions >= 1              # the killed slot regenerated
    if name == "paged":
        assert st.migrated_blocks > 0 and len(eng.migrations) >= 1
        assert st.scale_downs >= 1 and st.replans >= 1
        assert st.prefix_blocks_hit > 0


def test_chaos_run_repeats_on_one_engine():
    """Two runs of one chaos engine (the grown pool dropped, a new one
    built) give the same record, and the first run's faults land on the
    steps the schedule names."""
    eng, out, st = _port_run("paged")
    first = record(eng, out, st)
    again = record(eng, *eng.run(chaos_requests(P)))
    assert again == first
    assert eng.pool.n_blocks >= 24


def test_run_replay_verifies_on_the_cpu():
    """``run_replay(verify=True)``: every request not dropped, the burst
    included, equals the fault-free static contiguous engine at K=1 on the
    same weights."""
    arch, kind, spec, opt = SCENARIOS["paged"]
    eng = port_engine(arch, **chaos_kw(P, kind, spec, **opt))
    res = P.run_replay(eng, chaos_requests(P), verify=True,
                       ref_cfg=get_config(arch, smoke=True))
    assert res.verified and res.mismatched == []
    assert len(res.requests) == 10 and res.faults == eng.injector.injected
    with pytest.raises(ValueError, match="ref_cfg"):
        P.run_replay(eng, chaos_requests(P), verify=True)
