"""The port's dispatch profiler and profile store (``repro_torch.obs.prof``),
``ArchConfig.param_count`` and the tenant profiler's store path, against
the JAX package, on the CPU.

Profiled engine runs on the same weights give the reference's records
(signature, compile flag, tokens, width, K, FLOPs and HBM bytes exactly;
the durations are each package's own clock). Fed the same records, the
two profilers give equal aggregates and tenant shares, and the two stores
equal round trips, rate fits and dry-run conversions; ``profile_class``
takes the reference's measured, analytic and probed paths. The H100 peaks
replace the reference's TPU ones; the roofline terms (FLOPs and bytes)
equal the reference's.
"""
import numpy as np
import pytest

import repro.obs as JO
import repro.serve as J
from repro.configs import get_config as jax_config
from repro.serve import tenant as jax_tenant
import repro_torch.obs as PO
import repro_torch.serve as P
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.obs import prof
from repro_torch.serve import tenant as port_tenant

from _torch_parity import (ALL_KINDS, chaos_kw, chaos_requests, jax_engine,
                            port_engine)

#: the record fields two runs of one schedule share exactly
FIELDS = ("phase", "sig", "compile", "tokens", "width", "k", "flops",
          "hbm_bytes")


def _requests(M, lengths, tenants, max_new=4, seed=11):
    rng = np.random.default_rng(seed)
    return [M.ServeRequest(rng.integers(1, 512, size=s).astype(np.int32),
                           max_new_tokens=max_new, tenant=t)
            for s, t in zip(lengths, tenants)]


# ---------------------------------------------------------------------------
# config and roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_reference(arch):
    for smoke in (False, True):
        port, ref = get_config(arch, smoke=smoke), jax_config(arch,
                                                              smoke=smoke)
        for active in (False, True):
            assert (port.param_count(active_only=active)
                    == ref.param_count(active_only=active))


def test_h100_peaks_and_roofline_terms():
    cfg = get_config("qwen2-0.5b")
    p = PO.DispatchProfiler(cfg)
    assert (p.peak_flops, p.hbm_bw) == (989e12, 3.35e12)
    over = PO.DispatchProfiler(cfg, peak_flops=1.0, hbm_bw=2.0)
    assert (over.peak_flops, over.hbm_bw) == (1.0, 2.0)
    ref = JO.DispatchProfiler(jax_config("qwen2-0.5b"), peak_flops=989e12,
                              hbm_bw=3.35e12)
    for phase, kw in (("decode", dict(tokens=64, k=8, kv_pos_sum=2500)),
                      ("prefill_round", dict(tokens=64, kv_pos_sum=300)),
                      ("prefill", dict(tokens=200))):
        assert p.roofline_terms(phase, **kw) == ref.roofline_terms(phase,
                                                                   **kw)
    # a W 8 K 8 horizon re-reads the f32 weights 8 times: bytes bound it
    flops, hbm = p.roofline_terms("decode", tokens=64, k=8, kv_pos_sum=0)
    assert hbm / p.hbm_bw > flops / p.peak_flops
    kv_write = 64 * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 4
    assert hbm == 8 * cfg.param_count() * 4 + kv_write


def test_null_profiler_is_falsy_noop():
    assert not PO.NullDispatchProfiler() and not PO.NULL_PROFILER
    PO.NULL_PROFILER.record("decode", 0.1, width=4, k=8)
    assert PO.NULL_PROFILER.summary() == {}
    assert PO.NULL_PROFILER.records == [] and PO.NULL_PROFILER.tenant_s == {}


CALLS = [("decode", 0.5, dict(width=4, k=8, full=False, kv_pos_sum=40,
                              tenants={"a": 3, "b": 1})),
         ("decode", 0.01, dict(width=4, k=8, full=False, kv_pos_sum=72,
                               tenants={"a": 3, "b": 1})),
         ("decode", 0.4, dict(width=4, k=8, full=True, tenants={"b": 2})),
         ("prefill_round", 0.3, dict(width=2, tokens=8, kv_pos_sum=4,
                                     tenants={"a": 1, "b": 1})),
         ("prefill_round", 0.02, dict(width=2, tokens=8, kv_pos_sum=12,
                                      tenants={"a": 2})),
         ("prefill", 0.2, dict(seq=7, tokens=7, tenants={"b": 1})),
         ("decode", 0.0, dict(width=2, k=1, full=False))]


def _fed(M, cfg):
    p = M.DispatchProfiler(cfg, peak_flops=989e12, hbm_bw=3.35e12)
    obs = M.RunObs(M.Tracer())
    for phase, dur, kw in CALLS:
        p.record(phase, dur, obs=obs, **kw)
    return p, obs


def test_fed_profiler_equals_reference():
    """The same dispatches: equal records (but their clocks), aggregates,
    summaries with tenant shares, gauges and dispatch_profile events."""
    port, pobs = _fed(PO, get_config("qwen2-0.5b", smoke=True))
    ref, robs = _fed(JO, jax_config("qwen2-0.5b", smoke=True))
    strip = lambda rs: [{k: v for k, v in r.items() if k != "t"}  # noqa
                        for r in rs]
    assert strip(port.records) == strip(ref.records)
    assert port.by_signature() == ref.by_signature()
    assert port.summary() == ref.summary()
    assert port.summary()["tenant_shares"]["a"] == pytest.approx(
        (0.5 * 0.75 + 0.01 * 0.75 + 0.3 * 0.5 + 0.02) / 1.43)
    for kind in ("counters", "gauges"):
        assert ({k: m.value for k, m in getattr(pobs.metrics, kind).items()}
                == {k: m.value
                    for k, m in getattr(robs.metrics, kind).items()})
    assert ([{k: v for k, v in e.items() if k != "t"}
             for e in pobs.tracer.events]
            == [{k: v for k, v in e.items() if k != "t"}
                for e in robs.tracer.events])


# ---------------------------------------------------------------------------
# profiled engine runs against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_profiled_records_equal_jax_engine(cache):
    """Two runs on one engine (compiles, then executes), two tenants: the
    records' static half and roofline terms are the reference's; execute
    records carry a utilization and the stats a ``decode_util``."""
    kw = dict(max_len=32, n_slots=2, cache=cache)
    if cache == "paged":
        kw.update(block_size=4, prefill_lanes=2)
    lengths, tenants = [5, 7, 5, 7], ["a", "b", "a", "b"]
    profs, stats = [], []
    for M, engine, D, cfg in (
            (J, jax_engine, JO.DispatchProfiler, jax_config),
            (P, port_engine, PO.DispatchProfiler, get_config)):
        p = D(cfg("qwen2-0.5b", smoke=True))
        eng = engine("qwen2-0.5b", profiler=p, **kw)
        for _ in range(2):
            _, st = eng.run(_requests(M, lengths, tenants))
        profs.append(p)
        stats.append(st)
    ref, port = ([{k: r[k] for k in FIELDS} for r in p.records]
                 for p in profs)
    assert port == ref
    assert any(r["compile"] for r in port) and not all(r["compile"]
                                                       for r in port)
    assert all((r["util"] is None) == r["compile"]
               for r in profs[1].records)
    assert stats[1].decode_util > 0
    assert len(profs[1].records) == 2 * (stats[1].decode_dispatches
                                         + stats[1].prefill_dispatches)
    assert set(profs[1].summary()["tenant_shares"]) == {"a", "b"}


def test_store_fills_at_replans():
    """With tenants, a profiler and a store, every re-plan at a reshape
    folds the run's profile into the store (keyed by the cache kind); the
    tokens stay those of the run without them."""
    spec = ALL_KINDS.format(fail=9, fail_units=4)
    cfg = get_config("qwen2-0.5b", smoke=True)
    bare, s_bare = port_engine("qwen2-0.5b", **chaos_kw(
        P, "paged", spec)).run(chaos_requests(P))
    store = PO.ProfileStore()
    out, st = port_engine("qwen2-0.5b", profiler=PO.DispatchProfiler(cfg),
                          profile_store=store,
                          **chaos_kw(P, "paged", spec)).run(
        chaos_requests(P))
    assert [r.output for r in out] == [r.output for r in bare]
    assert st.replans == s_bare.replans > 0
    assert len(store) > 0
    assert {(r["source"], r["arch"], r["backend"]) for r in store.records} \
        == {("serve", "qwen2-0.5b", "paged")}


# ---------------------------------------------------------------------------
# the profile store
# ---------------------------------------------------------------------------
def _decode_rec(width, k, mean_s, n=4, arch="a1", backend="paged"):
    return {"source": "serve", "arch": arch, "backend": backend,
            "mesh": None, "phase": "decode", "sig": f"decode/W{width}/K{k}",
            "width": width, "k": k, "tokens": width * k, "n": n,
            "compiles": 1, "compile_s": 0.5, "mean_s": mean_s,
            "flops": 1e9, "hbm_bytes": 1e8, "util": 0.1}


STORES = {
    "fit": [_decode_rec(w, k, 8e-3 + w * k * 2.5e-4)
            for w, k in [(1, 8), (2, 8), (4, 8), (4, 4)]],
    "one_size": [_decode_rec(4, 8, 0.02)],
    "flat": [_decode_rec(1, 8, 0.02), _decode_rec(2, 8, 0.02)],
    "mixed": [_decode_rec(1, 8, 0.01, arch="a2"),
              _decode_rec(2, 8, 0.03, arch="a1", backend="contiguous"),
              _decode_rec(4, 8, 0.05, n=0), _decode_rec(8, 8, 0.07),
              _decode_rec(2, 4, 0.02)],
}


@pytest.mark.parametrize("name", sorted(STORES))
def test_store_round_trip_and_rate_fit_like_reference(name, tmp_path):
    recs = STORES[name] + STORES[name][:1]          # a repeated key
    port, ref = PO.ProfileStore(recs), JO.ProfileStore(recs)
    assert port.records == ref.records and len(port) == len(ref)
    path = str(tmp_path / "p.jsonl")
    port.save(path)
    assert PO.ProfileStore.load(path).records == \
        JO.ProfileStore.load(path).records == ref.records
    for arch in ("a1", "a2", "zz"):
        for backend in (None, "paged", "contiguous"):
            assert port.rate_fit(arch, backend) == ref.rate_fit(arch, backend)
    assert len(PO.ProfileStore.load(str(tmp_path / "none.jsonl"))) == 0


def test_add_run_and_dryrun_record_like_reference():
    port, ref = (_fed(PO, get_config("qwen2-0.5b", smoke=True))[0],
                 _fed(JO, jax_config("qwen2-0.5b", smoke=True))[0])
    ps, rs = PO.ProfileStore(), JO.ProfileStore()
    assert (ps.add_run(port, arch="qwen2-0.5b", backend="paged")
            == rs.add_run(ref, arch="qwen2-0.5b", backend="paged"))
    dry = {"arch": "qwen2-0.5b", "shape": "decode_32k", "mesh": "host",
           "mode": "decode_step", "compute_s": 0.001, "memory_s": 0.004,
           "collective_s": 0.0, "bottleneck": "memory",
           "flops_per_chip": 1.2e12, "bytes_per_chip": 3.4e9,
           "useful_flop_ratio": 0.41}
    ps.add_dryrun_record(dry)
    rs.add_dryrun_record(dry)
    assert ps.records == rs.records
    assert ps.rate_fit("qwen2-0.5b", "paged") == \
        rs.rate_fit("qwen2-0.5b", "paged")


# ---------------------------------------------------------------------------
# the tenant profiler's store path (tests/test_prof.py:203-238)
# ---------------------------------------------------------------------------
def _probe(k):
    return 100.0 * k / (1 + 0.1 * k)


CLASS_CASES = {
    "measured": dict(store="fit"),
    "analytic_no_store": dict(),
    "analytic_no_fit": dict(store="one_size"),
    "analytic_other_backend": dict(store="fit", backend="contiguous"),
    "analytic_no_arch": dict(store="fit", arch=None),
    "probed_over_store": dict(store="fit", probe=True),
}


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_profile_class_paths_like_reference(case):
    spec = dict(CLASS_CASES[case])
    got = []
    for M, T in ((J, jax_tenant), (P, port_tenant)):
        store_cls = JO.ProfileStore if M is J else PO.ProfileStore
        kw = dict(units_per_req=2, concurrency=4, total_units=8, max_k=8,
                  arch=spec.get("arch", "a1"),
                  backend=spec.get("backend", "paged"))
        if "store" in spec:
            kw["store"] = store_cls(STORES[spec["store"]])
        if spec.get("probe"):
            kw["probe"] = _probe
        p = T.profile_class("t", **kw)
        got.append((p.source, p.t_tok, p.t_fixed,
                    np.asarray(p.matrix.W).tolist()))
    assert got[1] == got[0]
    assert got[1][0] == case.split("_")[0]
    if case == "measured":
        assert got[1][1] == pytest.approx(2.5e-4, rel=1e-6)


def test_profiles_from_requests_with_store_like_reference():
    reqs = {M: [M.ServeRequest(np.arange(1, 9, dtype=np.int32),
                               max_new_tokens=4, tenant=t)
                for t in ("lat", "batch", "lat")] for M in (J, P)}
    out = []
    for M, S in ((J, JO.ProfileStore), (P, PO.ProfileStore)):
        reg = M.TenantRegistry([M.Tenant("lat", slo_steps=12.0),
                                M.Tenant("batch")])
        profs = M.profiles_from_requests(
            reg, reqs[M], total_units=12, units_for=lambda r: 3, max_k=8,
            store=S(STORES["fit"]), arch="a1", backend="paged")
        out.append({t: (p.source, p.t_tok, p.t_fixed, p.units_per_req,
                        p.concurrency) for t, p in profs.items()})
    assert out[1] == out[0]
    assert {v[0] for v in out[1].values()} == {"measured"}


def test_sharding_still_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        P.ServeEngine(get_config("qwen2-0.5b", smoke=True), device="cpu",
                      sharding=object())
    assert prof.PEAK_FLOPS_BF16 == 989e12 and prof.HBM_BW == 3.35e12
