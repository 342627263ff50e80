"""The port's event tracer, Chrome export and trace report
(``repro_torch.obs.events``, ``obs.chrome``, ``launch/trace_report.py``)
against the JAX package, on the CPU.

The tracer's ring, step clock, dump/load and schema check behave as the
reference's. Engine runs on the same weights emit the JAX engine's event
list, event for event and field for field apart from the wall times
(``t``, ``wall_s``, ``dur_s``, ``util``): the two golden runs of
``tests/test_obs.py`` on both caches, the chaos scenario of
``tests/test_chaos.py::test_chaos_replay_is_deterministic`` and the
all-kinds chaos scenario of ``_torch_parity`` (migrate and scale events).
The Chrome export and the trace report of one event list equal the
reference's. Tracing and profiling change no token and no counter, and
the serve and replay CLIs write and gate what their flags ask for.
"""
import json

import numpy as np
import pytest

import repro.obs as JO
import repro.serve as J
from repro.launch import trace_report as jax_report
import repro_torch.obs as PO
import repro_torch.serve as P
from repro_torch.configs import get_config
from repro_torch.launch import replay as replay_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import trace_report

from _torch_parity import (ALL_KINDS, chaos_kw, chaos_requests, jax_engine,
                            port_engine)

ARCH = "llama3.2-1b"
#: the fields that hold wall times
TIMES = ("t", "wall_s", "dur_s", "util")


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in TIMES} for e in events]


def _requests(M, lengths, max_new=4, seed=11, arrivals=None):
    rng = np.random.default_rng(seed)
    arrivals = arrivals or [0.0] * len(lengths)
    return [M.ServeRequest(rng.integers(1, 512, size=s).astype(np.int32),
                           max_new_tokens=max_new, arrival_time=a)
            for s, a in zip(lengths, arrivals)]


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------
def test_schema_is_the_references():
    assert PO.EVENT_SCHEMA == JO.EVENT_SCHEMA
    assert PO.SPAN_EVENTS == JO.SPAN_EVENTS


@pytest.mark.parametrize("capacity,n", [(4, 10), (16, 10), (1, 3)])
def test_ring_like_reference(capacity, n):
    rings = []
    for M in (JO, PO):
        tr = M.Tracer(capacity=capacity)
        for i in range(n):
            tr.step = float(i // 2)
            tr.emit("defer", req=i, tenant="t", cause="test")
        tr.emit("prefix_evict", step=99.0, blocks=1)
        rings.append((len(tr), tr.dropped, _untimed(tr.events)))
    assert rings[1] == rings[0]
    assert rings[1][2][-1]["step"] == 99.0


def test_tracer_step_clock_and_wall_time():
    tr = PO.Tracer()
    tr.step = 7.0
    tr.emit("prefix_evict", blocks=1)
    tr.emit("prefix_evict", step=3.0, blocks=2)
    a, b = tr.events
    assert a["step"] == 7.0 and b["step"] == 3.0
    assert 0.0 <= a["t"] <= b["t"]
    with pytest.raises(ValueError):
        PO.Tracer(capacity=0)


def test_null_tracer_is_falsy_noop():
    assert not PO.NullTracer() and not PO.NULL_TRACER
    PO.NULL_TRACER.emit("admit", req=1)
    assert PO.NULL_TRACER.events == []
    eng = P.ServeEngine(get_config(ARCH, smoke=True), device="cpu")
    assert eng.tracer is PO.NULL_TRACER and eng.profiler is PO.NULL_PROFILER


def test_dump_and_load_like_reference(tmp_path):
    tr = PO.Tracer(capacity=3)
    for i in range(5):
        tr.emit("block_alloc", slot=i, blocks=2, hits=0)
    path = str(tmp_path / "t.jsonl")
    tr.dump_jsonl(path)
    assert PO.load_trace(path) == JO.load_trace(path)
    head = PO.load_trace(path)[0]
    assert head["ev"] == "trace_meta"
    assert (head["events"], head["dropped"], head["capacity"]) == (3, 2, 3)
    # a dump cut mid-line: the last line drops, the flag says so
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[:-9])
    assert PO.read_trace(path) == JO.read_trace(path)
    assert PO.read_trace(path)[1] is True
    with open(path, "w") as f:
        f.write('{"ev": \n' + text)
    with pytest.raises(json.JSONDecodeError):
        PO.read_trace(path)


BAD_EVENTS = [
    [{"ev": "nope", "step": 0.0, "t": 0.0}],
    [{"ev": "defer", "step": 0.0, "req": 1, "tenant": "a", "cause": "x"}],
    [{"ev": "defer", "step": 0.0, "t": 0.0, "req": 1, "tenant": "a"}],
    [{"ev": "evict", "step": 0.0, "t": 0.0, "req": 1, "extra": 2}],
    [{"ev": "prefix_evict", "step": 0.0, "t": 0.0, "blocks": 1}],
]


@pytest.mark.parametrize("events", BAD_EVENTS)
def test_validate_events_like_reference(events):
    assert PO.validate_events(events) == JO.validate_events(events)


# ---------------------------------------------------------------------------
# event lists against the JAX engine
# ---------------------------------------------------------------------------
GOLDEN = {
    "contiguous": (dict(max_len=16, n_slots=2), [
        "run_start", "admit", "admit", "prefill", "prefill",
        "decode_horizon", "decode_horizon", "evict", "evict", "run_end"]),
    "paged": (dict(max_len=16, n_slots=2, cache="paged", block_size=4), [
        "run_start", "block_alloc", "admit", "block_alloc", "admit",
        "prefill_round", "prefill_round", "block_grow",
        "decode_horizon", "decode_horizon",
        "block_free", "block_free", "evict", "evict", "run_end"]),
}


@pytest.mark.parametrize("cache", sorted(GOLDEN))
def test_golden_trace_equals_jax_engine(cache):
    """``tests/test_obs.py``'s golden runs: the port emits the reference's
    types in the reference's order with the reference's fields."""
    kw, kinds = GOLDEN[cache]
    ref, port = JO.Tracer(), PO.Tracer()
    jax_engine(ARCH, tracer=ref, **kw).run(_requests(J, [5, 7]))
    out, _ = port_engine(ARCH, tracer=port, **kw).run(_requests(P, [5, 7]))
    assert [e["ev"] for e in port.events] == kinds
    assert _untimed(port.events) == _untimed(ref.events)
    assert PO.validate_events(port.events) == []
    assert port.events[0]["backend"] == cache


def test_chaos_events_equal_jax_engine():
    """``test_chaos.py::test_chaos_replay_is_deterministic``'s scenario:
    the fault / recovery / admission events, and the whole list."""
    spec = ("slot_kill@2,arrival_burst@3:n=2:prompt_len=8:max_new=3,"
            "pool_shrink@4:blocks=2:restore_after=3")
    runs = []
    for M, engine, T in ((J, jax_engine, JO.Tracer),
                         (P, port_engine, PO.Tracer)):
        tr = T()
        eng = engine(ARCH, max_len=32, n_slots=3, cache="paged",
                     block_size=8, decode_horizon=4, tracer=tr,
                     injector=M.FaultInjector(
                         M.FaultSchedule.from_spec(spec, seed=5)))
        out, _ = eng.run(_requests(M, [9, 12, 10], max_new=5, seed=5))
        picked = [e for e in _untimed(tr.events)
                  if e["ev"] in ("fault_inject", "recover", "admit",
                                 "preempt", "evict", "defer")]
        runs.append(([r.output for r in out], list(eng.injector.injected),
                     picked, _untimed(tr.events)))
    assert runs[1] == runs[0]
    assert {e["ev"] for e in runs[1][2]} >= {"fault_inject", "recover",
                                             "preempt"}


def test_all_kinds_chaos_events_equal_jax_engine():
    """Every fault kind with tenants and an elastic controller, a pool
    growth included: ``migrate``, ``scale_*``, ``budget_skip`` and the
    re-plans land where the reference's do."""
    spec = ALL_KINDS.format(fail=9, fail_units=4)
    lists = []
    for M, engine, T in ((J, jax_engine, JO.Tracer),
                         (P, port_engine, PO.Tracer)):
        tr = T()
        eng = engine("qwen2-0.5b", tracer=tr,
                     **chaos_kw(M, "paged", spec))
        eng.run(chaos_requests(M))
        lists.append(_untimed(tr.events))
    assert lists[1] == lists[0]
    kinds = {e["ev"] for e in lists[1]}
    assert {"migrate", "scale_up", "scale_down", "budget_skip", "defer",
            "fault_inject", "recover", "preempt"} <= kinds


# ---------------------------------------------------------------------------
# exports and the report over one event list
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def profiled_events(tmp_path_factory):
    """A traced, profiled paged run of the port (two runs: compiles, then
    executes), dumped to JSONL."""
    cfg = get_config(ARCH, smoke=True)
    tr = PO.Tracer()
    eng = port_engine(ARCH, max_len=24, n_slots=2, cache="paged",
                      block_size=4, tracer=tr,
                      profiler=PO.DispatchProfiler(cfg))
    for _ in range(2):
        eng.run(_requests(P, [5, 7, 9], arrivals=[0.0, 0.0, 2.0]))
    path = str(tmp_path_factory.mktemp("trace") / "t.jsonl")
    tr.dump_jsonl(path)
    return tr.events, path


def test_chrome_trace_equals_reference(profiled_events, tmp_path):
    events, _ = profiled_events
    doc = PO.to_chrome_trace(events)
    assert doc == JO.to_chrome_trace(events)
    kinds = {e["ph"] for e in doc["traceEvents"]}
    assert {"M", "X", "i", "C"} <= kinds
    path = str(tmp_path / "t.json")
    PO.write_chrome_trace(path, events)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(doc))


def test_report_equals_reference(profiled_events):
    events, path = profiled_events
    loaded = PO.load_trace(path)
    assert trace_report.build_report(loaded) == \
        jax_report.build_report(loaded)
    assert trace_report.phase_costs(events) == jax_report.phase_costs(events)
    rows = {r["phase"]: r for r in trace_report.phase_costs(events)}
    assert rows["decode"]["compiles"] >= 1 and rows["decode"]["util"] > 0
    assert trace_report.main([path, "--validate", "--json"]) == 0
    assert trace_report.main([path, "--require-slo-timeline"]) == 0


# ---------------------------------------------------------------------------
# tracing and profiling observe, never perturb
# ---------------------------------------------------------------------------
WALL_STATS = ("wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
              "decode_s", "tenants", "decode_util")


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_tracer_and_profiler_change_nothing(cache):
    cfg = get_config(ARCH, smoke=True)
    kw = dict(max_len=32, n_slots=3, cache=cache, decode_horizon=4)
    if cache == "paged":
        kw.update(block_size=4, n_blocks=14, prefix_cache=True)
    mk = lambda: _requests(P, [7, 12, 5, 9], max_new=6,  # noqa: E731
                           arrivals=[0.0, 0.0, 2.0, 4.0])
    off, s_off = port_engine(ARCH, **kw).run(mk())
    prof = PO.DispatchProfiler(cfg)
    on, s_on = port_engine(ARCH, tracer=PO.Tracer(), profiler=prof,
                           **kw).run(mk())
    assert [r.output for r in on] == [r.output for r in off]
    strip = lambda s: {k: v for k, v in s.__dict__.items()  # noqa: E731
                       if k not in WALL_STATS}
    assert strip(s_on) == strip(s_off)
    assert len(prof.records) == (s_on.decode_dispatches
                                 + s_on.prefill_dispatches)
    assert s_off.decode_util == 0.0


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
SMOKE = ["--device", "cpu", "--preset", "smoke", "--engine", "continuous",
         "--cache", "paged", "--slots", "3", "--batch", "6",
         "--shared-prefix", "8", "--prompt-len", "12", "--max-new", "5",
         "--max-len", "32", "--block-size", "4"]


def test_serve_cli_trace_profile_and_store(tmp_path, capsys):
    trace, store = str(tmp_path / "t.jsonl"), str(tmp_path / "p.jsonl")
    flags = SMOKE + ["--tenants", "2", "--policy", "slo", "--slo", "30,none",
                     "--trace", trace, "--profile", "--profile-store", store,
                     "--min-hit-rate", "0.1"]
    serve_cli.main(flags)
    rec = json.loads(capsys.readouterr().out)
    assert rec["trace"]["events"] == len(PO.load_trace(trace)) - 1
    assert PO.validate_events(PO.load_trace(trace)) == []
    prof = rec["profile"]
    assert prof["dispatches"] == (rec["decode_dispatches"]
                                  + rec["prefill_dispatches"])
    assert prof["store"]["records"] == len(PO.ProfileStore.load(store)) > 0
    assert rec["calibrate_source"] == {"t0": "analytic", "t1": "analytic"}
    # the second run reads the first run's decode records back: measured
    # when they span two dispatch sizes, as the reference's fit decides
    fit = PO.ProfileStore.load(store).rate_fit("qwen2-0.5b", "paged")
    serve_cli.main(flags + ["--trace-format", "chrome"])
    rec2 = json.loads(capsys.readouterr().out)
    want = "measured" if fit is not None else "analytic"
    assert set(rec2["calibrate_source"].values()) == {want}
    with open(trace) as f:
        assert "traceEvents" in json.load(f)


def test_min_hit_rate_gate_fails(capsys):
    with pytest.raises(SystemExit, match="prefix-cache hit rate"):
        serve_cli.main(SMOKE + ["--min-hit-rate", "0.99"])
    assert json.loads(capsys.readouterr().out)["prefix_hit_rate"] < 0.99


def test_replay_cli_trace(tmp_path, capsys):
    path = str(tmp_path / "r.jsonl")
    replay_cli.main(["--device", "cpu", "--slots", "3", "--n", "6",
                     "--max-len", "32", "--prompt-len", "12", "--max-new",
                     "4", "--block-size", "4", "--blocks", "16", "--faults",
                     "slot_kill@3", "--trace", path])
    rec = json.loads(capsys.readouterr().out)
    events = PO.load_trace(path)
    assert rec["trace"]["events"] == len(events) - 1
    assert PO.validate_events(events) == []
    rep = trace_report.build_report(events)
    assert rep["faults"]["injected"] == {"slot_kill": 1}
    assert replay_cli.build_parser().parse_args([]).trace is None
