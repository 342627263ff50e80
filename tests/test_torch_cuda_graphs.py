"""The engine's captured CUDA graphs (``repro_torch/serve/graphs.py``) on
the card, at smoke size, for the eight serving paths (paged dense, MoE and
VLM, contiguous dense and MoE, and the three families that prefill by
replaying one captured decode step: recurrent, hybrid and
encoder-decoder).

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither JAX nor the JAX package:

    python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py

On one engine, a captured run (first calls eager, then capture), a run
under ``graphs.eager()`` and a second captured run (replays only) give the
same tokens, the same ``ServeStats`` counters and the same kernel launch
counts; a new engine on the same weights (a new pool) gives them too.
The MoE layer repeats bit for bit, and paged MoE prefix hits that resume
the expert counts give the cold run's tokens where the shapes agree.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.serve import ServeEngine, ServeRequest, ServeStats, graphs

TIMES = {"wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
         "decode_s"}
COUNTERS = [f.name for f in dataclasses.fields(ServeStats)
            if f.name not in TIMES]
PATHS = {
    "paged-dense": ("qwen2-0.5b", "paged"),
    "contiguous-dense": ("qwen2-0.5b", "contiguous"),
    "contiguous-moe": ("olmoe-1b-7b", "contiguous"),
    "recurrent": ("mamba2-780m", "contiguous"),
    "paged-moe": ("olmoe-1b-7b", "paged"),
    "paged-vlm": ("phi-3-vision-4.2b", "paged"),
    "recurrent-hybrid": ("zamba2-7b", "contiguous"),
    "recurrent-encdec": ("whisper-large-v3", "contiguous"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _engine(arch, cache, params=None, **kw):
    cfg = get_config(arch, smoke=True)
    if params is None:
        params = build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0))
        if arch == "qwen2-0.5b":     # at init scale it repeats one token
            for lp in params["layers"]:
                for group in ("attn", "mlp"):
                    for t in lp[group].values():
                        if t.dim() == 2:
                            t.mul_(3.0)
    kw = dict(dict(max_len=64, n_slots=3, decode_horizon=8, cache=cache,
                   block_size=4, prefill_lanes=2), **kw)
    return ServeEngine(cfg, params=params, device="cuda", **kw)


def _run(engine):
    rng = np.random.default_rng(17)
    reqs = [ServeRequest(rng.integers(1, 512, size=n).astype(np.int32),
                         max_new_tokens=b, arrival_time=float(a))
            for n, a, b in zip([5, 9, 7, 12, 6], [0, 0, 1, 2, 4],
                               [6, 3, 8, 5, 2])]
    before = ops.counts()
    out, st = engine.run(reqs)
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(ops.counts(), before))
    return ([r.output for r in out], {n: getattr(st, n) for n in COUNTERS},
            launches)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_graph_run_equals_eager_run(cuda_device, path):
    arch, cache = PATHS[path]
    engine = _engine(arch, cache)
    first = _run(engine)
    captured = len(engine.graphs.keys)
    assert captured > 0 and engine.graphs.replays > 0
    with graphs.eager():
        replays = engine.graphs.replays
        assert _run(engine) == first
        assert engine.graphs.replays == replays
    second = _run(engine)
    assert second == first
    assert len(engine.graphs.keys) == captured      # replays only
    assert len({t for o in first[0] for t in o}) > 3
    if cache == "paged":      # both paged kernels run, their plain versions
        assert first[2][1] > 0 and first[2][2] > 0   # never
    if (arch, cache) == ("olmoe-1b-7b", "contiguous"):
        assert first[2][0] > 0                       # flash in the prefill
    if path.startswith("recurrent"):
        # the prefill replays a captured decode step; no kernel runs
        assert ("recurrent_step",) in engine.graphs.keys
        assert sum(first[2]) == 0
    assert sum(first[2][5:]) == 0
    # a new engine on the same weights: a new pool, captured anew
    assert _run(_engine(arch, cache, params=engine.params)) == first


@pytest.mark.cuda
def test_sampled_graph_run_repeats(cuda_device):
    """Sampling inside the captured horizons and prefill rounds: two runs
    (capture, then replays) and an eager run draw the same tokens."""
    engine = _engine("qwen2-0.5b", "paged", temperature=0.8, top_k=50)
    first = _run(engine)
    assert _run(engine) == first
    with graphs.eager():
        assert _run(engine) == first


@pytest.mark.cuda
def test_moe_layer_repeats_bit_for_bit(cuda_device):
    """The MoE layer sums each token's expert outputs in a fixed order, so
    the same call gives the same bits every time on the card."""
    cfg = get_config("olmoe-1b-7b", smoke=True, capacity_factor=0.5)
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn(3, 40, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    first = moe.moe_ffn(cfg, params["layers"][0], x)[0]
    for _ in range(5):
        assert torch.equal(moe.moe_ffn(cfg, params["layers"][0], x)[0],
                           first)


@pytest.mark.cuda
def test_paged_moe_prefix_hits_equal_cold_runs(cuda_device):
    """With one slot and one prefill lane every chunk and decode step has
    the same shapes with and without the prefix cache, so prefix hits
    that resume the expert counts give the cold run's tokens bit for bit
    (at a tight capacity, where the counts decide the drops)."""
    cfg = get_config("olmoe-1b-7b", smoke=True, capacity_factor=0.5)
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(5)
    common = rng.integers(1, 512, size=16).astype(np.int32)
    tails = [rng.integers(1, 512, size=n).astype(np.int32)
             for n in (7, 12, 3, 20)]

    def run(prefix_cache):
        engine = ServeEngine(cfg, params=params, device="cuda", max_len=64,
                             n_slots=1, cache="paged", block_size=4,
                             prefill_lanes=1, prefix_cache=prefix_cache)
        out, st = engine.run([ServeRequest(np.concatenate([common, t]),
                                           max_new_tokens=6) for t in tails])
        return [r.output for r in out], st.prefix_blocks_hit

    warm, hits = run(True)
    cold, none = run(False)
    assert warm == cold and hits > 0 and none == 0


def _chaos_engine(cache, params=None, spec=None):
    """A smoke qwen2 engine under faults, with tenants and an elastic
    controller: a join past the constructed pool grows it mid-run."""
    from repro_torch.serve import (ElasticController, FaultInjector,
                                   FaultSchedule, Tenant, TenantRegistry,
                                   plan_allocation, profiles_from_requests)
    spec = spec or ("defer_storm@1:duration=2,tenant_slowdown@2:tenant=b:"
                    "duration=3,slot_kill@3,arrival_burst@4:n=2:"
                    "prompt_len=8:max_new=3:tenant=a,prefix_flush@5,"
                    "pool_shrink@6:blocks=6:restore_after=4,"
                    "device_fail@8:blocks=3:restore_after=3,"
                    "device_join@10:blocks=12")
    registry = TenantRegistry([Tenant("a", weight=2.0, slo_steps=12.0),
                               Tenant("b")])
    total = 24 if cache == "paged" else 3
    units = ((lambda r: -(-(len(r.prompt) + r.max_new_tokens) // 4))
             if cache == "paged" else None)
    allocation = plan_allocation(
        registry, profiles_from_requests(registry, _chaos_requests(),
                                         total_units=total, units_for=units,
                                         max_k=8),
        total, total_lanes=2, max_k=8,
        watermark_units=2 if cache == "paged" else 0)
    kw = dict(n_blocks=24) if cache == "paged" else {}
    return _engine("qwen2-0.5b", cache, params=params, policy="slo",
                   tenants=registry, allocation=allocation,
                   injector=FaultInjector(FaultSchedule.from_spec(spec)),
                   elastic=ElasticController(queue_hi=3, step_units=4,
                                             cooldown=4.0), **kw)


def _chaos_requests():
    rng = np.random.default_rng(23)
    return [ServeRequest(rng.integers(1, 512, size=n).astype(np.int32),
                         max_new_tokens=b, arrival_time=float(a), tenant=t)
            for n, a, b, t in zip([5, 9, 7, 12, 6, 8], [0, 0, 1, 2, 4, 5],
                                  [6, 3, 8, 5, 2, 7],
                                  ["a", "b", "a", "b", "b", "a"])]


def _chaos_run(engine):
    before = ops.counts()
    out, st = engine.run(_chaos_requests())
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(ops.counts(), before))
    counters = {n: getattr(st, n) for n in COUNTERS if n != "tenants"}
    counters["tenants"] = {t: {k: v for k, v in d.items()
                               if not k.endswith("_s")}
                           for t, d in st.tenants.items()}
    if engine.cache_kind == "paged":
        engine.pool.audit()
    return ([r.output for r in out], list(engine.injector.injected),
            [(r.job_id, r.drop_cause) for r in out if r.dropped], counters,
            launches)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["paged", "contiguous"])
def test_chaos_graph_run_equals_eager_run(cuda_device, cache):
    """Under all eight fault kinds (the paged pool growing mid-run, its
    captured programs dropped and captured again over the new pools) a
    captured run, an eager run and a second captured run agree in tokens,
    faults, drops, counters and launches; the paged kernels run, their
    plain versions never; a new engine on the same weights agrees too."""
    engine = _chaos_engine(cache)
    first = _chaos_run(engine)
    assert engine.graphs.replays > 0
    with graphs.eager():
        assert _chaos_run(engine) == first
    assert _chaos_run(engine) == first
    assert {"slot_kill", "device_join", "pool_shrink"} <= {
        k for k, _ in first[1]}
    if cache == "paged":
        assert first[3]["migrated_blocks"] > 0 and engine.migrations
        assert engine.migrations[0]["graphs_dropped"] > 0
        assert first[4][1] > 0 and first[4][2] > 0
    assert sum(first[4][5:]) == 0
    assert _chaos_run(_chaos_engine(cache, params=engine.params)) == first


@pytest.mark.cuda
def test_growth_keeps_every_block_on_the_card(cuda_device):
    """``grow_physical`` on the card: the new pools' leading slice equals
    the old pools bit for bit, the new blocks are zero."""
    from repro_torch.serve import BlockManager
    model = build_model(get_config("qwen2-0.5b", smoke=True))
    pool = BlockManager(model, n_slots=2, max_len=32, block_size=4,
                        n_blocks=10, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    pool.buffers.k_buf.normal_(generator=gen)
    pool.buffers.v_buf.normal_(generator=gen)
    old = pool.buffers
    assert pool.grow_physical(6) == 6
    for name in ("k", "v"):
        assert torch.equal(pool.buffers[name][:, :10], old[name])
        assert not pool.buffers[name][:, 10:].any()


@pytest.mark.cuda
def test_capture_survives_a_dropped_runner_in_a_cycle(cuda_device):
    """A runner dropped in a reference cycle keeps its graphs until the
    garbage collector runs; a collection during another runner's capture
    would destroy them mid-capture and invalidate it. Here the cycle
    becomes garbage inside the capture, with collections as frequent as
    they go: the capture and its replay still succeed."""
    x = torch.arange(8.0, device=cuda_device)

    class Holder:
        pass

    old = graphs.GraphRunner(cuda_device)
    for k in range(4):
        old(("add", k), lambda t, k=k: t + k, x)
    held, calls = {"old": old}, []
    del old

    def fn(t):
        calls.append(1)
        if len(calls) == 2:              # the capture: drop the old runner
            h = Holder()
            h.me, h.runner = h, held.pop("old")
            del h
            [Holder() for _ in range(100)]
        return t * 2 + 1

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        new = graphs.GraphRunner(cuda_device)
        for _ in range(2):
            out = new(("mul",), fn, x)
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()
    assert new.replays == 1 and len(calls) == 2
    assert torch.equal(out, x * 2 + 1)
