"""Shared pieces of the port's serving parity tests: the JAX package's
smoke weights as numpy, one engine of each package on them, and the
host-side results two runs must share exactly.

Weights: the JAX ``Model.init`` pytree through numpy; qwen2's layer
matrices are scaled by 3 (at init scale its smoke model repeats one
token, which would make token identity a weak check).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine

#: the ServeStats counters of fault injection, elastic reshapes and the
#: engine loop that the port must give exactly
CHAOS_COUNTERS = ("faults_injected", "recoveries", "dropped", "preemptions",
                  "scale_ups", "scale_downs", "migrated_blocks", "replans",
                  "steps", "new_tokens", "host_syncs", "decode_dispatches",
                  "prefill_dispatches", "unfinished", "slo_attainment",
                  "max_active", "decode_rows_saved", "prefix_hit_rate")


@functools.lru_cache(maxsize=None)
def numpy_params(arch):
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build(jax_config(arch, smoke=True)).init(
            jax.random.key(0)))
    if arch == "qwen2-0.5b":
        for group in ("attn", "mlp"):
            for name, a in tree["layers"][group].items():
                if a.ndim == 3:                  # stacked [L, in, out]
                    tree["layers"][group][name] = a * np.float32(3.0)
    return tree


def jax_engine(arch, **kw):
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(arch))
    return JaxEngine(jax_config(arch, smoke=True), params=params, **kw)


def port_engine(arch, **kw):
    return ServeEngine(get_config(arch, smoke=True),
                       params=params_from_jax(numpy_params(arch),
                                              device="cpu"),
                       device="cpu", **kw)


def steps_tenant_stats(stats):
    """The per-tenant stats without their wall-clock entries."""
    if stats.tenants is None:
        return None
    return {tid: {k: v for k, v in d.items() if not k.endswith("_s")}
            for tid, d in stats.tenants.items()}


def record(engine, out, stats):
    """What two runs of one schedule must share: tokens, the injected
    faults, the dropped ids and causes, the counters, the steps-based
    per-tenant stats and each request's finishing step."""
    inj = getattr(engine, "injector", None)
    return dict(
        tokens=[r.output for r in out],
        injected=list(inj.injected) if inj is not None else [],
        dropped=[(r.job_id, r.drop_cause) for r in out if r.dropped],
        retries=[(r.n_retries, r.n_preempted) for r in out],
        counters={n: getattr(stats, n) for n in CHAOS_COUNTERS},
        tenants=steps_tenant_stats(stats),
        finished=[r.finished_at for r in out])


#: every injectable kind, a restore and a join past the constructed pool
ALL_KINDS = ("defer_storm@1:duration=2,tenant_slowdown@2:tenant=batch:"
             "duration=3,slot_kill@4,arrival_burst@5:n=2:prompt_len=8:"
             "max_new=3:tenant=lat,prefix_flush@6,pool_shrink@7:blocks=6:"
             "restore_after=5,device_fail@{fail}:blocks={fail_units}:"
             "restore_after=4,device_join@11:blocks=6")
#: prompt tails of the scenarios; the contiguous one takes two lengths (the
#: JAX engine compiles one contiguous prefill per prompt length)
TAILS = [5, 9, 3, 12, 7, 4, 6, 10]
TAILS2 = [5, 9, 5, 9, 9, 5, 9, 5]


def chaos_requests(M, tails=TAILS, seed=11):
    """Eight requests of ``M`` after a shared 8-token prefix (two blocks
    of 4), open-loop arrivals, two tenants."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 512, size=8).astype(np.int32)
    rows = zip(tails, [0, 0, 1, 2, 3, 5, 6, 9],
               [6, 4, 8, 5, 3, 7, 6, 4],
               ["lat", "batch", "lat", "batch", "batch", "lat", "batch",
                "lat"])
    return [M.ServeRequest(
        np.concatenate([pre, rng.integers(1, 512, size=n).astype(np.int32)]),
        max_new_tokens=b, arrival_time=float(a), tenant=t)
        for n, a, b, t in rows]


def chaos_kw(M, cache, spec, tenants=True, elastic=True, n_blocks=24,
             tails=TAILS, k=4):
    """Engine options for one package ``M`` (``repro.serve`` or
    ``repro_torch.serve``): tenants with an analytic plan on the pool's
    units, the injector of ``spec``, an elastic controller."""
    kw = dict(max_len=48, n_slots=3, cache=cache, decode_horizon=k,
              injector=M.FaultInjector(M.FaultSchedule.from_spec(spec,
                                                                 seed=2)))
    paged = cache == "paged"
    if paged:
        kw.update(block_size=4, n_blocks=n_blocks, prefill_lanes=2)
    if tenants:
        reg = M.TenantRegistry([M.Tenant("lat", weight=2.0, slo_steps=12.0),
                                M.Tenant("batch")])
        total = n_blocks if paged else 3
        units_for = ((lambda r: -(-(len(r.prompt) + r.max_new_tokens) // 4))
                     if paged else None)
        profiles = M.profiles_from_requests(reg, chaos_requests(M, tails),
                                            total_units=total,
                                            units_for=units_for, max_k=k)
        kw.update(tenants=reg, policy="slo", allocation=M.plan_allocation(
            reg, profiles, total, total_lanes=2, max_k=k,
            watermark_units=2 if paged else 0))
    if elastic:     # proactive scale-ups reclaim revoked capacity only
        kw["elastic"] = M.ElasticController(queue_hi=3, step_units=4,
                                            cooldown=4.0)
    return kw
