"""The rank processes of the port's sharded serving tests.

``python tests/_torch_sharded_ranks.py SPEC.pkl OUTDIR`` spawns the SPEC's
``world`` gloo ranks on its ``device`` (default the CPU, one torch thread
each; "cuda": every rank on cuda:0), rendezvous at
``tcp://localhost:<port>``; every rank builds one ``DeviceMesh`` per mesh
shape the scenarios name, runs every scenario in order and pickles its
results to ``OUTDIR/rank<r>.pkl``. A scenario is a sharded engine run
(the full params as numpy leaves, the request set, engine options, an
optional fault spec; a tracer records the host loop's dispatches) or a
``Model.forward`` under the rules against the
off-mesh forward, or (kind "capture") a collective issued inside a CUDA
graph capture, which must raise. Imports no jax: the caller holds the
results to the JAX package.
"""
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _engine_run(sc, cfg, params, mesh, device):
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.obs.events import Tracer
    from repro_torch.serve import (FaultInjector, FaultSchedule,
                                   ServeRequest, sharded_engine)
    kw = dict(sc.get("engine", {}))
    if sc.get("faults"):
        kw["injector"] = FaultInjector(FaultSchedule.from_spec(sc["faults"]),
                                       seed=0)
    kw["tracer"] = tracer = Tracer()
    eng = sharded_engine(cfg, params=params, mesh=mesh, device=device, **kw)
    reqs = [ServeRequest(np.asarray(p, np.int32).copy(), max_new_tokens=m,
                         arrival_time=a) for p, m, a in sc["requests"]]
    shd.reset_stats()
    ops.set_counts((0,) * len(ops.COUNTERS))
    partial = (ops.paged_attention_partial, ops.paged_prefill_partial,
               ops.flash_attention_offset)
    for f in partial:
        f.plain_calls = 0
    out, stats = eng.run(reqs)
    launches = {f.__name__: n for (f, _), n in zip(ops.COUNTERS, ops.counts())}
    partial_plain = {f.__name__: f.plain_calls for f in partial}
    ev = tracer.events
    scales = [(e["ev"], e.get("dmult")) for e in ev
              if e["ev"] in ("scale_up", "scale_down")]
    return dict(
        tokens=[list(map(int, r.output)) for r in out],
        decode_rows_saved=stats.decode_rows_saved,
        max_active=stats.max_active,
        graphs="eager" if eng.graphs.is_eager else "captured",
        scale_ups=stats.scale_ups, scale_downs=stats.scale_downs,
        held=list(eng.sharding.held_replicated),
        cache_seq=eng.sharding.cache_seq_axis,
        collectives=dict(shd.STATS), scales=scales, launches=launches,
        partial_plain=partial_plain, work=dict(eng.work),
        pool_shapes={k: tuple(eng.pool.buffers[k].shape)
                     for k in eng.sharding.cache_shape},
        held_slots=(list(eng.pool.held) if hasattr(eng.pool, "held")
                    else None),
        pool_axes=getattr(eng.pool, "batch_axes", None),
        # the host loop's dispatches, the same on every rank: a decode
        # horizon's bucket rows times its steps, a paged round's width, a
        # contiguous prompt
        rows_total=sum(e["width"] * e["k"] for e in ev
                       if e["ev"] == "decode_horizon"),
        lanes_total=sum(e["width"] if e["ev"] == "prefill_round" else 1
                        for e in ev if e["ev"] in ("prefill",
                                                   "prefill_round")))


def _capture(sc, cfg, params, mesh, device):
    from repro_torch.dist import sharding as shd
    x = torch.ones(4, device=device)
    graph = torch.cuda.CUDAGraph()
    try:
        with shd.axis_rules(mesh, {}), torch.cuda.graph(graph):
            shd.reduce_over(x, "model")
    except RuntimeError as e:
        return dict(error=str(e))
    return dict(error=None)


def _forward(sc, cfg, params, mesh, device):
    from repro_torch.dist import sharding as shd
    from repro_torch.models.api import build_model
    from repro_torch.serve.sharded import make_serve_sharding
    model = build_model(cfg)
    batch = {"tokens": torch.as_tensor(sc["tokens"])}
    with torch.no_grad():
        batch = {k: v.to(device) for k, v in batch.items()}
        off = model.forward(params, batch)
        plan = make_serve_sharding(cfg, 1, sc["tokens"].shape[1], mesh)
        local = plan.shard_params(params)
        with plan.rules():
            on = model.forward(local, batch)
    return dict(max_abs=float((on - off).abs().max()),
                scale=float(off.abs().max()), shape=tuple(on.shape),
                held=list(plan.held_replicated))


def _rank(rank, spec, outdir):
    device = spec.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    out = {}
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.configs import get_config
        from repro_torch.dist.sharding import Mesh
        from repro_torch.models.convert import params_from_jax
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{spec['port']}",
            world_size=spec["world"], rank=rank)
        meshes = {}
        for sc in spec["scenarios"]:
            shape = tuple(sc["mesh"])
            if shape not in meshes:
                dm = DeviceMesh(device, torch.arange(spec["world"])
                                .reshape(shape),
                                mesh_dim_names=("data", "model"))
                meshes[shape] = Mesh(shape, ("data", "model"), dm)
        for sc in spec["scenarios"]:
            cfg = get_config(sc["arch"], smoke=True,
                             **sc.get("overrides", {}))
            params = params_from_jax(spec["params"][sc["params"]],
                                     device=device)
            run = {"forward": _forward, "capture": _capture}.get(
                sc.get("kind"), _engine_run)
            out[sc["name"]] = run(sc, cfg, params, meshes[tuple(sc["mesh"])],
                                  device)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if "error" in out:
        os._exit(1)


def main(argv):
    with open(argv[0], "rb") as f:
        spec = pickle.load(f)
    mp.spawn(_rank, args=(spec, argv[1]), nprocs=spec["world"])


if __name__ == "__main__":
    main(sys.argv[1:])
