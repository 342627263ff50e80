"""Sharded serving on four gloo ranks on the CPU, held to the JAX package's
single-device engine (the contract of ``tests/test_serve.py:386-396``:
the reference's own sharded tests fail on this JAX, whose ``make_mesh``
axes ``with_sharding_constraint`` refuses).

One module-scoped spawn of four ranks (``tests/_torch_sharded_ranks.py``,
one torch thread each) runs every scenario on weights converted from the
JAX ``Model.init``; the parent computes the JAX engine's tokens meanwhile.
Every rank must give the same tokens, and they must equal the JAX
engine's: qwen2 and olmoe on both caches on mesh (2, 2) with the request
sets of ``test_serve.py:386-396``, ``:457-494`` and
``test_paged.py:353-365``; mamba2 (``test_serve.py:416-423``); qwen2 on
mesh (1, 4), unpadded and with ``pad_q_heads=8``, on both caches: its 2
KV heads do not divide 'model', so the pools' positions split over it and
decode runs kv-seq, nothing held whole; qwen2 with 6 q heads on mesh
(1, 4) (contiguous), whose prompts of a length 4 divides prefill q-seq;
a ``device_fail`` / ``device_join`` pair under which ``dmult`` collapses
and comes back, on both caches; the contiguous pools' slots over 'data'
(qwen2 and mamba2 on mesh (4, 1), 2 slots a rank, a rank with no live row
in a bucket computing padding); olmoe with 6 experts on mesh (1, 4), whose
expert FFNs split by width; the recurrent families tensor-parallel over
'model':
mamba2 on (2, 2) and (1, 4), zamba2 and whisper on (2, 2) (request set
``ssm``) and with 6 heads and 6 KV heads on (1, 4), whose self-attention
pools split by position (kv-seq) while whisper's cross attention gathers
q over whole cross K/V. ``Model.forward`` of llama3.2-1b under the rules stays
within 1e-4 of the off-mesh forward (``test_sharding.py:220-236``).
"""
import functools
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

from _torch_parity import JaxEngine, jax_build, jax_config, jax_engine, \
    numpy_params
from repro.serve import ServeRequest as JaxRequest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: (prompt lengths, arrivals, budgets) of the reference's sharded tests
SETS = {
    "decode": ([5, 3, 8, 2, 6, 4, 7, 3], [0.0] * 4 + [2.0] * 4, [6] * 8),
    "bucketed": ([5, 3, 8, 2, 6], [0.0, 0.0, 1.0, 2.0, 2.0],
                 [2, 9, 4, 7, 3]),
    "paged": ([5, 3, 8, 2, 6, 4], [0.0] * 3 + [2.0] * 3, [5] * 6),
    "ssm": ([5, 3, 7], [0.0] * 3, [6] * 3),
}
VOCAB = 512
BUCKETED = dict(n_slots=8, max_len=32, block_size=8)

#: name -> (arch, params, mesh, cache, request set, engine options, faults)
SCENARIOS = {
    "qwen2-contiguous-decode": ("qwen2-0.5b", "qwen2-0.5b", (2, 2),
                                "contiguous", "decode",
                                dict(n_slots=8, max_len=32), None),
    "qwen2-contiguous": ("qwen2-0.5b", "qwen2-0.5b", (2, 2), "contiguous",
                         "bucketed", BUCKETED, None),
    "qwen2-paged": ("qwen2-0.5b", "qwen2-0.5b", (2, 2), "paged", "bucketed",
                    BUCKETED, None),
    "olmoe-contiguous": ("olmoe-1b-7b", "olmoe-1b-7b", (2, 2), "contiguous",
                         "bucketed", BUCKETED, None),
    "olmoe-paged": ("olmoe-1b-7b", "olmoe-1b-7b", (2, 2), "paged",
                    "bucketed", BUCKETED, None),
    "qwen2-paged-4-slots": ("qwen2-0.5b", "qwen2-0.5b", (2, 2), "paged",
                            "paged", dict(n_slots=4, max_len=32,
                                          block_size=8), None),
    "mamba2-contiguous": ("mamba2-780m", "mamba2-780m", (2, 2),
                          "contiguous", "ssm", dict(n_slots=8, max_len=32),
                          None),
    "qwen2-pad8-contiguous": ("qwen2-0.5b", "qwen2-pad8", (1, 4),
                              "contiguous", "bucketed", BUCKETED, None),
    "qwen2-pad8-paged": ("qwen2-0.5b", "qwen2-pad8", (1, 4), "paged",
                         "bucketed", BUCKETED, None),
    "qwen2-contiguous-1x4": ("qwen2-0.5b", "qwen2-0.5b", (1, 4),
                             "contiguous", "bucketed", BUCKETED, None),
    "qwen2-paged-1x4": ("qwen2-0.5b", "qwen2-0.5b", (1, 4), "paged",
                        "bucketed", BUCKETED, None),
    "qwen2-h6-contiguous": ("qwen2-0.5b", "qwen2-h6", (1, 4), "contiguous",
                            "bucketed", BUCKETED, None),
    "qwen2-device-fail": ("qwen2-0.5b", "qwen2-0.5b", (2, 2), "paged",
                          "bucketed", dict(BUCKETED, decode_horizon=2),
                          "device_fail@2:blocks=0:restore_after=3"),
    # the recurrent families tensor-parallel over 'model': mamba2's fused
    # in_proj of 1072 columns cut 268 a rank across z / xBC / dt
    "mamba2-1x4": ("mamba2-780m", "mamba2-780m", (1, 4), "contiguous",
                   "ssm", dict(n_slots=8, max_len=32), None),
    "zamba2-2x2": ("zamba2-7b", "zamba2-7b", (2, 2), "contiguous", "ssm",
                   dict(n_slots=8, max_len=32), None),
    # 6 heads on 'model' 4: the shared block's leaves split flat, kv-seq
    "zamba2-h6-1x4": ("zamba2-7b", "zamba2-h6", (1, 4), "contiguous", "ssm",
                      dict(n_slots=8, max_len=32), None),
    "whisper-2x2": ("whisper-large-v3", "whisper-large-v3", (2, 2),
                    "contiguous", "ssm", dict(n_slots=8, max_len=32), None),
    # self-attention kv-seq; cross attention gathers q over whole K/V
    "whisper-h6-1x4": ("whisper-large-v3", "whisper-h6", (1, 4),
                       "contiguous", "ssm", dict(n_slots=8, max_len=32),
                       None),
    # the contiguous pools' slots over 'data', 2 a rank: the first
    # bucket's live rows both sit on rank 0, ranks 2 and 3 own none
    "qwen2-contiguous-4x1": ("qwen2-0.5b", "qwen2-0.5b", (4, 1),
                             "contiguous", "bucketed", BUCKETED, None),
    "mamba2-4x1": ("mamba2-780m", "mamba2-780m", (4, 1), "contiguous",
                   "ssm", dict(n_slots=8, max_len=32), None),
    # dmult collapses to 1: the buckets narrow, each row still decodes at
    # its slot's rank
    "qwen2-contiguous-device-fail": (
        "qwen2-0.5b", "qwen2-0.5b", (2, 2), "contiguous", "bucketed",
        dict(BUCKETED, decode_horizon=2),
        "device_fail@2:blocks=0:restore_after=3"),
    # 6 experts on 'model' 4: the expert FFNs split by width
    "olmoe-e6-1x4": ("olmoe-1b-7b", "olmoe-e6", (1, 4), "contiguous",
                     "bucketed", BUCKETED, None),
    "olmoe-e6-paged-1x4": ("olmoe-1b-7b", "olmoe-e6", (1, 4), "paged",
                           "bucketed", BUCKETED, None),
}
#: the JAX single-device run each scenario is held to:
#: (arch, request set, engine options)
REFS = {
    "qwen2-decode": ("qwen2-0.5b", "decode", dict(max_len=32)),
    "qwen2-bucketed": ("qwen2-0.5b", "bucketed",
                       dict(max_len=32, decode_horizon=1)),
    "olmoe-bucketed": ("olmoe-1b-7b", "bucketed",
                       dict(max_len=32, decode_horizon=1)),
    "qwen2-paged": ("qwen2-0.5b", "paged", dict(max_len=32)),
    "mamba2-ssm": ("mamba2-780m", "ssm", dict(max_len=32)),
    "qwen2-h6-bucketed": ("qwen2-0.5b", "bucketed",
                          dict(max_len=32, decode_horizon=1)),
    "zamba2-ssm": ("zamba2-7b", "ssm", dict(max_len=32)),
    "zamba2-h6-ssm": ("zamba2-7b", "ssm", dict(max_len=32)),
    "whisper-ssm": ("whisper-large-v3", "ssm", dict(max_len=32)),
    "whisper-h6-ssm": ("whisper-large-v3", "ssm", dict(max_len=32)),
    "olmoe-e6-bucketed": ("olmoe-1b-7b", "bucketed",
                          dict(max_len=32, decode_horizon=1)),
}
H6 = dict(n_heads=6, n_kv_heads=6)
E6 = dict(n_experts=6)
#: config overrides of a params tree and of the JAX run held to it
OVERRIDES = {"qwen2-pad8": dict(pad_q_heads=8), "qwen2-h6": dict(n_heads=6),
             "qwen2-h6-bucketed": dict(n_heads=6), "zamba2-h6": H6,
             "zamba2-h6-ssm": H6, "whisper-h6": H6, "whisper-h6-ssm": H6,
             "olmoe-e6": E6, "olmoe-e6-bucketed": E6}
#: the arch of each params tree drawn at its overrides
OVERRIDDEN = {"qwen2-h6": "qwen2-0.5b", "zamba2-h6": "zamba2-7b",
              "whisper-h6": "whisper-large-v3", "olmoe-e6": "olmoe-1b-7b"}
#: the params tree of each JAX run with overrides
REF_PARAMS = {"qwen2-h6-bucketed": "qwen2-h6", "zamba2-h6-ssm": "zamba2-h6",
              "whisper-h6-ssm": "whisper-h6",
              "olmoe-e6-bucketed": "olmoe-e6"}
REF_OF = {
    "qwen2-contiguous-decode": "qwen2-decode",
    "qwen2-contiguous": "qwen2-bucketed", "qwen2-paged": "qwen2-bucketed",
    "olmoe-contiguous": "olmoe-bucketed", "olmoe-paged": "olmoe-bucketed",
    "qwen2-paged-4-slots": "qwen2-paged", "mamba2-contiguous": "mamba2-ssm",
    "qwen2-pad8-contiguous": "qwen2-bucketed",
    "qwen2-pad8-paged": "qwen2-bucketed",
    "qwen2-contiguous-1x4": "qwen2-bucketed",
    "qwen2-paged-1x4": "qwen2-bucketed",
    "qwen2-h6-contiguous": "qwen2-h6-bucketed",
    "qwen2-device-fail": "qwen2-bucketed",
    "mamba2-1x4": "mamba2-ssm", "zamba2-2x2": "zamba2-ssm",
    "zamba2-h6-1x4": "zamba2-h6-ssm", "whisper-2x2": "whisper-ssm",
    "whisper-h6-1x4": "whisper-h6-ssm",
    "qwen2-contiguous-4x1": "qwen2-bucketed", "mamba2-4x1": "mamba2-ssm",
    "qwen2-contiguous-device-fail": "qwen2-bucketed",
    "olmoe-e6-1x4": "olmoe-e6-bucketed",
    "olmoe-e6-paged-1x4": "olmoe-e6-bucketed",
}


def _prompts(set_name):
    lengths, arrivals, budgets = SETS[set_name]
    rng = np.random.default_rng(5)
    return [(rng.integers(1, VOCAB, size=s).astype(np.int32), b, a)
            for s, a, b in zip(lengths, arrivals, budgets)]


def _padded(tree, pad):
    """qwen2's smoke params with q heads padded to ``pad`` inside each KV
    group (zero ``wo`` rows), as ``repro/models/layers.py:88-117`` pads
    them."""
    tree = jax.tree_util.tree_map(np.array, tree)
    att = tree["layers"]["attn"]
    n_layers, d, q = att["wq"].shape
    hd, nkv = 64, 2
    g_old, g_new = q // hd // nkv, pad // nkv
    wq = att["wq"].reshape(n_layers, d, nkv, g_old, hd)
    att["wq"] = np.pad(wq, ((0, 0), (0, 0), (0, 0), (0, g_new - g_old),
                            (0, 0))).reshape(n_layers, d, pad * hd)
    wo = att["wo"].reshape(n_layers, nkv, g_old, hd, d)
    att["wo"] = np.pad(wo, ((0, 0), (0, 0), (0, g_new - g_old), (0, 0),
                            (0, 0))).reshape(n_layers, pad * hd, d)
    bq = att["bq"].reshape(n_layers, nkv, g_old, hd)
    att["bq"] = np.pad(bq, ((0, 0), (0, 0), (0, g_new - g_old),
                            (0, 0))).reshape(n_layers, pad * hd)
    return tree


def _spec(port):
    params = {a: jax.tree_util.tree_map(np.asarray, numpy_params(a))
              for a in ("qwen2-0.5b", "olmoe-1b-7b", "mamba2-780m",
                        "llama3.2-1b", "zamba2-7b", "whisper-large-v3")}
    params["qwen2-pad8"] = _padded(params["qwen2-0.5b"], 8)
    for name in OVERRIDDEN:
        params[name] = _h6_params(name)
    scenarios = []
    for name, (arch, pname, mesh, cache, set_name, kw, faults) in \
            SCENARIOS.items():
        sc = dict(name=name, arch=arch, params=pname, mesh=mesh,
                  engine=dict(kw, cache=cache),
                  requests=_prompts(set_name), faults=faults)
        if pname in OVERRIDES:
            sc["overrides"] = OVERRIDES[pname]
        scenarios.append(sc)
    tokens = np.random.default_rng(1).integers(
        0, VOCAB, size=(4, 64)).astype(np.int64)
    scenarios.append(dict(name="llama-forward", kind="forward",
                          arch="llama3.2-1b", params="llama3.2-1b",
                          mesh=(2, 2), tokens=tokens))
    return dict(world=4, port=port, params=params, scenarios=scenarios)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _h6_params(name):
    """The smoke model of ``OVERRIDDEN[name]`` at ``OVERRIDES[name]``: JAX
    ``Model.init`` weights; qwen2's layer matrices scaled by 3 as
    ``numpy_params`` scales them."""
    arch = OVERRIDDEN[name]
    cfg = jax_config(arch, smoke=True, **OVERRIDES[name])
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build(cfg).init(jax.random.key(0)))
    if arch == "qwen2-0.5b":
        for group in ("attn", "mlp"):
            for key, a in tree["layers"][group].items():
                if a.ndim == 3:
                    tree["layers"][group][key] = a * np.float32(3.0)
    return tree


def _jax_tokens(ref):
    arch, set_name, kw = REFS[ref]
    reqs = [JaxRequest(p.copy(), max_new_tokens=b)
            for p, b, _ in _prompts(set_name)]
    if ref in OVERRIDES:
        cfg = jax_config(arch, smoke=True, **OVERRIDES[ref])
        engine = JaxEngine(cfg, params=jax.tree_util.tree_map(
            jax.numpy.asarray, _h6_params(REF_PARAMS[ref])), **kw)
    else:
        engine = jax_engine(arch, **kw)
    out, _ = engine.run(reqs)
    return [list(map(int, r.output)) for r in out]


@pytest.fixture(scope="module")
def runs():
    """(per-rank results, JAX tokens by reference run)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(_spec(_free_port()), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_sharded_ranks.py"),
             spec, tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            refs = {name: _jax_tokens(name) for name in REFS}
            log, _ = proc.communicate(timeout=300)
        finally:
            proc.kill()
        ranks = []
        for r in range(4):
            path = os.path.join(tmp, f"rank{r}.pkl")
            assert os.path.exists(path), log[-4000:]
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    for res in ranks:
        assert "error" not in res, res.get("error")
    return ranks, refs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_engine_matches_jax_single_device(runs, name):
    ranks, refs = runs
    first = ranks[0][name]
    for res in ranks[1:]:
        assert res[name]["tokens"] == first["tokens"]
    assert first["tokens"] == refs[REF_OF[name]]
    assert first["graphs"] == "eager"
    if SCENARIOS[name][4] == "bucketed":
        # the live set shrinks mid-run: buckets narrower than the pool
        assert first["decode_rows_saved"] > 0.0
        assert first["max_active"] <= 5


def test_device_fail_collapses_and_join_restores_dmult(runs):
    ranks, _ = runs
    for name in ("qwen2-device-fail", "qwen2-contiguous-device-fail"):
        res = ranks[0][name]
        assert res["scales"] == [("scale_down", 1), ("scale_up", 2)], name
        assert (res["scale_downs"], res["scale_ups"]) == (1, 1), name


#: the runs of the recurrent families, tensor-parallel over 'model'
RECURRENT = ("mamba2-contiguous", "mamba2-1x4", "zamba2-2x2",
             "zamba2-h6-1x4", "whisper-2x2", "whisper-h6-1x4")


def test_collectives_by_mesh(runs):
    """TP runs reduce and gather over 'model', the recurrent families'
    too (mamba2's projection and conv output gathered, its norm's sum of
    squares and ``out_proj``'s partial sums reduced); the (1, 4) mesh
    splits no rows."""
    ranks, _ = runs
    for name in ("qwen2-paged", "olmoe-contiguous", "qwen2-pad8-paged",
                 "qwen2-paged-1x4", "qwen2-contiguous-1x4",
                 "qwen2-h6-contiguous") + RECURRENT:
        for res in ranks:
            c = res[name]["collectives"]
            assert c["all_reduce"] > 0 and c["all_gather"] > 0, name


def test_seq_sharded_runs_take_the_partial_paths(runs):
    """On mesh (1, 4) the pools' positions split: the paged runs call the
    kernels' partial mode on every rank (here the partial wrappers' CPU
    route, counted apart from the whole-pool calls), the 6-head contiguous
    run's prompt of 8 prefills q-seq (flash with a query offset), and the
    ranks' merges gather (output, log-sum-exp) pairs, as many as the
    unsharded layers' own collectives would not explain. The runs whose
    layers keep whole pools and self-attention take none of these."""
    ranks, _ = runs
    for res in ranks:
        for name in ("qwen2-paged-1x4", "qwen2-pad8-paged"):
            calls = res[name]["partial_plain"]
            assert calls["paged_attention_partial"] > 0, name
            assert calls["paged_prefill_partial"] > 0, name
            assert calls["flash_attention_offset"] == 0, name
        assert res["qwen2-h6-contiguous"]["partial_plain"][
            "flash_attention_offset"] > 0
        for name in ("qwen2-paged", "qwen2-contiguous"):
            assert not any(res[name]["partial_plain"].values()), name
    whole = ranks[0]["qwen2-contiguous"]["collectives"]["all_gather"]
    assert ranks[0]["qwen2-contiguous-1x4"]["collectives"][
        "all_gather"] > whole


def test_held_replicated_leaves(runs):
    """No rank of any scenario holds a leaf whole where the reference's
    spec splits it, and each rank's contiguous pool holds its block of
    ``n_slots / d`` slots (ROADMAP A10)."""
    ranks, _ = runs
    for name, (_, _, mesh, cache, _, kw, _) in SCENARIOS.items():
        d, m = mesh
        n = kw["n_slots"]
        for rank, res in enumerate(ranks):
            x = res[name]
            assert x["held"] == [], (name, rank)
            if cache == "contiguous":
                per = n // d
                r = rank // m
                assert x["held_slots"] == list(range(r * per, (r + 1) * per))
                for leaf, shape in x["pool_shapes"].items():
                    assert shape[x["pool_axes"][leaf]] == per, (name, leaf)
    # 6 KV heads on 'model' 4: the self-attention pools' positions split
    for res in ranks:
        for name in RECURRENT:
            want = "model" if name.endswith("h6-1x4") else None
            assert res[name]["cache_seq"] == want, name


def test_data_ranks_split_the_work(runs):
    """Summed over the 'data' ranks (each with the rows that every 'data'
    rank computed whole counted once), the decode rows and the prefill
    lanes are the host loop's, and the decode tokens the JAX engine's. A
    contiguous pool split over 'data' computes every decode row at one
    rank (a rank may own none: qwen2 and mamba2 on (4, 1)); the paged runs
    split their prefill rounds."""
    ranks, refs = runs
    for name, (_, _, mesh, cache, _, _, _) in SCENARIOS.items():
        d, m = mesh
        got = [ranks[r * m][name] for r in range(d)]
        ref = refs[REF_OF[name]]
        want = {"rows": got[0]["rows_total"], "lanes": got[0]["lanes_total"],
                "tokens": sum(len(t) for t in ref) - len(ref)}
        for key, total in want.items():
            parts = sum(x["work"].get(key, 0) for x in got)
            assert parts + got[0]["work"].get(key + "_whole", 0) == total, (
                name, key)
        if d > 1 and cache == "contiguous":
            assert got[0]["work"].get("rows_whole", 0) == 0, name
        if d > 1 and cache == "paged":
            assert all(x["work"]["lanes"] > 0 for x in got), name


def test_forward_under_rules_matches_off_mesh(runs):
    ranks, _ = runs
    for res in ranks:
        fw = res["llama-forward"]
        assert fw["shape"] == (4, 64, VOCAB)
        assert fw["max_abs"] <= 1e-4
        assert fw["held"] == []       # a one-slot plan: no pool over 'data'
