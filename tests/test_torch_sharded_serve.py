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
``test_paged.py:353-365``; mamba2 (``test_serve.py:416-423``); qwen2 with
``pad_q_heads=8`` on mesh (1, 4), its KV heads whole over 'model'; a
``device_fail`` / ``device_join`` pair under which ``dmult`` collapses
and comes back. ``Model.forward`` of llama3.2-1b under the rules stays
within 1e-4 of the off-mesh forward (``test_sharding.py:220-236``).
"""
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

from _torch_parity import jax_engine, numpy_params
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
    "qwen2-device-fail": ("qwen2-0.5b", "qwen2-0.5b", (2, 2), "paged",
                          "bucketed", dict(BUCKETED, decode_horizon=2),
                          "device_fail@2:blocks=0:restore_after=3"),
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
}
REF_OF = {
    "qwen2-contiguous-decode": "qwen2-decode",
    "qwen2-contiguous": "qwen2-bucketed", "qwen2-paged": "qwen2-bucketed",
    "olmoe-contiguous": "olmoe-bucketed", "olmoe-paged": "olmoe-bucketed",
    "qwen2-paged-4-slots": "qwen2-paged", "mamba2-contiguous": "mamba2-ssm",
    "qwen2-pad8-contiguous": "qwen2-bucketed",
    "qwen2-pad8-paged": "qwen2-bucketed",
    "qwen2-device-fail": "qwen2-bucketed",
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
                        "llama3.2-1b")}
    params["qwen2-pad8"] = _padded(params["qwen2-0.5b"], 8)
    scenarios = []
    for name, (arch, pname, mesh, cache, set_name, kw, faults) in \
            SCENARIOS.items():
        sc = dict(name=name, arch=arch, params=pname, mesh=mesh,
                  engine=dict(kw, cache=cache),
                  requests=_prompts(set_name), faults=faults)
        if pname == "qwen2-pad8":
            sc["overrides"] = dict(pad_q_heads=8)
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


def _jax_tokens(ref):
    arch, set_name, kw = REFS[ref]
    reqs = [JaxRequest(p.copy(), max_new_tokens=b)
            for p, b, _ in _prompts(set_name)]
    out, _ = jax_engine(arch, **kw).run(reqs)
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
    res = ranks[0]["qwen2-device-fail"]
    assert res["scales"] == [("scale_down", 1), ("scale_up", 2)]
    assert (res["scale_downs"], res["scale_ups"]) == (1, 1)


def test_collectives_by_mesh(runs):
    """TP runs reduce and gather over 'model'; mamba2 is held whole over
    'model' and its rows unsplit, so it issues none; the (1, 4) mesh
    splits no rows."""
    ranks, _ = runs
    for name in ("qwen2-paged", "olmoe-contiguous", "qwen2-pad8-paged"):
        c = ranks[0][name]["collectives"]
        assert c["all_reduce"] > 0 and c["all_gather"] > 0, name
    assert ranks[0]["mamba2-contiguous"]["collectives"] == {
        "all_reduce": 0, "all_gather": 0, "seconds": 0.0}


def test_held_replicated_leaves(runs):
    """The leaves the port holds whole where the reference's spec splits
    them (ROADMAP: open layout work)."""
    ranks, _ = runs
    pool = ["cache/k", "cache/v"]
    assert ranks[0]["qwen2-contiguous"]["held"] == pool
    assert ranks[0]["qwen2-paged"]["held"] == []
    assert ranks[0]["olmoe-paged"]["held"] == []
    kv = [f"layers/*/attn/{n}" for n in ("wk", "wv", "bk", "bv")]
    assert ranks[0]["qwen2-pad8-paged"]["held"] == kv + pool
    assert ranks[0]["mamba2-contiguous"]["held"] == [
        "emb/tok_emb"] + [f"layers/*/{n}" for n in (
            "in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D",
            "out_proj")] + ["cache/conv", "cache/ssm"]


def test_forward_under_rules_matches_off_mesh(runs):
    ranks, _ = runs
    for res in ranks:
        fw = res["llama-forward"]
        assert fw["shape"] == (4, 64, VOCAB)
        assert fw["max_abs"] <= 1e-4
        assert fw["held"] == []       # a one-slot plan: no pool over 'data'
