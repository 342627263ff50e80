"""Sequence-sharded attention (kv-seq and q-seq) held to the JAX package.

A rank of a kv-seq layer holds a slice of the decode cache's positions:
the paged pool's in-block offsets ``[r BS/m, (r + 1) BS/m)`` of every
block, or the contiguous cache's positions ``[r S/m, (r + 1) S/m)``. It
attends over its own keys (the paged kernels' partial mode, whose plain
versions run here; ``layers.mha_partial``) and returns each row's
log-sum-exp, and ``sharding.merge_partials`` combines the ranks. Here the
m ranks run one after another in one process and the merge's all-gather
is a stand-in that hands back their (output, log-sum-exp) pairs in rank
order; the merged output is held to the JAX package's ``kernels/ref.py``
attention over the whole pool. A q-seq rank's block of query rows runs
flash with a query offset, held to rows of the reference's causal
attention, and its backward's dq to those rows of the reference's
gradients and its dk and dv, summed over the blocks, to the rest. The
serve plan's layouts of qwen2-0.5b, qwen2-7b and
olmoe-1b-7b on meshes (1, 4) and (1, 8) are the reference's specs with
nothing held whole. Inputs come from numpy seeds; f32, tolerance 2e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist import sharding as jshd
from repro.kernels import ref as jref
from repro.launch import dryrun as jdry
from repro.models.api import cache_specs as jax_cache_specs
from repro.models.api import paged_cache_specs as jax_paged_cache_specs
from repro.models.api import params_specs as jax_params_specs
from repro_torch.configs import InputShape, get_config
from repro_torch.dist import sharding as shd
from repro_torch.kernels import cost, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.convert import jax_layout
from repro_torch.serve.sharded import make_serve_sharding

TOL = 2e-5
HQ, HKV, D = 14, 2, 32          # qwen2-0.5b's grouping (G 7), a small D
NB, MB, B = 12, 4, 4


def _standin(monkeypatch, parts):
    """``merge_partials``' all-gather as a stand-in: the ranks' packed
    (output, log-sum-exp) pairs, in rank order."""
    packed = torch.cat([torch.cat([o.float(), l.float()[..., None]], -1)[None]
                        for o, l in parts])
    monkeypatch.setattr(shd, "gather_over", lambda x, dim, axis: packed)
    return shd.merge_partials(*parts[0], "model")


def _pool(seed, bs):
    """A pool, scattered tables with a -1 column inside a row's span and
    an all -1 row last (no visible key), positions inside the tables."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, bs, HKV, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, HKV, D)).astype(np.float32)
    tables = np.array([[3, -1, 7, 1], [0, 2, 9, 11], [5, 6, 4, -1],
                       [-1, -1, -1, -1]], np.int32)
    pos = np.array([3 * bs + 2, 4 * bs - 1, 2 * bs + bs // 2, 5], np.int32)
    return rng, kp, vp, tables, pos


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_partial_paged_merged_over_slices_matches_reference(
        monkeypatch, kind, m, bs, window):
    rng, kp, vp, tables, pos = _pool(m * 100 + bs + window, bs)
    c = 1 if kind == "decode" else 4
    start = pos - (c - 1)
    q = rng.standard_normal((B, c, HQ, D)).astype(np.float32)
    tq, tkp, tvp = (torch.from_numpy(a) for a in (q, kp, vp))
    tt, ts = torch.from_numpy(tables), torch.from_numpy(start)
    n = bs // m
    parts = []
    for r in range(m):
        ks, vs = tkp[:, r * n:(r + 1) * n], tvp[:, r * n:(r + 1) * n]
        if kind == "decode":
            o, lse = ops.paged_attention_partial(tq[:, 0], ks, vs, tt, ts,
                                                 window, (bs, r * n))
            assert lse.shape == (B, HQ)
        else:
            o, lse = ops.paged_prefill_partial(tq, ks, vs, tt, ts, window,
                                               (bs, r * n))
            assert lse.shape == (B, c, HQ)
        assert lse.dtype == torch.float32
        assert torch.isinf(lse[-1]).all() and (o[-1] == 0).all()
        parts.append((o, lse))
    out = _standin(monkeypatch, parts)
    if kind == "decode":
        exp = jref.paged_attention(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(tables),
                                   jnp.asarray(start), window)
        whole = pa.paged_attention_plain(tq[:, 0], tkp, tvp, tt, ts, window)
    else:
        exp = jref.paged_prefill_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(start), window)
        whole = pa.paged_prefill_attention_plain(tq, tkp, tvp, tt, ts,
                                                 window)
    # the oracle averages garbage on the row that sees no key: it is 0
    np.testing.assert_allclose(out.numpy()[:-1], np.asarray(exp)[:-1],
                               atol=TOL, rtol=TOL)
    assert (out[-1] == 0).all()
    torch.testing.assert_close(out, whole, atol=TOL, rtol=TOL)


def test_partial_with_one_slice_is_the_whole_pool():
    """pos_base (BS, 0) over the whole pool is the plain call, and its
    log-sum-exp is the rows' logsumexp of the visible scores."""
    rng, kp, vp, tables, pos = _pool(7, 8)
    q = torch.from_numpy(rng.standard_normal((B, HQ, D)).astype(np.float32))
    args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), torch.from_numpy(pos))
    o, lse = pa.paged_attention_plain(*args, 0, (8, 0), return_lse=True)
    torch.testing.assert_close(o, pa.paged_attention_plain(*args, 0))
    kg, _, k_pos, assigned = pa.paged_kv_gather(*args[1:4])
    logits = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, HKV, 7, D),
                          kg) / D ** 0.5
    vis = (assigned & (k_pos <= args[4].long()[:, None]))[:, None, None]
    want = torch.logsumexp(logits.masked_fill(~vis, -torch.inf), -1)
    torch.testing.assert_close(lse, want.reshape(B, HQ), atol=TOL, rtol=TOL)


def test_merge_partials_rank_order_and_empty_rows(monkeypatch):
    o = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    lse = torch.tensor([0.5, -torch.inf, 2.0])
    assert shd.merge_partials(o, lse) is o            # off the mesh
    torch.testing.assert_close(
        shd.combine_partials(o[None], lse[None])[[0, 2]], o[[0, 2]])
    o2 = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    lse2 = torch.tensor([1.5, -torch.inf, -torch.inf])
    out = _standin(monkeypatch, [(o, lse), (o2, lse2)])
    w = torch.softmax(torch.tensor([0.5, 1.5]), 0)
    torch.testing.assert_close(out[0], w[0] * o[0] + w[1] * o2[0])
    assert (out[1] == 0).all()                         # no rank saw a key
    torch.testing.assert_close(out[2], o[2])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("window", [0, 3])
def test_mha_partial_over_cache_slices_matches_reference(monkeypatch, m,
                                                         window):
    """The contiguous decode's kv-seq: ``mha_partial`` over each rank's
    positions of the cache, merged, against the reference's attention
    over every key (per-row positions, GQA)."""
    rng = np.random.default_rng(m + window)
    s = 16
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    pos = np.array([0, 5, 9, 15])
    n = s // m
    parts = []
    for r in range(m):
        k_pos = torch.arange(r * n, (r + 1) * n)[None, :]
        cpos = torch.from_numpy(pos)[:, None]
        valid = k_pos <= cpos
        if window:
            valid &= k_pos > cpos - window
        parts.append(L.mha_partial(torch.from_numpy(q),
                                   torch.from_numpy(k[:, r * n:(r + 1) * n]),
                                   torch.from_numpy(v[:, r * n:(r + 1) * n]),
                                   valid[:, None, None, :]))
    out = _standin(monkeypatch, parts)
    for b in range(B):
        exp = jref.attention(jnp.asarray(q[b:b + 1]),
                             jnp.asarray(k[b:b + 1, :pos[b] + 1]),
                             jnp.asarray(v[b:b + 1, :pos[b] + 1]),
                             causal=False, window=0)
        if window:
            lo = max(0, pos[b] - window + 1)
            exp = jref.attention(jnp.asarray(q[b:b + 1]),
                                 jnp.asarray(k[b:b + 1, lo:pos[b] + 1]),
                                 jnp.asarray(v[b:b + 1, lo:pos[b] + 1]),
                                 causal=False, window=0)
        np.testing.assert_allclose(out[b:b + 1].numpy(), np.asarray(exp),
                                   atol=TOL, rtol=TOL)


def test_writes_go_to_the_owner_slice_only():
    """``paged_kv_write`` with a pool slice and ``update_kv_cache`` with
    ``first``: the ranks' slices together hold exactly the whole write."""
    g = torch.Generator().manual_seed(3)
    bs, m, nb = 8, 4, 6
    tables = torch.tensor([[2, 0, -1], [4, 1, 3]], dtype=torch.int32)
    positions = torch.tensor([[9, 10, 11], [17, 18, 23]], dtype=torch.int32)
    k = torch.randn(2, 3, HKV, D, generator=g)
    whole = L.PagedKV(torch.zeros(nb + 1, bs, HKV, D),
                      torch.zeros(nb + 1, bs, HKV, D), tables)
    L.paged_kv_write(whole, k, -k, positions)
    n = bs // m
    for r in range(m):
        part = L.PagedKV(torch.zeros(nb + 1, n, HKV, D),
                         torch.zeros(nb + 1, n, HKV, D), tables)
        L.paged_kv_write(part, k, -k, positions, pos_base=(bs, r * n))
        assert torch.equal(part.k, whole.k[:, r * n:(r + 1) * n])
        assert torch.equal(part.v, whole.v[:, r * n:(r + 1) * n])

    s = 16
    ck = torch.randn(2, s, HKV, D, generator=g)
    new = torch.randn(2, 1, HKV, D, generator=g)
    pos = torch.tensor([3, 12], dtype=torch.int32)
    valid = torch.tensor([True, False])
    want = ck.clone()
    L.update_kv_cache(want, want.clone(), new, new, pos, valid)
    for r in range(m):
        n = s // m
        loc = ck[:, r * n:(r + 1) * n].clone()
        _, _, k_pos, cpos = L.update_kv_cache(loc, loc.clone(), new, new,
                                              pos, valid, first=r * n)
        assert torch.equal(loc, want[:, r * n:(r + 1) * n])
        assert torch.equal(k_pos[0], torch.arange(r * n, (r + 1) * n))
        assert torch.equal(cpos[:, 0], pos.long())


@pytest.mark.parametrize("a,b,window", [(0, 16, 0), (16, 32, 0),
                                        (48, 64, 0), (24, 40, 7),
                                        (40, 64, 20)])
def test_flash_query_offset_matches_reference_rows(a, b, window):
    rng = np.random.default_rng(a + b + window)
    s, hq, hkv = 64, 6, 2
    q, k, v = (rng.standard_normal((2, s, h, D)).astype(np.float32)
               for h in (hq, hkv, hkv))
    exp = np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window))[:, a:b]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.flash_attention_plain(tq[:, a:b], tk[:, :b], tv[:, :b], True,
                                   window, q_offset=a)
    np.testing.assert_allclose(got.numpy(), exp, atol=TOL, rtol=TOL)
    via = ops.flash_attention_offset(tq[:, a:b], tk, tv, a, window=window)
    np.testing.assert_allclose(via.numpy(), exp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("m,window", [(2, 0), (4, 0), (4, 7), (8, 20)])
def test_flash_query_offset_backward_matches_reference_grads(m, window):
    """The offset backward (its plain version) of each of m row blocks of a
    64-row causal pass, at the block's offset over the keys up to its last
    row (q-seq's rank blocks): dq of its rows equals those rows of
    ``jax.vjp`` of the reference's whole attention, and the blocks' dk and
    dv, summed over the blocks, equal the reference's."""
    rng = np.random.default_rng(100 * m + window)
    s, hq, hkv = 64, 6, 2
    q, k, v, do = (rng.standard_normal((2, s, h, D)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    _, vjp = jax.vjp(lambda q, k, v: jref.attention(
        q, k, v, causal=True, window=window), *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    n = s // m
    for r in range(m):
        a, b = r * n, (r + 1) * n
        gq, gk, gv = ops.flash_attention_offset_backward(
            tq[:, a:b], tk[:, :b], tv[:, :b], None, tdo[:, a:b], a,
            window=window)
        np.testing.assert_allclose(gq.numpy(), jdq[:, a:b], atol=TOL,
                                   rtol=TOL)
        dk[:, :b] += gk.numpy()
        dv[:, :b] += gv.numpy()
    np.testing.assert_allclose(dk, jdk, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dv, jdv, atol=TOL, rtol=TOL)


def test_cost_of_slices_and_row_blocks_adds_up():
    """The partial calls' flops over the m slices sum to the whole call's
    (their bytes add each slice's log-sum-exp), and flash's row blocks'
    pairs sum to the causal pass's."""
    tables = [[3, -1, 7, 1], [0, 2, 9, 11]]
    start = [26, 13]
    for c, window in ((1, 0), (16, 5)):
        whole = cost.paged_attention(HQ, HKV, D, 16, 4, c, window, tables,
                                     start)
        flops = sum(cost.paged_attention(
            HQ, HKV, D, 4, 4, c, window, tables, start, pos_base=(16, r * 4),
            lse=True)[0] for r in range(4))
        assert flops == whole[0]
    for window in (0, 9):
        rows = sum(cost.visible_pairs_rows(r * 16, 16, (r + 1) * 16, True,
                                           window) for r in range(4))
        assert rows == cost.visible_pairs(64, True, window)
    assert cost.flash_attention(1, 64, 6, 2, D, 4, True, 9) == \
        cost.flash_attention(1, 64, 6, 2, D, 4, True, 9, q_offset=0, sk=64)


def _jmesh(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape, dtype=object))


def _stacked(specs):
    def stack(leaf_specs):
        assert all(s == leaf_specs[0] for s in leaf_specs)
        return (None,) + tuple(leaf_specs[0])
    return jax_layout(specs, tuple, stack)


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("cache", ["paged", "contiguous"])
@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-7b", "olmoe-1b-7b"])
def test_plan_realizes_every_model_split(arch, m, cache):
    """The plan's layouts are the reference's ``param_pspecs`` and
    ``cache_pspecs`` (at full width), and nothing is held whole."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    plan = make_serve_sharding(cfg, 8, 256, shd.Mesh((1, m),
                                                     ("data", "model")),
                               cache=cache, block_size=16)
    with jshd.axis_rules(_jmesh((1, m)), plan.table) as jrules:
        want = jshd.param_pspecs(jax_params_specs(jcfg), jrules)
    assert _stacked(plan.param_layout) == _tuples(want)
    if cache == "paged":
        jshape = jax_paged_cache_specs(jcfg, 8 * 16, 16)
    else:
        jshape = jax_cache_specs(jcfg, 8, 256)
    jspec = jdry.cache_pspecs(jcfg, jshape, _jmesh((1, m)), seq_shard=False,
                              batch=8, paged=cache == "paged")
    assert plan.cache_layout == {k: tuple(v) for k, v in jspec.items()}
    assert plan.held_replicated == ()
    seq = cfg.n_kv_heads % m != 0
    assert plan.cache_seq_axis == ("model" if seq else None)
    kv = cfg.n_kv_heads if seq else cfg.n_kv_heads // m
    local = plan.local_shape("k", plan.cache_shape["k"])
    assert local[3] == kv
    assert local[2] == ((16 // m if seq else 16) if cache == "paged"
                        else 256 // m if seq else 256)


@pytest.mark.parametrize("arch,before", [("qwen2-0.5b", 1.687),
                                         ("qwen2-7b", 10.114)])
def test_dryrun_decode_32k_pod_holds_nothing_whole(arch, before):
    """decode_32k on the pod mesh (32, 8): the cache's sequence over
    'model' (KV heads 2 / 4 do not divide 8), the attention leaves split
    flat; the arguments a GPU are the reference's sharded bytes of the
    params and the cache, below the 1.687 / 10.114 GiB of the layout that
    held them whole."""
    rec, prog = dryrun.lower_combo(arch, "decode_32k", False, probe=False)
    assert rec["held_replicated"] == []
    assert prog.cache_seq == "model"
    pshape = api.params_specs(prog.cfg)
    cshape = api.cache_specs(prog.cfg, 128, 32768)
    with prog.rules() as rules:
        pspec = shd.param_pspecs(pshape, rules)
    cspec = dryrun.cache_pspecs(prog.cfg, cshape, prog.mesh,
                                seq_shard=False, batch=128)
    expect = (dryrun.sharded_arg_bytes(pshape, pspec, prog.mesh)
              + dryrun.sharded_arg_bytes(cshape, cspec, prog.mesh))
    assert rec["args_gib_per_device"] == round(expect / 2**30, 3) < before
    assert rec["collective_bytes"]["all-gather"] > 0      # the merge


class _LastRank(shd.Mesh):
    """A shape-only mesh whose rank sits last on every axis (the rank whose
    slice of a sequence-split cache holds the decode position)."""

    def coord(self, axis):
        return self.sizes[axis] - 1


@pytest.mark.parametrize("arch,seq_shard,mesh,axis", [
    ("gemma3-27b", True, (2, 2), "data"),
    ("qwen2-0.5b", False, (1, 4), "model")])
def test_dryrun_kv_seq_rank_writes_and_merges(arch, seq_shard, mesh, axis):
    """The last rank's local decode program: the cache's sequence split over
    'data' (long_500k's rule; gemma3's 2 KV heads also split over 'model',
    so the layer stays head-sharded over them) or over 'model' (qwen2's 2
    KV heads do not divide 4: every head whole); the decode position falls
    in the rank's slice, so the rank writes it, and the merge gathers over
    the sequence axis."""
    cfg = get_config(arch, smoke=True)
    table = shd.production_rules_table(seq_shard=seq_shard)
    if not seq_shard:
        table["kv_seq"] = "model"
    prog = dryrun.build_program(cfg, InputShape("t", 16, 1, "decode"),
                                _LastRank(mesh, ("data", "model")), table,
                                seq_shard=seq_shard)
    assert prog.cache_seq == axis
    assert prog.held_replicated == []
    assert prog.count()["collectives"][("all-gather", axis)] > 0


@pytest.mark.parametrize("mode,backward", [("train", True),
                                           ("prefill", False)])
def test_dryrun_q_seq_runs_in_train_and_prefill(mode, backward):
    """qwen2-0.5b (smoke: 4 q heads) on mesh (1, 8) at 16 positions: the
    heads do not divide 'model' but the length does, so a prefill and the
    train step run q-seq, each layer booking flash with a query offset;
    the train step also books its backward once a layer, and the
    backward's reduce-scatter of the gathered rows' partial gradient."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    prog = dryrun.build_program(
        cfg, InputShape("t", 16, 2, mode),
        shd.Mesh((1, 8), ("data", "model")),
        shd.production_rules_table(seq_shard=False))
    counted = prog.count()
    assert prog.held_replicated == []
    kernels = counted["kernels"]
    assert kernels["flash_attention_offset"]["calls"] == cfg.n_layers
    assert kernels.get("flash_attention_offset_backward", {}).get(
        "calls", 0) == (cfg.n_layers if backward else 0)
    assert not any(k.get("refused") for k in kernels.values())
    assert counted["collectives"][("all-gather", "model")] > 0
    assert (("reduce-scatter", "model") in counted["collectives"]) \
        == backward
