"""The port's sharding spec logic (``repro_torch/dist``,
``launch/dryrun.cache_pspecs``, ``serve/sharded.py``'s table) held to
``repro.dist`` exactly, with ``==``.

Spec logic reads only axis names and sizes: the reference's side runs on
``jax.make_mesh`` over the eight forced host devices (which its spec
functions accept; only its constraints refuse these meshes), the port's on
a shape-only ``Mesh``. A port ``Spec`` is a tuple and equals
``tuple(PartitionSpec)``.
"""
import threading

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.dist import sharding as jshd
from repro.launch.dryrun import cache_pspecs as jax_cache_pspecs
from repro.models.api import cache_specs as jax_cache_specs
from repro.models.api import paged_cache_specs as jax_paged_cache_specs
from repro.models.api import params_specs as jax_params_specs
from repro.serve.sharded import make_serve_sharding as jax_plan
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import cache_pspecs
from repro_torch.launch.mesh import axis_sizes, make_host_mesh
from repro_torch.models.convert import jax_layout
from repro_torch.serve.sharded import (cache_shapes, make_serve_sharding,
                                       param_shapes, rows_dim)

MESHES = [(4, 2), (2, 4), (8, 1), (1, 8)]
NAMES = ("data", "model")


def jmesh(shape, names=NAMES):
    return jax.make_mesh(shape, names)


def pmesh(shape, names=NAMES):
    return shd.Mesh(shape, names)


def _tuple(tree):
    """A reference spec tree with every PartitionSpec as a tuple."""
    return jax.tree_util.tree_map(
        lambda s: tuple(s), tree, is_leaf=lambda x: isinstance(x, JP))


def _stacked(port_specs):
    """The port's per-layer spec tree in the reference's stacked layout:
    each stacked leaf's spec gains one leading None a stacked axis (the
    per-layer specs must agree)."""
    def stack(specs):
        assert all(s == specs[0] for s in specs), specs
        return (None,) + tuple(specs[0])
    return jax_layout(port_specs, tuple, stack)


# ---------------------------------------------------------------------------
# rules registry
# ---------------------------------------------------------------------------
def test_off_mesh_everything_is_noop():
    import torch
    assert shd.current_rules() is None
    x = torch.ones(4, 8, 16)
    assert shd.shard(x, "batch", None, "ffn") is x
    assert shd.shard_spec(x, shd.P("data", None, "model")) is x
    assert shd.attention_scheme(4, 64, 8, 64) is None
    assert shd.reduce_over(x) is x and shd.gather_over(x, 0) is x
    assert shd.gather_rows(x) is x and shd.local_rows(x) is x
    with shd.split_rows(4) as rows:
        assert rows is None
    assert shd.axis_index("model") == 0


def test_rules_pop_on_exit_and_nest():
    mesh = pmesh((8,), ("data",))
    with shd.axis_rules(mesh, {"batch": "data"}) as outer:
        assert shd.current_rules() is outer
        with shd.axis_rules(mesh, {"batch": None}) as inner:
            assert shd.current_rules() is inner
        assert shd.current_rules() is outer
    assert shd.current_rules() is None


def test_rules_are_thread_local():
    seen = []
    with shd.axis_rules(pmesh((4, 2)), {"batch": "data"}):
        t = threading.Thread(target=lambda: seen.append(shd.current_rules()))
        t.start()
        t.join()
        assert shd.current_rules() is not None
    assert seen == [None]


def test_rule_table_lookup_and_axis_sizes():
    table = shd.production_rules_table(False)
    with shd.axis_rules(pmesh((4, 2)), table) as rules, \
            jshd.axis_rules(jmesh((4, 2)), table) as jrules:
        for name in ("batch", "ffn", "nonexistent", None):
            assert rules.mesh_axes(name) == jrules.mesh_axes(name)
        for axes in ("data", "model", ("data", "model"), None):
            assert rules.axis_size(axes) == jrules.axis_size(axes)
        assert rules.sizes == jrules.sizes
    with shd.axis_rules(pmesh((4, 2)), table) as rules:
        table["ffn"] = None           # the table is copied at install
        assert rules.mesh_axes("ffn") == "model"


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("seq_shard", [False, True])
def test_production_rules_table(multi_pod, seq_shard):
    assert shd.production_rules_table(multi_pod, seq_shard=seq_shard) == \
        jshd.production_rules_table(multi_pod, seq_shard=seq_shard)


# ---------------------------------------------------------------------------
# sanitizer and attention schemes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES)
def test_sanitize_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    entries = [None, "data", "model", "pod", ("data", "model"),
               ("model", "data"), ("data", "pod")]
    rules = shd.Rules(pmesh(shape), {})
    jrules = jshd.Rules(jmesh(shape), {})
    for _ in range(400):
        ndim = int(rng.integers(0, 5))
        dims = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 12, 16],
                                                size=ndim))
        parts = [entries[i] for i in
                 rng.integers(0, len(entries), size=int(rng.integers(0, 6)))]
        got = shd._sanitize(parts, dims, rules)
        assert isinstance(got, tuple)
        assert got == tuple(jshd._sanitize(parts, dims, jrules)), (
            parts, dims)


@pytest.mark.parametrize("shape", MESHES)
def test_attention_scheme_grid(shape):
    table = shd.production_rules_table(False)
    for kv_seq in (None, "model", "data"):
        table["kv_seq"] = kv_seq
        with shd.axis_rules(pmesh(shape), table), \
                jshd.axis_rules(jmesh(shape), table):
            for b in (1, 2, 4, 8):
                for s in (1, 3, 8, 64):
                    for nh in (1, 2, 4, 6, 8, 14, 32):
                        for kv_s in (1, 8, 48, 64):
                            got = shd.attention_scheme(b, s, nh, kv_s)
                            want = jshd.attention_scheme(b, s, nh, kv_s)
                            if want is None:
                                assert got is None
                                continue
                            assert got == _tuple(want), (b, s, nh, kv_s)


# ---------------------------------------------------------------------------
# parameter and cache specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_every_arch(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    pshape = param_shapes(cfg)
    for shape in ((4, 2), (1, 8)):
        table = shd.production_rules_table(False)
        with shd.axis_rules(pmesh(shape), table) as rules:
            got = _stacked(shd.param_pspecs(pshape, rules))
        with jshd.axis_rules(jmesh(shape), table) as jrules:
            want = _tuple(jshd.param_pspecs(jax_params_specs(jcfg), jrules))
        assert got == want, (arch, shape)


CACHE_ARCHS = ["qwen2-0.5b", "olmoe-1b-7b", "phi-3-vision-4.2b",
               "mamba2-780m", "zamba2-7b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_pspecs_every_family(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    for shape in MESHES:
        for batch in (1, 8):
            for seq_shard in (False, True):
                got = cache_pspecs(cfg, cache_shapes(cfg, batch, 32,
                                                     paged=False),
                                   pmesh(shape), seq_shard=seq_shard,
                                   batch=batch)
                want = jax_cache_pspecs(
                    jcfg, jax_cache_specs(jcfg, batch, 32), jmesh(shape),
                    seq_shard=seq_shard, batch=batch)
                assert got == _tuple(want), (shape, batch, seq_shard)
            if cfg.family in ("dense", "vlm", "moe"):
                got = cache_pspecs(cfg, cache_shapes(
                    cfg, batch, 32, paged=True, block_size=8, n_blocks=12),
                    pmesh(shape), seq_shard=False, batch=batch, paged=True)
                want = jax_cache_pspecs(
                    jcfg, jax_paged_cache_specs(jcfg, 12, 8), jmesh(shape),
                    seq_shard=False, batch=batch, paged=True)
                assert got == _tuple(want), (shape, batch, "paged")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "mamba2-780m", "whisper-large-v3"])
def test_serve_sharding_table_and_specs(arch):
    """The plan's table (with the ``kv_seq -> "model"`` retarget where the
    KV heads do not divide 'model'), param and cache specs are the
    reference plan's."""
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    for shape in MESHES:
        caches = (["contiguous", "paged"] if cfg.family in ("dense", "moe")
                  else ["contiguous"])
        for cache in caches:
            plan = make_serve_sharding(cfg, 8, 32, pmesh(shape), cache=cache,
                                       block_size=8)
            ref = jax_plan(jcfg, 8, 32, jmesh(shape), cache=cache,
                           block_size=8)
            assert plan.table == ref.table, (shape, cache)
            assert plan.cache_pspec == _tuple(ref.cache_pspec)
            want = jax.tree_util.tree_map(
                lambda s: tuple(s.spec), ref.param_sharding,
                is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
            assert _stacked(plan.param_pspec) == want
            assert plan.n_devices == ref.n_devices
            assert plan.axis_size("data") == ref.axis_size("data")
            assert plan.axis_size("pod") == ref.axis_size("pod") == 1
    table = make_serve_sharding(cfg, 8, 32, pmesh((2, 4))).table
    retarget = bool(cfg.n_kv_heads) and cfg.n_kv_heads % 4 != 0
    assert table["kv_seq"] == ("model" if retarget else None)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_plan_realizes_the_reference_layout(arch, shape):
    """Each family's plan at smoke size: every parameter leaf runs at the
    reference plan's spec (a fused expert leaf split by width too:
    olmoe's 4 experts on 'model' 8), every pool leaf at ``cache_pspecs``'
    spec (the slots over 'data' too), and nothing is held whole."""
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    plan = make_serve_sharding(cfg, 8, 32, pmesh(shape))
    ref = jax_plan(jcfg, 8, 32, jmesh(shape))
    want = jax.tree_util.tree_map(
        lambda s: tuple(s.spec), ref.param_sharding,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    is_spec = lambda x: isinstance(x, tuple)        # noqa: E731
    got = jax.tree_util.tree_flatten_with_path(
        _stacked(plan.param_layout), is_leaf=is_spec)[0]
    want = jax.tree_util.tree_flatten_with_path(want, is_leaf=is_spec)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g == w, (path[-1].key, g, w)
    assert plan.cache_layout == _tuple(ref.cache_pspec)
    assert plan.held_replicated == ()


#: the meshes every registered configuration's serve plan is held on
PLAN_MESHES = [(2, 1), (2, 2), (4, 2), (1, 8)]


def _block(shape, spec, sizes) -> tuple:
    """The block of a leaf of global ``shape`` one rank holds under
    ``spec`` (each dimension over the ranks of its entry's axes)."""
    out = []
    for n, entry in zip(shape, spec):
        for a in shd._flat(entry):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_plan_holds_nothing_whole(arch):
    """Every registered configuration at full width, 8 slots, on each of
    ``PLAN_MESHES`` and both caches where its family serves on both: the
    plan holds nothing whole, and each contiguous pool leaf's local shape
    is its block of the reference's ``cache_pspecs`` (the slots over
    'data', a rank ``8 / d`` of them)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    caches = (["contiguous", "paged"] if cfg.family in ("dense", "vlm", "moe")
              else ["contiguous"])
    jshape = jax_cache_specs(jcfg, 8, 256)
    for shape in PLAN_MESHES:
        plans = {cache: make_serve_sharding(cfg, 8, 256, pmesh(shape),
                                            cache=cache) for cache in caches}
        for cache, plan in plans.items():
            assert plan.held_replicated == (), (shape, cache)
        plan = plans["contiguous"]
        want = jax_cache_pspecs(jcfg, jshape, jmesh(shape), seq_shard=False,
                                batch=8)
        assert set(plan.cache_shape) == set(want)
        for name, spec in want.items():
            block = _block(jshape[name].shape, tuple(spec),
                           dict(zip(NAMES, shape)))
            local = plan.local_shape(name, plan.cache_shape[name])
            assert local == block, (shape, name)
            assert local[rows_dim(name, len(local))] == 8 // shape[0]


@pytest.mark.parametrize("shape,held", [((4, 2), False), ((2, 4), True),
                                        ((1, 8), True)])
def test_heads_held_whole_where_the_scheme_does_not_split_them(shape, held):
    """qwen2-0.5b's 14 q heads: head-sharded over 'model' 2 (the scheme's
    head branch); over 4 and 8 the scheme is q-seq / kv-seq, whose heads
    the reference holds whole in the attention while its weights split
    flat. The port realizes every split (nothing is held whole): the
    attention leaves split over 'model' at every 'model' size, and where
    the 2 KV heads do not divide 'model' the paged pool's in-block
    positions split over it instead (the layer runs kv-seq)."""
    cfg = get_config("qwen2-0.5b")
    plan = make_serve_sharding(cfg, 8, 256, pmesh(shape), cache="paged")
    with jshd.axis_rules(jmesh(shape), plan.table):
        scheme = jshd.attention_scheme(1, 1, cfg.n_heads, 256)
    assert (scheme["q"][2] is None) == held
    assert plan.held_replicated == ()
    for name in ("wq", "wk", "wv"):
        assert plan.param_layout["layers"][0]["attn"][name] == (None,
                                                                 "model")
    assert plan.param_layout["layers"][0]["attn"]["wo"] == ("model", None)
    assert plan.cache_layout == plan.cache_pspec
    seq = shape[1] > 2
    assert plan.cache_layout["k"][2] == ("model" if seq else None)
    assert plan.cache_seq_axis == ("model" if seq else None)
    local = plan.local_shape("k", plan.cache_shape["k"])
    assert local[2] == (16 // shape[1] if seq else 16)
    assert local[3] == (cfg.n_kv_heads if seq
                        else cfg.n_kv_heads // shape[1])


def test_bucket_shardings_axis_choice():
    cfg, jcfg = get_config("qwen2-0.5b", smoke=True), \
        jax_config("qwen2-0.5b", smoke=True)
    for shape in MESHES:
        plan = make_serve_sharding(cfg, 8, 32, pmesh(shape))
        ref = jax_plan(jcfg, 8, 32, jmesh(shape))
        for width in (1, 2, 3, 4, 6, 8):
            got = plan.bucket_shardings(width)
            want = ref.bucket_shardings(width)
            for k in ("tokens", "pos", "tables"):
                assert got[k].spec == tuple(want[k].spec), (shape, width)
                assert got[k].is_fully_replicated == \
                    want[k].is_fully_replicated
        assert plan.replicated().spec == tuple(ref.replicated().spec)


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = pmesh((4, 2))
    ns = shd.named({"a": shd.P(None, "model"), "b": [shd.P("data")]}, mesh)
    assert ns["a"].placements == (Replicate(), Shard(1))
    assert ns["b"][0].placements == (Shard(0), Replicate())
    assert not ns["a"].is_fully_replicated
    assert shd.named(shd.P(), mesh).is_fully_replicated


def test_local_block_cuts_even_chunks():
    import torch
    x = torch.arange(8 * 6).reshape(8, 6)

    class Coord(shd.Mesh):
        def coord(self, axis):
            return {"data": 3, "model": 1}[axis]
    mesh = Coord((4, 2), NAMES)
    assert torch.equal(shd.local_block(x, shd.P("data", "model"), mesh),
                       x[6:8, 3:6])
    assert torch.equal(shd.local_block(x, shd.P(None, None), mesh), x)


def test_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torchrun"):
        make_host_mesh()
    assert axis_sizes(pmesh((4, 2))) == {"data": 4, "model": 2}
