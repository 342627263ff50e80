"""TP/DP-sharded serving (``repro/serve/sharded.py``) over
``torch.distributed``.

A ``ServeSharding`` plan holds what the engine needs to serve over a
("data", "model") mesh of ranks, each rank one process:

  * the mesh (default: ``launch.mesh.make_host_mesh()`` over the
    initialized process group) and the production rules table, with the
    small-KV-head retarget ``kv_seq -> "model"`` when the KV head count
    does not divide 'model';
  * the reference's specs and ``NamedSharding``s for the params
    (``param_pspecs``) and the pooled decode cache (``launch.dryrun.
    cache_pspecs``, the dry-run's specs), and the bucketed token / pos /
    table shardings of each compacted decode width (``bucket_shardings``);
  * the layout each leaf actually has on this rank (``param_layout``,
    ``cache_layout``). The port realizes head-sharded attention (q heads
    over 'model'; KV heads too where they divide it), vocab-parallel
    embeddings and logits, ffn-parallel MLPs and expert-parallel MoE. A
    leaf whose reference spec it does not realize is held replicated over
    'model' and listed in ``held_replicated``: attention whose scheme is q-seq
    or kv-seq sharded (a head count that 'model' does not divide), a leaf
    whose spec splits a head, the fused expert gate/up split by width, the
    mamba2 weights and states (the sanitizer splits the fused
    ``in_proj`` flat) and every leaf of the hybrid and encdec families.
    The pools are held whole over 'data' (the paged pool by the
    reference's spec; the contiguous pool in this slice): new K/V rows are
    gathered over 'data' before each write.

``shard_params`` cuts a full param tree into this rank's blocks (the
counterpart of ``jax.device_put(params, param_sharding)``); ``cache_cfg``
is the config the pools are built from (this rank's KV heads). A decode
bucket whose width the 'data' axis divides is computed a part a 'data'
rank (``split_rows``), for the attention families; everything else every
rank computes whole. The engine runs the same host loop on every rank, so
the scheduler, the block manager and the counters agree; the selected
tokens are gathered over 'data'.

Every sharded engine runs its programs eager: a gloo collective cannot be
captured into a CUDA graph (one issued during a capture raises), and
capturing over NCCL with one card a rank is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import cache_pspecs
from repro_torch.launch.mesh import axis_sizes, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models.api import build_model

#: families whose layers the port computes tensor-parallel
TP_FAMILIES = ("dense", "vlm", "moe")
_HEAD_LEAVES = ("wq", "bq", "wo")
_KV_LEAVES = ("wk", "wv", "bk", "bv")


def param_shapes(cfg) -> dict:
    """The port's param tree of ``cfg`` as shapes, without allocating (the
    init runs on fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        gen = torch.Generator(device="cpu").manual_seed(0)
        params = build_model(cfg).init(gen)
    return shd.tree_map_with_path(lambda _, t: tuple(t.shape), params)


def cache_shapes(cfg, n_slots: int, max_len: int, *, paged: bool,
                 block_size: int = 16, n_blocks: Optional[int] = None
                 ) -> dict:
    """The pooled decode cache's leaves as shapes: the contiguous
    ``init_cache`` dict, or the paged pool's ``{"k", "v"}``
    ``[L, n_blocks, block_size, kv, hd]``."""
    model = build_model(cfg)
    if paged:
        cache = model.init_paged_cache(n_blocks, block_size, device="meta")
        return {"k": tuple(cache["k"].shape), "v": tuple(cache["v"].shape)}
    cache = model.init_cache(n_slots, max_len, device="meta")
    return {k: tuple(v.shape) for k, v in cache.items()}


def heads_shard(cfg, rules) -> bool:
    """Whether attention runs head-sharded under ``rules`` (installed): the
    layer's scheme (``layers.plan_attention_scheme``, the reference's)
    splits the q heads over 'model', and each rank's q heads read a whole
    number of KV groups or one KV head (so the kernels see one G)."""
    m = rules.sizes.get("model", 1)
    if m <= 1 or cfg.family not in TP_FAMILIES or not cfg.n_kv_heads:
        return False
    scheme = L.plan_attention_scheme(cfg, 1, 1, 1)
    if scheme is None or scheme["q"][2] != "model":
        return False
    per, g = cfg.n_heads_eff // m, cfg.n_heads_eff // cfg.n_kv_heads
    return cfg.n_kv_heads % m == 0 or per % g == 0 or g % per == 0


def realized(cfg, name: str, spec: shd.Spec, m: int,
             heads: bool) -> shd.Spec:
    """The spec a parameter leaf named ``name`` runs with: the reference's
    ``spec``, or it with 'model' (of ``m`` ranks) dropped where the port
    does not realize that split (module docstring); ``heads``: attention
    runs head-sharded (``heads_shard``)."""
    if m == 1 or "model" not in (a for e in spec for a in shd._flat(e)):
        return spec
    keep = cfg.family in TP_FAMILIES
    if name in _HEAD_LEAVES:
        keep = keep and heads
    elif name in _KV_LEAVES:
        keep = keep and heads and cfg.n_kv_heads % m == 0
    elif name in ("we_gate_up", "we_down"):  # [E, D, 2F] / [E, F, D]:
        keep = keep and spec[-3] == "model"  # experts over 'model' only
    if keep:
        return spec
    return shd.Spec(*(None if "model" in shd._flat(e) else e for e in spec))


@dataclass
class ServeSharding:
    """Mesh + rules table + specs for one (cfg, n_slots, max_len)."""
    mesh: object
    table: dict
    param_sharding: object
    cache_sharding: object
    cache_pspec: object = field(default=None, repr=False)
    cfg: object = field(default=None, repr=False)
    param_pspec: object = field(default=None, repr=False)
    param_layout: object = field(default=None, repr=False)
    cache_layout: object = field(default=None, repr=False)
    #: leaves held whole where the reference's spec splits them
    #: ('/'-joined paths, per-layer leaves as layers/*/..., the pool's
    #: leaves as cache/...)
    held_replicated: tuple = ()

    def rules(self):
        """Context manager installing the logical-axis rules."""
        return shd.axis_rules(self.mesh, self.table)

    def axis_size(self, name: str) -> int:
        """Size of one mesh axis (1 when the mesh does not carry it)."""
        return axis_sizes(self.mesh).get(name, 1)

    @property
    def n_devices(self) -> int:
        """Ranks under the plan: the dispatch profiler's per-device
        divisor."""
        return int(self.mesh.size)

    @property
    def backend(self) -> Optional[str]:
        """The process groups' backend (None on a shape-only mesh)."""
        if self.mesh.device_mesh is None:
            return None
        import torch.distributed as dist
        return dist.get_backend(self.mesh.group(self.mesh.axis_names[0]))

    @property
    def splits_rows(self) -> bool:
        """Whether decode buckets split over 'data' (attention families)."""
        return self.cfg.family in TP_FAMILIES and self.axis_size("data") > 1

    def replicated(self) -> shd.NamedSharding:
        """Fully replicated (the decode state: a few int32 a slot,
        delta-updated from the host on every rank)."""
        return shd.named(shd.Spec(), self.mesh)

    def bucket_shardings(self, width: int) -> dict:
        """Shardings of one compacted decode width: a bucket's
        tokens / pos / tables split over 'data' when the width divides it
        (widths are rounded to multiples of 'data' for that; a capped
        full-width bucket of a pool 'data' does not divide, or any width
        after a ``device_fail`` collapsed the multiple, stays whole)."""
        ax = "data" if width % self.axis_size("data") == 0 else None
        return {name: shd.named(shd.Spec(*spec), self.mesh)
                for name, spec in (("tokens", (ax, None)), ("pos", (ax,)),
                                   ("tables", (ax, None)))}

    @property
    def cache_cfg(self):
        """The config the pools are built from: this rank's KV heads."""
        m = self.axis_size("model")
        spec = self.cache_layout.get("k") if self.cache_layout else None
        if spec is not None and "model" in spec:
            return self.cfg.replace(n_kv_heads=self.cfg.n_kv_heads // m)
        return self.cfg

    def shard_params(self, params):
        """This rank's blocks of a full param tree (each leaf cut by its
        ``param_layout`` spec)."""
        def cut(path, leaf):
            spec = _at(self.param_layout, path)
            return shd.local_block(leaf, spec, self.mesh)
        return shd.tree_map_with_path(cut, params)

    def gather_params(self, local):
        """The full param tree from this rank's blocks (each split leaf
        gathered over its mesh axes; every rank takes part)."""
        def join(path, leaf):
            spec = _at(self.param_layout, path)
            with self.rules():
                for d, entry in enumerate(spec):
                    for a in shd._flat(entry):
                        leaf = shd.gather_over(leaf, d, a)
            return leaf
        return shd.tree_map_with_path(join, local)

    def reshard_cache(self, buffers):
        """The pool after a host-side write or a growth: every rank's
        buffers are its own blocks already (the host loop writes the same
        rows on every rank), so this checks each leaf's local shape against
        the plan and returns the buffers."""
        want = self.cache_cfg.n_kv_heads
        for name in ("k", "v"):
            if name in self.cache_layout and buffers[name].shape[-2] != want:
                raise RuntimeError(
                    f"cache leaf {name} holds {buffers[name].shape[-2]} KV "
                    f"heads, the plan {want}")
        return buffers


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _replicated(ref, layout, sizes, prefix="") -> list:
    """Paths whose layout spec dropped a mesh axis of more than one rank
    from the reference's."""
    if isinstance(ref, dict):
        return [p for k in ref for p in _replicated(ref[k], layout[k], sizes,
                                                    f"{prefix}{k}/")]
    if isinstance(ref, list):
        # one entry per distinct per-layer leaf: every layer is alike
        found = []
        for i in range(len(ref)):
            for p in _replicated(ref[i], layout[i], sizes, prefix + "*/"):
                if p not in found:
                    found.append(p)
        return found
    kept = {a for e in layout for a in shd._flat(e)}
    dropped = {a for e in ref for a in shd._flat(e)} - kept
    return [prefix[:-1]] if any(sizes[a] > 1 for a in dropped) else []


def make_serve_sharding(cfg, n_slots: int, max_len: int, mesh=None, *,
                        cache: str = "contiguous", block_size: int = 16,
                        n_blocks=None) -> ServeSharding:
    """Build the sharding plan for a pooled serve engine (the reference's
    table, param and cache specs; the port's realized layout beside
    them)."""
    mesh = mesh if mesh is not None else make_host_mesh()
    sizes = axis_sizes(mesh)
    table = shd.production_rules_table("pod" in mesh.axis_names)
    if cfg.n_kv_heads and cfg.n_kv_heads % sizes["model"] != 0:
        table["kv_seq"] = "model"

    with shd.axis_rules(mesh, table) as rules:
        pspec = shd.param_pspecs(param_shapes(cfg), rules)
        heads = heads_shard(cfg, rules)

    paged = cache == "paged"
    if paged and n_blocks is None:
        n_blocks = n_slots * (-(-max_len // block_size))
    cshape = cache_shapes(cfg, n_slots, max_len, paged=paged,
                          block_size=block_size, n_blocks=n_blocks)
    cspec = cache_pspecs(cfg, cshape, mesh, seq_shard=False, batch=n_slots,
                         paged=paged)

    m = sizes["model"]
    layout = shd.tree_map_with_path(
        lambda path, s: realized(cfg, next(
            (k for k in reversed(path) if isinstance(k, str)), ""), s, m,
            heads), pspec)
    kv_model = m == 1 or (heads and cfg.n_kv_heads % m == 0)
    # the pools: whole over 'data'; KV heads over 'model' where realized
    clayout = {name: shd.Spec(*(
        e if (kv_model and name in ("k", "v") and d == len(spec) - 2)
        else None for d, e in enumerate(spec)))
        for name, spec in cspec.items()}
    return ServeSharding(
        mesh=mesh,
        table=table,
        param_sharding=shd.named(pspec, mesh),
        cache_sharding=shd.named(cspec, mesh),
        cache_pspec=cspec,
        cfg=cfg,
        param_pspec=pspec,
        param_layout=layout,
        cache_layout=clayout,
        held_replicated=tuple(
            _replicated(pspec, layout, sizes)
            + [f"cache/{p}" for p in _replicated(cspec, clayout, sizes)]),
    )


def sharded_engine(cfg, *, n_slots: int = 8, max_len: int = 256,
                   policy: str = "fcfs", params=None, mesh=None,
                   cache: str = "contiguous", block_size: int = 16,
                   n_blocks=None, **engine_kw):
    """A continuous-batching engine whose decode runs TP/DP-sharded over
    ``mesh`` (default: the host mesh over the process group). ``params``
    is the full tree; the engine keeps this rank's blocks."""
    from repro_torch.serve.engine import ServeEngine

    plan = make_serve_sharding(cfg, n_slots, max_len, mesh=mesh, cache=cache,
                               block_size=block_size, n_blocks=n_blocks)
    return ServeEngine(cfg, params=params, max_len=max_len, n_slots=n_slots,
                       policy=policy, sharding=plan, cache=cache,
                       block_size=block_size, n_blocks=n_blocks, **engine_kw)
