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
    ``cache_layout``). The port realizes every 'model' split of the
    reference, in every family: the attention leaves split flat over the
    heads (``heads_flat``: whole heads where 'model' divides the head
    count, else a column block that cuts a head, whose columns the layer
    gathers), vocab-parallel embeddings and logits, ffn-parallel MLPs,
    expert-parallel MoE, the Mamba2 leaves (the fused ``in_proj`` split
    flat, the conv over its channels, the SSM over its heads,
    ``out_proj`` row-parallel; ``models/mamba2.py``), KV heads over
    'model' where they divide it, and where they do not, the pools'
    positions over 'model' (the paged pool's in-block offsets, the
    contiguous pool's sequence, the hybrid's shared-block K/V; the layer
    runs kv-seq over them, ``models/layers.py``), the conv states over
    their channels and the SSM states over their heads. A leaf whose
    reference spec it does not realize is held replicated over 'model'
    and listed in ``held_replicated``: the fused expert gate/up split by
    width. The pools are held whole over 'data' (the paged pool by the
    reference's spec; the contiguous pools in this slice): new K/V rows
    are gathered over 'data' before each write.

``shard_params`` cuts a full param tree into this rank's blocks (the
counterpart of ``jax.device_put(params, param_sharding)``); ``pools``
builds every pool, contiguous or paged, at this rank's block of its
global shape (``local_shape``: the global shape cut by the layout), while
the host side (the block manager and its tables, the scheduler's lengths)
stays at the global one. A decode bucket whose width the 'data' axis
divides is computed a part a 'data' rank (``split_rows``), for the attention
families; everything else every rank computes whole. The engine runs the
same host loop on every rank, so the scheduler, the block manager and the
counters agree; the selected tokens are gathered over 'data'.

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
from repro_torch.models.api import build_model, params_specs
from repro_torch.models.transformer import PagedCache

#: families whose decode buckets split over 'data' (``splits_rows``)
ROW_FAMILIES = ("dense", "vlm", "moe")
#: the pool leaves of K/V heads [L | G, B | NB, S | BS, kv, hd]
KV_LEAVES = ("k", "v", "attn_k", "attn_v", "ck", "cv")


def param_shapes(cfg) -> dict:
    """The port's param tree of ``cfg`` as shapes, without allocating."""
    return shd.tree_map_with_path(lambda _, t: tuple(t.shape),
                                  params_specs(cfg))


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


def realized(name: str, spec: shd.Spec, m: int) -> shd.Spec:
    """The spec a parameter leaf named ``name`` runs with: the reference's
    ``spec``, or it with 'model' (of ``m`` ranks) dropped where the port
    does not realize that split: the fused expert gate/up and down
    ([E, D, 2F] / [E, F, D]) split by width, not by expert (module
    docstring)."""
    if m == 1 or "model" not in (a for e in spec for a in shd._flat(e)):
        return spec
    if name not in ("we_gate_up", "we_down") or spec[-3] == "model":
        return spec
    return shd.Spec(*(None if "model" in shd._flat(e) else e for e in spec))


def rows_dim(name: str, ndim: int) -> int:
    """A pool leaf's slot (or block) dimension: 2 for the hybrid's
    per-group states ``gconv`` [G, E, B, K-1, C] and ``gssm``
    [G, E, B, H, N, P], else 1."""
    return 2 if ndim == 6 or (ndim == 5 and name.endswith("conv")) else 1


def cache_layout(cfg, cspec: dict, sizes: dict, heads: bool,
                 keep_axes=()) -> dict:
    """The splits of a pool's reference specs ``cspec`` the port realizes:
    every split over 'model' (the K/V leaves' heads where attention runs
    head-sharded and 'model' divides them, the positions over the axis the
    reference splits them, the conv channels, the SSM heads), the rows
    over ``keep_axes`` (the dry-run's batch axes) and any entry over axes
    of one rank; every other entry whole (the rows over 'data' in
    serving)."""
    m = sizes.get("model", 1)
    kv_model = m == 1 or (heads and cfg.n_kv_heads % m == 0)

    def keep(name, d, e, ndim):
        if e is None:
            return False
        axes = shd._flat(e)
        if all(sizes.get(a, 1) == 1 for a in axes):
            return True                  # a split over one rank cuts nothing
        if d == rows_dim(name, ndim):
            return set(axes) <= set(keep_axes)
        if name in KV_LEAVES and d == ndim - 2:
            return kv_model
        return True
    return {name: shd.Spec(*(e if keep(name, d, e, len(spec)) else None
                             for d, e in enumerate(spec)))
            for name, spec in cspec.items()}


def cache_seq(clayout: dict, sizes: dict):
    """The mesh axis a realized pool layout splits the positions over
    (dim 2 of its "k" or "attn_k" leaf, of more than one rank), else
    None."""
    spec = clayout.get("k", clayout.get("attn_k"))
    if spec is None or len(spec) < 3 or spec[2] is None:
        return None
    axes = shd._flat(spec[2])
    return axes[0] if len(axes) == 1 and sizes.get(axes[0], 1) > 1 else None


class LocalPools:
    """A model's pool constructors at this rank's blocks
    (``ServeSharding.pools``): each builds the pool at its global shape on
    ``meta`` and allocates every leaf at its block under the plan's
    layout (a conv channel block of the flat ``d_inner + 2 G N`` has no
    config that describes it; the paged pools' in-block offsets split
    where their positions do)."""

    def __init__(self, plan, model):
        self.plan, self.model = plan, model
        self.cfg = model.cfg

    def _local(self, name: str, t: torch.Tensor, device) -> torch.Tensor:
        return torch.zeros(self.plan.local_shape(name, t.shape),
                           dtype=t.dtype, device=device)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device="cuda") -> dict:
        full = self.model.init_cache(batch, max_len, dtype, device="meta")
        return {name: self._local(name, t, device)
                for name, t in full.items()}

    def init_paged_cache(self, n_blocks: int, block_size: int, dtype=None,
                         device="cuda") -> PagedCache:
        # the buffers [L, NB + 1, BS, kv, hd] (the scratch block too)
        full = self.model.init_paged_cache(n_blocks, block_size, dtype,
                                           device="meta")
        return PagedCache(self._local("k", full.k_buf, device),
                          self._local("v", full.v_buf, device))


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
    #: the pools' global shape, each leaf's
    cache_shape: dict = field(default_factory=dict, repr=False)

    def rules(self):
        """Context manager installing the logical-axis rules (and the
        pools' position split, ``cache_seq_axis``)."""
        return shd.axis_rules(self.mesh, self.table,
                              cache_seq=self.cache_seq_axis)

    @property
    def cache_seq_axis(self) -> Optional[str]:
        """The mesh axis the pools' positions are split over (None:
        whole)."""
        return cache_seq(self.cache_layout or {}, axis_sizes(self.mesh))

    @property
    def seq_shards(self) -> int:
        """The ranks the pools' positions are split over (1: whole)."""
        axis = self.cache_seq_axis
        return 1 if axis is None else self.axis_size(axis)

    def local_shape(self, name: str, shape) -> tuple:
        """The shape of this rank's block of pool leaf ``name`` at global
        ``shape`` (each dimension over the ranks its layout splits it)."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.cache_layout.get(name, ())):
            for a in shd._flat(entry):
                out[d] //= sizes[a]
        return tuple(out)

    def pools(self, model) -> LocalPools:
        """``model``'s pool constructors at this rank's blocks."""
        return LocalPools(self, model)

    def local_cache_row(self, row: dict) -> dict:
        """This rank's positions of a batch-1 contiguous cache row (the
        prefill's, at ``max_len``) for ``CachePool.write``."""
        axis = self.cache_seq_axis
        if axis is None:
            return row
        n = row["k"].shape[2] // self.seq_shards
        r = self.mesh.coord(axis)
        return {name: t.narrow(2, r * n, n) for name, t in row.items()}

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
        """Whether decode buckets split over 'data' (attention families;
        the others' pools keep their rows whole over 'data')."""
        return self.cfg.family in ROW_FAMILIES and self.axis_size("data") > 1

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
        rows on every rank), so this checks each leaf against its layout
        (every dimension but the slots' or blocks', which a growth
        changes) and returns the buffers."""
        for name, shape in self.cache_shape.items():
            buf = buffers[name]
            want = self.local_shape(name, shape)
            rows = rows_dim(name, buf.dim())
            got = tuple(buf.shape)
            if got[:rows] + got[rows + 1:] != want[:rows] + want[rows + 1:]:
                raise RuntimeError(
                    f"cache leaf {name} is {got} on this rank, the plan's "
                    f"block {want} (slots or blocks aside)")
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
        heads = L.heads_sharded(cfg)

    paged = cache == "paged"
    if paged and n_blocks is None:
        n_blocks = n_slots * (-(-max_len // block_size))
    cshape = cache_shapes(cfg, n_slots, max_len, paged=paged,
                          block_size=block_size, n_blocks=n_blocks)
    cspec = cache_pspecs(cfg, cshape, mesh, seq_shard=False, batch=n_slots,
                         paged=paged)

    m = sizes["model"]
    layout = shd.tree_map_with_path(
        lambda path, s: realized(next(
            (k for k in reversed(path) if isinstance(k, str)), ""), s, m),
        pspec)
    # the pools: whole over 'data'; every split over 'model'
    clayout = cache_layout(cfg, cspec, sizes, heads)
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
        cache_shape=cshape,
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
