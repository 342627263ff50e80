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
  * the layout each leaf has on this rank (``param_layout``,
    ``cache_layout``): the reference's specs, every split realized. Over
    'model': the attention leaves split flat over the heads
    (``heads_flat``: whole heads where 'model' divides the head count,
    else a column block that cuts a head, whose columns the layer
    gathers), vocab-parallel embeddings and logits, ffn-parallel MLPs,
    expert-parallel MoE, or where 'model' does not divide the experts
    their fused ``we_gate_up`` split flat by width and ``we_down`` by rows
    (``models/moe.py``), the Mamba2 leaves (the fused ``in_proj`` split
    flat, the conv over its channels, the SSM over its heads, ``out_proj``
    row-parallel; ``models/mamba2.py``), KV heads where they divide
    'model', and where they do not, the pools' positions (the paged pool's
    in-block offsets, the contiguous pool's sequence, the hybrid's
    shared-block K/V; the layer runs kv-seq over them,
    ``models/layers.py``), the conv states over their channels and the SSM
    states over their heads. Over 'data': the contiguous pools' slots
    wherever 'data' divides the slot count (global slot ``s`` on 'data'
    rank ``s // (n_slots / d)``, at local row ``s % (n_slots / d)``);
    the paged pool is whole over 'data', by the reference's spec.
    ``held_replicated`` lists the leaves held whole where the reference's
    spec splits them: none.

``shard_params`` cuts a full param tree into this rank's blocks (the
counterpart of ``jax.device_put(params, param_sharding)``); ``pools``
builds every pool, contiguous or paged, at this rank's block of its
global shape (``local_shape``: the global shape cut by the layout), while
the host side (the slots' free list, the block manager and its tables,
the scheduler's lengths) stays at the global one. A decode bucket over a
contiguous pool split over 'data' is computed at its slots' ranks, each
rank its own rows; one over the paged pool, and a paged prefill round,
a part a 'data' rank where 'data' divides its width (``split_rows``);
everything else every rank computes whole. The engine runs the same host
loop on every rank, so the scheduler, the block manager and the counters
agree; the selected tokens are gathered over 'data'.

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
from repro_torch.models.api import build_model, params_specs
from repro_torch.models.transformer import PagedCache


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


def rows_dim(name: str, ndim: int) -> int:
    """A pool leaf's slot (or block) dimension: 2 for the hybrid's
    per-group states ``gconv`` [G, E, B, K-1, C] and ``gssm``
    [G, E, B, H, N, P], else 1."""
    return 2 if ndim == 6 or (ndim == 5 and name.endswith("conv")) else 1


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
    where their positions do). The slot dimension is cut only for the
    plan's own slot count: a batch-1 prefill row, or a probe of another
    batch size, keeps its rows."""

    def __init__(self, plan, model):
        self.plan, self.model = plan, model
        self.cfg = model.cfg

    def _local(self, name: str, t: torch.Tensor, device,
               slots: bool = True) -> torch.Tensor:
        return torch.zeros(self.plan.local_shape(name, t.shape, slots),
                           dtype=t.dtype, device=device)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device="cuda") -> dict:
        full = self.model.init_cache(batch, max_len, dtype, device="meta")
        slots = batch == self.plan.n_slots
        return {name: self._local(name, t, device, slots)
                for name, t in full.items()}

    def held_slots(self, n_slots: int) -> range:
        """The global slots of a pool of ``n_slots`` this rank holds
        (``ServeSharding.held_slots``)."""
        return self.plan.held_slots(n_slots)

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
    #: leaves held whole where the reference's spec splits them: none,
    #: every layout is the reference's spec
    held_replicated: tuple = ()
    #: the pools' global shape, each leaf's
    cache_shape: dict = field(default_factory=dict, repr=False)
    #: the slot count the pool specs were made for, and whether the pool
    #: is the paged one (whose block dimension a growth changes)
    n_slots: int = 0
    paged: bool = False

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

    def local_shape(self, name: str, shape, slots: bool = True) -> tuple:
        """The shape of this rank's block of pool leaf ``name`` at global
        ``shape`` (each dimension over the ranks its layout splits it; the
        slot dimension whole unless ``slots``)."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        keep = None if slots else rows_dim(name, len(out))
        for d, entry in enumerate(self.cache_layout.get(name, ())):
            for a in shd._flat(entry):
                if d != keep:
                    out[d] //= sizes[a]
        return tuple(out)

    def held_slots(self, n_slots: int) -> range:
        """The global slots of a contiguous pool of ``n_slots`` this rank
        holds: its 'data' block of the plan's pool (the reference's block
        layout of a ``P(..., "data", ...)`` dimension), every slot of a
        whole pool, of the paged pool or of another slot count."""
        name, spec = next(iter(self.cache_layout.items()))
        entry = spec[rows_dim(name, len(spec))]
        if self.paged or entry is None or n_slots != self.n_slots:
            return range(n_slots)
        d = self.axis_size(entry)
        per = n_slots // d
        r = self.mesh.coord("data")
        return range(r * per, (r + 1) * per)

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
            spec = shd.leaf_at(self.param_layout, path)
            return shd.local_block(leaf, spec, self.mesh)
        return shd.tree_map_with_path(cut, params)

    def gather_params(self, local):
        """The full param tree from this rank's blocks (each split leaf
        gathered over its mesh axes; every rank takes part)."""
        def join(path, leaf):
            spec = shd.leaf_at(self.param_layout, path)
            with self.rules():
                for d, entry in enumerate(spec):
                    for a in shd._flat(entry):
                        leaf = shd.gather_over(leaf, d, a)
            return leaf
        return shd.tree_map_with_path(join, local)

    def reshard_cache(self, buffers):
        """The pool after a host-side write or a growth: every rank's
        buffers are its own blocks already (a row is written at its owner,
        the paged pool on every rank), so this checks each leaf against
        its layout (every dimension, but the paged pool's blocks, which a
        growth changes) and returns the buffers."""
        for name, shape in self.cache_shape.items():
            got, want = tuple(buffers[name].shape), self.local_shape(name,
                                                                     shape)
            if self.paged:
                got, want = got[:1] + got[2:], want[:1] + want[2:]
            if got != want:
                raise RuntimeError(
                    f"cache leaf {name} is {tuple(buffers[name].shape)} on "
                    f"this rank, the plan's block "
                    f"{self.local_shape(name, shape)}"
                    + (" (blocks aside)" if self.paged else ""))
        return buffers


def make_serve_sharding(cfg, n_slots: int, max_len: int, mesh=None, *,
                        cache: str = "contiguous", block_size: int = 16,
                        n_blocks=None) -> ServeSharding:
    """Build the sharding plan for a pooled serve engine (the reference's
    table, param and cache specs, and the port's layout of them)."""
    mesh = mesh if mesh is not None else make_host_mesh()
    sizes = axis_sizes(mesh)
    table = shd.production_rules_table("pod" in mesh.axis_names)
    if cfg.n_kv_heads and cfg.n_kv_heads % sizes["model"] != 0:
        table["kv_seq"] = "model"

    with shd.axis_rules(mesh, table) as rules:
        pspec = shd.param_pspecs(param_shapes(cfg), rules)

    paged = cache == "paged"
    if paged and n_blocks is None:
        n_blocks = n_slots * (-(-max_len // block_size))
    cshape = cache_shapes(cfg, n_slots, max_len, paged=paged,
                          block_size=block_size, n_blocks=n_blocks)
    cspec = cache_pspecs(cfg, cshape, mesh, seq_shard=False, batch=n_slots,
                         paged=paged)

    return ServeSharding(
        mesh=mesh,
        table=table,
        param_sharding=shd.named(pspec, mesh),
        cache_sharding=shd.named(cspec, mesh),
        cache_pspec=cspec,
        cfg=cfg,
        param_pspec=pspec,
        param_layout=pspec,
        cache_layout=cspec,
        cache_shape=cshape,
        n_slots=n_slots,
        paged=paged,
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
