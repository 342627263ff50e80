"""Multi-pod dry-run (``repro/launch/dryrun.py``): run every (architecture x
input shape x mesh) combination as the local program of one rank on
tensors without storage, and read its roofline terms off the run.

Usage (any machine, no card needed; nothing full-width is allocated):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh pod --out build/dryrun/dryrun.jsonl

What replaces the reference's "lower and compile". The reference lowers a
jitted SPMD program and reads XLA's cost and memory analyses and the HLO's
collectives. The port computes SPMD as plain local tensors with explicit
collectives (``dist/sharding.py``), so one rank's local program is the
whole story: ``lower_combo`` builds it on meta tensors and runs it under a
counting mode that records

  * FLOPs, from ``torch.utils.flop_counter.FlopCounterMode``, plus the
    hand-written kernels' ``kernels/cost.py`` terms, which ``kernels/ops.py``
    books into the counting mode (``book_kernel``, found on the dispatch
    stack) for every kernel call on tensors without storage (so the count
    is the card's work, not the plain versions' scores); a call the CUDA
    route would refuse (an SSD backward whose chunk or state exceeds the
    kernel's limits, a flash backward in a dtype other than f32 and bf16)
    is booked with its reason, and the record lists it under
    ``not_runnable``;
  * bytes accessed: for each op that is not a view or metadata op, the
    bytes its tensor inputs read (each by its storage extent, so an
    expanded mask counts once) and its outputs write, plus the kernels'
    booked bytes;
  * peak live bytes: a storage's bytes are added when it is created and
    taken off when it is freed, from the arguments up;
  * collective output bytes by kind and mesh axis (``reduce_over`` and
    ``gather_over`` on tensors without storage book them through
    ``book_collective``), as the reference sums the output bytes of the
    HLO's collectives.

The program is the port's own plan, which realizes every split of the
reference: parameters are the local blocks of ``param_pspecs``; the
decode cache the local blocks of ``cache_pspecs`` (rows over the batch
axes; KV heads over 'model' where they divide it, else the sequence over
the axis the reference splits it, 'model', or 'data' for long_500k, where
the layer runs kv-seq over that axis; the conv states' channels and the
SSM states' heads over 'model'). The record's ``held_replicated`` (leaves
held whole where the reference splits them) is empty. Batch rows split
over the batch axes when those divide the batch. The program runs under
``axis_rules(mesh, production_rules_table(...))`` with the reference's
``kv_seq`` override, and the cache's sequence axis (``cache_seq``). Modes: ``train`` is the port's train step
(``Model.loss``, backward, clip and AdamW as ``train/trainer.py`` runs it,
under ``--remat``; with ZeRO-1 the update runs on this rank's shards of
the gradients, moments and params); ``prefill`` is ``Model.forward``;
``decode`` is ``Model.decode_step`` at the int position ``seq_len - 1``.

Train collectives. The port has no sharded train step; the record derives
it (``derived_collective_bytes``): the backward issues each forward
collective over 'model' again at the same bytes, its conjugate (an
all-reduce for an all-reduce, a reduce-scatter for an all-gather), and the
gradients sync over the batch axes as ``opt_state_pspecs`` lays them out:
an all-reduce of each local gradient, or under ZeRO-1 a reduce-scatter of
it and an all-gather of the updated params (a leaf ZeRO-1 cannot split is
all-reduced). ``collective_s`` sums each axis's wire bytes (2x an
all-reduce's, as the reference's ring factor) over its bandwidth:
NVLink for 'model', the network for 'data' and 'pod' (``launch/mesh.py``).

Every layer is counted: the port's layer loops are Python, unlike XLA's
while bodies, which its cost analysis counts once. ``probe_slopes`` keeps
the reference's two-point probes (``_probe_plan``) and records their
extrapolation under ``probe``, beside its gap to the full count (0 for a
uniform stack). ZeRO-1 picks a dimension of each per-layer leaf: where the
reference's stacked leaf would take its layer axis, the port splits the
layer's own first free dimension instead.

The reference's ``launch/_bootstrap.py`` (``force_host_devices``) has no
counterpart: it forces XLA's host platform to expose many devices before
jax initializes, and a shape-only mesh needs no devices. ``--mesh host``
is ``make_host_mesh``'s layout over ``REPRO_DRYRUN_DEVICES`` ranks
(default: the CUDA devices present, else 8, as the reference forces 8);
``lower_combo(..., ranks=)`` fixes the count instead.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Spec as P, tree_map_with_path
from repro_torch.launch.mesh import (AXIS_BW, HBM_BW, NET_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, axis_sizes,
                                     make_host_mesh, make_production_mesh)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _div(n: int, size: int) -> bool:
    return n % size == 0 and n > 0


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _leaves(tree) -> list:
    """The leaves of a nested dict / list tree, in its order (tensors,
    shapes or specs: a ``Spec`` is a tuple, not a list)."""
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def cache_pspecs(cfg, cache_shape, mesh, *, seq_shard: bool, batch: int,
                 paged: bool = False):
    """Specs for the decode cache, per family (leaves: tensors or shapes,
    matched by their '/'-joined path).

    KV head counts that do not divide the model axis fall back to sharding
    the cache SEQ dimension over 'model'. ``paged=True`` describes the
    block-pool layout ``[L, n_blocks, block_size, kv, hd]`` instead: the
    block dimension stays unsharded (any slot's table may name any block),
    KV heads shard over 'model', and the small-KV-head fallback shards the
    in-block position dimension."""
    ba = _batch_axes(mesh)
    bsz = 1
    for a in ba:
        bsz *= axis_sizes(mesh)[a]
    b_ax = ba if _div(batch, bsz) else None
    msize = axis_sizes(mesh)["model"]

    def spec_for(path, leaf):
        name = "/".join(str(p) for p in path)
        shape = _shape(leaf)
        ndim = len(shape)

        def m_ax(dim):
            return "model" if _div(shape[dim], msize) else None
        if paged and name in ("k", "v"):
            # [L, NB, BS, kv, hd]
            s_ax = ("model" if m_ax(3) is None and _div(shape[2], msize)
                    else None)
            return P(None, None, s_ax, m_ax(3), None)
        if name in ("k", "v") or name.endswith(("attn_k", "attn_v")):
            # [L_or_G, B, S, kv, hd]
            if seq_shard:
                s_ax = "data"
            elif m_ax(3) is None and _div(shape[2], msize):
                s_ax = "model"
            else:
                s_ax = None
            return P(None, b_ax, s_ax, m_ax(3), None)
        if name in ("ck", "cv"):
            return P(None, b_ax, None, m_ax(3), None)
        if name.endswith("conv") and ndim == 4:     # [L,B,K-1,ch]
            return P(None, b_ax, None, m_ax(3))
        if name.endswith("conv") and ndim == 5:     # [G,E,B,K-1,ch]
            return P(None, None, b_ax, None, m_ax(4))
        if name.endswith("ssm") and ndim == 5:      # [L,B,H,N,P]
            return P(None, b_ax, m_ax(2), None, None)
        if name.endswith("ssm") and ndim == 6:      # [G,E,B,H,N,P]
            return P(None, None, b_ax, m_ax(3), None, None)
        return P()

    return tree_map_with_path(spec_for, cache_shape)


def opt_state_pspecs(param_specs_tree, params_shape, mesh):
    """ZeRO-1: shard the optimizer moments over the data axes on top of
    each param's own spec (its first unsharded, divisible dimension).
    Leaves are tensors or shapes; the port's per-layer leaves have no
    layer axis to take (module docstring)."""
    ba = _batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dsz = 1
    for a in ba:
        dsz *= sizes[a]

    def zero1(path, spec):
        shape = _shape(_at(params_shape, path))
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (p_, d) in enumerate(zip(parts, shape)):
            if p_ is None and d % dsz == 0 and d > 0:
                parts[i] = ba if len(ba) > 1 else ba[0]
                break
        return P(*parts)

    return tree_map_with_path(zero1, param_specs_tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _probe_plan(arch: str) -> tuple:
    """(probe layer counts, extra overrides per probe, effective full L):
    the reference's plan (two unrolled depths, extrapolated linearly)."""
    cfg = get_config(arch)
    if arch == "gemma3-27b":
        # preserve the 5:1 local:global pattern (global_every=6)
        return (6, 12), {}, cfg.n_layers
    if cfg.family == "hybrid":
        # multiples of shared_attn_every (6): 1 and 2 super-groups
        return (6, 12), {}, cfg.n_layers
    if cfg.family == "encdec":
        return (2, 4), {"scale_enc": True}, cfg.n_layers
    return (2, 4), {}, cfg.n_layers


def probe_slopes(arch: str, shape_name: str, multi_pod: bool, *,
                 zero1: bool, remat: str, extra_cfg: Optional[dict] = None,
                 mesh_kind: Optional[str] = None,
                 ranks: Optional[int] = None) -> Dict[str, float]:
    """The reference's two-point extrapolation: the counts at the probe
    depths and ``total = f(la) + slope * (L_full - la)``."""
    (la, lb), opts, l_full = _probe_plan(arch)
    vals = {}
    for n_layers in (la, lb):
        ov = dict(extra_cfg or {})
        ov["n_layers"] = n_layers
        if opts.get("scale_enc"):
            ov["n_enc_layers"] = n_layers
        rec, _ = lower_combo(arch, shape_name, multi_pod, zero1=zero1,
                             remat=remat, extra_cfg=ov, probe=False,
                             mesh_kind=mesh_kind, ranks=ranks)
        vals[n_layers] = rec
    out = {}
    for key in ("flops_per_chip", "bytes_per_chip", "wire_bytes_per_chip"):
        fa, fb = vals[la][key], vals[lb][key]
        slope = (fb - fa) / (lb - la)
        out[key] = fa + slope * (l_full - la)
        out[key + "_slope"] = slope
    out["probe_layers"] = [la, lb]
    out["probe_compile_s"] = sum(v["compile_s"] + v["lower_s"]
                                 for v in vals.values())
    return out


def _spec_ranks(spec, sizes) -> int:
    denom = 1
    for part in (spec or P()):
        for ax in shd._flat(part):
            denom *= sizes[ax]
    return denom


def sharded_arg_bytes(shape_tree, spec_tree, mesh) -> float:
    """Analytic per-device bytes of the program arguments: each leaf's
    bytes over the ranks its spec splits it across (leaves: tensors)."""
    sizes = axis_sizes(mesh)
    total = 0.0
    for leaf, spec in zip(_leaves(shape_tree), _leaves(spec_tree)):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n * leaf.element_size() / _spec_ranks(spec, sizes)
    return total


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
#: ops that move no data (besides views, ``OpOverload.is_view``)
_NO_DATA = {
    _aten.detach.default, _aten.alias.default, _aten._unsafe_view.default,
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.lift_fresh.default,
    _aten.lift_fresh_copy.default,
}
#: ops that write their first argument without reading it
_PURE_WRITES = {"copy_", "fill_", "zero_", "normal_", "random_", "uniform_"}
#: ops that write their first argument at some indices only
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
             "scatter_", "scatter_add_", "scatter_reduce_",
             "masked_scatter_"}


def _extent(t: torch.Tensor) -> int:
    """The bytes a view spans in its storage (a broadcast dimension, of
    stride 0, spans one element)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return span * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CountingMode(TorchDispatchMode):
    """Counts a storage-less program's bytes accessed and live bytes, and
    takes the bookings of the kernels (``kernels/ops.py``) and collectives
    (``dist/sharding.py``), which find it on the dispatch-mode stack.

    ``args`` are the program's arguments, live before it starts."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.live: Dict[int, int] = {}
        for t in _tensors(args):
            s = t.untyped_storage()
            self.live.setdefault(s._cdata, s.nbytes())
        self.argument_bytes = sum(self.live.values())
        self.current = self.peak = self.argument_bytes
        self.kernels: Dict[str, dict] = {}
        self.collectives: Dict[tuple, float] = {}
        self.derived: Dict[tuple, float] = {}

    @staticmethod
    def active() -> Optional["CountingMode"]:
        """The innermost counting mode on the dispatch stack (or None)."""
        return next((m for m in reversed(_get_current_dispatch_mode_stack())
                     if isinstance(m, CountingMode)), None)

    # -- bookings ------------------------------------------------------------
    def book_kernel(self, name: str, flops: int, nbytes: int,
                    refused: Optional[str] = None) -> None:
        """One kernel call's ``kernels/cost.py`` terms; ``refused``: why
        the CUDA route would refuse it."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        if refused:
            k["refused"] = refused

    def book_collective(self, kind: str, axis: str, nbytes: float,
                        derived: bool = False) -> None:
        """One collective's output bytes over mesh ``axis``; ``derived``:
        one the program does not issue but its sharded counterpart would
        (the train rule, module docstring)."""
        into = self.derived if derived else self.collectives
        into[(kind, axis)] = into.get((kind, axis), 0.0) + nbytes

    # -- the dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _NO_DATA:
            self.bytes += self._moved(func, args, kwargs, out)
        for t in _tensors(out):
            self._track(t)
        return out

    def _moved(self, func, args, kwargs, out) -> int:
        name = func.overloadpacket.__name__
        written = [a for a, s in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and s.alias_info is not None
                   and s.alias_info.is_write]
        written += [v for k, v in kwargs.items()
                    if isinstance(v, torch.Tensor) and k == "out"]
        keys = {w.untyped_storage()._cdata for w in written}
        ins = [t for t in _tensors((args, kwargs))
               if all(t is not w for w in written)]
        if name in _SCATTERS:
            vals = [t for t in ins
                    if t.dtype.is_floating_point or t.dtype.is_complex]
            return (sum(_extent(t) for t in ins)
                    + sum(_extent(t) for t in vals))
        nbytes = sum(_extent(t) for t in ins)
        for w in written:
            nbytes += _extent(w) * (1 if name in _PURE_WRITES else 2)
        for t in _tensors(out):
            if t.untyped_storage()._cdata not in keys:
                nbytes += t.numel() * t.element_size()
        return nbytes

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.live:
            return
        n = s.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key)


# ---------------------------------------------------------------------------
# the local program of one rank
# ---------------------------------------------------------------------------
@dataclass
class Program:
    """One rank's program: ``run(*args)`` on ``args`` (meta tensors here;
    real ones of the same shapes on a card), its config, mesh and rules
    table, and the leaves it holds whole where the reference splits them
    (none: the layouts are the reference's specs)."""
    cfg: object
    mesh: object
    table: dict
    args: tuple
    run: Callable
    held_replicated: list = field(default_factory=list)
    #: the mesh axis the decode cache's sequence is split over (None:
    #: whole, or no cache)
    cache_seq: Optional[str] = None

    def rules(self):
        return shd.axis_rules(self.mesh, self.table,
                              cache_seq=self.cache_seq)

    def count(self) -> dict:
        """Run once under the counting modes; the counts and the outputs'
        bytes."""
        with self.rules(), FlopCounterMode(display=False) as fc, \
                CountingMode(self.args) as cm:
            out = self.run(*self.args)
            out_bytes = sum({t.untyped_storage()._cdata:
                             t.untyped_storage().nbytes()
                             for t in _tensors(out)}.values())
        del out
        booked = sum(k["flops"] for k in cm.kernels.values())
        return {"flops": fc.get_total_flops() + booked,
                "torch_flops": fc.get_total_flops(),
                "bytes": cm.bytes + sum(k["bytes"]
                                        for k in cm.kernels.values()),
                "argument_bytes": cm.argument_bytes,
                "output_bytes": out_bytes, "peak_bytes": cm.peak,
                "kernels": cm.kernels, "collectives": cm.collectives,
                "derived": cm.derived}


def _block(leaf, spec, mesh):
    """This rank's block of a meta leaf, in a storage of its own (a block
    cut along the first dimension would share the whole leaf's)."""
    return shd.local_block(leaf, spec, mesh).clone()


def _local(tree, layout, mesh, requires_grad: bool = False):
    """Meta local blocks of a meta tree under a spec tree."""
    def cut(path, leaf):
        t = _block(leaf, _at(layout, path), mesh)
        return t.requires_grad_(True) if requires_grad else t
    return tree_map_with_path(cut, tree)


def _cut_view(x, spec, mesh):
    """This rank's block of ``x`` as a view (``local_block`` without the
    copy)."""
    for d, entry in enumerate(spec):
        for a in shd._flat(entry):
            n = mesh.sizes[a]
            if n > 1:
                x = x.narrow(d, mesh.coord(a) * (x.shape[d] // n),
                             x.shape[d] // n)
    return x


def build_program(cfg, ishape, mesh, table, *, zero1: bool = True,
                  seq_shard: bool = False) -> Program:
    """The local program of one rank for ``cfg`` at ``ishape`` on ``mesh``
    (module docstring): its meta arguments, cut to the port's plan."""
    from repro_torch.models.api import (build_model, cache_specs,
                                        input_specs, params_specs)
    from repro_torch.serve.sharded import cache_seq
    from repro_torch.train.optimizer import (adamw, constant, leaves,
                                             tree_map)
    sizes = axis_sizes(mesh)
    model = build_model(cfg)
    ba = _batch_axes(mesh)
    basz = 1
    for a in ba:
        basz *= sizes[a]
    bsz = ishape.global_batch
    rows = bsz // basz if _div(bsz, basz) else bsz
    with shd.axis_rules(mesh, table) as rules:
        pshape = params_specs(cfg)
        layout = shd.param_pspecs(pshape, rules)
    batch = input_specs(cfg, rows, ishape.seq_len, ishape.mode)
    common = dict(cfg=cfg, mesh=mesh, table=table)

    if ishape.mode == "prefill":
        params = _local(pshape, layout, mesh)

        def prefill(params, batch):
            with torch.no_grad():
                return model.forward(params, batch)
        return Program(args=(params, batch), run=prefill, **common)

    if ishape.mode == "decode":
        params = _local(pshape, layout, mesh)
        cshape = cache_specs(cfg, bsz, ishape.seq_len)
        cspec = cache_pspecs(cfg, cshape, mesh, seq_shard=seq_shard,
                             batch=bsz)
        cache = _local(cshape, cspec, mesh)
        tokens = batch["tokens"]
        pos = ishape.seq_len - 1

        def decode(params, cache, tokens):
            with torch.no_grad():
                return model.decode_step(params, cache, tokens, pos)
        return Program(args=(params, cache, tokens), run=decode,
                       cache_seq=cache_seq(cspec, sizes), **common)

    # train: the port's train step on this rank's blocks
    optimizer = adamw(constant(1e-4))
    params = _local(pshape, layout, mesh, requires_grad=True)
    olayout = opt_state_pspecs(layout, pshape, mesh) if zero1 else layout
    moments = tree_map_with_path(
        lambda path, t: _block(t.to(torch.float32), _at(olayout, path),
                               mesh), pshape)
    opt = {"mu": moments, "nu": tree_map(torch.empty_like, moments)}
    batch_axes = "+".join(ba)

    def train(params, opt, batch):
        """``state.make_train_step``'s step, its update on this rank's
        ZeRO-1 shards, with the derived collectives booked."""
        cm = CountingMode.active()
        before = dict(cm.collectives) if cm is not None else {}
        loss = model.loss(params, batch)
        if cm is not None:
            for (kind, axis), nb in list(cm.collectives.items()):
                nb -= before.get((kind, axis), 0.0)
                if axis == "model" and nb:
                    cm.book_collective(
                        "all-reduce" if kind == "all-reduce"
                        else "reduce-scatter", axis, nb, derived=True)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)

        def shard(path, g):
            spec, ospec_ = _at(layout, path), _at(olayout, path)
            if basz > 1 and cm is not None:
                nb = g.numel() * g.element_size()
                extra = _spec_ranks(ospec_, sizes) // _spec_ranks(spec,
                                                                  sizes)
                if extra > 1:
                    cm.book_collective("reduce-scatter", batch_axes,
                                       nb / extra, derived=True)
                    cm.book_collective("all-gather", batch_axes, nb,
                                       derived=True)
                else:
                    cm.book_collective("all-reduce", batch_axes, nb,
                                       derived=True)
            return _cut_view(g, _shard_only(spec, ospec_), mesh)
        g_local = tree_map_with_path(shard, grads)
        p_local = tree_map_with_path(
            lambda path, p: _cut_view(p.detach(), _shard_only(
                _at(layout, path), _at(olayout, path)), mesh), params)
        gnorm = optimizer.update(g_local, opt, p_local, 0)
        for p in leaves(params):
            p.grad = None
        return loss.detach(), gnorm
    return Program(args=(params, opt, batch), run=train, **common)


def _shard_only(spec, ospec) -> P:
    """The entries ZeRO-1 adds to ``spec`` (the cut of a local block)."""
    return P(*(None if a == b else b for a, b in zip(spec, ospec)))


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------
def host_ranks() -> int:
    """The ranks of ``--mesh host``: ``REPRO_DRYRUN_DEVICES``, else the
    CUDA devices present, else 8."""
    n = os.environ.get("REPRO_DRYRUN_DEVICES")
    if n:
        return int(n)
    return torch.cuda.device_count() or 8


def combo_program(arch: str, shape_name: str, multi_pod: bool, *,
                  zero1: bool = True, remat: str = "full",
                  extra_cfg: Optional[dict] = None,
                  mesh_kind: Optional[str] = None,
                  ranks: Optional[int] = None) -> Program:
    """The local program of one rank for a combination (the reference's
    mesh, rules table, ``kv_seq`` override and bf16 overrides); ``ranks``:
    the host mesh's (default ``host_ranks()``)."""
    mesh = (make_host_mesh(ranks=ranks or host_ranks())
            if mesh_kind == "host"
            else make_production_mesh(multi_pod=multi_pod))
    ishape = INPUT_SHAPES[shape_name]
    seq_shard = shape_name == "long_500k"
    table = shd.production_rules_table(multi_pod, seq_shard=seq_shard)
    if ishape.mode == "decode" and not seq_shard:
        pre_cfg = get_config(arch, **(extra_cfg or {}))
        msize = axis_sizes(mesh)["model"]
        if pre_cfg.n_kv_heads and pre_cfg.n_kv_heads % msize != 0:
            table["kv_seq"] = "model"

    overrides = dict(dtype="bfloat16", param_dtype="bfloat16")
    if ishape.mode == "train":
        overrides["remat"] = remat
    if extra_cfg:
        overrides.update(extra_cfg)
    cfg = get_config(arch, **overrides)
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        raise SystemExit(f"SKIP: {arch} does not support long_500k (full "
                         f"attention)")
    return build_program(cfg, ishape, mesh, table, zero1=zero1,
                         seq_shard=seq_shard)


def _wire(by_kind: Dict[str, float]) -> float:
    """Wire bytes a chip: a ring all-reduce moves ~2x its output."""
    return (2.0 * by_kind.get("all-reduce", 0.0)
            + sum(v for k, v in by_kind.items()
                  if k in _COLLECTIVES and k != "all-reduce"))


def _axis_bw(axis: str) -> float:
    return min(AXIS_BW[a] for a in axis.split("+"))


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                *, zero1: bool = True, remat: str = "full",
                extra_cfg: Optional[dict] = None, probe: bool = True,
                mesh_kind: Optional[str] = None, ranks: Optional[int] = None):
    """Build and count one combination; returns (record, program).

    ``mesh_kind="host"`` lays out ``ranks`` ranks (default
    ``host_ranks()``); default is the production pod / multipod mesh.
    ``lower_s`` is the program's set-up time (specs, local blocks),
    ``compile_s`` the counted run's."""
    t_start = time.time()
    program = combo_program(arch, shape_name, multi_pod, zero1=zero1,
                            remat=remat, extra_cfg=extra_cfg,
                            mesh_kind=mesh_kind, ranks=ranks)
    t_lower = time.time()
    counts = program.count()
    t_count = time.time()
    mesh, ishape = program.mesh, INPUT_SHAPES[shape_name]
    n_chips = mesh.size

    coll: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    by_axis: Dict[str, Dict[str, float]] = {}
    derived: Dict[str, Dict[str, float]] = {}
    for into, src in ((by_axis, counts["collectives"]),
                      (derived, counts["derived"])):
        for (kind, axis), nb in sorted(src.items()):
            coll[kind] += nb
            into.setdefault(axis, {})[kind] = \
                into.setdefault(axis, {}).get(kind, 0.0) + nb
    coll["total"] = sum(coll[k] for k in _COLLECTIVES)
    axis_wire: Dict[str, float] = {}
    for group in (by_axis, derived):
        for axis, kinds in group.items():
            axis_wire[axis] = axis_wire.get(axis, 0.0) + _wire(kinds)
    wire = sum(axis_wire.values())

    flops = float(counts["flops"])
    bytes_accessed = float(counts["bytes"])
    collective_s = sum(w / _axis_bw(a) for a, w in axis_wire.items())
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_accessed / HBM_BW

    probe_stats = None
    if probe:
        probe_stats = probe_slopes(arch, shape_name, multi_pod, zero1=zero1,
                                   remat=remat, extra_cfg=extra_cfg,
                                   mesh_kind=mesh_kind, ranks=ranks)
        full = {"flops_per_chip": flops, "bytes_per_chip": bytes_accessed,
                "wire_bytes_per_chip": wire}
        probe_stats["gap"] = {k: probe_stats[k] - v for k, v in full.items()}

    n = get_config(arch).param_count()
    n_active = get_config(arch).param_count(active_only=True)
    tokens = ishape.global_batch * (ishape.seq_len if ishape.mode != "decode"
                                    else 1)
    mult = 6 if ishape.mode == "train" else 2
    model_flops_per_chip = mult * n_active * tokens / n_chips
    peak = counts["peak_bytes"]

    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind or ("multipod" if multi_pod else "pod"),
        "n_chips": n_chips,
        "mode": ishape.mode,
        "zero1": zero1,
        "remat": remat if ishape.mode == "train" else None,
        "lower_s": round(t_lower - t_start, 1),
        "compile_s": round(t_count - t_lower, 1),
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_accessed,
        "collective_bytes": coll,
        "wire_bytes_per_chip": wire,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(("compute", compute_s), ("memory", memory_s),
                          ("collective", collective_s), key=lambda t: t[1])[0],
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flop_ratio": (model_flops_per_chip / flops) if flops else None,
        "memory_stats": {
            "bytes_per_device": peak - counts["argument_bytes"],
            "argument_bytes": counts["argument_bytes"],
            "output_bytes": counts["output_bytes"],
            "peak_bytes": peak,
        },
        "args_gib_per_device": round(counts["argument_bytes"] / 2**30, 3),
        "params": n,
        "params_active": n_active,
        "probe": probe_stats,
        # the port's own keys
        "mesh_shape": dict(axis_sizes(mesh)),
        "collective_bytes_by_axis": by_axis,
        "derived_collective_bytes": derived,
        "kernels": counts["kernels"],
        "held_replicated": program.held_replicated,
        "not_runnable": {name: k["refused"]
                         for name, k in counts["kernels"].items()
                         if "refused" in k},
        "roofline": {"peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
                     "nvlink_bw": NVLINK_BW, "net_bw": NET_BW},
    }
    return record, program


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "host"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the two-point probes (multipod pass/fail runs)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--cfg-json", default=None,
                    help="JSON dict of ArchConfig overrides (perf iterations)")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)

    extra = json.loads(args.cfg_json) if args.cfg_json else None
    record, _ = lower_combo(
        args.arch, args.shape, args.mesh == "multipod",
        zero1=not args.no_zero1, remat=args.remat, extra_cfg=extra,
        probe=not args.no_probe,
        mesh_kind="host" if args.mesh == "host" else None)
    if args.tag:
        record["tag"] = args.tag

    print(json.dumps({k: v for k, v in record.items()
                      if k != "memory_stats"}, indent=2))
    print("memory:", record["memory_stats"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")


if __name__ == "__main__":
    main()
