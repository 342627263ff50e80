"""Logical-axis sharding rules over a device mesh (``repro/dist/sharding.py``)
and the collectives that realize them over ``torch.distributed``.

Model code names *logical* axes (``batch``, ``kv_seq``, ``ffn``, ``vocab``,
``experts``, ``inner_flat``, ``heads`` / ``heads_flat``, ``embed``) and a
rules table maps each to zero or more mesh axes. ``axis_rules(mesh, table)``
installs a table for the dynamic extent of a block (a thread-local stack, as
in the reference); every helper reads the innermost one through
``current_rules()``.

Spec logic is the reference's, exactly: ``_sanitize`` drops a mesh axis from
an entry when it is unknown to the mesh, already used by an earlier
dimension, or does not divide the dimension; ``attention_scheme``,
``production_rules_table`` and ``param_pspecs`` return the reference's
values. A ``Spec`` is a tuple of mesh-axis entries and compares equal to
``tuple(jax PartitionSpec)``. It needs only axis names and sizes, so a
``Mesh`` built from a shape alone serves every spec computation.

Off the mesh (no rules installed) every helper is an exact no-op:
``shard`` / ``shard_spec`` return their input, ``attention_scheme``
returns None, ``reduce_over`` / ``gather_over`` / ``fan_out`` /
``gather_rows`` return their input.

On the mesh the port computes SPMD with plain local tensors and explicit
collectives, not DTensor dispatch. Each rank holds the local blocks of the
leaves (``serve/sharded.py`` slices them), the hand-written kernels run
unchanged on each rank's heads, and the model calls, at the reference's
``shard`` sites:

  * ``reduce_over(x, "model")``: the sum of a row-parallel product's
    partial results (``wo``, ``w_down``, the vocab-parallel embedding, the
    expert-parallel MoE combine);
  * ``gather_over(x, dim, "model")``: the pieces of a column-parallel
    output along ``dim`` (the vocab-parallel logits, the router's expert
    logits, flat head columns gathered into whole heads);
  * ``fan_out(x, "model")``: a replicated activation entering a
    column-parallel product (the identity; see Gradients);
  * ``gather_rows(x)``: a decode bucket's or a prefill round's rows over
    ``"data"`` while ``split_rows`` is open (the selected tokens, a MoE
    round's expert counts, new K/V before a write into the paged pool,
    which every ``data`` rank holds whole);
  * ``merge_partials(o, lse, axis)``: the whole attention output from each
    rank's partial output over its own keys and the rows' log-sum-exp
    (kv-seq attention over a decode cache whose positions are split over
    ``axis``, ``cache_seq_axis()``);
  * ``max_over`` and ``reduce_scatter_over``, without gradients: the
    vocab-split loss's row maximum and a train step's gradients over the
    batch axes (``train/sharded.py``).

Gradients. ``reduce_over``, ``gather_over`` and ``fan_out`` are autograd
functions, and every rank runs the same backward, issuing the conjugate
collectives in the same order. The convention is Megatron's: an activation
that is the same on every rank of 'model' (the residual stream) has the
whole gradient on every rank. So the backward of ``reduce_over`` passes the
gradient on, and ``fan_out`` (identity forward) all-reduces it at every
column-parallel entry, where each rank's product contributes only its part.
A call names what its output's gradient is across the ranks (``grad``,
``GRADS``): "replicated" where what follows computes the same on every rank
(the gather then takes this rank's block of it), "partial" where what
follows differs by rank (the gather reduce-scatters it, the reduce
all-reduces it): the flat head columns gathered for a rank's rows or its
own heads (``layers._whole``), the q-seq rows gathered for ``wo``'s
row-parallel product, a column block's sum of squares. A collective's
ranks are fixed when it is issued (``_Span``), so the backward needs no
rules.

``shard`` and ``shard_spec`` keep the reference's signatures and return
their input: a local tensor's layout is the one the plan gave its leaves,
and the collectives above are where values move. A mesh built over a
process group (``launch/mesh.py``) carries a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
``("data", "model")``, whose groups the collectives use, and ``named``
maps a spec to its DTensor placements (``Shard(d)`` / ``Replicate()`` per
mesh dimension), the counterpart of ``NamedSharding``.

The collectives run on the tensors where they lie: gloo takes CUDA
tensors for ``all_reduce``, ``all_gather`` and ``reduce_scatter_tensor``
(torch 2.11 on the card, ``tools/gloo_cuda_probe.py``), so nothing is
staged by hand. A gloo
collective cannot be captured into a CUDA graph (the capture is
invalidated): one issued while the stream captures raises first.
``STATS`` counts the calls by kind and the host seconds spent in them (a
gloo collective on CUDA tensors returns when its result is on the
device, so that includes the wait for the stream).

On tensors without storage (meta: the dry-run's local program of one
rank, ``launch/dryrun.py``) the collectives need no process group: on an
axis of more than one rank they return an output of the collective's shape,
made by the same local copies as the real path (this rank's piece standing
for every rank's), count the call in ``STATS`` and book its output bytes by
kind and mesh axis into the dry-run's counting mode (the innermost mode on
the dispatch stack that takes collective bookings), as the reference's
dry-run sums the output bytes of each collective in the HLO. The backward's
collectives book themselves the same way, so a train program's record
holds what its step issues.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

#: one mesh-axis assignment: nothing, a single axis, or several fused axes
MeshAxes = Union[None, str, Tuple[str, ...]]

__all__ = [
    "Spec", "P", "Mesh", "Rules", "axis_rules", "current_rules", "shard",
    "shard_spec", "attention_scheme", "production_rules_table",
    "param_pspecs", "named", "NamedSharding", "PARAM_LOGICAL_AXES",
    "reduce_over", "gather_over", "fan_out", "max_over",
    "reduce_scatter_over", "GRADS", "gather_rows", "split_rows", "local_rows",
    "rows_split", "rank_rows", "RowSplit", "merge_partials", "combine_partials", "cache_seq_axis",
    "axis_index", "local_block", "use_rules", "STATS", "AXIS_CALLS",
]


def _entry(part) -> MeshAxes:
    """One spec entry in canonical form, as ``PartitionSpec`` keeps it: a
    sequence of one axis is that axis, an empty one None."""
    if isinstance(part, (tuple, list)):
        if not part:
            return None
        return part[0] if len(part) == 1 else tuple(part)
    return part


class Spec(tuple):
    """A partition spec: one mesh-axis entry per dimension (None, an axis
    name, or a tuple of fused axis names). A tuple, so it equals
    ``tuple(jax.sharding.PartitionSpec(...))`` entry for entry."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = Spec


class Mesh:
    """An n-d mesh of ranks with named axes. ``device_mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` over the same shape and
    names) gives this rank's coordinates and one process group per axis;
    without it the mesh is shape only (spec logic; coordinates ``coords``,
    {axis: index}, a given rank's view, 0 on an axis it omits)."""

    def __init__(self, shape, axis_names, device_mesh=None, coords=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match its "
                             f"axis names {self.axis_names}")
        self.device_mesh = device_mesh
        self.coords = dict(coords or {})

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (``coords``' on a shape-only
        mesh)."""
        if self.device_mesh is None:
            return int(self.coords.get(axis, 0))
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.device_mesh is None:
            raise RuntimeError(
                f"mesh {self.sizes} has no process group: build it over "
                "torch.distributed (launch.mesh.make_host_mesh) to run "
                "sharded")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.sizes})"


# ---------------------------------------------------------------------------
# rules registry
# ---------------------------------------------------------------------------
class Rules:
    """An installed (mesh, logical-axis table) pair. ``rows`` is the open
    ``split_rows`` block's ``RowSplit``, None outside one;
    ``cache_seq`` the mesh axis the decode cache's positions are split over
    (the serve plan's or the dry-run's pool layout), None when whole."""

    def __init__(self, mesh, table: Dict[str, MeshAxes],
                 cache_seq: Optional[str] = None):
        self.mesh = mesh
        self.table: Dict[str, MeshAxes] = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in dict(table).items()
        }
        self.sizes: Dict[str, int] = dict(mesh.sizes)
        self.rows = None
        self.cache_seq = cache_seq

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        """Mesh axes assigned to a logical axis name (None if unmapped)."""
        if logical is None:
            return None
        return self.table.get(logical)

    def axis_size(self, axes: MeshAxes) -> int:
        """Total number of shards over ``axes`` (1 for None)."""
        n = 1
        for a in _flat(axes):
            n *= self.sizes.get(a, 1)
        return n

    def __repr__(self) -> str:
        return f"Rules(mesh={tuple(self.sizes.items())}, table={self.table})"


_STATE = threading.local()


def _stack() -> List[Rules]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def current_rules() -> Optional[Rules]:
    """The innermost active Rules, or None when off-mesh."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def axis_rules(mesh, table: Dict[str, MeshAxes],
               cache_seq: Optional[str] = None):
    """Install ``table`` over ``mesh`` for the dynamic extent of the block;
    ``cache_seq``: the mesh axis the decode cache's positions are split
    over (``Rules``)."""
    with use_rules(Rules(mesh, table, cache_seq)) as rules:
        yield rules


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Install an existing ``Rules`` (nothing for None) for the block: a
    recomputation in the backward, which autograd may run on another
    thread, runs under the rules its forward ran under
    (``layers.remat``)."""
    if rules is None:
        yield None
        return
    _stack().append(rules)
    try:
        yield rules
    finally:
        _stack().pop()


# ---------------------------------------------------------------------------
# spec construction / sanitization
# ---------------------------------------------------------------------------
def _flat(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, (tuple, list)):
        return tuple(axes)
    return (axes,)


def _sanitize(parts, shape, rules: Rules) -> Spec:
    """Right-pad ``parts`` to ``shape``'s rank and drop invalid entries
    (unknown mesh axis, duplicate use, non-divisible dimension)."""
    parts = list(parts)[:len(shape)]
    parts += [None] * (len(shape) - len(parts))
    used: set = set()
    out = []
    for dim, ax in zip(shape, parts):
        axes = _flat(ax)
        if (not axes
                or any(a not in rules.sizes for a in axes)
                or any(a in used for a in axes)
                or dim % rules.axis_size(ax) != 0):
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return Spec(*out)


def _overlaps(a: MeshAxes, b: MeshAxes) -> bool:
    return bool(set(_flat(a)) & set(_flat(b)))


# ---------------------------------------------------------------------------
# constraint helpers (no-ops off-mesh)
# ---------------------------------------------------------------------------
def shard(x, *logical_axes):
    """The reference's constraint by logical axis names: the port's local
    tensors already have their plan's layout, so ``x`` comes back as it
    is, on the mesh and off it (module docstring)."""
    return x


def shard_spec(x, pspec):
    """The reference's constraint by an explicit spec; returns ``x`` (see
    ``shard``)."""
    return x


# ---------------------------------------------------------------------------
# attention scheme selection
# ---------------------------------------------------------------------------
def attention_scheme(b: int, s: int, nh: int, kv_s: int):
    """Pick the attention sharding layout for shapes (B, Sq, H, Skv).

    Returns None off-mesh, else {"q", "kv", "logits"} specs laid out for
    q/kv of shape [B, S, H, D] and logits of [B, H, Sq, Sk]:

      * head-sharded   — H divides the 'heads' axes: the classic TP layout.
      * q-seq-sharded  — awkward head count but a long query: shard Sq.
      * kv-seq-sharded — decode (Sq == 1) with awkward heads: shard the
        cache sequence.
      * batch-only     — nothing else fits.

    The port realizes all four (``models/layers.py:attention``): q-seq
    as a block of query rows a rank (flash with a query offset), kv-seq as
    each rank's partial attention over its slice of a position-split cache,
    merged by ``merge_partials``.
    """
    rules = current_rules()
    if rules is None:
        return None

    def fits(n: int, ax: MeshAxes) -> bool:
        size = rules.axis_size(ax)
        return ax is not None and size > 1 and n % size == 0

    b_ax = rules.mesh_axes("batch")
    if not fits(b, b_ax):
        b_ax = None
    m_ax = rules.mesh_axes("heads")
    if m_ax is not None and rules.axis_size(m_ax) <= 1:
        m_ax = None
    kv_ax = rules.mesh_axes("kv_seq")
    if not fits(kv_s, kv_ax) or _overlaps(kv_ax, b_ax):
        kv_ax = None
    if b_ax is None and m_ax is None and kv_ax is None:
        return None

    msize = rules.axis_size(m_ax) if m_ax is not None else 0
    if m_ax is not None and nh % msize == 0:
        kv_seq = kv_ax if not _overlaps(kv_ax, m_ax) else None
        return {"q": P(b_ax, None, m_ax, None),
                "kv": P(b_ax, kv_seq, m_ax, None),
                "logits": P(b_ax, m_ax, None, None)}
    if m_ax is not None and s > 1 and s % msize == 0:
        return {"q": P(b_ax, m_ax, None, None),
                "kv": P(b_ax, kv_ax, None, None),
                "logits": P(b_ax, None, m_ax, None)}
    if m_ax is not None and s == 1 and kv_s % msize == 0:
        return {"q": P(b_ax, None, None, None),
                "kv": P(b_ax, m_ax, None, None),
                "logits": P(b_ax, None, None, m_ax)}
    return {"q": P(b_ax, None, None, None),
            "kv": P(b_ax, kv_ax, None, None),
            "logits": P(b_ax, None, None, None)}


# ---------------------------------------------------------------------------
# production tables / parameter specs
# ---------------------------------------------------------------------------
def production_rules_table(multi_pod: bool = False, *,
                          seq_shard: bool = False) -> Dict[str, MeshAxes]:
    """Logical-axis table for a ("data", "model") mesh; ``multi_pod``
    adds a leading "pod" axis fused into the batch axes, ``seq_shard``
    routes kv_seq to "data" (long-context decode at batch 1). Callers may
    retarget entries before installing the table, e.g.
    ``table["kv_seq"] = "model"`` for small-KV-head decode."""
    batch: MeshAxes = ("pod", "data") if multi_pod else "data"
    return {
        "batch": batch,
        "heads": "model",
        "heads_flat": "model",
        "kv_seq": "data" if seq_shard else None,
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "inner_flat": "model",
        "embed": None,
        "model": None,
    }


#: logical axes of each parameter's *trailing* dimensions, keyed by leaf
#: name. Leading stacked dimensions are replicated. Where two entries map to
#: the same mesh axes (experts and ffn -> "model") the sanitizer keeps the
#: leftmost: expert parallelism wins over TP within an expert.
PARAM_LOGICAL_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings
    "tok_emb": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    # attention
    "wq": ("embed", "heads_flat"),
    "wk": ("embed", "heads_flat"),
    "wv": ("embed", "heads_flat"),
    "bq": ("heads_flat",),
    "bk": ("heads_flat",),
    "bv": ("heads_flat",),
    "wo": ("heads_flat", "embed"),
    # dense MLP
    "w_gate": ("embed", "ffn"),
    "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
    # MoE
    "router": ("embed", "experts"),
    "we_gate_up": ("experts", "embed", "ffn"),
    "we_down": ("experts", "ffn", "embed"),
    # Mamba2 / SSD
    "in_proj": ("embed", "inner_flat"),
    "out_proj": ("inner_flat", "embed"),
    "conv_w": (None, "inner_flat"),
    "conv_b": ("inner_flat",),
    "A_log": ("heads",),
    "dt_bias": ("heads",),
    "D": ("heads",),
}


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list tree (the port's
    params and caches); the path holds dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def leaf_at(tree, path):
    """The leaf of ``tree`` at ``path`` (``tree_map_with_path``'s)."""
    for k in path:
        tree = tree[k]
    return tree


def spec_ranks(spec, sizes: Dict[str, int]) -> int:
    """The ranks ``spec`` splits a leaf over: the product of its axes'
    sizes in ``sizes`` ({axis: size})."""
    n = 1
    for entry in spec or ():
        for a in _flat(entry):
            n *= sizes[a]
    return n


def mesh_index(mesh: Mesh, axes: MeshAxes) -> int:
    """This rank's index along ``axes`` (a name, or fused names, the first
    outermost)."""
    sizes, c = mesh.sizes, 0
    for a in _flat(axes):
        c = c * sizes[a] + mesh.coord(a)
    return c


def param_pspecs(params, rules: Rules):
    """Spec tree for a params tree (tensors or shapes) under ``rules``.

    Leaves are matched by their final dict key against
    ``PARAM_LOGICAL_AXES`` (right-aligned over trailing dims); unknown
    leaves (norm scales) are replicated. Every spec is full-rank and
    sanitized. The port's per-layer lists hold unstacked leaves, so a
    leaf's spec is the reference's without its leading layer entry."""
    def spec_for(path, leaf):
        name = next((str(k) for k in reversed(path) if isinstance(k, str)),
                    "")
        shape = _shape(leaf)
        logical = PARAM_LOGICAL_AXES.get(name, ())
        ndim = len(shape)
        trailing = ([rules.mesh_axes(a) for a in logical[-ndim:]] if ndim
                    else [])
        parts = [None] * (ndim - len(trailing)) + trailing
        return _sanitize(parts, shape, rules)

    return tree_map_with_path(spec_for, params)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh with its DTensor placements (one per mesh axis:
    ``Shard(d)`` where tensor dim d splits over it, else ``Replicate()``)."""
    mesh: Mesh
    spec: Spec
    placements: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return all(self.mesh.sizes[a] == 1
                   for e in self.spec for a in _flat(e))


def placements(spec: Spec, mesh: Mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dim = next((d for d, e in enumerate(spec) if axis in _flat(e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def named(spec, mesh):
    """Map a spec tree to ``NamedSharding`` leaves on ``mesh``."""
    def one(s):
        if isinstance(s, Spec):
            return NamedSharding(mesh, s, placements(s, mesh))
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        if isinstance(s, list):
            return [one(v) for v in s]
        raise TypeError(f"not a spec tree leaf: {s!r}")
    return one(spec)


def local_block(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a global tensor ``x`` under ``spec``: each
    sharded dimension cut into even chunks in mesh order (the blocks
    ``distribute_tensor(x, mesh, placements).to_local()`` holds)."""
    for d, entry in enumerate(spec):
        for a in _flat(entry):
            n = mesh.sizes[a]
            if n > 1:
                size = x.shape[d] // n
                x = x.narrow(d, mesh.coord(a) * size, size)
    return x.contiguous()


# ---------------------------------------------------------------------------
# collectives (no-ops off-mesh)
# ---------------------------------------------------------------------------
#: collective calls by kind, and the host seconds spent in them
STATS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
         "seconds": 0.0}
#: collective calls by mesh axis (fused axes joined by "+")
AXIS_CALLS: Dict[str, int] = {}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)
    AXIS_CALLS.clear()


def axis_index(axis: str) -> int:
    """This rank's index along mesh ``axis`` (0 off-mesh)."""
    rules = current_rules()
    if rules is None or axis not in rules.sizes:
        return 0
    return rules.mesh.coord(axis)


class _Span:
    """The ranks one collective spans over a mesh axis (a name, or fused
    names on a shape-only mesh), fixed when it is issued: a backward, which
    autograd may run on another thread, issues its collectives over the
    same ranks without the (thread-local) rules. ``group`` is None on
    tensors without storage (the dry-run books instead); ``coord`` is this
    rank's index along the (fused) axis."""

    def __init__(self, label: str, n: int, group, coord: int):
        self.label, self.n, self.group, self.coord = label, n, group, coord


def _span(x: torch.Tensor, axis: MeshAxes) -> Optional[_Span]:
    """The span of a collective on ``x`` over ``axis`` under the active
    rules; None off the mesh and where the axis has one rank (or is not
    the mesh's)."""
    rules = current_rules()
    if rules is None:
        return None
    names = _flat(axis)
    n = rules.axis_size(axis)
    if n == 1 or any(a not in rules.sizes for a in names):
        return None
    coord = mesh_index(rules.mesh, names)
    if x.device.type == "meta":
        return _Span("+".join(names), n, None, coord)
    if len(names) != 1:
        raise ValueError(f"a collective over the fused axes {names} needs a "
                         "process group of its own: only the dry-run's "
                         "tensors without storage take one")
    return _Span(names[0], n, rules.mesh.group(names[0]), coord)


def _count(kind: str, span: _Span, x: torch.Tensor) -> None:
    """Count one collective; refuse a gloo one inside a graph capture."""
    if (span.group is not None and x.is_cuda
            and torch.cuda.is_current_stream_capturing()
            and dist.get_backend(span.group) == "gloo"):
        raise RuntimeError(
            f"a gloo {kind} cannot be captured into a CUDA graph: a gloo "
            "plan's programs run eager")
    STATS[kind] += 1
    AXIS_CALLS[span.label] = AXIS_CALLS.get(span.label, 0) + 1


def _book(kind: str, axis: str, x: torch.Tensor, n: int = 1) -> None:
    """Book a collective's output bytes (``n`` times ``x``'s) over ``axis``
    into the active counting mode (none: nothing counts)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "book_collective"):
            mode.book_collective(kind, axis, n * x.numel() * x.element_size())
            return


def _all_reduce(x: torch.Tensor, span: _Span, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``span``'s ranks, a new tensor."""
    _count("all_reduce", span, x)
    out = x.contiguous().clone()
    if span.group is None:
        _book("all-reduce", span.label, out)
        return out
    t0 = time.perf_counter()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=span.group)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def _all_gather(x: torch.Tensor, dim: int, span: _Span) -> torch.Tensor:
    """The ranks' pieces of ``x`` concatenated along ``dim`` in rank order
    (without storage, this rank's piece stands for every rank's)."""
    _count("all_gather", span, x)
    src = x.contiguous()
    if span.group is None:
        _book("all-gather", span.label, src, span.n)
        return torch.cat([src] * span.n, dim=dim)
    t0 = time.perf_counter()
    parts = [torch.empty_like(src) for _ in range(span.n)]
    dist.all_gather(parts, src, group=span.group)
    STATS["seconds"] += time.perf_counter() - t0
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, span: _Span) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``span``'s
    ranks (``dim`` cut into even blocks in rank order)."""
    _count("reduce_scatter", span, x)
    size = x.shape[dim] // span.n
    if span.group is None:
        out = x.narrow(dim, span.coord * size, size).contiguous().clone()
        _book("reduce-scatter", span.label, out)
        return out
    t0 = time.perf_counter()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=span.group)
    STATS["seconds"] += time.perf_counter() - t0
    return out.movedim(0, dim).contiguous()


#: what a collective's output gradient is across the ranks of its axis:
#: "replicated" (what follows computes the same on every rank, so each rank
#: holds the whole gradient) or "partial" (each rank holds its own part of
#: it, the whole gradient being their sum)
GRADS = ("replicated", "partial")


def _grad_kind(grad: str) -> bool:
    if grad not in GRADS:
        raise ValueError(f"grad must be one of {GRADS}, got {grad!r}")
    return grad == "partial"


class _Reduce(torch.autograd.Function):
    """An all-reduce; its backward passes a replicated gradient on and
    all-reduces a partial one."""

    @staticmethod
    def forward(ctx, x, span, partial):
        ctx.span, ctx.partial = span, partial
        return _all_reduce(x, span)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.span) if ctx.partial else g), None, None


class _Gather(torch.autograd.Function):
    """An all-gather; its backward takes this rank's block of a replicated
    gradient and reduce-scatters a partial one."""

    @staticmethod
    def forward(ctx, x, dim, span, partial):
        ctx.dim, ctx.size, ctx.span, ctx.partial = (dim, x.shape[dim], span,
                                                    partial)
        return _all_gather(x, dim, span)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            dx = _reduce_scatter(g, ctx.dim, ctx.span)
        else:
            dx = g.narrow(ctx.dim, ctx.span.coord * ctx.size, ctx.size)
        return dx, None, None, None


class _FanOut(torch.autograd.Function):
    """The identity; its backward all-reduces the ranks' partial
    gradients."""

    @staticmethod
    def forward(ctx, x, span):
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.span), None


def reduce_over(x: torch.Tensor, axis: MeshAxes = "model", *,
                grad: str = "replicated") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor; ``x``
    itself when off-mesh or the axis has one rank). ``grad`` (``GRADS``):
    the output's gradient across the ranks, which sets the backward: the
    gradient itself where it is replicated, its all-reduce where each rank
    holds a part."""
    partial = _grad_kind(grad)
    span = _span(x, axis)
    return x if span is None else _Reduce.apply(x, span, partial)


def gather_over(x: torch.Tensor, dim: int, axis: MeshAxes = "model", *,
                grad: str = "replicated") -> torch.Tensor:
    """The ranks' pieces of ``x`` along ``axis``, concatenated along
    ``dim`` in rank order (``x`` itself off-mesh). ``grad`` (``GRADS``)
    sets the backward: this rank's block of a replicated gradient, or the
    reduce-scatter of the ranks' parts of it."""
    partial = _grad_kind(grad)
    span = _span(x, axis)
    return (x if span is None
            else _Gather.apply(x, dim % x.dim(), span, partial))


def fan_out(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x``, the same on every rank of ``axis``, entering a computation
    that differs by rank (a column-parallel product): the identity, whose
    backward all-reduces the ranks' parts of the gradient, so that the
    gradient of a replicated activation is whole on every rank. ``x``
    itself off the mesh or on an axis of one rank."""
    span = _span(x, axis)
    return x if span is None else _FanOut.apply(x, span)


def max_over(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The element-wise maximum of ``x`` over the ranks of ``axis``,
    without a gradient (a new tensor; ``x`` detached off the mesh)."""
    x = x.detach()
    span = _span(x, axis)
    return x if span is None else _all_reduce(x, span, dist.ReduceOp.MAX)


def reduce_scatter_over(x: torch.Tensor, dim: int,
                        axis: MeshAxes = "data") -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    of ``axis``, without a gradient (a train step's gradients; ``x`` itself
    off the mesh). ``axis`` may fuse names (``("pod", "data")``) on a
    shape-only mesh."""
    span = _span(x, axis)
    return x if span is None else _reduce_scatter(x.detach(), dim, span)


def cache_seq_axis() -> Optional[str]:
    """The mesh axis the decode cache's positions are split over under the
    active rules (``Rules.cache_seq``, when it has more than one rank);
    None off the mesh and for a whole cache."""
    rules = current_rules()
    if rules is None or rules.cache_seq is None:
        return None
    return rules.cache_seq if rules.sizes.get(rules.cache_seq, 1) > 1 \
        else None


def merge_partials(o: torch.Tensor, lse: torch.Tensor,
                   axis: str = "model") -> torch.Tensor:
    """The whole attention output of rows whose keys are split over the
    ranks of ``axis``: each rank holds its output over its own keys ``o``
    [..., D] (normalized over them) and each row's log-sum-exp over them
    ``lse`` [...] f32 (-inf: none visible). One all-gather of (o, lse) over
    the axis, then, in rank order and in f32, ``o = sum_r exp(lse_r - L)
    o_r`` with ``L = logsumexp_r lse_r``: every rank computes the same
    values. A row whose lse is -inf on every rank gives 0 (the kernels'
    ``l == 0 -> 1`` rule). Returns o's dtype; ``o`` itself off the mesh or
    on an axis of one rank."""
    packed = torch.cat([o.float(), lse.float()[..., None]], dim=-1)[None]
    parts = gather_over(packed, 0, axis)
    if parts is packed:
        return o
    return combine_partials(parts[..., :-1], parts[..., -1]).to(o.dtype)


def combine_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """``merge_partials``' arithmetic on the gathered pairs: o [n, ..., D]
    and lse [n, ...] of n key slices, in slice order -> the f32 output
    over all of them (0 for a row no slice saw a key of)."""
    m = lse.float().amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = torch.zeros_like(o[0], dtype=torch.float32)
    den = torch.zeros_like(m)
    for r in range(o.shape[0]):
        w = torch.exp(lse[r].float() - m)        # -inf: weight 0
        acc = acc + w[..., None] * o[r].float()
        den = den + w
    return acc / torch.where(den > 0, den, torch.ones_like(den))[..., None]


# ---------------------------------------------------------------------------
# data-parallel decode rows
# ---------------------------------------------------------------------------
class RowSplit:
    """An open ``split_rows`` block: ``index``, this rank's bucket
    positions (int64), padded to the largest rank's part, ``n`` of them
    real (the padding comes last), and ``order``: each bucket row's
    position among the gathered parts (None: the parts are the bucket in
    order)."""

    def __init__(self, mine, n: int, order, device):
        self.n = n
        self.index = torch.as_tensor(mine, dtype=torch.int64, device=device)
        self.order = (None if order is None else
                      torch.as_tensor(order, dtype=torch.int64,
                                      device=device))


def _parts(rows, n: int):
    """The bucket positions each of ``n`` 'data' ranks computes under
    ``split_rows(rows)``, or None when the block does not split."""
    if rows is None or n == 1:
        return None
    if isinstance(rows, int):
        if rows % n:
            return None
        per = rows // n
        return [list(range(r * per, (r + 1) * per)) for r in range(n)]
    parts = [list(p) for p in rows]
    if (len(parts) != n or sorted(i for p in parts for i in p)
            != list(range(sum(map(len, parts))))):
        raise ValueError(f"split_rows: {parts} does not give each of the "
                         f"bucket's rows to one of {n} 'data' ranks")
    return parts


def rank_rows(rows) -> Optional[List[int]]:
    """This rank's bucket positions under ``split_rows(rows)`` (the host's
    view: no tensor), None where the block would not split."""
    rules = current_rules()
    parts = _parts(rows, rules.sizes.get("data", 1) if rules else 1)
    return None if parts is None else parts[rules.mesh.coord("data")]


@contextlib.contextmanager
def split_rows(rows, device=None):
    """Split a decode bucket's (or a prefill round's) rows over 'data' for
    the block. ``rows``: the bucket's width, cut into equal consecutive
    parts where 'data' divides it, or one list of bucket positions a
    'data' rank, in rank order (each position in one list: the rows whose
    pool rows that rank holds). This rank computes its part
    (``local_rows``), padded to the largest part with its first position
    (position 0 where it has none), so that every rank computes as many
    rows and joins every collective, and ``gather_rows`` joins the ranks'
    parts in bucket order without the padding (gloo's all-gather takes
    equal pieces). A no-op off-mesh, with 'data' of one rank, for ``rows``
    None and for a width 'data' does not divide; the index tensors go to
    ``device``."""
    rules = current_rules()
    n = rules.sizes.get("data", 1) if rules is not None else 1
    parts = _parts(rows, n)
    if parts is None:
        yield None
        return
    pad = max(len(p) for p in parts)
    mine = parts[rules.mesh.coord("data")]
    order = [0] * sum(len(p) for p in parts)
    for r, part in enumerate(parts):
        for j, pos in enumerate(part):
            order[pos] = r * pad + j
    if order == list(range(n * pad)):
        order = None
    split = RowSplit(mine + [mine[0] if mine else 0] * (pad - len(mine)),
                     len(mine), order, device)
    prev, rules.rows = rules.rows, split
    try:
        yield split
    finally:
        rules.rows = prev


def _rows() -> Optional[RowSplit]:
    rules = current_rules()
    return rules.rows if rules is not None else None


def rows_split() -> bool:
    """Whether a ``split_rows`` block is open (this rank computes a part
    of the bucket's rows)."""
    return _rows() is not None


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows (padding included) of a bucket-wide ``x`` along
    ``dim`` inside ``split_rows``; ``x`` elsewhere."""
    split = _rows()
    if split is None:
        return x
    return x.index_select(dim, split.index.to(x.device))


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every 'data' rank's rows of ``x`` along ``dim`` inside
    ``split_rows``, in bucket order without the padding; ``x``
    elsewhere."""
    split = _rows()
    if split is None:
        return x
    out = gather_over(x, dim, "data")
    if split.order is None:
        return out
    return out.index_select(dim, split.order.to(out.device))
