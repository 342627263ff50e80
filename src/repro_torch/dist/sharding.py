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
returns None, ``reduce_over`` / ``gather_over`` / ``gather_rows`` return
their input.

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
    logits);
  * ``gather_rows(x)``: a decode bucket's rows over ``"data"`` while
    ``split_rows`` is open (new K/V before a write into a pool that every
    ``data`` rank holds, the selected tokens).

``shard`` and ``shard_spec`` keep the reference's signatures and return
their input: a local tensor's layout is the one the plan gave its leaves,
and the collectives above are where values move. A mesh built over a
process group (``launch/mesh.py``) carries a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
``("data", "model")``, whose groups the collectives use, and ``named``
maps a spec to its DTensor placements (``Shard(d)`` / ``Replicate()`` per
mesh dimension), the counterpart of ``NamedSharding``.

The collectives run on the tensors where they lie: gloo takes CUDA
tensors for ``all_reduce`` and ``all_gather`` (torch 2.11 on the card,
``tools/gloo_cuda_probe.py``), so nothing is staged by hand. A gloo
collective cannot be captured into a CUDA graph (the capture is
invalidated): one issued while the stream captures raises first.
``STATS`` counts the calls by kind and the host seconds spent in them (a
gloo collective on CUDA tensors returns when its result is on the
device, so that includes the wait for the stream).
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

#: one mesh-axis assignment: nothing, a single axis, or several fused axes
MeshAxes = Union[None, str, Tuple[str, ...]]

__all__ = [
    "Spec", "P", "Mesh", "Rules", "axis_rules", "current_rules", "shard",
    "shard_spec", "attention_scheme", "production_rules_table",
    "param_pspecs", "named", "NamedSharding", "PARAM_LOGICAL_AXES",
    "reduce_over", "gather_over", "gather_rows", "split_rows", "local_rows",
    "rows_split",
    "axis_index", "local_block", "STATS",
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
    without it the mesh is shape only (spec logic, coordinates 0)."""

    def __init__(self, shape, axis_names, device_mesh=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match its "
                             f"axis names {self.axis_names}")
        self.device_mesh = device_mesh

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
        """This rank's index along ``axis`` (0 on a shape-only mesh)."""
        if self.device_mesh is None:
            return 0
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
    ``split_rows`` range of a decode bucket, None outside one."""

    def __init__(self, mesh, table: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.table: Dict[str, MeshAxes] = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in dict(table).items()
        }
        self.sizes: Dict[str, int] = dict(mesh.sizes)
        self.rows: Optional[Tuple[int, int]] = None

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
def axis_rules(mesh, table: Dict[str, MeshAxes]):
    """Install ``table`` over ``mesh`` for the dynamic extent of the block."""
    rules = Rules(mesh, table)
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

    The port realizes head-sharded and batch-only; a layer whose scheme is
    q-seq or kv-seq sharded runs replicated over 'model'
    (``serve/sharded.py``).
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
STATS = {"all_reduce": 0, "all_gather": 0, "seconds": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


def axis_index(axis: str) -> int:
    """This rank's index along mesh ``axis`` (0 off-mesh)."""
    rules = current_rules()
    if rules is None or axis not in rules.sizes:
        return 0
    return rules.mesh.coord(axis)


def _group(axis: str):
    """(group, size) of ``axis`` under the active rules; (None, 1) when
    the axis is absent or of size 1."""
    rules = current_rules()
    if rules is None or rules.sizes.get(axis, 1) == 1:
        return None, 1
    return rules.mesh.group(axis), rules.sizes[axis]


def _count(kind: str, group, x: torch.Tensor) -> None:
    """Count one collective; refuse a gloo one inside a graph capture."""
    if (x.is_cuda and torch.cuda.is_current_stream_capturing()
            and dist.get_backend(group) == "gloo"):
        raise RuntimeError(
            f"a gloo {kind} cannot be captured into a CUDA graph: a gloo "
            "plan's programs run eager")
    STATS[kind] += 1


def reduce_over(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor; ``x``
    itself when off-mesh or the axis has one rank)."""
    group, n = _group(axis)
    if group is None:
        return x
    _count("all_reduce", group, x)
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def gather_over(x: torch.Tensor, dim: int, axis: str = "model"
                ) -> torch.Tensor:
    """The ranks' pieces of ``x`` along ``axis``, concatenated along
    ``dim`` in rank order (``x`` itself off-mesh)."""
    group, n = _group(axis)
    if group is None:
        return x
    _count("all_gather", group, x)
    t0 = time.perf_counter()
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# data-parallel decode rows
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def split_rows(width: int):
    """Split a decode bucket of ``width`` rows over 'data' for the block:
    this rank computes rows ``[r0, r1)`` (``local_rows``) and
    ``gather_rows`` joins the ranks' rows. A no-op off-mesh, and when
    'data' has one rank or does not divide ``width``."""
    rules = current_rules()
    n = rules.sizes.get("data", 1) if rules is not None else 1
    if n == 1 or width % n:
        yield None
        return
    per = width // n
    r0 = rules.mesh.coord("data") * per
    prev, rules.rows = rules.rows, (r0, r0 + per)
    try:
        yield rules.rows
    finally:
        rules.rows = prev


def _rows() -> Optional[Tuple[int, int]]:
    rules = current_rules()
    return rules.rows if rules is not None else None


def rows_split() -> bool:
    """Whether a ``split_rows`` block is open (this rank computes a part
    of the bucket's rows)."""
    return _rows() is not None


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a bucket-wide ``x`` (dim 0) inside
    ``split_rows``; ``x`` elsewhere."""
    rows = _rows()
    return x if rows is None else x[rows[0]:rows[1]]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every 'data' rank's rows of ``x`` (dim 0) inside ``split_rows``;
    ``x`` elsewhere."""
    if _rows() is None:
        return x
    return gather_over(x, 0, "data")
