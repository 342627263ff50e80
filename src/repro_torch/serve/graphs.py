"""The port's ``jax.jit``: one captured CUDA graph per static signature.

The reference compiles each decode horizon once per static ``(h, full)``
(``repro/serve/engine.py:640-651``), its paged prefill round once per lane
width and scans its recurrent prefill inside one program. ``GraphRunner``
is the torch form of that: a key names the static signature (the engine
uses ``("paged" | "contiguous", W, h, full)``, ``("prefill", w)`` and
``("recurrent_step",)``) and holds, per key, static input buffers, the
static output (a tensor or a tuple of tensors: the MoE prefill round also
returns its lanes' expert counts) and one ``torch.cuda.CUDAGraph``.

  * First call of a key: the inputs are copied into fresh static buffers
    and the function runs eagerly on them, for real, its kernel launches
    counted as usual; then it is captured into a new graph (capture
    executes nothing). The call returns the eager outputs.
  * Later calls: the inputs are copied into the static buffers, the graph
    replays, and the call returns the graph's static output — valid until
    the next call of the same key, so read it first. The ``fn`` of a later
    call is not used: the graph holds the first call's.

The function must read its other tensors (weights, pools, decode state)
at fixed addresses: a caller that reallocates them calls ``reset``. All
of a runner's graphs share one memory pool; they replay one after another,
never at once. A replay runs no Python, so the kernel wrappers' launch
counters (``kernels/ops.py``) are read around the capture, put back, and
the capture's difference is added on every replay: a captured run counts
the launches an eager run counts.

There is no fallback: on a CUDA device a capture or replay that fails
raises. The garbage collector is off while a graph captures: a collection
that freed another runner's graph (an engine dropped in a reference cycle)
would destroy a graph mid-capture, which invalidates the capture. On the CPU there is nothing to capture: every call runs the first
call's function through the same static buffers and copies its output
into the static output, so the CPU tests exercise the copy-in and
copy-out. The CPU also holds the function to the fixed-address contract:
each call records the storages its ops read that it did not allocate, and
a later call that reads one the first call did not raises — on the card
its replay would have read the old tensor.
``eager()`` switches the runners off (the counterpart of
``jax.disable_jit()``): calls run the function on their own inputs.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every ``GraphRunner`` call eagerly on its own inputs while the
    context is open: no static buffer, no capture, no replay."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


class _Reads(TorchDispatchMode):
    """The storages (data pointers) that the ops run inside the context
    read and that none of them allocated."""

    def __init__(self):
        super().__init__()
        self.read, self._made = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not torch.ops.aten.lift_fresh.default:  # torch.tensor()
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    ptr = t.untyped_storage().data_ptr()
                    if ptr and ptr not in self._made:
                        self.read.add(ptr)
        out = func(*args, **(kwargs or {}))
        self._made.update(t.untyped_storage().data_ptr()
                          for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor))
        return out


def _tensors(out) -> tuple:
    """A function's output as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


class _Entry:
    """One key's static inputs, static output and first function; on
    CUDA its graph and the kernel launches one replay makes, on the CPU the
    storages its first call read."""
    __slots__ = ("inputs", "output", "fn", "graph", "counts", "reads")

    def __init__(self, inputs, output, fn, graph=None, counts=None,
                 reads=None):
        self.inputs, self.output, self.fn = inputs, output, fn
        self.graph, self.counts, self.reads = graph, counts, reads


class GraphRunner:
    """One captured program per key on ``device`` (module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: Dict[Hashable, _Entry] = {}
        self._pool: Optional[Tuple[int, int]] = None
        #: graph replays so far (0 on the CPU and under ``eager()``)
        self.replays = 0

    @property
    def keys(self):
        """The keys captured so far (or, on the CPU, first called)."""
        return list(self._entries)

    def reset(self) -> None:
        """Drop every graph: the tensors they read have moved. Their
        memory pool goes with them (the allocator releases a private pool
        whose last graph is gone; a later capture takes a new one)."""
        self._entries.clear()
        self._pool = None

    def __call__(self, key: Hashable, fn: Callable, *inputs: torch.Tensor):
        """``fn(*inputs)`` (a tensor or a tuple of tensors) through the
        static signature ``key``. The inputs may lie on the host or the
        device; they are copied to the device."""
        if _eager_depth:
            return fn(*(x.to(self.device) for x in inputs))
        entry = self._entries.get(key)
        if entry is None:
            return self._first(key, fn, inputs)
        for buf, x in zip(entry.inputs, inputs):
            buf.copy_(x)
        if entry.graph is None:
            with _Reads() as reads:
                out = entry.fn(*entry.inputs)
            if reads.read - entry.reads:
                raise RuntimeError(
                    f"graph {key!r} read {len(reads.read - entry.reads)} "
                    "tensor(s) its first call did not: a tensor it reads was "
                    "rebound since, and a replay would read the old one")
            for dst, src in zip(_tensors(entry.output), _tensors(out)):
                dst.copy_(src)
        else:
            entry.graph.replay()
            ops.add_counts(entry.counts)
            self.replays += 1
        return entry.output

    def _first(self, key, fn, inputs):
        static = tuple(torch.empty(x.shape, dtype=x.dtype,
                                   device=self.device).copy_(x)
                       for x in inputs)
        if self.device.type != "cuda":
            with _Reads() as reads:
                out = fn(*static)
            kept = tuple(t.clone() for t in _tensors(out))
            self._entries[key] = _Entry(
                static, kept if isinstance(out, tuple) else kept[0], fn,
                reads=reads.read)
            return out
        out = fn(*static)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = ops.counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                output = fn(*static)
            delta = tuple(a - b for a, b in zip(ops.counts(), before))
        finally:
            ops.set_counts(before)
            if collecting:
                gc.enable()
        self._entries[key] = _Entry(static, output, fn, graph, delta)
        return out
