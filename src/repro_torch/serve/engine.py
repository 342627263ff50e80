"""Continuous-batching serve engine (``repro/serve/engine.py``) over
either cache backend.

The loop is the reference's, boundary for boundary, so its counters match
it exactly:

  * admission: ``ContinuousScheduler`` over a ``CachePool`` (contiguous:
    one max_len row per slot, admission by free slot) or a
    ``BlockManager`` (paged: watermark admission by free blocks,
    prefix-cache hits, deferral);
  * prefill, contiguous: one forward pass per admitted request at its
    exact prompt length, capturing every layer's K/V (``return_cache``),
    padded to max_len and written into the request's slot — or, for the
    recurrent (SSM), hybrid and encdec families, one captured batch-1
    ``decode_step`` replayed per prompt position (an input of the graph)
    on a zeroed cache (the reference scans); the first token is picked on
    the device and fetched (one host sync per request);
  * prefill, paged: prompts run in ``block_size`` chunks, up to
    ``prefill_lanes`` joining requests per ``[P, block_size]`` dispatch
    (one captured dispatch per chunk-round and lane width, padded lanes
    masked), starting past each request's prefix-cache hits; every lane's
    token is picked on the device and the finishing lanes' are fetched once
    per round. MoE lanes carry their per-layer expert counts from round to
    round and into the prefix cache on the device, and each lane routes at
    its own prompt's capacity, so chunked routing equals a one-pass
    forward's;
  * decode: one *horizon* per boundary runs up to ``decode_horizon`` steps
    of ``decode_step`` / ``paged_decode_step`` with token selection
    (``sampling.pick``), token feedback, per-row ``pos`` advance and
    budget/EOS stop masks all on the device — one CUDA graph per static
    ``(W, h, full)``, where the reference jits a scan — and fetches only
    the ``[W, h]`` int32 token block, so ``host_syncs`` keeps its
    meaning;
  * compaction: the horizon runs over the live slots bucketed to a power
    of two (``_bucket``) — the contiguous bucket gathers its cache rows
    with ``index_select`` and scatters them back with ``index_copy_``, the
    paged bucket gathers only its block tables — ``h`` is a power of two
    (``_pick_h``), and paged ``_ensure_growth`` shrinks ``h`` before it
    preempts.

Between horizons the decode state (``_DecodeState``) stays on the device
and takes delta updates at admission, growth and eviction only.

The captured programs (``serve/graphs.py``'s ``GraphRunner``; the
attention families' contiguous prefill, at each prompt's exact length,
stays eager) read the pool and the decode state at fixed addresses, so a
run with the same slot count reuses the previous run's pool and state,
reset in place, and another slot count drops the graphs.
``graphs.eager()`` runs the same loop with no capture.

The contiguous backend serves every ported family (dense, VLM, MoE, SSM,
hybrid, encdec), the paged one the attention families (dense, VLM, MoE),
as in the reference. Serving is text-only: the VLM patch prefix reaches
``forward`` and ``loss`` only, and the encdec engine never runs the
encoder — the reference engine never calls ``prefill_cross_kv``, so every
slot's cross K/V stay zero and the decoder's cross attention adds
nothing.

Multi-tenant serving, fault injection and elastic reshapes follow the
reference's hooks boundary for boundary (``repro/serve/engine.py:883-1279``):
``tenants`` + ``policy="slo"`` order admission by SLO slack and pick the
largest-slack preemption victim, an ``allocation`` adds per-tenant budgets,
watermark headroom, prefill-lane shares and a horizon cap; an ``injector``
applies its due faults at each boundary (the horizon is capped to land on
the next one), audits the block pool after each, and turns the
crash-on-exhaustion paths into bounded retry-with-backoff, then drop; an
``elastic`` controller reshapes the pool from the boundary gauges. A
``device_join`` larger than what was revoked grows the paged pool
(``BlockManager.grow_physical``): the pool tensors move, so every captured
program is dropped and captured again, and the next run builds a new pool.
A ``device_fail`` also collapses the mesh's bucketing multiple ``dmult`` to
1 and a ``device_join`` restores it (on one device both are 1, so a
``device_fail`` that revokes nothing counts no scale-down there, as in the
reference).

A ``tracer`` (``obs.Tracer``) records the reference's events at the
reference's sites (the scheduler's and the block pool's too, at the
engine's step clock), so a run's event list equals the JAX engine's field
for field apart from times. A ``profiler`` (``obs.DispatchProfiler``)
records every dispatch against its roofline (``ServeStats.decode_util``);
it times each dispatch to the end of its device work — the decode
horizon's token fetch and the contiguous prefill's id fetch already wait
for it, and a paged prefill round then waits on the stream, which no
counter sees. With a ``profile_store`` as well, every re-plan folds the
run's profile into the store and fits the tenants' rates from it. Both are
read-only: tokens, counters and event order do not change, and with
neither attached nothing waits.

A ``sharding`` plan (``serve/sharded.py``) serves TP/DP-sharded over a
("data", "model") mesh of ranks, one process each, every rank running this
same loop on the same requests (``engine.py:348-439``): the engine keeps
this rank's blocks of the params, builds its pools at this rank's
blocks (``ServeSharding.pools``: slots, KV heads or positions, conv
channels, SSM heads; a position-split pool holds its slice of every block
or row, while the slots' free list, the block manager, its tables and the
scheduler keep the global slot count, block size and ``max_len``), and
the recurrent prefill's row the same way (every slot), enters the plan's
rules around each run and rounds bucket widths up to a multiple ``dmult``
of the 'data' axis (``_bucket``). A contiguous pool whose slots split over
'data' decodes each bucket row at the rank that holds its slot, from and
into its own rows, every family alike (``_decode_rows``), and a prompt row,
which every rank computes, is stored by its owner; the paged pool is whole
on every rank, and a decode bucket or a prefill round over it is computed
a part a 'data' rank where 'data' divides its width and ``dmult`` has not
collapsed (a collapsed multiple leaves every 'data' rank computing every
such row until a ``device_join``: degraded but exact). The selected
tokens are gathered over 'data', so every rank carries the whole bucket;
the decode state is whole on every rank. ``work`` counts the rows this
rank computed. Host-side pool writes are checked against the plan
(``reshard_cache``). A sharded engine's programs run eager
(``graphs.is_eager``; the CLI summary's ``graphs``).
"""
from __future__ import annotations

import contextlib
import functools
import math
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.api import Model, build_model
from repro_torch.models.moe import capacity
from repro_torch.obs.events import NULL_TRACER
from repro_torch.obs.metrics import RunObs
from repro_torch.obs.prof import NULL_PROFILER
from repro_torch.serve import sampling
from repro_torch.serve.cache import CachePool
from repro_torch.serve.elastic import ScalePlan, pool_capacity
from repro_torch.serve.graphs import GraphRunner
from repro_torch.serve.paged import BlockManager
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest
from repro_torch.serve.tenant import (SLOSlack, TenantAllocation,
                                      TenantRegistry, plan_allocation,
                                      profile_class, profiles_from_requests)

CACHE_BACKENDS = ("contiguous", "paged")
#: families whose layers attend over a KV cache alone: one-pass prefill, a
#: write-masked decode horizon, a pageable cache (``engine.py:98``); the
#: others (ssm, hybrid, encdec) prefill by stepping ``decode_step``
_ATTN_FAMILIES = ("dense", "vlm", "moe")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _bucket(n: int, cap: int, multiple: int = 1) -> int:
    """Compacted width: smallest power of two >= n, rounded up to a
    multiple of the mesh 'data' axis size (so bucketed rows split evenly),
    capped at the pool width."""
    b = _pow2(max(n, 1))
    if multiple > 1:
        b = -(-b // multiple) * multiple
    return min(b, cap)


@dataclass
class ServeStats:
    n_requests: int
    new_tokens: int
    steps: int
    wall_s: float
    tokens_per_s: float
    slot_utilization: float           # mean active/n_slots over decode steps
    mean_latency_steps: float
    p95_latency_steps: float
    mean_latency_s: float
    max_active: int = 0               # peak concurrently-decoding requests
    unfinished: int = 0               # non-dropped requests that never
                                      # finished (SLO misses)
    slo_attainment: float = 1.0       # non-dropped requests meeting their
                                      # tenant's SLO (1.0 without SLOs)
    #: per-tenant latency and SLO summary (tenant id -> dict), None
    #: without a registry or tenant tags
    tenants: Optional[dict] = field(default=None)
    decode_rows_saved: float = 0.0    # fraction of pool rows never decoded
    preemptions: int = 0              # requests bounced on pool pressure
    block_report: Optional[dict] = field(default=None)
    prefill_s: float = 0.0            # wall seconds inside prefill
    decode_s: float = 0.0             # wall seconds inside decode horizons
    prefill_dispatches: int = 0       # one per chunk-round across all lanes
    decode_dispatches: int = 0        # one per horizon (<= K steps)
    decode_horizon: int = 1           # configured K
    host_syncs: int = 0               # one [W, h] fetch per horizon + one
                                      # id fetch per finishing prefill round
    prefix_blocks_total: int = 0
    prefix_blocks_hit: int = 0
    prefix_hit_rate: float = 0.0
    mean_queue_depth: float = 0.0     # waiting requests at boundaries
    max_queue_depth: int = 0
    mean_occupancy: float = 0.0       # used blocks at boundaries
    max_occupancy: float = 0.0
    # -- dispatch profiling (obs.prof; 0.0 with profiling off) ---------------
    decode_util: float = 0.0          # mean measured-vs-roofline utilization
                                      # over execute decode dispatches
    # -- fault injection (serve/chaos.py; 0 without an injector) -------------
    faults_injected: int = 0          # faults applied at boundaries
    recoveries: int = 0               # regenerate / retry / restore /
                                      # rescale / drop actions
    dropped: int = 0                  # requests a recovery gave up on
    # -- elastic reshapes (serve/elastic.py; 0 without reshapes) -------------
    scale_ups: int = 0
    scale_downs: int = 0
    migrated_blocks: int = 0          # live blocks moved by grow_physical
    replans: int = 0                  # allocator re-plans at reshapes


@dataclass
class _PrefillLane:
    """One live lane of the batched prefill: a joining request, its chunk
    cursor (starting past any prefix-cache hits) and, for MoE, its routing
    capacity and its expert counts after the last chunk ([L, 1, E] int32
    on the device)."""
    req: ServeRequest
    prompt: np.ndarray
    ptr: int
    cap_row: int = 0
    state: Optional[torch.Tensor] = None


class _DecodeState:
    """Device-resident decode state: last token, per-row ``pos``, per-row
    freeze position ``stop`` (a row is live while ``pos < stop``), and —
    paged only — the block tables. The host writes deltas only, at
    admission, growth and eviction. Under a sharding plan every rank holds
    all of it (the reference replicates it)."""

    def __init__(self, n_slots: int, max_blocks: Optional[int], device):
        self.device = device
        i32 = dict(dtype=torch.int32, device=device)
        self.tok = torch.zeros((n_slots, 1), **i32)
        self.pos = torch.zeros((n_slots,), **i32)
        self.stop = torch.zeros((n_slots,), **i32)
        self.tables = (torch.full((n_slots, max_blocks), -1, **i32)
                       if max_blocks else None)

    def reset(self) -> None:
        """A fresh state in place (captured graphs read these tensors)."""
        for t in (self.tok, self.pos, self.stop):
            t.zero_()
        if self.tables is not None:
            self.tables.fill_(-1)

    def _idx(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def set_rows(self, slots, toks, pos, stop) -> None:
        """Install freshly prefilled rows."""
        idx = self._idx(slots)
        self.tok[idx] = self._put(toks)[:, None]
        self.pos[idx] = self._put(pos)
        self.stop[idx] = self._put(stop)

    def set_tables(self, slots, rows) -> None:
        self.tables[self._idx(slots)] = self._put(rows)

    def freeze(self, slots) -> None:
        """stop=0 for vacated slots: frozen rows never advance and never
        write KV through a stale block table."""
        if slots:
            self.stop[self._idx(sorted(slots))] = 0


class ServeEngine:
    """Serving engine for every ported family (module docstring).

    ``n_slots=None`` sizes the pool to the request set (static batching);
    a fixed ``n_slots`` turns on continuous batching. ``decode_horizon=K``
    runs up to K decode steps per dispatch; any K gives the same tokens.
    ``temperature=0`` decodes greedily; above it each slot samples on its
    own lane (``sampling.pick``: ``top_k`` truncation, ``sample_seed``).
    ``device`` holds the weights, the pools and the decode state; CUDA
    runs the hand-written attention kernels inside captured graphs, the CPU
    their plain versions. ``cache="contiguous"`` (the default, as in the
    reference) gives every slot a max_len cache row; ``cache="paged"`` the
    block pool.

    ``tenants`` (a ``TenantRegistry``), ``allocation`` (a
    ``TenantAllocation``), ``injector`` (a ``FaultInjector``; a request a
    shrunken pool cannot hold waits ``max_admit_retries`` backoff retries
    before it drops), ``elastic`` (an ``ElasticController``),
    ``tracer``, ``profiler`` and ``profile_store`` as in the module
    docstring (the profiler is the engine's, not the run's, so its
    seen-signature set spans runs);
    ``metrics_every`` samples the boundary gauges into the run's series
    every N boundaries (0: never). ``migrations`` lists the last run's
    pool growths: the live blocks moved, the blocks added, the bytes
    copied, the copy's seconds and the graphs dropped.

    ``sharding`` (a ``ServeSharding``) serves sharded over its mesh; the
    params, given or drawn from ``seed``, are the full tree, of which the
    engine keeps this rank's blocks. ``work`` counts the last run's decode
    rows (a bucket's rows times its steps), their tokens and the prefill
    lanes (a round's width, or one a contiguous prompt) this rank computed
    as its part (``rows``, ``tokens``, ``lanes``) and those every one of
    several 'data' ranks computed whole (``rows_whole``, ``tokens_whole``,
    ``lanes_whole``): the parts summed over the 'data' ranks, plus one
    rank's whole counts, are the run's.
    """

    def __init__(self, cfg: ArchConfig, params=None, max_len: int = 256,
                 n_slots: Optional[int] = None, policy: str = "fcfs",
                 cache: str = "contiguous", block_size: int = 16,
                 n_blocks: Optional[int] = None, watermark: float = 0.05,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, prefill_lanes: int = 4,
                 prefix_cache: bool = True, decode_horizon: int = 8,
                 eos_token: Optional[int] = None,
                 tenants: Optional[TenantRegistry] = None,
                 allocation: Optional[TenantAllocation] = None,
                 metrics_every: int = 1, injector=None,
                 max_admit_retries: int = 4, elastic=None, tracer=None,
                 profiler=None, profile_store=None, device="cuda",
                 seed: int = 0, sharding=None):
        if cache not in CACHE_BACKENDS:
            raise ValueError(f"unknown cache backend {cache!r}; "
                             f"known: {CACHE_BACKENDS}")
        if cache == "paged":
            if cfg.family not in _ATTN_FAMILIES:
                raise ValueError(
                    f"cache='paged' needs an attention family (got "
                    f"{cfg.family!r}: recurrent state is O(1))")
            # every layer checks its cache against this
            # (layers.plan_decode_backend), as the reference's engine sets it
            cfg = cfg.replace(decode_attention="paged")
        if policy == "slo" and tenants is None:
            raise ValueError("policy='slo' needs a TenantRegistry "
                             "(tenants=...) to compute slack")
        if allocation is not None and tenants is None:
            raise ValueError("a TenantAllocation needs its TenantRegistry "
                             "(tenants=...) installed too")
        if sharding is not None and not hasattr(sharding, "shard_params"):
            raise TypeError("sharding= takes a ServeSharding plan "
                            "(serve.sharded.make_serve_sharding)")
        self.cfg = cfg
        self.model: Model = build_model(cfg)
        self.sharding = sharding
        #: the pools' constructors: this rank's blocks under a plan
        self._cache_model = (sharding.pools(self.model)
                             if sharding is not None else self.model)
        #: the mesh bucketing multiple: a device_fail collapses it to 1, a
        #: device_join restores it
        self._dmult_full = (sharding.axis_size("data")
                            if sharding is not None else 1)
        self._dmult = self._dmult_full
        self.device = torch.device(device)
        self.max_len = max_len
        self.n_slots = n_slots
        self.policy = policy
        self.cache_kind = cache
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.watermark = watermark
        self.prefill_lanes = max(int(prefill_lanes), 1)
        self.prefix_cache = bool(prefix_cache)
        self.decode_horizon = max(int(decode_horizon), 1)
        self.eos_token = None if eos_token is None else int(eos_token)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.sample_seed = int(sample_seed)
        self.tenants = tenants
        self.allocation = allocation
        #: the allocation as constructed: reshapes re-plan in place, and
        #: every run starts from this one
        self._allocation0 = allocation
        self.metrics_every = max(int(metrics_every), 0)
        self.injector = injector
        self.max_admit_retries = max(int(max_admit_retries), 1)
        self.elastic = elastic
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.profiler = profiler if profiler is not None else NULL_PROFILER
        self.profile_store = profile_store
        self.migrations: List[dict] = []
        self._pick = functools.partial(
            sampling.pick, temperature=self.temperature, top_k=self.top_k,
            seed=self.sample_seed)
        #: the most recent run's cache pool (audit surface) and decode
        #: state, kept for the next run of the same slot count
        self.pool = None
        self._state: Optional[_DecodeState] = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        if sharding is not None:
            params = sharding.shard_params(params)
        self.params = params
        self._horizon = (self._paged_horizon if cache == "paged"
                         else self._contiguous_horizon)
        #: the captured programs (one per static signature); a sharded
        #: engine's run eager
        self.graphs = GraphRunner(self.device, eager=sharding is not None)
        #: the recurrent prefill's batch-1 state (read by its graph)
        self._row = None
        self.work: Counter = Counter()

    def full_params(self):
        """The full param tree: under a plan, this rank's blocks gathered
        over the mesh (every rank calls it together)."""
        if self.sharding is None:
            return self.params
        return self.sharding.gather_params(self.params)

    def _rules(self):
        """The plan's logical-axis rules (no-op unsharded)."""
        return (self.sharding.rules() if self.sharding is not None
                else contextlib.nullcontext())

    def _data_ranks(self) -> int:
        return (self.sharding.axis_size("data") if self.sharding is not None
                else 1)

    def _even(self, width: int) -> Optional[int]:
        """``split_rows``' rows of a decode bucket or a prefill round over
        the paged pool, which every rank holds whole: its width (equal
        parts where 'data' divides it) while ``dmult`` is whole; None
        (every rank computes every row) unsharded or once it collapsed."""
        if self.sharding is None or self._dmult != self._dmult_full:
            return None
        return width

    def _decode_rows(self, pool, idx: np.ndarray):
        """``split_rows``' rows of a decode bucket of slot ids ``idx``: over
        a contiguous pool split over 'data', each rank's bucket positions
        of the slots it holds (their owner computes them, whatever
        ``dmult``: the pool rows never move); over the paged pool
        ``_even``; None where every rank computes every row."""
        if self.cache_kind == "paged":
            return self._even(len(idx))
        per = len(pool.held)
        if self._data_ranks() == 1 or per == pool.n_slots:
            return None
        owner = idx // per
        return [np.flatnonzero(owner == r).tolist()
                for r in range(self._data_ranks())]

    def _count_work(self, split, **per_row) -> None:
        """Book one dispatch into ``work``: each keyword's amounts, one a
        bucket position (or lane), this rank's part of them under
        ``split_rows(split)``, or all of them, under ``<name>_whole`` where
        every one of several 'data' ranks computes them."""
        mine = shd.rank_rows(split)
        whole = mine is None and self._data_ranks() > 1
        for name, amounts in per_row.items():
            a = np.asarray(amounts, np.int64)
            n = int(a.sum() if mine is None else a[mine].sum())
            self.work[name + "_whole" if whole else name] += n

    def _pool_and_state(self, n_slots: int):
        """The run's pool and decode state: the last run's, reset in place,
        when it had ``n_slots`` slots (the pool's shape follows from that
        and the engine's fixed options) and its buffers never grew — the
        captured graphs read their tensors at fixed addresses — else new
        ones, and the graphs go with the old tensors."""
        if (self.pool is not None and self.pool.n_slots == n_slots
                and not getattr(self.pool, "grown", False)):
            self.pool.reset()
            self._state.reset()
            if self.cache_kind == "paged":     # as a new pool would take
                self.pool.tracer = self.tracer
            return self.pool, self._state
        self.graphs.reset()
        self.pool = self._state = None       # free the old tensors first
        if self.cache_kind == "paged":
            pool = BlockManager(self._cache_model, n_slots, self.max_len,
                                block_size=self.block_size,
                                n_blocks=self.n_blocks,
                                watermark=self.watermark,
                                prefix_cache=self.prefix_cache,
                                device=self.device, tracer=self.tracer)
            max_blocks = pool.max_blocks
        else:
            pool = CachePool(self._cache_model, n_slots, self.max_len,
                             device=self.device)
            max_blocks = None
        if self.sharding is not None:
            pool.buffers = self.sharding.reshard_cache(pool.buffers)
        self.pool, self._state = pool, _DecodeState(n_slots, max_blocks,
                                                    self.device)
        return self.pool, self._state

    # -- prefill (contiguous) -------------------------------------------------
    def _prefill(self, tokens):
        """tokens [1, S] -> (last logits [1, 1, V], a batch-1 cache dict for
        ``pool.write``) (``engine.py:455-484``). Attention families: one
        pass via the ``return_cache`` hook at the prompt's exact length
        (eager), every leaf padded to max_len. The recurrent, hybrid and
        encdec families: a zeroed batch-1 cache stepped through the
        prompt, one replay of the captured ``decode_step`` per position
        (the reference scans), its position ``t`` a [1] int32 device tensor
        copied into the graph's static input before each replay (the
        hybrid's shared block and the decoder write their K/V there); the
        cache is the engine's until the next prefill, at this rank's
        blocks under a plan, as the pool's."""
        if self.cfg.family not in _ATTN_FAMILIES:
            if self._row is None:
                self._row = self._cache_model.init_cache(1, self.max_len,
                                                         device=self.device)
            row = self._row
            for buf in row.values():
                buf.zero_()

            def step(tok, pos):
                return self.model.decode_step(self.params, row, tok, pos)[0]

            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=self.device)
            for t in range(tokens.shape[1]):
                logits = self.graphs(("recurrent_step",), step,
                                     tokens[:, t:t + 1], positions[t:t + 1])
            return logits, row
        logits, (k, v) = self.model.module.forward(self.cfg, self.params,
                                                   tokens, return_cache=True)
        pad = (0, 0, 0, 0, 0, self.max_len - tokens.shape[1])  # [L,B,S,H,D]
        row = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
        if self.sharding is not None:        # this rank's positions
            row = self.sharding.local_cache_row(row)
        return logits[:, -1:], row

    # -- the engine loop ---------------------------------------------------------
    def run(self, requests: List[ServeRequest]
            ) -> Tuple[List[ServeRequest], ServeStats]:
        """Serve ``requests`` to completion; returns (requests, stats)."""
        reqs = list(requests)
        n_slots = self.n_slots if self.n_slots else max(len(reqs), 1)
        if self.injector is not None:
            # re-armed every run: repeated runs replay the same chaos
            self.injector.bind(vocab_size=self.cfg.vocab_size,
                               max_len=self.max_len, n_slots=n_slots)
            self.injector.reset()
        if self.elastic is not None:
            self.elastic.reset()
        self.allocation = self._allocation0
        self.migrations = []
        self.work = Counter()
        self._dmult = self._dmult_full
        c = RunObs(self.tracer)
        tr = c.tracer
        if tr:
            tr.step = 0.0
            tr.emit("run_start", backend=self.cache_kind, n_slots=n_slots,
                    horizon=self.decode_horizon, n_requests=len(reqs))
        t0 = time.perf_counter()
        with self._rules(), torch.inference_mode():
            if self.cache_kind == "paged":
                self._run_paged(reqs, n_slots, c)
            else:
                self._run_contiguous(reqs, n_slots, c)
        wall = time.perf_counter() - t0
        if tr:
            tr.emit("run_end", steps=c.value("steps"), wall_s=wall)
        return reqs, self._stats(reqs, c, n_slots, wall)

    def _finished(self, r: ServeRequest) -> bool:
        """Finished with both clocks stamped; anything else counts as
        unfinished (an SLO miss)."""
        return (r.done and r.latency_steps is not None
                and r.latency_s is not None)

    def _meets_slo(self, r: ServeRequest) -> bool:
        """Whether ``r`` finished inside its tenant's SLO (both clocks where
        both targets are set; a tenant without targets asks completion
        only)."""
        if not self._finished(r):
            return False
        t = self.tenants.get(r.tenant) if self.tenants is not None else None
        if t is None:
            return True
        if t.slo_steps is not None and r.latency_steps > t.slo_steps:
            return False
        if t.slo_s is not None and r.latency_s > t.slo_s:
            return False
        return True

    def _tenant_stats(self, reqs) -> Optional[dict]:
        """Per-tenant p50/p99 latency (steps and wall) and SLO attainment;
        None without a registry or a non-default tag. The ``_s`` entries
        (and ``slo_attainment`` where a tenant has ``slo_s``) are wall
        time."""
        tids = sorted({r.tenant for r in reqs})
        if self.tenants is None and tids in ([], ["default"]):
            return None
        out = {}
        for tid in tids:
            all_rs = [r for r in reqs if r.tenant == tid]
            rs = [r for r in all_rs if not r.dropped]
            steps = [r.latency_steps for r in rs if self._finished(r)]
            walls = [r.latency_s for r in rs if self._finished(r)]
            t = self.tenants.get(tid) if self.tenants is not None else None
            met = sum(1 for r in rs if self._meets_slo(r))
            out[tid] = {
                "n_requests": len(all_rs),
                "unfinished": sum(1 for r in rs if not self._finished(r)),
                "dropped": len(all_rs) - len(rs),
                "preemptions": sum(r.n_preempted for r in rs),
                "p50_latency_steps": (float(np.percentile(steps, 50))
                                      if steps else 0.0),
                "p99_latency_steps": (float(np.percentile(steps, 99))
                                      if steps else 0.0),
                "p50_latency_s": (float(np.percentile(walls, 50))
                                  if walls else 0.0),
                "p99_latency_s": (float(np.percentile(walls, 99))
                                  if walls else 0.0),
                "slo_steps": t.slo_steps if t is not None else None,
                "slo_s": t.slo_s if t is not None else None,
                "slo_attainment": met / len(rs) if rs else 1.0,
            }
        return out

    def _stats(self, reqs, c: RunObs, n_slots, wall) -> ServeStats:
        m = c.metrics
        new_tokens = sum(len(r.output) for r in reqs)
        lat_steps = [r.latency_steps for r in reqs
                     if r.latency_steps is not None]
        lat_wall = [r.latency_s for r in reqs if r.latency_s is not None]
        steps = int(m.value("steps"))
        rows_possible = steps * n_slots
        hit, total = int(m.value("prefix_hits")), int(m.value("prefix_total"))
        qd_mean, qd_max = m.series_stats("queue_depth")
        occ_mean, occ_max = m.series_stats("occupancy")
        # dropped requests leave the scored set: counted in ``dropped``,
        # neither ``unfinished`` nor in slo_attainment's denominator
        scored = [r for r in reqs if not r.dropped]
        met = sum(1 for r in scored if self._meets_slo(r))
        return ServeStats(
            n_requests=len(reqs),
            new_tokens=new_tokens,
            steps=steps,
            wall_s=wall,
            tokens_per_s=new_tokens / wall if wall > 0 else 0.0,
            slot_utilization=m.value("util_acc") / steps if steps else 0.0,
            mean_latency_steps=float(np.mean(lat_steps)) if lat_steps else 0.0,
            p95_latency_steps=(float(np.percentile(lat_steps, 95))
                               if lat_steps else 0.0),
            mean_latency_s=float(np.mean(lat_wall)) if lat_wall else 0.0,
            max_active=int(m.value("max_active")),
            unfinished=sum(1 for r in scored if not self._finished(r)),
            slo_attainment=met / len(scored) if scored else 1.0,
            tenants=self._tenant_stats(reqs),
            decode_rows_saved=(1.0 - m.value("rows_decoded") / rows_possible
                               if rows_possible else 0.0),
            preemptions=int(m.value("preemptions")),
            block_report=c.block_report,
            prefill_s=m.value("prefill_s"),
            decode_s=m.value("decode_s"),
            prefill_dispatches=int(m.value("prefill_dispatches")),
            decode_dispatches=int(m.value("decode_dispatches")),
            decode_horizon=self.decode_horizon,
            host_syncs=int(m.value("host_syncs")),
            prefix_blocks_total=total,
            prefix_blocks_hit=hit,
            prefix_hit_rate=hit / total if total else 0.0,
            mean_queue_depth=qd_mean,
            max_queue_depth=int(qd_max),
            mean_occupancy=occ_mean,
            max_occupancy=occ_max,
            decode_util=m.series_stats("util[decode]")[0],
            faults_injected=int(m.value("faults_injected")),
            recoveries=int(m.value("recoveries")),
            dropped=len(reqs) - len(scored),
            scale_ups=int(m.value("scale_ups")),
            scale_downs=int(m.value("scale_downs")),
            migrated_blocks=int(m.value("migrated_blocks")),
            replans=int(m.value("replans")),
        )

    def _sample_boundary(self, sched, pool, c: RunObs) -> None:
        """Update the gauges after a decode boundary and, every
        ``metrics_every`` boundaries, set each tenant's smallest slack
        (``slack[<tenant>]``, read by the elastic controller) and snapshot
        every gauge and counter into the series (the stats' queue-depth and
        occupancy summaries)."""
        m = c.metrics
        c.boundaries += 1
        m.set("queue_depth", len(sched.waiting))
        m.set("active", len(sched.active))
        if self.cache_kind == "paged":
            occ = (1.0 - pool.free_blocks / pool.n_blocks
                   if pool.n_blocks else 0.0)
        else:
            occ = len(sched.active) / pool.capacity if pool.capacity else 0.0
        m.set("occupancy", occ)
        every = self.metrics_every
        if every and c.boundaries % every == 0:
            if self.tenants is not None:
                live = list(sched.waiting) + list(sched.active.values())
                for t in self.tenants:
                    slk = min((self._slack(r, sched.step) for r in live
                               if r.tenant == t.tenant_id),
                              default=math.inf)
                    if math.isfinite(slk):
                        m.set(f"slack[{t.tenant_id}]", slk)
            m.sample(sched.step)

    def _evict(self, sched, state: _DecodeState, c: RunObs):
        """Evict finished requests and freeze their device rows."""
        done_slots = [s for s, r in sched.active.items() if r.done]
        out = sched.evict_finished()
        state.freeze(done_slots)
        for slot, r in zip(done_slots, out):
            c.metrics.observe("latency_steps", r.latency_steps)
            if c.tracer:
                t = (self.tenants.get(r.tenant)
                     if self.tenants is not None else None)
                c.tracer.emit(
                    "evict", req=r.job_id, tenant=r.tenant, slot=slot,
                    latency_steps=r.latency_steps,
                    finished_early=r.finished_early,
                    slo_steps=t.slo_steps if t is not None else None,
                    met=self._meets_slo(r))

    def _make_sched(self, pool) -> ContinuousScheduler:
        """The run's scheduler: SLO-slack ordering for ``policy="slo"`` and
        the per-tenant budget check when an allocation is installed."""
        policy = (SLOSlack(self.tenants) if self.policy == "slo"
                  else self.policy)
        return ContinuousScheduler(pool, policy, allocation=self.allocation,
                                   tracer=self.tracer)

    def _slack(self, req, step) -> float:
        """SLO slack in decode steps (+inf without a registry or SLO)."""
        if self.tenants is None:
            return math.inf
        return self.tenants.slack(req, step)

    # -- fault injection + recovery (serve/chaos.py) ---------------------------
    def _fault_hold(self, sched):
        """The admission-hold hook (``tenant_slowdown`` / ``defer_storm``
        windows); None when nothing is held."""
        inj = self.injector
        if inj is None or not inj.has_holds(sched.step):
            return None
        return lambda r: inj.hold_cause(r, sched.step)

    def _drop(self, sched, req, c: RunObs, cause: str) -> None:
        """Give up on a waiting request (a recovery path exhausted)."""
        if req in sched.waiting:
            sched.waiting.remove(req)
        req.dropped = True
        req.drop_cause = cause
        c.inc("recoveries")
        if c.tracer:
            c.tracer.emit("recover", kind=cause, action="drop",
                          req=req.job_id, detail=req.n_retries)

    def _pending_units(self, pool, step) -> int:
        """Capacity units scheduled to arrive after ``step``: pending
        ``pool_restore`` / ``device_join`` faults plus the elastic
        controller's scale-up headroom."""
        pend = 0
        if self.injector is not None and step is not None:
            pend += self.injector.pending_capacity(step)
        if self.elastic is not None:
            pend += self.elastic.pending_units(pool)
        return pend

    def _can_ever_admit(self, pool, req, step=None) -> bool:
        """Whether the pool's capacity, with the capacity scheduled to
        arrive, could ever admit ``req`` (wait, or drop): the arithmetic
        of ``validate_request`` against the live ``n_blocks``."""
        if not hasattr(pool, "blocks_for"):
            return True                      # contiguous slots never vanish
        need = len(req.prompt) + req.max_new_tokens
        if need > pool.max_len:
            return False
        cap = pool.n_blocks + self._pending_units(pool, step)
        return (pool.blocks_for(need) <= cap
                and pool.blocks_for(len(req.prompt)) + pool.watermark_blocks
                <= cap)

    def _chaos_admission(self, sched, pool, c: RunObs) -> None:
        """Bounded retry-with-backoff for waiting requests a shrink left
        unservable: each due retry re-checks capacity (capacity back, or
        coming back, clears the count), backs off 2^n steps, and past
        ``max_admit_retries`` the request drops."""
        for r in list(sched.waiting):
            if r.arrival_time > sched.step:
                continue
            if self._can_ever_admit(pool, r, step=sched.step):
                r.n_retries = 0
                continue
            if sched.step < r.next_retry:
                continue
            r.n_retries += 1
            if r.n_retries > self.max_admit_retries:
                self._drop(sched, r, c, cause="pool_shrink")
                continue
            r.next_retry = sched.step + float(2 ** r.n_retries)
            c.inc("recoveries")
            if c.tracer:
                c.tracer.emit("recover", kind="pool_shrink", action="retry",
                              req=r.job_id, detail=r.n_retries)

    def _next_unblock(self, sched) -> Optional[float]:
        """The earliest future step at which a stalled queue could move:
        an arrival, a hold release, a pending fault or a backoff retry."""
        cands = [r.arrival_time for r in sched.waiting
                 if r.arrival_time > sched.step]
        cands += [r.next_retry for r in sched.waiting
                  if r.next_retry > sched.step]
        inj = self.injector
        if inj is not None:
            for s in (inj.release_step(sched.step),
                      inj.next_fault_step(sched.step)):
                if s is not None and s > sched.step:
                    cands.append(s)
        return min(cands, default=None)

    def _apply_faults(self, sched, pool, state, c: RunObs,
                      reqs: List[ServeRequest]) -> None:
        """Apply every due fault at this boundary and audit the block pool
        after each (a fault that breaks the accounting fails here)."""
        for f in self.injector.due(sched.step):
            self._apply_fault(f, sched, pool, state, c, reqs)
            self.injector.injected.append((f.kind, float(sched.step)))
            c.inc("faults_injected")
            if isinstance(pool, BlockManager):
                pool.audit()

    def _apply_fault(self, f, sched, pool, state, c: RunObs,
                     reqs: List[ServeRequest]) -> None:
        tr = c.tracer
        inj = self.injector
        paged = isinstance(pool, BlockManager)
        if f.kind == "pool_shrink":
            took = pool.shrink(f.blocks) if paged else 0
            if tr:
                tr.emit("fault_inject", kind=f.kind, target=None, mag=took)
            if took and f.restore_after is not None:
                inj.defer_restore(f, float(sched.step), took)
            if took and self.allocation is not None:
                pool.tenant_reserves = self.allocation.rescaled_reserves(
                    pool.n_blocks)
                c.inc("recoveries")
                if tr:
                    tr.emit("recover", kind=f.kind, action="reserve_rescale",
                            req=None, detail=sum(
                                pool.tenant_reserves.values()))
        elif f.kind == "pool_restore":
            got = pool.expand(f.blocks) if paged else 0
            if got and self.allocation is not None:
                pool.tenant_reserves = self.allocation.rescaled_reserves(
                    pool.n_blocks)
            c.inc("recoveries")
            if tr:
                tr.emit("recover", kind="pool_shrink", action="restore",
                        req=None, detail=got)
        elif f.kind == "device_fail":
            # a 'data' rank leaves: its share of the pool is revoked and
            # the bucketing multiple collapses to 1 (every 'data' rank then
            # computes every row: degraded but exact)
            took = self._apply_scale(sched, pool, c, ScalePlan(
                kind="scale_down", units=f.blocks, reason="device_fail",
                step=float(sched.step), dmult=1))
            if tr:
                tr.emit("fault_inject", kind=f.kind, target=None, mag=took)
            if f.restore_after is not None:
                # the join is scheduled even when nothing was revocable:
                # on a mesh it must restore the bucketing multiple
                inj.defer_restore(f, float(sched.step), took)
        elif f.kind == "device_join":
            got = self._apply_scale(sched, pool, c, ScalePlan(
                kind="scale_up", units=f.blocks, reason="device_join",
                step=float(sched.step), dmult=self._dmult_full))
            c.inc("recoveries")
            if tr:
                tr.emit("recover", kind="device_fail", action="restore",
                        req=None, detail=got)
        elif f.kind == "slot_kill":
            slot = inj.pick_slot(list(sched.active), f.slot)
            if slot is None:
                if tr:
                    tr.emit("fault_inject", kind=f.kind, target=None, mag=0)
                return
            victim = sched.active[slot]
            if tr:
                tr.emit("fault_inject", kind=f.kind, target=slot, mag=1)
            # the slot's device state is lost: preempt and regenerate. The
            # row freezes before the next horizon, so no replay writes KV
            # through the freed table.
            sched.preempt(victim, cause="slot_kill")
            state.freeze([slot])
            c.inc("preemptions")
            c.inc("recoveries")
            if tr:
                tr.emit("recover", kind=f.kind, action="regenerate",
                        req=victim.job_id, detail=victim.n_preempted)
        elif f.kind in ("tenant_slowdown", "defer_storm"):
            tenant = f.tenant if f.kind == "tenant_slowdown" else None
            inj.hold(tenant, float(sched.step) + f.duration)
            if tr:
                tr.emit("fault_inject", kind=f.kind, target=tenant,
                        mag=f.duration)
        elif f.kind == "arrival_burst":
            burst = inj.burst_requests(f)
            if tr:
                tr.emit("fault_inject", kind=f.kind, target=f.tenant,
                        mag=len(burst))
            for r in burst:
                r.job_id = len(reqs)
                r.arrival_time = float(sched.step)
                reqs.append(r)          # the stats score the injected load
                try:
                    sched.submit(r)
                except ValueError:
                    # the current pool cannot hold it; scheduled capacity
                    # may: wait under bounded retry, else drop
                    if self._can_ever_admit(pool, r, step=sched.step):
                        sched.park(r)
                        c.inc("recoveries")
                        if tr:
                            tr.emit("recover", kind=f.kind, action="retry",
                                    req=r.job_id, detail=0)
                    else:
                        self._drop(sched, r, c, cause="burst_unservable")
        elif f.kind == "prefix_flush":
            flushed = pool.flush_prefix() if paged else 0
            if tr:
                tr.emit("fault_inject", kind=f.kind, target=None,
                        mag=flushed)

    # -- elastic reshapes (serve/elastic.py) -----------------------------------
    def _apply_scale(self, sched, pool, c: RunObs, plan) -> int:
        """Apply one ``ScalePlan`` at a horizon boundary: a scale-down
        revokes capacity, a scale-up returns revoked capacity first and,
        paged, grows the pool past its buffers (``grow_physical``: the live
        blocks move into new tensors, so every captured program is dropped;
        the move is recorded in ``migrations``). Then tenant reserves
        rescale, the allocator re-plans and the pool is audited. Returns
        the capacity units moved. A plan's ``dmult`` re-buckets the mesh's
        'data' axis for every later dispatch (a change of it alone still
        counts as a reshape, with no re-plan)."""
        tr = c.tracer
        paged = isinstance(pool, BlockManager)
        old_dmult = self._dmult
        if plan.kind == "scale_down":
            moved = pool.shrink(plan.units)
        else:
            moved = pool.expand(plan.units)       # the revoked ledger first
            extra = plan.units - moved
            if extra > 0 and paged:
                live = (pool._total_blocks - len(pool._free_blocks)
                        - len(pool._revoked))
                dropped = len(self.graphs.keys)
                t0 = time.perf_counter()
                added = pool.grow_physical(extra)
                if self.sharding is not None:
                    pool.buffers = self.sharding.reshard_cache(pool.buffers)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                self.graphs.reset()
                if added:
                    moved += added
                    c.inc("migrated_blocks", live)
                    if tr:
                        tr.emit("migrate", blocks=live, added=added,
                                dur_s=dt)
                    k = pool.buffers["k"]
                    old = pool._total_blocks - added
                    self.migrations.append(dict(
                        step=int(sched.step), blocks=live, added=added,
                        bytes=2 * k[:, :old].numel() * k.element_size(),
                        dur_s=dt, graphs_dropped=dropped))
        if plan.dmult is not None:
            self._dmult = max(int(plan.dmult), 1)
        if not moved and self._dmult == old_dmult:
            return 0                         # nothing applied: no event
        c.inc("scale_ups" if plan.kind == "scale_up" else "scale_downs")
        if tr:
            tr.emit(plan.kind, units=moved, capacity=pool_capacity(pool),
                    dmult=self._dmult, reason=plan.reason)
        if moved and paged and self.allocation is not None:
            pool.tenant_reserves = self.allocation.rescaled_reserves(
                pool.n_blocks)
        if moved:
            self._replan(sched, pool, c)
        if self.elastic is not None:
            self.elastic.note_scale(sched.step, plan)
        if paged:
            pool.audit()
        return moved

    def _replan(self, sched, pool, c: RunObs) -> None:
        """Re-profile the live request mix and re-plan the tenants' budgets,
        horizon knees and lane shares for the reshaped capacity (a
        tenant-carrying engine without a plan gets its first one here).
        With a profiler and a ``profile_store``, the run's dispatch profile
        folds into the store first and the rates come from its fit.
        Allocation only: outputs stay token-identical."""
        if self.tenants is None:
            return
        max_k = (self.allocation.max_k if self.allocation is not None
                 else self.decode_horizon)
        store = self.profile_store
        if store is not None and self.profiler:
            store.add_run(self.profiler, arch=self.cfg.arch_id,
                          backend=self.cache_kind)
        total = pool_capacity(pool)
        live = list(sched.waiting) + list(sched.active.values())
        units_for = ((lambda r: pool.blocks_for(len(r.prompt)
                                                + r.max_new_tokens))
                     if hasattr(pool, "blocks_for") else None)
        profiles = profiles_from_requests(
            self.tenants, live, total_units=total, units_for=units_for,
            max_k=max_k, store=store, arch=self.cfg.arch_id,
            backend=self.cache_kind)
        for t in self.tenants:
            if t.tenant_id not in profiles:      # drained: a minimal profile
                profiles[t.tenant_id] = profile_class(
                    t.tenant_id, units_per_req=1, concurrency=1,
                    total_units=total, max_k=max_k, store=store,
                    arch=self.cfg.arch_id, backend=self.cache_kind)
        wm = (pool.watermark_blocks if hasattr(pool, "watermark_blocks")
              else 0)
        self.allocation = plan_allocation(
            self.tenants, profiles, total, total_lanes=self.prefill_lanes,
            max_k=max_k, watermark_units=wm)
        sched.allocation = self.allocation
        if isinstance(pool, BlockManager):
            pool.tenant_reserves = self.allocation.reserves()
        c.inc("replans")
        if c.tracer:
            c.tracer.emit("recover", kind="reshape", action="replan",
                          req=None, detail=int(total))

    def _submit_all(self, sched, pool, reqs) -> None:
        """Submit the run's requests; one the constructed pool cannot
        validate is parked when scheduled capacity will cover it, else the
        submit error propagates."""
        for i, r in enumerate(reqs):
            r.job_id = i
            try:
                sched.submit(r)
            except ValueError:
                if not self._can_ever_admit(pool, r, step=float(sched.step)):
                    raise
                sched.park(r)

    def _elastic_poll(self, sched, pool, c: RunObs) -> None:
        """Ask the elastic controller for a proactive reshape."""
        if self.elastic is None:
            return
        plan = self.elastic.decide(sched.step, pool, c.metrics)
        if plan is not None:
            self._apply_scale(sched, pool, c, plan)

    def _admission_round(self, sched, pool, state, c: RunObs, reqs):
        """The top of a boundary, both loops: faults, the elastic poll,
        evict, admit (past any holds), the bounded retries. Returns the
        admitted requests awaiting prefill."""
        if self.injector is not None:
            self._apply_faults(sched, pool, state, c, reqs)
        self._elastic_poll(sched, pool, c)
        self._evict(sched, state, c)
        sched.admit(hold=self._fault_hold(sched))
        if self.injector is not None or self.elastic is not None:
            self._chaos_admission(sched, pool, c)
        return sched.drain_prefill()

    # -- horizon scheduling helpers (host side) --------------------------------
    def _pick_h(self, sched, act) -> int:
        """Horizon length: at most ``decode_horizon``, capped to the longest
        remaining budget, to the allocator's largest knee among the active
        tenants, to the next open-loop arrival when the pool could admit
        it, to the smallest waiting SLO slack and to the next pending
        fault; quantized down to a power of two."""
        rem = max(sched.active[s].max_new_tokens - len(sched.active[s].output)
                  for s in act)
        h = max(1, min(self.decode_horizon, rem))
        if self.allocation is not None:
            h = min(h, max(1, self.allocation.k_cap_for(
                {sched.active[s].tenant for s in act})))
        nxt = sched.next_arrival()
        if (nxt is not None and nxt > sched.step
                and self._could_admit_arrival(sched)):
            h = max(1, min(h, int(math.ceil(nxt - sched.step))))
        if self.tenants is not None and sched.waiting:
            urgent = min(self._slack(r, sched.step) for r in sched.waiting)
            if math.isfinite(urgent):
                h = max(1, min(h, int(max(1.0, urgent))))
        if self.injector is not None:
            nf = self.injector.next_fault_step(sched.step)
            if nf is not None and nf > sched.step:
                h = max(1, min(h, int(math.ceil(nf - sched.step))))
        return _pow2_floor(h)

    @staticmethod
    def _could_admit_arrival(sched) -> bool:
        """Whether shortening the horizon for the next arrival could pay
        off: free slots (contiguous) or watermark-clearing blocks (paged)
        for some waiting request."""
        pool = sched.pool
        if hasattr(pool, "can_admit"):
            return any(pool.can_admit(len(r.prompt)) for r in sched.waiting)
        return pool.n_free > 0

    # -- decode horizons ------------------------------------------------------
    def _scan_horizon(self, step_fn, t, p, s, idx, step0, h: int):
        """The shared horizon loop (a Python loop, captured whole, where
        the reference scans): up to ``h`` steps of ``step_fn(t, p, active)
        -> logits`` with token selection (``self._pick`` on lane ``idx``,
        the bucket's slot ids, at step ``step0 + k``), token feedback,
        per-row pos advance and the budget/EOS stop masks, all on the
        device. A row is live while ``p < s``; frozen rows keep (token,
        pos), write no KV and emit -1. Inside a 'data' split
        (``split_rows``) ``step_fn`` computes this rank's rows and the
        picked tokens are gathered, so every rank carries the whole
        bucket. Returns (t, p, s, token block [W, h])."""
        emitted = []
        lanes = shd.local_rows(idx)
        for k in range(h):
            active = p < s
            logits = step_fn(shd.local_rows(t), shd.local_rows(p),
                             shd.local_rows(active))
            nxt = shd.gather_rows(self._pick(logits[:, -1], lanes,
                                             step0 + k))
            emitted.append(torch.where(active, nxt,
                                       torch.full_like(nxt, -1)))
            t = torch.where(active[:, None], nxt[:, None], t)
            p = p + active.to(torch.int32)
            if self.eos_token is not None:
                s = torch.where(active & (nxt == self.eos_token), p, s)
        return t, p, s, torch.stack(emitted, dim=1)

    @staticmethod
    def _put_rows(state: _DecodeState, ix, t, p, s) -> None:
        """Write a bucket's (token, pos, stop) back into the state's own
        tensors (ix None: full)."""
        if ix is None:
            state.tok.copy_(t)
            state.pos.copy_(p)
            state.stop.copy_(s)
        else:
            state.tok[ix], state.pos[ix], state.stop[ix] = t, p, s

    def _paged_horizon(self, pool: BlockManager, state: _DecodeState, idx,
                       step0, h: int, full: bool, rows=None) -> torch.Tensor:
        """Up to ``h`` paged decode steps over the bucket ``idx`` (int64
        slot ids on the device; ``step0`` the scheduler step, an int64
        device scalar; ``rows`` the bucket's 'data' split,
        ``_decode_rows``): the bucket gathers tokens, positions, stops and
        block tables only (compaction through the tables is free). Returns
        the [W, h] int32 token block (still on the device)."""
        if full:
            ix, tb = None, state.tables
            t, p, s = state.tok, state.pos, state.stop
        else:
            ix, tb = idx, state.tables[idx]
            t, p, s = state.tok[ix], state.pos[ix], state.stop[ix]

        def step(t, p, active):
            return self.model.paged_decode_step(
                self.params, pool.buffers, t, p, shd.local_rows(tb),
                write_valid=active)[0]

        with shd.split_rows(rows, self.device):
            t, p, s, blk = self._scan_horizon(step, t, p, s, idx, step0, h)
        self._put_rows(state, ix, t, p, s)
        return blk

    def _contiguous_horizon(self, pool: CachePool, state: _DecodeState, idx,
                            step0, h: int, full: bool,
                            rows=None) -> torch.Tensor:
        """Up to ``h`` contiguous decode steps over the bucket ``idx``
        (``engine.py:539-598``; ``idx``, ``step0`` and ``rows`` as in
        ``_paged_horizon``): gather the bucket's cache rows along each
        leaf's batch axis with ``index_select`` (unless ``full``: every
        slot decodes, idle rows frozen and inert), decode with
        ``write_valid`` = the live rows, and scatter the rows back with
        ``index_copy_``. The recurrent, hybrid and encdec families decode
        without ``write_valid``, as the reference's unmasked path does:
        their frozen rows recompute state (and rewrite K/V at their frozen
        position) that slot reuse overwrites. Over a pool split over
        'data' a rank gathers, decodes and scatters back the rows of its
        own slots (``full``: its whole block in place); its padding rows
        (``split_rows``) decode a copy of one of its rows, never written
        back. Returns the [W, h] int32 token block."""
        if full:
            t, p, s = state.tok, state.pos, state.stop
        else:
            t, p, s = state.tok[idx], state.pos[idx], state.stop[idx]
        masked = self.cfg.family in _ATTN_FAMILIES
        held = pool.held
        with shd.split_rows(rows, self.device) as split:
            if full:
                ix, sub = None, pool.buffers
            else:
                # this rank's pool rows of the bucket rows it computes
                ix = idx if split is None else (
                    shd.local_rows(idx) - held.start).clamp(0, len(held) - 1)
                sub = {name: buf.index_select(pool.batch_axes[name], ix)
                       for name, buf in pool.buffers.items()}

            def step(t, p, active):
                return self.model.decode_step(
                    self.params, sub, t, p,
                    write_valid=active if masked else None)[0]

            t, p, s, blk = self._scan_horizon(step, t, p, s, idx, step0, h)
        if ix is not None:
            n = len(ix) if split is None else split.n
            for name, buf in pool.buffers.items():
                ax = pool.batch_axes[name]
                buf.index_copy_(ax, ix[:n], sub[name].narrow(ax, 0, n))
        self._put_rows(state, None if full else idx, t, p, s)
        return blk

    def _decode_boundary(self, sched, pool, state, c, n_slots,
                         h) -> List[int]:
        """One horizon dispatch at a scheduler boundary: bucket the live
        rows, run the horizon, unpack the [W, h] token block, update the
        counters and the scheduler clock. Returns the per-row emitted
        counts in sorted-active order."""
        act = sorted(sched.active)
        h = _pow2_floor(min(h, max(sched.active[s].max_new_tokens
                                   - len(sched.active[s].output)
                                   for s in act)))
        bc = _bucket(len(act), n_slots, self._dmult)
        full = bc == n_slots
        if full:
            idx = np.arange(n_slots, dtype=np.int64)
            rows = act                       # block rows are slot-indexed
        else:
            idle = [s for s in range(n_slots) if s not in sched.active]
            idx = np.asarray(act + idle[:bc - len(act)], np.int64)
            rows = list(range(len(act)))     # compacted row order
        split = self._decode_rows(pool, idx)
        t0 = time.perf_counter()
        blk = self.graphs(
            (self.cache_kind, len(idx), h, full),
            lambda ix, step0: self._horizon(pool, state, ix, step0, h, full,
                                            split),
            torch.from_numpy(idx), torch.tensor(int(sched.step)))
        c.inc("decode_dispatches")
        blk = blk.cpu().numpy()              # the one [W, h] int32 fetch
        c.inc("host_syncs")
        dt = time.perf_counter() - t0        # the fetch waited for the device
        c.inc("decode_s", dt)
        prof = self.profiler
        if prof:
            # KV positions at dispatch start (outputs not yet extended);
            # tenants maps tenant -> live rows for the cost-share split
            kv = sum(len(sched.active[s].prompt) + len(sched.active[s].output)
                     for s in act)
            prof.record("decode", dt, width=len(idx), k=h, full=full,
                        kv_pos_sum=kv,
                        tenants=Counter(sched.active[s].tenant for s in act),
                        obs=c)
        counts = self._unpack_horizon(sched, act, rows, blk, h, n_slots, c)
        c.inc("rows_decoded", len(idx) * h)
        emitted = np.zeros(len(idx), np.int64)
        emitted[rows] = counts
        self._count_work(split, rows=np.full(len(idx), h), tokens=emitted)
        c.hi("max_active", len(act))
        c.inc("steps", h)
        c.metrics.observe("horizon_k", h)
        if c.tracer:
            c.tracer.emit("decode_horizon", step=sched.step, k=h,
                          width=len(idx), active=len(act), full=full,
                          dur_s=dt)
        sched.step += h
        if c.tracer:
            c.tracer.step = sched.step
        self._sample_boundary(sched, pool, c)
        return counts

    def _unpack_horizon(self, sched, act, rows, blk, h, n_slots,
                        c) -> List[int]:
        """Distribute a horizon's [W, h] token block: active slot
        ``act[i]`` reads row ``rows[i]``, its first min(h, remaining)
        entries, truncated at the EOS token."""
        counts = []
        step0 = sched.step
        for slot, row in zip(act, rows):
            r = sched.active[slot]
            m = min(h, r.max_new_tokens - len(r.output))
            toks = [int(x) for x in blk[row, :m]]
            if self.eos_token is not None and self.eos_token in toks:
                toks = toks[:toks.index(self.eos_token) + 1]
                r.finished_early = True
            r.output.extend(toks)
            counts.append(len(toks))
            if r.done and r.finished_at is None:
                r.finished_at = float(step0 + len(toks))
        for k in range(h):
            c.inc("util_acc", sum(1 for m in counts if m > k) / n_slots)
        return counts

    # -- contiguous loop ------------------------------------------------------
    def _run_contiguous(self, reqs, n_slots, c: RunObs):
        """The contiguous engine loop (``engine.py:1362-1438``): faults,
        the elastic poll, evict, admit, one exact-length prefill per
        admitted request (its cache row written into its slot, its first
        token picked on the device), then one decode horizon per
        boundary."""
        dev = self.device
        pool, state = self._pool_and_state(n_slots)
        sched = self._make_sched(pool)
        self._submit_all(sched, pool, reqs)
        tr = c.tracer
        prof = self.profiler

        while sched.has_work:
            admitted = self._admission_round(sched, pool, state, c, reqs)
            t0 = time.perf_counter()
            for r in admitted:
                rt0 = time.perf_counter() if (tr or prof) else 0.0
                tokens = torch.as_tensor(np.asarray(r.prompt, np.int32),
                                         device=self.device)[None, :]
                logits, row = self._prefill(tokens)
                c.inc("prefill_dispatches")
                self._count_work(None, lanes=[1])
                pool.write(r.slot, row)          # at the slot's owner
                lane = torch.tensor([r.slot], device=dev)
                tok = int(self._pick(logits[:, -1], lane,
                                     ~int(sched.step))[0])  # one id fetch
                c.inc("host_syncs")
                r.output.append(tok)
                if self.eos_token is not None and tok == self.eos_token:
                    r.finished_early = True
                if tr or prof:               # the id fetch waited
                    rdt = time.perf_counter() - rt0
                    if tr:
                        tr.emit("prefill", req=r.job_id, tenant=r.tenant,
                                slot=r.slot, prompt_len=len(r.prompt),
                                dur_s=rdt)
                    if prof:
                        # one program per prompt length (the reference
                        # jits one): seq is the static half of the signature
                        prof.record("prefill", rdt, seq=len(r.prompt),
                                    tokens=len(r.prompt),
                                    tenants={r.tenant: 1}, obs=c)
            if admitted:
                c.inc("prefill_s", time.perf_counter() - t0)
                if self.sharding is not None:
                    pool.buffers = self.sharding.reshard_cache(pool.buffers)
                state.set_rows(
                    [r.slot for r in admitted],
                    [r.output[-1] for r in admitted],
                    [len(r.prompt) for r in admitted],
                    [len(r.prompt) + r.max_new_tokens - 1 for r in admitted])
            self._evict(sched, state, c)  # satisfied by prefill alone / EOS
            if not sched.active:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                if self.injector is not None and nxt <= sched.step:
                    # everything waiting is held: jump to the next event
                    # that could unstall admission
                    unb = self._next_unblock(sched)
                    nxt = unb if unb is not None else sched.step + 1
                sched.step = max(sched.step + 1, int(math.ceil(nxt)))
                if c.tracer:
                    c.tracer.step = sched.step
                continue
            h = self._pick_h(sched, sorted(sched.active))
            self._decode_boundary(sched, pool, state, c, n_slots, h)
        self._evict(sched, state, c)

    # -- prefill (paged) ------------------------------------------------------
    def _next_lane_req(self, queue: deque, lanes) -> ServeRequest:
        """The request to fill a freed prefill lane: with an allocation and
        a mixed-tenant queue, a tenant at its lane share yields the lane to
        the first queued request of a tenant under its share; otherwise
        (and when every queued tenant is at its share) the head. Lane
        order only: outputs do not change."""
        if self.allocation is None or len(queue) == 1:
            return queue.popleft()
        held = Counter(ln.req.tenant for ln in lanes)
        if len({r.tenant for r in queue} | set(held)) <= 1:
            return queue.popleft()
        for i, r in enumerate(queue):
            if held[r.tenant] < self.allocation.lane_share(r.tenant):
                del queue[i]
                return r
        return queue.popleft()

    def _batched_paged_prefill(self, pool: BlockManager, reqs, step: int,
                               c: RunObs) -> None:
        """Prefill the joining requests through up to ``prefill_lanes``
        lanes in lockstep chunk-rounds (one ``[P, block_size]`` dispatch per
        round, captured once per lane width ``P``;
        ``engine.py:1463-1542``). A lane starts past its prefix-cache hits,
        commits each completed full block to the prefix cache, and on its
        final chunk takes its first token (picked on lane = its slot at step
        ``~step``); the freed lane refills from the queue. MoE rounds also
        take each lane's expert counts (from the prefix cache on a hit,
        else zeros; padding lanes zeros) and capacity ``caps``, with the
        dispatch buffers sized by the static ``max_len``, and give each lane
        its column of the new counts, kept on the device. Under a plan a
        round is computed ``w / d`` lanes a 'data' rank where 'data' ``d``
        divides its width ``w`` (``_even``): a rank's lanes write their K/V
        into the whole paged pool of every rank, and the picked tokens and
        the MoE counts are gathered."""
        if not reqs:
            return
        bs, mb = pool.block_size, pool.max_blocks
        is_moe = self.cfg.family == "moe"
        cap_static = self.max_len if is_moe else 0

        def round_ids(tokens, starts, n_valid, tables, lanes, step,
                      state=None, caps=None):
            loc = shd.local_rows
            with shd.split_rows(self._even(tokens.shape[0]), self.device):
                logits, _, new_state = self.model.paged_prefill_chunk(
                    self.params, pool.buffers, loc(tokens), loc(starts),
                    loc(tables), None if state is None else loc(state, 1),
                    cap_static, n_valid=loc(n_valid),
                    cap_rows=None if caps is None else loc(caps))
                ids = shd.gather_rows(self._pick(logits[:, -1], loc(lanes),
                                                 step))
                if new_state is not None:
                    new_state = shd.gather_rows(new_state, 1)
            return ids if new_state is None else (ids, new_state)

        zeros = (self.model.paged_prefill_state(1, self.device) if is_moe
                 else None)
        tr = c.tracer
        prof = self.profiler
        queue = deque(reqs)
        lanes: List[_PrefillLane] = []
        while queue or lanes:
            while queue and len(lanes) < self.prefill_lanes:
                r = self._next_lane_req(queue, lanes)
                prompt = np.asarray(r.prompt, np.int32)
                lane = _PrefillLane(req=r, prompt=prompt,
                                    ptr=pool.cached_tokens(r.slot))
                if is_moe:
                    lane.cap_row = capacity(self.cfg, len(prompt))
                    lane.state = pool.resume_state(r.slot)
                    if lane.state is None:
                        lane.state = zeros
                lanes.append(lane)
            w = _bucket(len(lanes), self.prefill_lanes)
            tokens = np.zeros((w, bs), np.int32)
            starts = np.zeros((w,), np.int32)
            nv = np.zeros((w,), np.int32)
            caps = np.zeros((w,), np.int32)
            tables = np.full((w, mb), -1, np.int32)
            slots = np.zeros((w,), np.int64)
            for i, ln in enumerate(lanes):
                n = min(bs, len(ln.prompt) - ln.ptr)
                tokens[i, :n] = ln.prompt[ln.ptr:ln.ptr + n]
                starts[i], nv[i], caps[i] = ln.ptr, n, ln.cap_row
                tables[i] = pool.tables[ln.req.slot]
                slots[i] = ln.req.slot
            inputs = [torch.from_numpy(a)
                      for a in (tokens, starts, nv, tables, slots)]
            inputs.append(torch.tensor(~step))
            if is_moe:
                inputs.append(torch.cat([ln.state for ln in lanes]
                                        + [zeros] * (w - len(lanes)), dim=1))
                inputs.append(torch.from_numpy(caps))
            rt0 = time.perf_counter() if (tr or prof) else 0.0
            ids = self.graphs(("prefill", w), round_ids, *inputs)
            if is_moe:
                ids, new_state = ids
            c.inc("prefill_dispatches")
            self._count_work(self._even(w), lanes=np.ones(w))
            if tr or prof:
                if prof and self.device.type == "cuda":
                    # the round's device work, not its launch: a wait no
                    # counter sees (host_syncs counts the engine's fetches)
                    torch.cuda.current_stream(self.device).synchronize()
                rdt = time.perf_counter() - rt0
                if tr:
                    tr.emit("prefill_round", lanes=len(lanes), width=w,
                            dur_s=rdt)
                if prof:
                    # one program per width bucket; padded lanes compute,
                    # so the roofline counts the full [w, bs] dispatch
                    prof.record("prefill_round", rdt, width=w, tokens=w * bs,
                                kv_pos_sum=int(starts.sum()),
                                tenants=Counter(ln.req.tenant
                                                for ln in lanes), obs=c)
            done_idx: List[int] = []
            live: List[_PrefillLane] = []
            for i, ln in enumerate(lanes):
                n = int(nv[i])
                if is_moe:     # a copy: the round's output is overwritten
                    ln.state = new_state[:, i:i + 1].clone()
                if n == bs:        # a full block is final: cacheable
                    pool.commit_block(ln.req.slot, ln.ptr // bs, ln.state)
                ln.ptr += n
                if ln.ptr >= len(ln.prompt):
                    done_idx.append(i)
                else:
                    live.append(ln)
            if done_idx:
                toks = ids.cpu().numpy()[done_idx]   # the one id fetch
                c.inc("host_syncs")
                for t, i in zip(toks, done_idx):
                    lanes[i].req.output.append(int(t))
            lanes = live

    # -- growth ------------------------------------------------------------------
    def _growth_blocks_needed(self, sched, pool: BlockManager, pos_np,
                              stop_np, h: int) -> int:
        """Fresh blocks a horizon of ``h`` steps would allocate."""
        need = 0
        for s in sched.active:
            want = pool.blocks_for(min(int(pos_np[s]) + h, int(stop_np[s])))
            need += max(0, want - pool.owned_blocks(s))
        return need

    def _ensure_growth(self, sched, pool: BlockManager, pos_np, stop_np,
                       h: int, c: RunObs):
        """Guarantee blocks for up to ``h`` decode tokens per active row
        before a horizon. Shrinks the horizon toward 1 before preempting:
        the largest SLO slack with a registry, else the most recently
        admitted request. A sole request the pool cannot cover raises —
        or, under chaos or elasticity, drops. Returns (h, victim slots)."""
        victims = []
        tr = c.tracer
        while True:
            h0 = h
            while h > 1 and (self._growth_blocks_needed(
                    sched, pool, pos_np, stop_np, h) > pool.free_blocks):
                h = max(1, h // 2)
            if tr and h < h0:
                tr.emit("horizon_shrink", from_k=h0, to_k=h,
                        cause="pool_pressure")
            blocked = next(
                (s for s in sorted(sched.active)
                 if not pool.ensure(s, min(int(pos_np[s]) + h,
                                           int(stop_np[s])))),
                None)
            if blocked is None:
                return h, victims
            if len(sched.active) == 1:
                if self.injector is None and self.elastic is None:
                    raise RuntimeError(
                        "paged KV pool exhausted with a single active "
                        "request; grow n_blocks or lower max_new_tokens")
                # the budget vanished under the last active request (a
                # shrink): drop it instead of crashing the run
                victim = sched.active[blocked]
                victims.append(victim.slot)
                sched.preempt(victim, cause="pool_exhausted")
                self._drop(sched, victim, c, cause="pool_exhausted")
                return h, victims
            if self.tenants is not None:
                victim = max(sched.active.values(),
                             key=lambda r: (self._slack(r, sched.step),
                                            r.admitted_at, r.slot))
            else:
                victim = max(sched.active.values(),
                             key=lambda r: (r.admitted_at, r.slot))
            victims.append(victim.slot)
            sched.preempt(victim, cause="pool_pressure")

    def _run_paged(self, reqs, n_slots, c: RunObs):
        """The paged engine loop (``engine.py:1619-1723``)."""
        pool, state = self._pool_and_state(n_slots)
        if self.allocation is not None:
            pool.tenant_reserves = self.allocation.reserves()
        sched = self._make_sched(pool)
        self._submit_all(sched, pool, reqs)
        pos_np = np.zeros((n_slots,), np.int64)
        stop_np = np.zeros((n_slots,), np.int64)
        peak_report = pool.report()

        while sched.has_work:
            admitted = self._admission_round(sched, pool, state, c, reqs)
            if admitted:
                t0 = time.perf_counter()
                self._batched_paged_prefill(pool, admitted,
                                            int(sched.step), c)
                c.inc("prefill_s", time.perf_counter() - t0)
                for r in admitted:
                    pos_np[r.slot] = len(r.prompt)
                    stop_np[r.slot] = len(r.prompt) + r.max_new_tokens - 1
                    if (self.eos_token is not None
                            and r.output[-1] == self.eos_token):
                        r.finished_early = True
                slots = [r.slot for r in admitted]
                state.set_rows(slots, [r.output[-1] for r in admitted],
                               [int(pos_np[s]) for s in slots],
                               [int(stop_np[s]) for s in slots])
                snap = pool.report()
                if snap["used_blocks"] >= peak_report["used_blocks"]:
                    peak_report = snap
                if self.sharding is not None:
                    pool.buffers = self.sharding.reshard_cache(pool.buffers)
            self._evict(sched, state, c)  # satisfied by prefill alone / EOS
            if not sched.active:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                if not admitted and nxt <= sched.step:
                    if self.injector is None and self.elastic is None:
                        raise RuntimeError(
                            "paged KV pool cannot admit any waiting "
                            "request; grow n_blocks or lower the watermark")
                    # a shrink or a hold made everything inadmissible for
                    # now: jump to the next event that could unstall it
                    unb = self._next_unblock(sched)
                    nxt = unb if unb is not None else sched.step + 1
                sched.step = max(sched.step + 1, int(math.ceil(nxt)))
                if c.tracer:
                    c.tracer.step = sched.step
                continue

            h = self._pick_h(sched, sorted(sched.active))
            h, victims = self._ensure_growth(sched, pool, pos_np, stop_np, h,
                                             c)
            c.inc("preemptions", len(victims))
            state.freeze(victims)
            if not sched.active:    # the sole request dropped on exhaustion
                continue
            # delta-sync the device tables: only rows dirtied by admission
            # or growth (freed rows stay stale — frozen and write-masked)
            dirty = sorted(s for s in pool.drain_dirty() if s in sched.active)
            if dirty:
                state.set_tables(dirty, pool.tables[np.asarray(dirty)])

            act = sorted(sched.active)
            counts = self._decode_boundary(sched, pool, state, c, n_slots, h)
            for slot, m in zip(act, counts):
                pos_np[slot] += m
            snap = pool.report()
            if snap["used_blocks"] >= peak_report["used_blocks"]:
                peak_report = snap
        self._evict(sched, state, c)
        c.block_report = peak_report
        c.inc("prefix_hits", pool.prefix_blocks_hit)
        c.inc("prefix_total", pool.prefix_blocks_total)
