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
    recurrent (SSM) family, one captured batch-1 ``decode_step`` replayed
    per prompt position on a zeroed state (the reference scans); the
    first token is picked on the device and fetched (one host sync per
    request);
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

The contiguous backend serves the dense, VLM, MoE and SSM families, the
paged one the attention families (dense, VLM, MoE; the recurrent state is
O(1) per slot and has nothing to page). Serving is text-only: the VLM
patch prefix reaches ``forward`` and ``loss`` only, as in the reference.
Tenants, fault injection, elastic reshapes, sharding, tracing and
profiling are ported later and raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import functools
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import Model, build_model
from repro_torch.models.moe import capacity
from repro_torch.obs.metrics import RunObs
from repro_torch.serve import sampling
from repro_torch.serve.cache import CachePool
from repro_torch.serve.graphs import GraphRunner
from repro_torch.serve.paged import BlockManager
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

CACHE_BACKENDS = ("contiguous", "paged")
#: families whose layers attend over a KV cache: one-pass prefill, a
#: write-masked decode horizon, a pageable cache (``engine.py:98``)
_ATTN_FAMILIES = ("dense", "vlm", "moe")

#: engine options of the reference that later slices port, by ROADMAP
#: queue A item
_LATER = {"tenants": 8, "allocation": 8, "injector": 8, "elastic": 8,
          "tracer": 9, "profiler": 9, "profile_store": 9, "sharding": 10}


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


def _bucket(n: int, cap: int) -> int:
    """Compacted width: smallest power of two >= n, capped at the pool
    width (the reference also rounds to the mesh 'data' axis; the port
    runs on one device)."""
    return min(_pow2(max(n, 1)), cap)


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
    unfinished: int = 0               # requests that never finished
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
    admission, growth and eviction."""

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
    """Serving engine for the dense, VLM, MoE and SSM families.

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
    """

    def __init__(self, cfg: ArchConfig, params=None, max_len: int = 256,
                 n_slots: Optional[int] = None, policy: str = "fcfs",
                 cache: str = "contiguous", block_size: int = 16,
                 n_blocks: Optional[int] = None, watermark: float = 0.05,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, prefill_lanes: int = 4,
                 prefix_cache: bool = True, decode_horizon: int = 8,
                 eos_token: Optional[int] = None, device="cuda",
                 seed: int = 0, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet (ROADMAP queue A, item "
                    f"{_LATER[name]})")
        if cache not in CACHE_BACKENDS:
            raise ValueError(f"unknown cache backend {cache!r}; "
                             f"known: {CACHE_BACKENDS}")
        if cache == "paged" and cfg.family not in _ATTN_FAMILIES:
            raise ValueError(
                f"cache='paged' needs an attention family (got "
                f"{cfg.family!r}: recurrent state is O(1))")
        self.cfg = cfg
        self.model: Model = build_model(cfg)
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
        self.params = params
        self._horizon = (self._paged_horizon if cache == "paged"
                         else self._contiguous_horizon)
        #: the captured programs (one per static signature)
        self.graphs = GraphRunner(self.device)
        #: the recurrent prefill's batch-1 state (read by its graph)
        self._row = None

    def _pool_and_state(self, n_slots: int):
        """The run's pool and decode state: the last run's, reset in place,
        when it had ``n_slots`` slots (the pool's shape follows from that
        and the engine's fixed options) — the captured graphs read their
        tensors at fixed addresses — else new ones, and the graphs go with
        the old tensors."""
        if self.pool is not None and self.pool.n_slots == n_slots:
            self.pool.reset()
            self._state.reset()
            return self.pool, self._state
        self.graphs.reset()
        self.pool = self._state = None       # free the old tensors first
        if self.cache_kind == "paged":
            pool = BlockManager(self.model, n_slots, self.max_len,
                                block_size=self.block_size,
                                n_blocks=self.n_blocks,
                                watermark=self.watermark,
                                prefix_cache=self.prefix_cache,
                                device=self.device)
            max_blocks = pool.max_blocks
        else:
            pool = CachePool(self.model, n_slots, self.max_len,
                             device=self.device)
            max_blocks = None
        self.pool, self._state = pool, _DecodeState(n_slots, max_blocks,
                                                    self.device)
        return self.pool, self._state

    # -- prefill (contiguous) -------------------------------------------------
    def _prefill(self, tokens):
        """tokens [1, S] -> (last logits [1, 1, V], a batch-1 cache dict for
        ``pool.write``) (``engine.py:455-484``). Attention families: one
        pass via the ``return_cache`` hook at the prompt's exact length
        (eager), every leaf padded to max_len. Recurrent families: a
        zeroed batch-1 state stepped through the prompt, one replay of the
        captured ``decode_step`` per position (the reference scans); the
        state is the engine's until the next prefill."""
        if self.cfg.family not in _ATTN_FAMILIES:
            if self._row is None:
                self._row = self.model.init_cache(1, self.max_len,
                                                  device=self.device)
            row = self._row
            for buf in row.values():
                buf.zero_()

            def step(tok):
                return self.model.decode_step(self.params, row, tok, 0)[0]

            for t in range(tokens.shape[1]):
                logits = self.graphs(("recurrent_step",), step,
                                     tokens[:, t:t + 1])
            return logits, row
        logits, (k, v) = self.model.module.forward(self.cfg, self.params,
                                                   tokens, return_cache=True)
        pad = (0, 0, 0, 0, 0, self.max_len - tokens.shape[1])  # [L,B,S,H,D]
        return logits[:, -1:], {"k": F.pad(k, pad), "v": F.pad(v, pad)}

    # -- the engine loop ---------------------------------------------------------
    def run(self, requests: List[ServeRequest]
            ) -> Tuple[List[ServeRequest], ServeStats]:
        """Serve ``requests`` to completion; returns (requests, stats)."""
        reqs = list(requests)
        n_slots = self.n_slots if self.n_slots else max(len(reqs), 1)
        c = RunObs()
        t0 = time.perf_counter()
        with torch.inference_mode():
            if self.cache_kind == "paged":
                self._run_paged(reqs, n_slots, c)
            else:
                self._run_contiguous(reqs, n_slots, c)
        wall = time.perf_counter() - t0
        return reqs, self._stats(reqs, c, n_slots, wall)

    def _finished(self, r: ServeRequest) -> bool:
        return (r.done and r.latency_steps is not None
                and r.latency_s is not None)

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
            unfinished=sum(1 for r in reqs if not self._finished(r)),
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
        )

    def _sample_boundary(self, sched, pool, c: RunObs) -> None:
        """Update the gauges after a decode boundary and snapshot them into
        the series (the stats' queue-depth and occupancy summaries)."""
        m = c.metrics
        m.set("queue_depth", len(sched.waiting))
        m.set("active", len(sched.active))
        if self.cache_kind == "paged":
            occ = (1.0 - pool.free_blocks / pool.n_blocks
                   if pool.n_blocks else 0.0)
        else:
            occ = len(sched.active) / pool.capacity if pool.capacity else 0.0
        m.set("occupancy", occ)
        m.sample(sched.step)

    def _evict(self, sched, state: _DecodeState, c: RunObs):
        """Evict finished requests and freeze their device rows."""
        done_slots = [s for s, r in sched.active.items() if r.done]
        out = sched.evict_finished()
        state.freeze(done_slots)
        for r in out:
            c.metrics.observe("latency_steps", r.latency_steps)

    # -- horizon scheduling helpers (host side) --------------------------------
    def _pick_h(self, sched, act) -> int:
        """Horizon length: at most ``decode_horizon``, capped to the longest
        remaining budget and to the next open-loop arrival when the pool
        could admit it, quantized down to a power of two."""
        rem = max(sched.active[s].max_new_tokens - len(sched.active[s].output)
                  for s in act)
        h = max(1, min(self.decode_horizon, rem))
        nxt = sched.next_arrival()
        if (nxt is not None and nxt > sched.step
                and self._could_admit_arrival(sched)):
            h = max(1, min(h, int(math.ceil(nxt - sched.step))))
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
        pos), write no KV and emit -1. Returns (t, p, s, token block
        [W, h])."""
        emitted = []
        for k in range(h):
            active = p < s
            logits = step_fn(t, p, active)
            nxt = self._pick(logits[:, -1], idx, step0 + k)
            emitted.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
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
                       step0, h: int, full: bool) -> torch.Tensor:
        """Up to ``h`` paged decode steps over the bucket ``idx`` (int64
        slot ids on the device; ``step0`` the scheduler step, an int64
        device scalar): the bucket gathers tokens, positions, stops and
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
                self.params, pool.buffers, t, p, tb, write_valid=active)[0]

        t, p, s, blk = self._scan_horizon(step, t, p, s, idx, step0, h)
        self._put_rows(state, ix, t, p, s)
        return blk

    def _contiguous_horizon(self, pool: CachePool, state: _DecodeState, idx,
                            step0, h: int, full: bool) -> torch.Tensor:
        """Up to ``h`` contiguous decode steps over the bucket ``idx``
        (``engine.py:539-598``; ``idx`` and ``step0`` as in
        ``_paged_horizon``): gather the bucket's cache rows along each
        leaf's batch axis with ``index_select`` (unless ``full``: every
        slot decodes, idle rows frozen and inert), decode with
        ``write_valid`` = the live rows, and scatter the rows back with
        ``index_copy_``. Recurrent families decode without ``write_valid``:
        their frozen rows recompute state that slot reuse overwrites.
        Returns the [W, h] int32 token block."""
        if full:
            ix, sub = None, pool.buffers
            t, p, s = state.tok, state.pos, state.stop
        else:
            ix = idx
            sub = {name: buf.index_select(pool.batch_axes[name], ix)
                   for name, buf in pool.buffers.items()}
            t, p, s = state.tok[ix], state.pos[ix], state.stop[ix]

        masked = self.cfg.family in _ATTN_FAMILIES

        def step(t, p, active):
            return self.model.decode_step(
                self.params, sub, t, p,
                write_valid=active if masked else None)[0]

        t, p, s, blk = self._scan_horizon(step, t, p, s, idx, step0, h)
        if ix is not None:
            for name, buf in pool.buffers.items():
                buf.index_copy_(pool.batch_axes[name], ix, sub[name])
        self._put_rows(state, ix, t, p, s)
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
        bc = _bucket(len(act), n_slots)
        full = bc == n_slots
        if full:
            idx = np.arange(n_slots, dtype=np.int64)
            rows = act                       # block rows are slot-indexed
        else:
            idle = [s for s in range(n_slots) if s not in sched.active]
            idx = np.asarray(act + idle[:bc - len(act)], np.int64)
            rows = list(range(len(act)))     # compacted row order
        t0 = time.perf_counter()
        blk = self.graphs(
            (self.cache_kind, len(idx), h, full),
            lambda ix, step0: self._horizon(pool, state, ix, step0, h, full),
            torch.from_numpy(idx), torch.tensor(int(sched.step)))
        c.inc("decode_dispatches")
        blk = blk.cpu().numpy()              # the one [W, h] int32 fetch
        c.inc("host_syncs")
        c.inc("decode_s", time.perf_counter() - t0)
        counts = self._unpack_horizon(sched, act, rows, blk, h, n_slots, c)
        c.inc("rows_decoded", len(idx) * h)
        c.hi("max_active", len(act))
        c.inc("steps", h)
        c.metrics.observe("horizon_k", h)
        sched.step += h
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
        """The contiguous engine loop (``engine.py:1362-1438``): evict,
        admit, one exact-length prefill per admitted request (its cache row
        written into its slot, its first token picked on the device), then
        one decode horizon per boundary."""
        dev = self.device
        pool, state = self._pool_and_state(n_slots)
        sched = ContinuousScheduler(pool, self.policy)
        for i, r in enumerate(reqs):
            r.job_id = i
            sched.submit(r)

        while sched.has_work:
            self._evict(sched, state, c)
            sched.admit()
            admitted = sched.drain_prefill()
            t0 = time.perf_counter()
            for r in admitted:
                tokens = torch.as_tensor(np.asarray(r.prompt, np.int32),
                                         device=self.device)[None, :]
                logits, row = self._prefill(tokens)
                c.inc("prefill_dispatches")
                pool.write(r.slot, row)
                lane = torch.tensor([r.slot], device=dev)
                tok = int(self._pick(logits[:, -1], lane,
                                     ~int(sched.step))[0])  # one id fetch
                c.inc("host_syncs")
                r.output.append(tok)
                if self.eos_token is not None and tok == self.eos_token:
                    r.finished_early = True
            if admitted:
                c.inc("prefill_s", time.perf_counter() - t0)
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
                sched.step = max(sched.step + 1, int(math.ceil(nxt)))
                continue
            h = self._pick_h(sched, sorted(sched.active))
            self._decode_boundary(sched, pool, state, c, n_slots, h)
        self._evict(sched, state, c)

    # -- prefill (paged) ------------------------------------------------------
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
        its column of the new counts, kept on the device."""
        if not reqs:
            return
        bs, mb = pool.block_size, pool.max_blocks
        is_moe = self.cfg.family == "moe"
        cap_static = self.max_len if is_moe else 0

        def round_ids(tokens, starts, n_valid, tables, lanes, step,
                      state=None, caps=None):
            logits, _, new_state = self.model.paged_prefill_chunk(
                self.params, pool.buffers, tokens, starts, tables, state,
                cap_static, n_valid=n_valid, cap_rows=caps)
            ids = self._pick(logits[:, -1], lanes, step)
            return ids if new_state is None else (ids, new_state)

        zeros = (self.model.paged_prefill_state(1, self.device) if is_moe
                 else None)
        queue = deque(reqs)
        lanes: List[_PrefillLane] = []
        while queue or lanes:
            while queue and len(lanes) < self.prefill_lanes:
                r = queue.popleft()
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
            ids = self.graphs(("prefill", w), round_ids, *inputs)
            if is_moe:
                ids, new_state = ids
            c.inc("prefill_dispatches")
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
                       h: int):
        """Guarantee blocks for up to ``h`` decode tokens per active row
        before a horizon. Shrinks the horizon toward 1 before preempting
        the most recently admitted request. Returns (h, victim slots)."""
        victims = []
        while True:
            while h > 1 and (self._growth_blocks_needed(
                    sched, pool, pos_np, stop_np, h) > pool.free_blocks):
                h = max(1, h // 2)
            blocked = next(
                (s for s in sorted(sched.active)
                 if not pool.ensure(s, min(int(pos_np[s]) + h,
                                           int(stop_np[s])))),
                None)
            if blocked is None:
                return h, victims
            if len(sched.active) == 1:
                raise RuntimeError(
                    "paged KV pool exhausted with a single active request; "
                    "grow n_blocks or lower max_new_tokens")
            victim = max(sched.active.values(),
                         key=lambda r: (r.admitted_at, r.slot))
            victims.append(victim.slot)
            sched.preempt(victim)

    def _run_paged(self, reqs, n_slots, c: RunObs):
        pool, state = self._pool_and_state(n_slots)
        sched = ContinuousScheduler(pool, self.policy)
        for i, r in enumerate(reqs):
            r.job_id = i
            sched.submit(r)
        pos_np = np.zeros((n_slots,), np.int64)
        stop_np = np.zeros((n_slots,), np.int64)
        peak_report = pool.report()

        while sched.has_work:
            self._evict(sched, state, c)
            sched.admit()
            admitted = sched.drain_prefill()
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
            self._evict(sched, state, c)  # satisfied by prefill alone / EOS
            if not sched.active:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                if not admitted and nxt <= sched.step:
                    raise RuntimeError(
                        "paged KV pool cannot admit any waiting request; "
                        "grow n_blocks or lower the watermark")
                sched.step = max(sched.step + 1, int(math.ceil(nxt)))
                continue

            h = self._pick_h(sched, sorted(sched.active))
            h, victims = self._ensure_growth(sched, pool, pos_np, stop_np, h)
            c.inc("preemptions", len(victims))
            state.freeze(victims)
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
