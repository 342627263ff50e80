"""Block-table KV manager (``repro/serve/paged.py``).

A request at length L holds ``ceil(L / block_size)`` blocks of one shared
``[n_blocks, block_size, ...]`` pool behind a per-request block table.
Admission is watermark-based (the prompt's blocks must fit while
``watermark * n_blocks`` blocks stay free for decode growth); growth
(``ensure``) may eat into the reserve; the engine preempts when the pool
is dry. Blocks and slots recycle FIFO, and a freed table row is cleared to
-1 so a re-issued block is never read through a stale table.

Prefix caching shares FULL prompt blocks by a blake2b hash chain over their
tokens (byte for byte the reference's, so the two packages hit the same
blocks): hits are ref-counted and skip both allocation and prefill; the
partial tail and every growth block stay private (copy-on-write); a hit on
a block whose donor has not written it yet defers the request one round;
refcount-0 blocks park in an evictable FIFO until the free list runs dry.
For MoE the per-layer expert-assignment counts after each block are kept
with its entry (``commit_block``'s ``state``) and the routing capacity is
folded into the hash seed, so a prefix-hit resume routes token for token
like a cold prefill (``resume_state``).

Chaos and elastic serving reshape the pool mid-run: ``shrink`` revokes
capacity (idle blocks first, the rest as a *deficit* collected from blocks
as their holders free them), ``expand`` returns it, ``grow_physical``
allocates larger pools and copies every block into their leading slice
(block ids stay put), ``flush_prefix`` evicts the prefix cache (entries
still held are *retired*: unhittable, freed with their last holder), and
``tenant_reserves`` lets a tenant admitting spend its own share of the
watermark. ``audit`` checks that every block the pool was built with is
in exactly one place, the revoked ledger and the deficit included.

The pools are torch tensors on the engine's device (the model's
``PagedCache``); tables and every other piece of bookkeeping stay numpy on
the host.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.moe import capacity
from repro_torch.obs.events import NULL_TRACER


@dataclass
class _PrefixEntry:
    """One cached full prompt block. ``ready`` flips when its owner's
    prefill has written the block (``commit_block``); ``state`` is the
    family's cross-chunk prefill carry after the block (MoE expert counts,
    a device tensor; None for dense / vlm)."""
    block: int
    refs: int = 0
    ready: bool = False
    state: object = field(default=None, repr=False)
    #: force-flushed while still held: kept for refcounting, never hit,
    #: its block released when the last holder frees
    retired: bool = False


class BlockManager:
    """Paged decode cache over a model's ``init_paged_cache``: the pool
    surface the scheduler drives (``alloc_for`` / ``free`` /
    ``validate_request``) plus the per-boundary calls of the engine
    (``ensure``, ``drain_dirty``, ``report``), the prefix-cache surface
    (``cached_tokens``, ``resume_state``, ``commit_block``) and the
    reshape surface (``shrink``, ``expand``, ``grow_physical``,
    ``flush_prefix``, ``audit``). ``tracer`` (an ``obs.Tracer``) records
    the pool's events (``block_alloc``, ``block_grow``, ``block_free``,
    ``prefix_evict``) at the engine's clock, ``tracer.step``.
    ``model`` is anything with the model's ``init_paged_cache``: under a
    serve plan its ``pools``, whose buffers are this rank's blocks (a
    block then holds a slice of ``block_size`` offsets where the pool's
    positions are split over ranks); every host-side count and table
    stays at ``block_size``."""

    def __init__(self, model, n_slots: int, max_len: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 watermark: float = 0.05, dtype=None,
                 prefix_cache: bool = False, device="cuda",
                 tracer=NULL_TRACER):
        self.model = model
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)   # table width per slot
        #: the constructed capacity (``reset`` restores it)
        self._blocks0 = (n_blocks if n_blocks is not None
                         else n_slots * self.max_blocks)
        self.watermark = float(watermark)   # fraction; re-applied on reshape
        self._dtype, self._device = dtype, device
        self.buffers = model.init_paged_cache(self._blocks0, block_size,
                                              dtype, device=device)
        #: blocks the pool buffers hold (grows with ``grow_physical``)
        self._total_blocks = self._blocks0
        self.prefix_cache = prefix_cache
        self._clear()

    def _clear(self) -> None:
        """Every block and slot free, the tables -1, the prefix cache
        empty, nothing revoked, no tenant reserve."""
        self.n_blocks = self._total_blocks
        self.watermark_blocks = math.ceil(self.watermark * self.n_blocks)
        #: blocks revoked mid-run, and the revocation still owed by blocks
        #: in tables (collected as they free)
        self._revoked: List[int] = []
        self._revoke_deficit = 0
        #: per-tenant watermark headroom (``TenantAllocation.reserves``):
        #: a tenant admitting keeps only the other tenants' reserve free
        self.tenant_reserves: Dict[str, int] = {}
        self._free_blocks = deque(range(self.n_blocks))
        self._free_slots = deque(range(self.n_slots))
        self._in_use: set = set()
        self.tables = np.full((self.n_slots, self.max_blocks), -1, np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int64)  # tokens owned
        # -- prefix cache ----------------------------------------------------
        self._entries: Dict[int, _PrefixEntry] = {}       # hash -> entry
        self._evictable: "OrderedDict[int, None]" = OrderedDict()  # FIFO
        #: per-slot chain of (hash | None, owned) for the prompt's full
        #: blocks; None marks a private block (hash already owned elsewhere)
        self._chains: Dict[int, List[Tuple[Optional[int], bool]]] = {}
        self._cached_tokens = np.zeros((self.n_slots,), np.int64)
        self._resume: Dict[int, object] = {}
        self.prefix_blocks_total = 0   # full+partial prompt blocks allocated
        self.prefix_blocks_hit = 0     # of those, served from the cache
        #: True iff the last alloc_for returned None because a donor was
        #: still prefilling (vs pool exhaustion)
        self.deferred_last_alloc = False
        #: slots whose table row changed since the last ``drain_dirty``
        self._dirty_slots: set = set()

    @property
    def grown(self) -> bool:
        """Whether ``grow_physical`` replaced the constructed buffers."""
        return self._total_blocks != self._blocks0

    def reset(self) -> None:
        """Empty the pool in place at its constructed capacity: the pools
        zeroed, the host bookkeeping rebuilt. The pool tensors keep their
        addresses (the engine's captured graphs read them); a pool whose
        buffers grew cannot be reset (build a new one)."""
        if self.grown:
            raise ValueError("a pool that grew past its constructed "
                             "capacity cannot be reset: build a new one")
        self.buffers.k_buf.zero_()
        self.buffers.v_buf.zero_()
        self._clear()

    # -- block math ----------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.block_size)

    @property
    def free_blocks(self) -> int:
        """Blocks available to allocation: truly free + evictable cached."""
        return len(self._free_blocks) + len(self._evictable)

    @property
    def evictable_blocks(self) -> int:
        return len(self._evictable)

    # -- prefix hashing ------------------------------------------------------
    def _hash_chain(self, prompt: np.ndarray) -> List[int]:
        """Rolling content hashes of the prompt's FULL blocks, chained from
        an 8-byte seed: the MoE routing capacity of the prompt's length (two
        prompts sharing tokens but not capacity drop different tokens), 0
        for the other families."""
        cfg = self.model.cfg
        salt = capacity(cfg, len(prompt)) if cfg.family == "moe" else 0
        prev = salt.to_bytes(8, "little", signed=True)
        hashes = []
        for i0 in range(0, (len(prompt) // self.block_size) * self.block_size,
                        self.block_size):
            h = hashlib.blake2b(
                prev + np.ascontiguousarray(
                    prompt[i0:i0 + self.block_size], np.int64).tobytes(),
                digest_size=16).digest()
            hashes.append(int.from_bytes(h, "little"))
            prev = h
        return hashes

    def _take_block(self) -> int:
        """A free block, evicting the oldest refcount-0 cached block if the
        free list is dry (its hash entry is dropped)."""
        if self._free_blocks:
            return self._free_blocks.popleft()
        h, _ = self._evictable.popitem(last=False)
        if self.tracer:
            self.tracer.emit("prefix_evict", blocks=1)
        return self._entries.pop(h).block

    def _release_block(self, blk: int) -> None:
        """Return a block to the pool, or to a pending revocation: after a
        ``shrink`` that found too few idle blocks, the deficit is collected
        here as blocks in tables come back."""
        if self._revoke_deficit > 0:
            self._revoke_deficit -= 1
            self._revoked.append(blk)
        else:
            self._free_blocks.append(blk)

    # -- admission -----------------------------------------------------------
    def validate_request(self, req) -> None:
        """Reject requests that can never run on this pool."""
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache positions but the pool's block "
                f"tables span {self.max_len}")
        if self.blocks_for(need) > self.n_blocks:
            raise ValueError(
                f"request needs {self.blocks_for(need)} blocks but the pool "
                f"holds {self.n_blocks}")
        if self.blocks_for(len(req.prompt)) + self.watermark_blocks \
                > self.n_blocks:
            raise ValueError(
                f"prompt needs {self.blocks_for(len(req.prompt))} blocks "
                f"which can never clear the {self.watermark_blocks}-block "
                f"admission watermark on a {self.n_blocks}-block pool")

    def _blocks_clear_watermark(self, n_new_blocks: int,
                                tenant: Optional[str] = None) -> bool:
        """``n_new_blocks`` fresh blocks fit while the reserve stays free.
        With per-tenant reserves installed, a known tenant keeps only the
        other tenants' headroom free (its own is spendable)."""
        reserve = self.watermark_blocks
        if tenant is not None and tenant in self.tenant_reserves:
            reserve = min(reserve,
                          sum(self.tenant_reserves.values())
                          - self.tenant_reserves[tenant])
        return self.free_blocks - n_new_blocks >= reserve

    def can_admit(self, n_tokens: int) -> bool:
        """Cache-blind watermark admission test (``alloc_for`` decides)."""
        return (bool(self._free_slots)
                and self._blocks_clear_watermark(self.blocks_for(n_tokens)))

    def alloc_for(self, req) -> Optional[int]:
        """Admit ``req``: claim a slot + its prompt's blocks; None if the
        watermark would be violated or a prefix donor is still prefilling
        (``deferred_last_alloc``). Ready prefix hits are shared; the last
        chunk is never served from cache (its logits seed the first token).
        """
        n = len(req.prompt)
        need = self.blocks_for(n)
        hashes: List[int] = []
        hits = revived = 0
        self.deferred_last_alloc = False
        if self.prefix_cache:
            memo = getattr(req, "_prefix_hashes", None)
            if memo is not None and memo[0] == self.block_size:
                hashes = memo[1]
            else:
                hashes = self._hash_chain(np.asarray(req.prompt))
                req._prefix_hashes = (self.block_size, hashes)
            hit_cap = (n - 1) // self.block_size
            for h in hashes[:hit_cap]:
                e = self._entries.get(h)
                if e is None or e.retired:   # retired: flushed, unhittable
                    break
                if not e.ready:
                    self.deferred_last_alloc = True
                    return None
                hits += 1
                # reviving a refcount-0 block costs no new block but still
                # shrinks availability: charge it
                revived += e.refs == 0
        if (not self._free_slots
                or not self._blocks_clear_watermark(
                    need - hits + revived, getattr(req, "tenant", None))):
            return None
        slot = self._free_slots.popleft()
        self._in_use.add(slot)
        chain: List[Tuple[Optional[int], bool]] = []
        for j in range(need):
            if j < hits:
                e = self._entries[hashes[j]]
                if e.refs == 0:
                    self._evictable.pop(hashes[j], None)
                e.refs += 1
                self.tables[slot, j] = e.block
                chain.append((hashes[j], False))
            else:
                self.tables[slot, j] = self._take_block()
                if self.prefix_cache and j < len(hashes):
                    if hashes[j] in self._entries:
                        chain.append((None, False))   # hash owned elsewhere
                    else:
                        self._entries[hashes[j]] = _PrefixEntry(
                            block=int(self.tables[slot, j]), refs=1)
                        chain.append((hashes[j], True))
        self._lengths[slot] = n
        self._dirty_slots.add(slot)
        if self.prefix_cache:
            self._chains[slot] = chain
            self._cached_tokens[slot] = hits * self.block_size
            self._resume[slot] = (self._entries[hashes[hits - 1]].state
                                  if hits else None)
            self.prefix_blocks_total += need
            self.prefix_blocks_hit += hits
        if self.tracer:
            self.tracer.emit("block_alloc", slot=slot, blocks=need - hits,
                             hits=hits)
        return slot

    # -- prefix-cache surface --------------------------------------------------
    def cached_tokens(self, slot: int) -> int:
        """Prompt positions covered by cache hits: prefill resumes here."""
        return int(self._cached_tokens[slot])

    def resume_state(self, slot: int):
        """The cross-chunk prefill carry kept after the last hit block
        (MoE expert counts), or None for a cold start."""
        return self._resume.get(slot)

    def commit_block(self, slot: int, block_idx: int, state=None) -> None:
        """Mark a prompt block's content written: the entry becomes
        hittable and keeps ``state``, the prefill carry after the block
        (the caller's snapshot: it must not change afterwards)."""
        chain = self._chains.get(slot, ())
        if block_idx >= len(chain):
            return
        h, owned = chain[block_idx]
        if not owned or h is None:
            return
        e = self._entries.get(h)
        if e is not None and e.block == int(self.tables[slot, block_idx]):
            e.ready = True
            e.state = state

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to cover ``n_tokens`` positions (decode append),
        with private blocks only. False when the pool is dry."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        have = have0 = int((self.tables[slot] >= 0).sum())
        while have * self.block_size < n_tokens:
            if not self._free_blocks and not self._evictable:
                return False
            self.tables[slot, have] = self._take_block()
            self._dirty_slots.add(slot)
            have += 1
        if self.tracer and have > have0:
            self.tracer.emit("block_grow", slot=slot, blocks=have - have0)
        self._lengths[slot] = max(self._lengths[slot], n_tokens)
        return True

    def owned_blocks(self, slot: int) -> int:
        """Blocks currently assigned to ``slot``'s table."""
        return int((self.tables[slot] >= 0).sum())

    def drain_dirty(self) -> set:
        """Slots whose table rows changed since the last drain (clears the
        set): the engine's device copy of the tables syncs these rows."""
        dirty, self._dirty_slots = self._dirty_slots, set()
        return dirty

    def free(self, slot: int) -> None:
        """Release a request's slot and blocks (FIFO recycle, table row
        cleared). Shared prefix blocks are only de-referenced: at refcount 0
        they park in the evictable FIFO, still hittable."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        chain = self._chains.pop(slot, ())
        n_freed = n_shared = 0
        for j in range(self.max_blocks):
            blk = int(self.tables[slot, j])
            if blk < 0:
                continue
            n_freed += 1
            h = chain[j][0] if j < len(chain) else None
            e = self._entries.get(h) if h is not None else None
            if e is not None and e.block == blk:
                n_shared += 1
                e.refs -= 1
                if e.refs == 0:
                    if e.ready and not e.retired:
                        self._evictable[h] = None
                    else:   # owner left before writing, or force-flushed
                        del self._entries[h]      # while held: unservable
                        self._release_block(blk)
            else:
                self._release_block(blk)
        self.tables[slot] = -1
        self._dirty_slots.add(slot)
        self._lengths[slot] = 0
        self._cached_tokens[slot] = 0
        self._resume.pop(slot, None)
        self._free_slots.append(slot)
        if self.tracer:
            self.tracer.emit("block_free", slot=slot, blocks=n_freed,
                             shared=n_shared)

    # -- reshapes (chaos and elastic serving) ---------------------------------
    def shrink(self, n: int) -> int:
        """Revoke up to ``n`` blocks of capacity (``pool_shrink``,
        ``device_fail``, an elastic scale-down): idle blocks first — the
        free list, then evictable cached blocks (their entries dropped) —
        and the rest as a deficit collected as blocks free. Capacity and
        the watermark rescale at once; at least one block of capacity
        survives. Returns the blocks revoked."""
        take = max(0, min(int(n), self.n_blocks - 1))
        got = 0
        while got < take and (self._free_blocks or self._evictable):
            self._revoked.append(self._take_block())
            got += 1
        self._revoke_deficit += take - got
        self.n_blocks -= take
        self.watermark_blocks = math.ceil(self.watermark * self.n_blocks)
        return take

    def expand(self, n: int) -> int:
        """Return up to ``n`` revoked blocks (``pool_restore``, a join, a
        scale-up): the deficit cancels first (those blocks never left the
        tables), then revoked blocks rejoin the free list."""
        give = min(int(n), len(self._revoked) + self._revoke_deficit)
        cancel = min(give, self._revoke_deficit)
        self._revoke_deficit -= cancel
        for _ in range(give - cancel):
            self._free_blocks.append(self._revoked.pop())
        self.n_blocks += give
        self.watermark_blocks = math.ceil(self.watermark * self.n_blocks)
        return give

    def grow_physical(self, n: int) -> int:
        """Grow true capacity past the buffers' (a ``device_join`` larger
        than what was revoked): allocate pools of ``n`` more blocks and copy
        every block of the old pools into their leading slice — a move,
        never a recompute, so in-flight decodes resume token for token.
        Block ids are stable: the new blocks take ids past the old capacity
        and join the free list, so tables, prefix entries and the revoked
        ledger survive untouched. The pool tensors move: whoever captured
        programs over them must drop those. Returns the blocks added."""
        n = int(n)
        if n <= 0:
            return 0
        old_total = self._total_blocks
        new = self.model.init_paged_cache(old_total + n, self.block_size,
                                          self._dtype, device=self._device)
        for name in ("k", "v"):
            new[name][:, :old_total].copy_(self.buffers[name])
        self.buffers = new
        self._free_blocks.extend(range(old_total, old_total + n))
        self._total_blocks = old_total + n
        self.n_blocks += n
        self.watermark_blocks = math.ceil(self.watermark * self.n_blocks)
        return n

    def flush_prefix(self) -> int:
        """Force-evict the prefix cache (``prefix_flush``): refcount-0
        entries release their blocks at once; held entries retire —
        unhittable, released with their last holder. Returns the entries
        flushed (freed + retired)."""
        freed = 0
        for h in list(self._evictable):
            del self._evictable[h]
            self._release_block(self._entries.pop(h).block)
            freed += 1
        retired = 0
        for e in self._entries.values():
            if not e.retired:
                e.retired = True
                retired += 1
        if freed and self.tracer:
            self.tracer.emit("prefix_evict", blocks=freed)
        return freed + retired

    def audit(self) -> Dict[str, int]:
        """Block-conservation check: every block the buffers hold is in
        exactly one of {free list, revoked, a table (counted once across
        sharers), evictable cache}, the deficit's blocks sitting in tables;
        each entry's refcount equals its block's table multiplicity; idle
        slots hold no blocks; capacity + revoked + deficit = the buffers'
        blocks. Raises RuntimeError on any violation."""
        problems: List[str] = []
        free = list(self._free_blocks)
        free_set = set(free)
        if len(free_set) != len(free):
            problems.append(f"duplicate blocks in the free list: {free}")
        revoked_set = set(self._revoked)
        if len(revoked_set) != len(self._revoked):
            problems.append(f"duplicate revoked blocks: {self._revoked}")
        if free_set & revoked_set:
            problems.append(f"free∩revoked: {sorted(free_set & revoked_set)}")
        table_refs: Dict[int, int] = {}
        for slot in range(self.n_slots):
            row = self.tables[slot]
            if slot not in self._in_use:
                if (row >= 0).any():
                    problems.append(f"idle slot {slot} holds table blocks")
                continue
            for blk in row[row >= 0]:
                table_refs[int(blk)] = table_refs.get(int(blk), 0) + 1
        table_set = set(table_refs)
        for name, other in (("free", free_set), ("revoked", revoked_set)):
            if table_set & other:
                problems.append(
                    f"table∩{name}: {sorted(table_set & other)}")
        entry_blocks: Dict[int, int] = {}
        for h, e in self._entries.items():
            if e.block in entry_blocks:
                problems.append(f"two entries share block {e.block}")
            entry_blocks[e.block] = e.refs
            if e.refs != table_refs.get(e.block, 0):
                problems.append(
                    f"entry {h:#x} refs={e.refs} but block {e.block} has "
                    f"table multiplicity {table_refs.get(e.block, 0)}")
            if e.refs == 0 and h not in self._evictable:
                problems.append(
                    f"refcount-0 entry {h:#x} not in the evictable FIFO")
        for blk, cnt in table_refs.items():
            if cnt > 1 and blk not in entry_blocks:
                problems.append(
                    f"block {blk} shared by {cnt} tables without an entry")
        evict_blocks = {self._entries[h].block for h in self._evictable
                        if h in self._entries}
        missing = set(self._evictable) - set(self._entries)
        if missing:
            problems.append(f"evictable hashes without entries: "
                            f"{[hex(h) for h in missing]}")
        accounted = (len(free_set) + len(revoked_set) + len(table_set)
                     + len(evict_blocks - table_set))
        if accounted != self._total_blocks:
            problems.append(
                f"{accounted} blocks accounted for "
                f"(free={len(free_set)} revoked={len(revoked_set)} "
                f"table={len(table_set)} evictable={len(evict_blocks)}) "
                f"of {self._total_blocks}")
        if (self.n_blocks + len(self._revoked) + self._revoke_deficit
                != self._total_blocks):
            problems.append(
                f"capacity arithmetic broken: n_blocks={self.n_blocks} "
                f"+ revoked={len(self._revoked)} "
                f"+ deficit={self._revoke_deficit} != {self._total_blocks}")
        if problems:
            raise RuntimeError("block audit failed:\n  "
                               + "\n  ".join(problems))
        return {"free": len(free_set), "revoked": len(revoked_set),
                "deficit": self._revoke_deficit, "in_table": len(table_set),
                "evictable": len(evict_blocks), "capacity": self.n_blocks}

    def report(self) -> Dict[str, float]:
        """Occupancy + fragmentation snapshot. Shared blocks count once
        toward ``used_blocks`` but every request's tokens count toward
        ``used_tokens``, so fragmentation is clamped at 0."""
        used_blocks = self.n_blocks - self.free_blocks
        allocated = used_blocks * self.block_size
        used_tokens = int(self._lengths.sum())
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "used_blocks": used_blocks,
            "free_blocks": self.free_blocks,
            "evictable_blocks": self.evictable_blocks,
            "watermark_blocks": self.watermark_blocks,
            "occupancy": used_blocks / self.n_blocks if self.n_blocks else 0.0,
            "used_tokens": used_tokens,
            "allocated_tokens": allocated,
            "internal_fragmentation": max(
                0.0, 1.0 - used_tokens / allocated) if allocated else 0.0,
            "prefix_blocks_total": self.prefix_blocks_total,
            "prefix_blocks_hit": self.prefix_blocks_hit,
            "revoked_blocks": len(self._revoked),
            "revoke_deficit": self._revoke_deficit,
        }
