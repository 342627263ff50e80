"""Block-table KV manager (``repro/serve/paged.py:73-426``, ``:530-641``).

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

The pools are torch tensors on the engine's device (the model's
``PagedCache``); tables and every other piece of bookkeeping stay numpy on
the host. The reference's ``shrink`` / ``expand`` / ``grow_physical`` /
``flush_prefix`` (chaos and elastic serving) are ported later (ROADMAP
queue A, item 8).
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.moe import capacity


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


class BlockManager:
    """Paged decode cache over a model's ``init_paged_cache``: the pool
    surface the scheduler drives (``alloc_for`` / ``free`` /
    ``validate_request``) plus the per-boundary calls of the engine
    (``ensure``, ``drain_dirty``, ``report``) and the prefix-cache surface
    (``cached_tokens``, ``resume_state``, ``commit_block``)."""

    def __init__(self, model, n_slots: int, max_len: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 watermark: float = 0.05, dtype=None,
                 prefix_cache: bool = False, device="cuda"):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)   # table width per slot
        self.n_blocks = (n_blocks if n_blocks is not None
                         else n_slots * self.max_blocks)
        self.watermark_blocks = math.ceil(watermark * self.n_blocks)
        self.buffers = model.init_paged_cache(self.n_blocks, block_size,
                                              dtype, device=device)
        self.prefix_cache = prefix_cache
        self._clear()

    def _clear(self) -> None:
        """Every block and slot free, the tables -1, the prefix cache
        empty."""
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

    def reset(self) -> None:
        """Empty the pool in place: the pools zeroed, the host bookkeeping
        rebuilt. The pool tensors keep their addresses (the engine's
        captured graphs read them)."""
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
        return self._entries.pop(h).block

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

    def _blocks_clear_watermark(self, n_new_blocks: int) -> bool:
        """``n_new_blocks`` fresh blocks fit while the reserve stays free."""
        return self.free_blocks - n_new_blocks >= self.watermark_blocks

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
                if e is None:
                    break
                if not e.ready:
                    self.deferred_last_alloc = True
                    return None
                hits += 1
                # reviving a refcount-0 block costs no new block but still
                # shrinks availability: charge it
                revived += e.refs == 0
        if (not self._free_slots
                or not self._blocks_clear_watermark(need - hits + revived)):
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
        have = int((self.tables[slot] >= 0).sum())
        while have * self.block_size < n_tokens:
            if not self._free_blocks and not self._evictable:
                return False
            self.tables[slot, have] = self._take_block()
            self._dirty_slots.add(slot)
            have += 1
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
        for j in range(self.max_blocks):
            blk = int(self.tables[slot, j])
            if blk < 0:
                continue
            h = chain[j][0] if j < len(chain) else None
            e = self._entries.get(h) if h is not None else None
            if e is not None and e.block == blk:
                e.refs -= 1
                if e.refs == 0:
                    if e.ready:
                        self._evictable[h] = None
                    else:          # owner left before writing: unservable
                        del self._entries[h]
                        self._free_blocks.append(blk)
            else:
                self._free_blocks.append(blk)
        self.tables[slot] = -1
        self._dirty_slots.add(slot)
        self._lengths[slot] = 0
        self._cached_tokens[slot] = 0
        self._resume.pop(slot, None)
        self._free_slots.append(slot)

    def audit(self) -> Dict[str, int]:
        """Block-conservation check: every block is in exactly one of {free
        list, a table (counted once across sharers), evictable cache}, each
        entry's refcount equals its block's table multiplicity, and idle
        slots hold no blocks. Raises RuntimeError on any violation."""
        problems: List[str] = []
        free = list(self._free_blocks)
        free_set = set(free)
        if len(free_set) != len(free):
            problems.append(f"duplicate blocks in the free list: {free}")
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
        if table_set & free_set:
            problems.append(f"table∩free: {sorted(table_set & free_set)}")
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
        accounted = (len(free_set) + len(table_set)
                     + len(evict_blocks - table_set))
        if accounted != self.n_blocks:
            problems.append(
                f"{accounted} blocks accounted for (free={len(free_set)} "
                f"table={len(table_set)} evictable={len(evict_blocks)}) "
                f"of {self.n_blocks}")
        if problems:
            raise RuntimeError("block audit failed:\n  "
                               + "\n  ".join(problems))
        return {"free": len(free_set), "in_table": len(table_set),
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
        }
