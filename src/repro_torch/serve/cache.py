"""Pooled decode cache with per-slot alloc/free (``repro/serve/cache.py``).

One padded cache (the model's ``init_cache(n_slots, max_len)`` dict of
tensors) is shared by all in-flight requests; each request owns one *slot*
— one index along the batch axis of every leaf. Requests of different
lengths coexist because each slot keeps its own write position (the
per-row ``pos`` of ``decode_step``) and the decode mask spans ``[0, pos]``
per row.

The attention families' cache is ``{"k", "v"}`` of ``[L, B, S, Hkv, D]``;
the SSM family's is ``{"conv": [L, B, K-1, C], "ssm": [L, B, H, N, P]}``
(conv in ``cfg.dtype``, ssm in float32); the hybrid's adds the shared
block's ``attn_k`` / ``attn_v`` ``[G, B, S, Hkv, D]`` to per-group state
``gconv`` / ``gssm`` with batch at axis 2 and trailing ``tconv`` /
``tssm`` (zero-size where a model has no trailing blocks, which every
operation carries through); encdec's adds the cross K/V ``ck`` / ``cv``
``[L, B, enc_seq, Hkv, D]``. The batch axis need not be the
same dimension in every leaf, so the pool infers each leaf's once, by
diffing the shapes of two ``init_cache`` probes with different batch
sizes built on ``device="meta"`` (no memory — the counterpart of the
reference's ``jax.eval_shape``). ``write`` replaces
an entire slot row in place, so a recycled slot never sees its previous
tenant's state. Elastic serving revokes idle slots (``shrink``) and
returns them (``expand``); ``capacity`` counts the live slots. The
buffers never reallocate.

Under a serve plan whose pool splits its slots over 'data' the buffers
hold this rank's block of slots (``held``: global slot ``s`` at local row
``s - held.start``), while the free list, ``alloc`` / ``free`` /
``shrink`` / ``expand`` stay global and the same on every rank; ``write``
checks a row on every rank and stores it at its owner only.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import torch


def _batch_axis(a: torch.Tensor, b: torch.Tensor) -> int:
    """Index of the (single) differing dimension between two probes."""
    diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
    if len(diff) != 1:
        raise ValueError(f"cannot locate batch axis: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return diff[0]


class CachePool:
    """Slot-managed decode cache over a model's ``init_cache`` dict.

    Slots are recycled FIFO: freed slots go to the back of the free queue,
    so a request never lands in the most recently vacated row.
    ``model`` is anything with the model's ``init_cache``: under a serve
    plan its ``pools``, whose leaves are this rank's blocks (a slot then
    holds a slice of ``max_len`` where the positions are split over
    ranks, and ``write`` takes rows of that shape; its ``held_slots`` says
    which slots the rank holds); ``max_len`` stays what a request may
    span.
    """

    def __init__(self, model, n_slots: int, max_len: int, device="cuda"):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        probe_a = model.init_cache(3, max_len, device="meta")
        probe_b = model.init_cache(5, max_len, device="meta")
        self.batch_axes = {name: _batch_axis(probe_a[name], probe_b[name])
                           for name in probe_a}
        self.buffers = model.init_cache(n_slots, max_len, device=device)
        held = getattr(model, "held_slots", None)
        #: the global slots whose rows this rank's buffers hold
        self.held = held(n_slots) if held is not None else range(n_slots)
        self._free = deque(range(n_slots))
        self._in_use: set = set()
        #: slots revoked by a scale-down: still in the buffers, withheld
        #: from allocation until a scale-up returns them
        self._revoked: list = []

    def reset(self) -> None:
        """Empty the pool in place: every slot free and live, every buffer
        zeroed. The tensors keep their addresses (the engine's captured
        graphs read them)."""
        for buf in self.buffers.values():
            buf.zero_()
        self._free = deque(range(self.n_slots))
        self._in_use = set()
        self._revoked = []

    # -- slot management -----------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Claim a slot; None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.popleft()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self):
        return frozenset(self._in_use)

    @property
    def capacity(self) -> int:
        """Live slot capacity: all slots but the revoked (the contiguous
        twin of ``BlockManager.n_blocks``)."""
        return self.n_slots - len(self._revoked)

    @property
    def utilization(self) -> float:
        return len(self._in_use) / max(self.capacity, 1)

    # -- elastic capacity ------------------------------------------------------
    def shrink(self, n: int) -> int:
        """Revoke up to ``n`` idle slots (a ``device_fail`` / scale-down on
        the contiguous backend); in-flight rows keep their state and at
        least one slot of capacity survives. Returns the slots revoked."""
        take = max(0, min(int(n), len(self._free), self.capacity - 1))
        for _ in range(take):
            self._revoked.append(self._free.pop())
        return take

    def expand(self, n: int) -> int:
        """Return up to ``n`` revoked slots to the free list. Returns the
        slots restored."""
        give = min(int(n), len(self._revoked))
        for _ in range(give):
            self._free.append(self._revoked.pop())
        return give

    # -- buffer access ---------------------------------------------------------
    def write(self, slot: int, row_cache: dict) -> None:
        """Install a batch-1 cache dict (same ``max_len``) into ``slot``, in
        place, on the rank that holds it (``held``). A row whose non-batch
        dimensions or dtype disagree with the pool (a ``max_len``
        mismatch, most commonly) is rejected on every rank — a short row
        broadcast across a longer slot would corrupt the decode mask's
        invariants."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        for name, buf in self.buffers.items():
            ax = self.batch_axes[name]
            row = row_cache[name]
            expect = buf.shape[:ax] + (1,) + buf.shape[ax + 1:]
            if tuple(row.shape) != tuple(expect):
                raise ValueError(
                    f"row cache leaf shape {tuple(row.shape)} does not match "
                    f"the pool's slot shape {tuple(expect)} (max_len "
                    "mismatch?)")
            if row.dtype != buf.dtype:
                raise ValueError(f"row cache dtype {row.dtype} does not "
                                 f"match the pool's {buf.dtype}")
        if slot not in self.held:
            return
        row = slot - self.held.start
        for name, buf in self.buffers.items():
            buf.select(self.batch_axes[name], row).copy_(
                row_cache[name].select(self.batch_axes[name], 0))

    def read_slot(self, slot: int) -> Optional[dict]:
        """The slot's cache row as a batch-1 dict on the rank that holds it,
        None on the others (tests / debugging)."""
        if slot not in self.held:
            return None
        return {name: buf.narrow(self.batch_axes[name],
                                 slot - self.held.start, 1)
                for name, buf in self.buffers.items()}
