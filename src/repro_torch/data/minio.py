"""MinIO-style DNN-aware cache model ([41], §3.1, §6; a copy of
``repro/data/minio.py``).

Properties the paper relies on (and we implement):
  * a FIXED subset of the dataset is cached for an entire epoch — no
    thrashing, so the per-epoch hit rate is exactly capacity/dataset and
    therefore *predictable* (this is what licenses optimistic profiling);
  * per-job isolation: each job owns its cache instance sized by the
    scheduler's memory allocation (unlike the shared OS page cache);
  * capacity is adjustable between rounds when the allocation changes.

The cached subset is chosen deterministically by a multiplicative hash of the
sample index so that resizing keeps a nested subset (a bigger cache strictly
contains a smaller one — no re-warm penalty on grow).
"""
from __future__ import annotations

from dataclasses import dataclass


_PHI = 0x9E3779B97F4A7C15
_MASK = (1 << 64) - 1


def _hash01(idx: int) -> float:
    return (((int(idx) + 1) * _PHI) & _MASK) / float(1 << 64)


@dataclass
class MinIOCache:
    n_samples: int
    sample_bytes: int
    capacity_bytes: int = 0
    hits: int = 0
    misses: int = 0

    @property
    def n_cached(self) -> int:
        if self.sample_bytes <= 0:
            return self.n_samples
        return min(self.n_samples, self.capacity_bytes // self.sample_bytes)

    @property
    def hit_rate(self) -> float:
        return self.n_cached / max(self.n_samples, 1)

    def set_capacity(self, capacity_bytes: int) -> None:
        self.capacity_bytes = max(0, int(capacity_bytes))

    def set_capacity_gb(self, gb: float) -> None:
        self.set_capacity(int(gb * (1 << 30)))

    def lookup(self, idx: int) -> bool:
        """True = cache hit. Deterministic nested-subset membership."""
        hit = _hash01(idx) < self.hit_rate
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        return hit

    def observed_hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = 0
