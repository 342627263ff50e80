"""Input pipeline with real, tunable CPU preprocessing cost (a copy of
``repro/data/pipeline.py``).

This is the resource Synergy arbitrates, so it is not a stub: every sample is
(1) fetched — cache hit via MinIO or a (simulated or slept) storage read, and
(2) preprocessed — a calibrated numpy compute kernel that releases the GIL,
so the worker-pool size (== the job's CPU allocation) genuinely changes
throughput on a real machine. ``set_workers`` / ``set_cache_gb`` are the two
knobs the Synergy scheduler turns at every round via the iterator lease.

Samples are deterministic functions of (seed, index): the same corpus
regardless of CPU/cache allocation, so training curves are reproducible.
Samples and epoch orders come from numpy's generators as in the reference,
so both packages give the same corpus element by element. Batches are
``{"tokens", "labels"}`` as int32 torch tensors on the host; the consumer
moves them to its device.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.minio import MinIOCache


@dataclass(frozen=True)
class DataConfig:
    n_samples: int = 4096
    seq_len: int = 64
    vocab_size: int = 512
    preprocess_cost_s: float = 0.0      # CPU-seconds of work per sample
    sample_bytes: int = 1 << 20          # 1 MB/sample on "storage"
    disk_bw_bytes: float = 500e6         # 500 MB/s
    simulate_io: bool = True             # virtual fetch clock (no sleeping)
    # 'pool': real ThreadPool parallelism (needs >1 physical cores);
    # 'scaled': burn cost/n_workers serially: ideal CPU scaling, independent
    # of how many cores the host has.
    parallel_mode: str = "scaled"
    seed: int = 0


_CAL_LOCK = threading.Lock()
_CAL_OPS_PER_SEC: Optional[float] = None
_CAL_K = 96


def _burn_unit() -> None:
    """One calibration unit of GIL-releasing numpy work."""
    a = np.full((_CAL_K, _CAL_K), 1.0003)
    np.dot(a, a)


def _ops_per_second() -> float:
    global _CAL_OPS_PER_SEC
    with _CAL_LOCK:
        if _CAL_OPS_PER_SEC is None:
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < 0.1:
                _burn_unit()
                n += 1
            _CAL_OPS_PER_SEC = n / (time.perf_counter() - t0)
        return _CAL_OPS_PER_SEC


def _preprocess_burn(cost_s: float) -> None:
    if cost_s <= 0:
        return
    units = max(1, int(cost_s * _ops_per_second()))
    for _ in range(units):
        _burn_unit()


class SyntheticDataset:
    """Deterministic token corpus: sample i is PRNG(seed, i)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def __len__(self) -> int:
        return self.cfg.n_samples

    def raw(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed << 32) ^ idx)
        return rng.integers(0, self.cfg.vocab_size,
                            size=self.cfg.seq_len + 1).astype(np.int32)


class DataPipeline:
    """Fetch -> MinIO cache -> preprocess(worker pool) -> batch."""

    def __init__(self, cfg: DataConfig, batch_size: int,
                 n_workers: int = 1, cache=None):
        self.cfg = cfg
        self.dataset = SyntheticDataset(cfg)
        self.batch_size = batch_size
        self.cache = cache or MinIOCache(cfg.n_samples, cfg.sample_bytes)
        self._n_workers = max(1, int(n_workers))
        self._pool = ThreadPoolExecutor(max_workers=self._n_workers)
        self._epoch = 0
        self.virtual_fetch_seconds = 0.0     # simulated storage time
        self.samples_out = 0

    # -- the Synergy knobs -----------------------------------------------------
    def set_workers(self, n: int) -> None:
        n = max(1, int(n))
        if n != self._n_workers:
            old = self._pool
            self._n_workers = n
            self._pool = ThreadPoolExecutor(max_workers=n)
            old.shutdown(wait=False)

    def set_cache_gb(self, gb: float) -> None:
        self.cache.set_capacity_gb(gb)

    @property
    def n_workers(self) -> int:
        return self._n_workers

    # -- sample path -------------------------------------------------------------
    def _fetch(self, idx: int) -> np.ndarray:
        if not self.cache.lookup(idx):
            dt = self.cfg.sample_bytes / self.cfg.disk_bw_bytes
            if self.cfg.simulate_io:
                self.virtual_fetch_seconds += dt
            else:
                time.sleep(dt)
        return self.dataset.raw(idx)

    def _sample(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        raw = self._fetch(idx)
        cost = self.cfg.preprocess_cost_s
        if self.cfg.parallel_mode == "scaled":
            cost = cost / self._n_workers
        _preprocess_burn(cost)
        # the actual transform: deterministic augmentation (roll by epoch)
        toks = np.roll(raw, self._epoch)
        return toks[:-1], toks[1:]

    # -- batching ------------------------------------------------------------------
    def epoch_indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.cfg.seed + 7919 * self._epoch)
        return rng.permutation(len(self.dataset))

    def __iter__(self) -> Iterator[dict]:
        idxs = self.epoch_indices()
        n_full = len(idxs) // self.batch_size
        for b in range(n_full):
            batch_idx = idxs[b * self.batch_size:(b + 1) * self.batch_size]
            if self.cfg.parallel_mode == "scaled":
                results = [self._sample(i) for i in batch_idx]
            else:
                results = list(self._pool.map(self._sample, batch_idx))
            tokens = np.stack([r[0] for r in results])
            labels = np.stack([r[1] for r in results])
            self.samples_out += len(batch_idx)
            yield {"tokens": torch.from_numpy(tokens),
                   "labels": torch.from_numpy(labels)}
        self._epoch += 1

    def batches(self, n: int) -> Iterator[dict]:
        """Yield exactly n batches, crossing epochs as needed."""
        got = 0
        while got < n:
            for batch in self:
                yield batch
                got += 1
                if got >= n:
                    return

    def close(self) -> None:
        self._pool.shutdown(wait=False)
