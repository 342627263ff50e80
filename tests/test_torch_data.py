"""The data path on the port (``repro_torch.data``, ``core.iterator``)
against the JAX package's, on the CPU.

Held exactly: ``MinIOCache``'s ``n_cached``, ``hit_rate`` and ``lookup``
sequences across resizes (nested subsets on growth); ``DataPipeline``'s
batches over three epochs at 1 and 3 workers in both parallel modes
(the port's int32 torch tensors against the reference's numpy arrays,
element by element), its epoch orders, cache hits and misses and virtual
fetch seconds; ``SynergyIterator``'s lease, termination and progress
semantics. Templates: ``tests/test_integration.py:53-88`` and
``tests/test_scheduler.py:225``.
"""
import numpy as np
import pytest
import torch

from repro.core import iterator as J_it
from repro.data import minio as J_minio
from repro.data import pipeline as J_pipe
from repro_torch.core import iterator as P_it
from repro_torch.data import minio as P_minio
from repro_torch.data import pipeline as P_pipe

SIDES = {"jax": (J_minio, J_pipe, J_it), "port": (P_minio, P_pipe, P_it)}


def _array(x):
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int32 and x.device.type == "cpu"
        return x.numpy()
    return x


def _lookups(cache, n):
    return [cache.lookup(i) for i in range(n)]


def test_minio_cache_matches():
    out = {}
    for side in SIDES:
        minio = SIDES[side][0]
        c = minio.MinIOCache(n_samples=1000, sample_bytes=1 << 20)
        log = [(c.n_cached, c.hit_rate)]
        for gb in (0.0, 0.2, 0.5, 0.7, 1.5, 0.1):
            c.set_capacity_gb(gb)
            c.reset_stats()
            log.append((c.capacity_bytes, c.n_cached, c.hit_rate,
                        _lookups(c, 1000), c.hits, c.misses,
                        c.observed_hit_rate()))
        c.set_capacity(-5)
        log.append((c.capacity_bytes, c.n_cached))
        free = minio.MinIOCache(n_samples=10, sample_bytes=0)
        log.append((free.n_cached, free.hit_rate, _lookups(free, 10)))
        out[side] = log
    assert out["port"] == out["jax"]
    # the reference's properties: a fixed per-epoch hit rate, and a bigger
    # cache holds the smaller one's samples
    c = P_minio.MinIOCache(n_samples=1000, sample_bytes=1 << 20)
    c.set_capacity_gb(0.5)
    assert abs(sum(_lookups(c, 1000)) - 512) < 60
    c.set_capacity_gb(0.2)
    small = {i for i, hit in enumerate(_lookups(c, 1000)) if hit}
    c.set_capacity_gb(0.7)
    big = {i for i, hit in enumerate(_lookups(c, 1000)) if hit}
    assert small and small <= big and len(big) > len(small)


def _run_pipeline(side, mode, workers, cache_gb, cost=0.0, n=12):
    pipe_mod = SIDES[side][1]
    cfg = pipe_mod.DataConfig(n_samples=40, seq_len=16, vocab_size=128,
                              preprocess_cost_s=cost, sample_bytes=1 << 20,
                              parallel_mode=mode, seed=3)
    pipe = pipe_mod.DataPipeline(cfg, batch_size=8, n_workers=workers)
    pipe.set_cache_gb(cache_gb)
    orders = [pipe.epoch_indices().tolist()]
    batches = []
    for b in pipe.batches(n):             # 5 batches an epoch: 3 epochs
        batches.append((_array(b["tokens"]), _array(b["labels"])))
    orders.append(pipe.epoch_indices().tolist())
    raw = [pipe.dataset.raw(i) for i in (0, 7, 39)]
    stats = (pipe.cache.hits, pipe.cache.misses, pipe.virtual_fetch_seconds,
             pipe.samples_out, pipe.n_workers, len(pipe.dataset))
    pipe.close()
    return batches, orders, raw, stats


@pytest.mark.parametrize("mode", ["scaled", "pool"])
@pytest.mark.parametrize("workers", [1, 3])
def test_pipeline_batches_match(mode, workers):
    got = _run_pipeline("port", mode, workers, 0.02)
    ref = _run_pipeline("jax", mode, workers, 0.02)
    assert len(got[0]) == len(ref[0]) == 12
    for (t, l), (rt, rl) in zip(got[0], ref[0]):
        assert t.dtype == rt.dtype == np.int32 and t.shape == (8, 16)
        assert np.array_equal(t, rt) and np.array_equal(l, rl)
    assert got[1] == ref[1] and got[1][0] != got[1][1]
    assert all(np.array_equal(a, b) for a, b in zip(got[2], ref[2]))
    if mode == "scaled" or workers == 1:   # one thread counts: no race
        assert got[3] == ref[3]
        hits, misses, fetch_s = got[3][:3]
        assert hits + misses == 96 and hits > 0 and misses > 0
        assert fetch_s == pytest.approx(misses * (1 << 20) / 500e6)
    # the labels are the tokens shifted by one, rolled by the epoch
    t, l = got[0][0]
    assert np.array_equal(t[:, 1:], l[:, :-1])


def test_pipeline_cache_and_workers_knobs_match():
    fetch = {}
    for gb in (0.0, 0.01, 0.03):
        got = _run_pipeline("port", "scaled", 2, gb, cost=1e-4, n=5)
        assert got[3] == _run_pipeline("jax", "scaled", 2, gb, cost=1e-4,
                                       n=5)[3]
        fetch[gb] = got[3][2]
    # a bigger cache, fewer virtual fetch seconds (test_integration.py:80)
    assert fetch[0.0] > fetch[0.01] > fetch[0.03]
    pipe = P_pipe.DataPipeline(P_pipe.DataConfig(n_samples=16), 4)
    for n, want in ((3, 3), (0, 1), (-2, 1), (2.7, 2)):
        pipe.set_workers(n)
        assert pipe.n_workers == want
    pipe.set_cache_gb(0.25)
    assert pipe.cache.capacity_bytes == int(0.25 * (1 << 30))
    pipe.close()


def _iterate(side):
    _, pipe_mod, it_mod = SIDES[side]
    pipe = pipe_mod.DataPipeline(pipe_mod.DataConfig(
        n_samples=64, seq_len=16, vocab_size=128), batch_size=4, n_workers=1)
    ch = it_mod.ControlChannel(0)
    called = []
    it = it_mod.SynergyIterator(0, pipe, ch,
                                on_terminate=lambda: called.append(1))
    gen = iter(it)
    log = [_array(next(gen)["tokens"]).tolist()]
    ch.send_lease(cpus=2.6, mem_gb=0.25)
    log.append((pipe.n_workers, pipe.cache.capacity_bytes))
    log.append(_array(next(gen)["tokens"]).tolist())
    log.append((pipe.n_workers, pipe.cache.capacity_bytes, it.iters))
    ch.send_lease(cpus=1, mem_gb=0.0)
    ch.send_lease(cpus=4, mem_gb=0.5)            # both apply, the last wins
    next(gen)
    log.append((pipe.n_workers, pipe.cache.capacity_bytes))
    log.append([(p.job_id, p.iters) for p in ch.drain_progress()])
    ch.terminate()
    rest = list(gen)
    log.append((len(rest), len(called), it.terminated, it.iters,
                [(p.job_id, p.iters) for p in ch.drain_progress()]))
    log.append(ch.drain_progress())
    pipe.close()
    return log


def test_synergy_iterator_matches():
    got = _iterate("port")
    assert got == _iterate("jax")
    # a lease shows on the next batch; termination calls back once and
    # stops; one progress message an iteration
    assert got[3][:2] == (3, int(0.25 * (1 << 30)))
    assert got[4] == (4, int(0.5 * (1 << 30)))
    assert got[5] == [(0, 1), (0, 2)]
    assert got[6] == (0, 1, True, 3, [(0, 3)])
    # report_every thins the progress stream
    pipe = P_pipe.DataPipeline(P_pipe.DataConfig(n_samples=64, seq_len=8),
                               batch_size=4)
    ch = P_it.ControlChannel(5)
    it = P_it.SynergyIterator(5, pipe, ch, report_every=2)
    gen = iter(it)
    for _ in range(6):
        next(gen)
    assert [(p.job_id, p.iters) for p in ch.drain_progress()] == [
        (5, 2), (5, 4)]
    pipe.close()
