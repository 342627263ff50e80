"""The Synergy iterator (§4.3; a copy of ``repro/core/iterator.py``): the
thin API between scheduler and DNN job.

The paper wraps PyTorch/DALI iterators and talks gRPC; here the iterator
wraps the ``DataPipeline`` and talks over an in-process, thread-safe
control channel (the live runtime runs jobs as threads — a process+gRPC
transport would carry the same three message types):

  scheduler -> job:  LeaseUpdate(cpus, mem_gb)  |  LeaseTerminate
  job -> scheduler:  Progress(iters, t)

On ``LeaseUpdate`` the iterator retunes the pipeline (worker count == CPU
allocation, MinIO capacity == memory allocation). On ``LeaseTerminate`` it
checkpoints via the provided callback and stops iteration; the runtime
re-registers the job when it is scheduled again.
"""
from __future__ import annotations

import queue
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional


@dataclass
class LeaseUpdate:
    cpus: float
    mem_gb: float


class LeaseTerminate:
    pass


@dataclass
class Progress:
    job_id: int
    iters: int
    t: float


class ControlChannel:
    """Per-job bidirectional channel (in-process stand-in for gRPC)."""

    def __init__(self, job_id: int):
        self.job_id = job_id
        self.to_job: "queue.Queue" = queue.Queue()
        self.to_scheduler: "queue.Queue" = queue.Queue()

    # scheduler side
    def send_lease(self, cpus: float, mem_gb: float) -> None:
        self.to_job.put(LeaseUpdate(cpus, mem_gb))

    def terminate(self) -> None:
        self.to_job.put(LeaseTerminate())

    def drain_progress(self):
        out = []
        while True:
            try:
                out.append(self.to_scheduler.get_nowait())
            except queue.Empty:
                return out


class SynergyIterator:
    """Wraps a DataPipeline; applies leases; reports progress."""

    def __init__(self, job_id: int, pipeline, channel: ControlChannel,
                 on_terminate: Optional[Callable[[], None]] = None,
                 report_every: int = 1):
        self.job_id = job_id
        self.pipeline = pipeline
        self.channel = channel
        self.on_terminate = on_terminate
        self.report_every = report_every
        self.iters = 0
        self.terminated = False

    def _poll_control(self) -> bool:
        """Apply pending control messages; False => lease terminated."""
        while True:
            try:
                msg = self.channel.to_job.get_nowait()
            except queue.Empty:
                return True
            if isinstance(msg, LeaseUpdate):
                self.pipeline.set_workers(int(round(msg.cpus)))
                self.pipeline.set_cache_gb(msg.mem_gb)
            elif isinstance(msg, LeaseTerminate):
                return False

    def __iter__(self) -> Iterator[dict]:
        gen = self.pipeline.batches(10 ** 9)
        while True:
            if not self._poll_control():
                self.terminated = True
                if self.on_terminate:
                    self.on_terminate()
                return
            try:
                batch = next(gen)
            except StopIteration:
                return
            yield batch
            self.iters += 1
            if self.iters % self.report_every == 0:
                self.channel.to_scheduler.put(
                    Progress(self.job_id, self.iters, time.time()))
