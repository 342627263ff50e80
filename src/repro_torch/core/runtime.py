"""Live round-based runtime: real training jobs under Synergy control (a
port of ``repro/core/runtime.py``).

Jobs are threads running real train steps (``repro_torch.train.Trainer``)
of the assigned architectures (reduced configs) through real data
pipelines, on the card unless ``device="cpu"``; the scheduler's round loop
recomputes placements with the same policies and mechanisms as the
simulator and pushes CPU-worker / MinIO-capacity leases to each job's
Synergy iterator. Job throughputs are measured from train steps (the
optimistic profiler's probes); nothing in the placement comes from the
analytic model but the memory fill the reference also models.

Accelerator slots are virtual: every job of every server runs on the one
device, and the pipeline runs in its "scaled" mode, as in the reference.
A terminated lease checkpoints through the iterator's ``on_terminate``
and the next lease resumes from that step (``LiveJob.saves`` and
``restores`` list the steps of each; the reference keeps no such record).
The kernels' launch counters are not atomic across the job threads: read
them as "some" and "none" here.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.allocators import get_allocator
from repro_torch.core.cluster import Cluster, ServerSpec
from repro_torch.core.iterator import ControlChannel, SynergyIterator
from repro_torch.core.job import Job
from repro_torch.core.policies import get_policy
from repro_torch.core.profiler import OptimisticProfiler, ProfilerConfig
from repro_torch.core.sensitivity import (ARCH_SENSITIVITY, MODEL_ZOO,
                                          WorkloadModel)
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.train.trainer import Trainer, TrainerConfig


@dataclass
class LiveJobSpec:
    job_id: int
    arch_id: str
    total_iters: int = 40
    batch_size: int = 8
    gpu_demand: int = 1
    preprocess_cost_s: float = 0.002
    dataset_gb: float = 2.0
    sample_mb: float = 1.0
    seq_len: int = 32
    arrival_time: float = 0.0


class LiveJob:
    def __init__(self, spec: LiveJobSpec, ckpt_dir: str, device="cuda"):
        self.spec = spec
        self.device = device
        self.channel = ControlChannel(spec.job_id)
        n_samples = int(spec.dataset_gb * 1024 / spec.sample_mb)
        self.data_cfg = DataConfig(
            n_samples=n_samples, seq_len=spec.seq_len,
            vocab_size=get_config(spec.arch_id, smoke=True).vocab_size,
            preprocess_cost_s=spec.preprocess_cost_s,
            sample_bytes=int(spec.sample_mb * (1 << 20)),
            simulate_io=False, parallel_mode="scaled", seed=spec.job_id)
        self.ckpt_path = os.path.join(ckpt_dir, f"job{spec.job_id}.ckpt")
        self.pipeline: Optional[DataPipeline] = None
        self.trainer: Optional[Trainer] = None
        self.thread: Optional[threading.Thread] = None
        self.iters_done = 0
        self.running = False
        self.done = threading.Event()
        self.sched_job: Optional[Job] = None   # core Job seen by the allocator
        self.progress_log: List = []           # (t, iters)
        self.submit_time: Optional[float] = None
        self.finish_wall: Optional[float] = None
        self.saves: List[int] = []             # steps checkpointed at a
        self.restores: List[int] = []          # termination / resumed from
        self.error: Optional[BaseException] = None

    # -- training thread -----------------------------------------------------
    def _make_trainer(self) -> Trainer:
        cfg = get_config(self.spec.arch_id, smoke=True)
        tcfg = TrainerConfig(total_steps=self.spec.total_iters,
                             ckpt_path=self.ckpt_path, warmup_steps=2)
        tr = Trainer(cfg, tcfg, device=self.device)
        if tr.maybe_restore():
            self.restores.append(tr.step)
        return tr

    def _adapt_batch(self, cfg, batch: dict, step: int) -> dict:
        """Add the stub modality-frontend embeddings (the reference's
        numpy draws, seeded by the step)."""
        b = batch["tokens"].shape[0]
        rng = np.random.default_rng(step)
        if cfg.family == "encdec":
            batch = dict(batch)
            batch["frames"] = rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.02
        elif cfg.family == "vlm":
            batch = dict(batch)
            batch["patch_embeds"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        return batch

    def start(self, cpus: float, mem_gb: float) -> None:
        assert not self.running
        self.pipeline = DataPipeline(self.data_cfg, self.spec.batch_size,
                                     n_workers=max(1, int(round(cpus))))
        self.pipeline.set_cache_gb(mem_gb)
        self.running = True

        def save(trainer):
            trainer.save()
            self.saves.append(trainer.step)

        def main():
            try:
                trainer = self._make_trainer()
                self.trainer = trainer
                self.iters_done = int(trainer.step)
                it = SynergyIterator(self.spec.job_id, self.pipeline,
                                     self.channel,
                                     on_terminate=lambda: save(trainer))
                for batch in it:
                    batch = self._adapt_batch(trainer.cfg, batch,
                                              self.iters_done)
                    trainer.train_step(batch)
                    self.iters_done = int(trainer.step)
                    self.progress_log.append((time.time(), self.iters_done))
                    if self.iters_done >= self.spec.total_iters:
                        self.finish_wall = time.time()
                        self.done.set()
                        break
            except BaseException as e:      # surfaced by LiveRuntime.run
                self.error = e
            finally:
                self.running = False
                self.pipeline.close()

        self.thread = threading.Thread(target=main, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        """Terminate the lease: checkpoint + stop the thread."""
        if self.running:
            self.channel.terminate()
            self.thread.join(timeout=30.0)
            self.running = False
            if self.sched_job is not None:
                self.sched_job.n_preemptions += 1

    def update_lease(self, cpus: float, mem_gb: float) -> None:
        self.channel.send_lease(cpus, mem_gb)


class LiveRuntime:
    def __init__(self, n_servers: int = 2,
                 spec: ServerSpec = ServerSpec(gpus=2, cpus=6.0, mem=4.0),
                 policy: str = "srtf", allocator: str = "tune",
                 round_seconds: float = 2.0, probe_iters: int = 2,
                 ckpt_dir: Optional[str] = None, device="cuda"):
        self.cluster = Cluster(n_servers, spec)
        self.policy = get_policy(policy, self.cluster)
        self.allocator = get_allocator(allocator)
        self.round_seconds = round_seconds
        self.probe_iters = probe_iters
        self.device = device
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="synergy_ckpt_")
        self.profiler = OptimisticProfiler(
            spec, ProfilerConfig(mem_unit_gb=1.0, min_mem_gb=0.0))
        self.jobs: Dict[int, LiveJob] = {}
        self.round_log: List[Dict] = []

    # -- live optimistic profiling ------------------------------------------------
    def _measure_rate(self, lj: LiveJob, cpus: float) -> float:
        """Actually run a few train steps at this CPU allocation, full
        cache."""
        pipeline = DataPipeline(lj.data_cfg, lj.spec.batch_size,
                                n_workers=max(1, int(round(cpus))))
        pipeline.set_cache_gb(lj.data_cfg.n_samples * lj.data_cfg.sample_bytes
                              / (1 << 30) + 1.0)
        trainer = lj._make_trainer()
        gen = pipeline.batches(self.probe_iters + 1)
        trainer.train_step(lj._adapt_batch(trainer.cfg, next(gen), 0))  # warmup
        t0 = time.perf_counter()
        n = 0
        for batch in gen:
            trainer.train_step(lj._adapt_batch(trainer.cfg, batch, n))
            n += 1
        dt = time.perf_counter() - t0
        pipeline.close()
        return n * lj.spec.batch_size / max(dt, 1e-9)

    def _profile(self, lj: LiveJob) -> None:
        spec = lj.spec
        wm = WorkloadModel(
            name=spec.arch_id, task=MODEL_ZOO[ARCH_SENSITIVITY[spec.arch_id]].task,
            batch_per_gpu=spec.batch_size, t_gpu=1.0, k_cpu=0.0,
            sample_mb=spec.sample_mb, dataset_gb=spec.dataset_gb,
            disk_bw_mbps=lj.data_cfg.disk_bw_bytes / 1e6)
        mat = self.profiler.profile(wm, spec.gpu_demand,
                                    measure_fn=lambda c: self._measure_rate(lj, c))
        j = Job(job_id=spec.job_id, model_name=ARCH_SENSITIVITY[spec.arch_id],
                gpu_demand=spec.gpu_demand, arrival_time=spec.arrival_time,
                duration=spec.total_iters, arch_id=spec.arch_id)
        j.matrix = mat
        cg, mg = self.cluster.proportional_demand(spec.gpu_demand)
        j.prop_rate = mat.rate(cg, mg)
        j.demand_cpu, j.demand_mem = mat.best_demand(floor_rate=j.prop_rate)
        lj.sched_job = j

    # -- public API -------------------------------------------------------------
    def submit(self, spec: LiveJobSpec) -> None:
        lj = LiveJob(spec, self.ckpt_dir, self.device)
        lj.submit_time = time.time()
        self._profile(lj)
        self.jobs[spec.job_id] = lj

    def _raise_job_errors(self) -> None:
        for lj in self.jobs.values():
            if lj.error is not None:
                raise RuntimeError(f"live job {lj.spec.job_id} "
                                   f"({lj.spec.arch_id}) failed") from lj.error

    def run(self, max_rounds: int = 100) -> Dict:
        t_start = time.time()
        for rnd in range(max_rounds):
            self._raise_job_errors()
            active = {jid: lj for jid, lj in self.jobs.items()
                      if not lj.done.is_set()}
            if not active:
                break
            queue = [lj.sched_job for lj in active.values()]
            # remaining work for SRTF: iters left at measured base rate
            for lj in active.values():
                lj.sched_job.remaining = max(
                    1e-9, lj.spec.total_iters - lj.iters_done)
            self.cluster.release_all()
            ordered = self.policy.order(queue, time.time() - t_start)
            plan = self.allocator.schedule(self.cluster, ordered)

            for jid, lj in active.items():
                if jid in plan.scheduled:
                    c, m = plan.scheduled[jid]
                    if not lj.running:
                        lj.start(c, m)
                    else:
                        lj.update_lease(c, m)
                elif lj.running:
                    lj.stop()

            self.round_log.append({
                "round": rnd,
                "t": time.time() - t_start,
                "scheduled": sorted(plan.scheduled),
                "util": self.cluster.utilization(),
            })
            deadline = time.time() + self.round_seconds
            while time.time() < deadline:
                if all(lj.done.is_set() for lj in active.values()):
                    break
                time.sleep(0.05)

        # drain: stop any stragglers
        for lj in self.jobs.values():
            if lj.running:
                lj.stop()
        self._raise_job_errors()
        return self.metrics(t_start)

    def metrics(self, t_start: float) -> Dict:
        jcts = []
        for lj in self.jobs.values():
            if lj.finish_wall is not None:
                jcts.append(lj.finish_wall - t_start - lj.spec.arrival_time)
        makespan = max((lj.finish_wall or time.time()) for lj in
                       self.jobs.values()) - t_start if self.jobs else 0.0
        return {
            "avg_jct": float(np.mean(jcts)) if jcts else float("nan"),
            "p99_jct": float(np.percentile(jcts, 99)) if jcts else float("nan"),
            "makespan": makespan,
            "finished": len(jcts),
            "total": len(self.jobs),
        }
