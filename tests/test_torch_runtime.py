"""The port's ``Trainer`` and live Synergy runtime (``repro_torch.train``,
``repro_torch.core.runtime``) against the JAX package's, on the CPU.

* ``Trainer`` over 5 steps for qwen2-0.5b, mamba2-780m and
  phi-3-vision-4.2b at smoke size: the same initial state (the JAX
  trainer's, through ``state_from_jax``) and the same pipeline batches
  (each package's ``DataPipeline`` on one ``DataConfig``; the VLM's patch
  embeddings from one numpy draw). Losses and gradient norms per step at
  1e-5 relative, the final params at 2e-5 absolute plus 1e-4 relative
  (five AdamW steps at lr 1e-3 over f32 gradients summed in other orders)
  but the key bias, whose gradient is 0 in exact arithmetic (the softmax
  cancels it) and so noise that AdamW scales to ~lr a step: held to the
  five steps' size, 5e-3.
* ``tests/test_integration.py:19-35``'s template on the port: the loss
  falls over 20 steps and a checkpoint resumes at its step with equal
  params.
* The runtime: ``_adapt_batch`` draws the reference's arrays;
  ``_profile`` with a stub measure gives the reference's ``W``, demands
  and proportional rate; a two-job ``LiveRuntime`` on the CPU runs a
  first round whose drain terminates both leases (each checkpoints), then
  runs to the end: every job finishes at its ``total_iters`` and each
  resumed lease starts from the step its termination saved.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import runtime as jrt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.core import runtime as rt
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.models.convert import params_to_jax, state_from_jax
from repro_torch.train.optimizer import leaves
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its models are small, and
    the suite runs several workers at once, whose default thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS, BATCH, SEQ = 5, 4, 32


def _patches(cfg, step):
    rng = np.random.default_rng(100 + step)
    return (rng.standard_normal((BATCH, cfg.n_patches, cfg.d_model))
            * 0.02).astype(np.float32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m",
                                  "phi-3-vision-4.2b"])
def test_trainer_matches_jax(arch):
    kw = dict(total_steps=STEPS, warmup_steps=1, peak_lr=1e-3)
    jcfg = jax_config(arch, smoke=True)
    jtr = JTrainer(jcfg, JTrainerConfig(**kw))
    tr = Trainer(get_config(arch, smoke=True), TrainerConfig(**kw),
                 device="cpu")
    tr.state = state_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state),
                              device="cpu")
    dc = dict(n_samples=64, seq_len=SEQ, vocab_size=jcfg.vocab_size, seed=3)
    jgen = JDataPipeline(JDataConfig(**dc), BATCH).batches(STEPS)
    tgen = DataPipeline(DataConfig(**dc), BATCH).batches(STEPS)
    for step, (jb, tb) in enumerate(zip(jgen, tgen)):
        if jcfg.family == "vlm":
            jb = dict(jb, patch_embeds=_patches(jcfg, step))
            tb = dict(tb, patch_embeds=torch.from_numpy(_patches(jcfg,
                                                                 step)))
        want, got = jtr.train_step(jb), tr.train_step(tb)
        assert got["step"] == want["step"] == step + 1
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    ours = params_to_jax(tr.state["params"])
    ref = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, w), (_, g) in zip(jl, tl):
        name = jax.tree_util.keystr(path)
        # the key bias adds q.bk to every score of a row, which the softmax
        # cancels: its gradient is 0 in exact arithmetic and rounding noise
        # in both packages, which AdamW scales up to ~lr a step. Held to the
        # update's size: 5 steps of lr 1e-3
        tol = dict(atol=STEPS * 1e-3, rtol=0) if name.endswith(
            "['bk']") else dict(atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(g, w, **tol, err_msg=name)


def test_train_loss_decreases_and_ckpt_resumes(tmp_path):
    cfg = get_config("llama3.2-1b", smoke=True)
    dc = DataConfig(n_samples=256, seq_len=32, vocab_size=cfg.vocab_size)
    pipe = DataPipeline(dc, batch_size=8)
    ck = str(tmp_path / "t.ckpt")
    tr = Trainer(cfg, TrainerConfig(total_steps=20, peak_lr=1e-3,
                                    ckpt_path=ck, ckpt_every=10),
                 device="cpu")
    hist = tr.fit(pipe.batches(20))
    assert hist[-1]["loss"] < hist[0]["loss"]

    tr2 = Trainer(cfg, TrainerConfig(total_steps=20, ckpt_path=ck),
                  device="cpu")
    assert tr2.maybe_restore()
    assert tr2.step == 20
    for a, b in zip(leaves(tr.state["params"]), leaves(tr2.state["params"])):
        assert torch.allclose(a, b)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-large-v3",
                                  "qwen2-0.5b"])
def test_adapt_batch_matches_reference(arch, tmp_path):
    spec = dict(job_id=1, arch_id=arch, batch_size=3, seq_len=16)
    ours = rt.LiveJob(rt.LiveJobSpec(**spec), str(tmp_path), device="cpu")
    ref = jrt.LiveJob(jrt.LiveJobSpec(**spec), str(tmp_path))
    cfg = get_config(arch, smoke=True)
    toks = np.zeros((3, 16), np.int32)
    for step in (0, 7):
        got = ours._adapt_batch(cfg, {"tokens": toks}, step)
        want = ref._adapt_batch(jax_config(arch, smoke=True),
                                {"tokens": toks}, step)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_profile_with_stub_measure_matches_reference(tmp_path):
    """The live profile's W, demands and proportional rate from the same
    measured curve (a stub: a knee at 3 CPUs)."""
    def curve(c):
        return 40.0 * min(c, 3.0) / 3.0 + 0.5 * c

    ours = rt.LiveRuntime(n_servers=1, ckpt_dir=str(tmp_path), device="cpu")
    ref = jrt.LiveRuntime(n_servers=1, ckpt_dir=str(tmp_path))
    for i, arch in enumerate(("mamba2-780m", "phi-3-vision-4.2b")):
        spec = dict(job_id=i, arch_id=arch, total_iters=12, batch_size=4)
        lj = rt.LiveJob(rt.LiveJobSpec(**spec), str(tmp_path), device="cpu")
        jlj = jrt.LiveJob(jrt.LiveJobSpec(**spec), str(tmp_path))
        ours._measure_rate = lambda job, c: curve(c)
        ref._measure_rate = lambda job, c: curve(c)
        ours._profile(lj)
        ref._profile(jlj)
        a, b = lj.sched_job, jlj.sched_job
        np.testing.assert_array_equal(a.matrix.W, b.matrix.W)
        assert a.matrix.profile_probes == b.matrix.profile_probes
        assert (a.demand_cpu, a.demand_mem, a.prop_rate) == (
            b.demand_cpu, b.demand_mem, b.prop_rate)
        assert (a.model_name, a.duration, a.gpu_demand) == (
            b.model_name, b.duration, b.gpu_demand)


def test_live_runtime_finishes_and_resumes_a_terminated_lease(tmp_path):
    runtime = rt.LiveRuntime(n_servers=1, policy="srtf", allocator="tune",
                             round_seconds=0.2, probe_iters=1,
                             ckpt_dir=str(tmp_path), device="cpu")
    for i, arch in enumerate(("qwen2-0.5b", "mamba2-780m")):
        runtime.submit(rt.LiveJobSpec(i, arch, total_iters=30, batch_size=2,
                                      preprocess_cost_s=0.001,
                                      dataset_gb=0.05, seq_len=16))
    first = runtime.run(max_rounds=1)       # the drain ends both leases
    assert first["finished"] == 0, first
    for lj in runtime.jobs.values():
        assert len(lj.saves) == 1 and not lj.restores
        assert lj.iters_done == lj.saves[0] < 30
    m = runtime.run(max_rounds=100)
    assert m["finished"] == 2 and m["avg_jct"] > 0, m
    for lj in runtime.jobs.values():
        assert lj.iters_done == lj.spec.total_iters == lj.trainer.step
        assert lj.restores == lj.saves
        assert lj.sched_job.n_preemptions >= 1
