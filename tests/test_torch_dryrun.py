"""The port's dry-run and roofline tooling (``repro_torch/launch/dryrun.py``,
``run_all_dryruns.py``, ``roofline.py``, ``configs/shapes.py``,
``kernels/cost.py``, the storage-less routes of ``kernels/ops.py`` and
``dist/sharding.py``) held to the reference's spec functions with ``==``.

No test lowers a JAX program (the reference's lowering fails on this JAX,
ROADMAP C): the reference side runs its spec and shape functions only, on
stand-in meshes that carry axis names and a device grid's shape. The
port's counts are held to the same programs on real CPU tensors.
"""
import ast
import dataclasses
import io
import json
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.dist import sharding as jshd
from repro.launch import dryrun as jdry
from repro.launch import roofline as jroof
from repro.launch import run_all_dryruns as jrun
from repro.models import api as japi
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, get_config
from repro_torch.dist import sharding as shd
from repro_torch.kernels import cost, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, mesh as mesh_mod, roofline
from repro_torch.launch import run_all_dryruns
from repro_torch.models import api
from repro_torch.models.convert import jax_layout
from repro_torch.train.optimizer import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((4, 2), ("data", "model"))]


def jmesh(shape, names):
    """A stand-in for the reference's mesh: its spec functions read the
    axis names and the device grid's shape only."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _stack_spec(specs):
    assert all(s == specs[0] for s in specs), specs
    return (None,) + tuple(specs[0])


def _stacked(port_specs):
    """The port's per-layer spec tree in the reference's stacked layout."""
    return jax_layout(port_specs, tuple, _stack_spec)


def _jtuple(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda x: isinstance(x, JP))


def _sd(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


def _jsd(tree):
    return jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  tree)


# ---------------------------------------------------------------------------
# shapes, skips, combos, probe plans
# ---------------------------------------------------------------------------
def test_shapes_skips_combos_and_probe_plans_equal_reference():
    assert ({k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()})
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert (get_config(arch, smoke=smoke).supports_long_decode
                    == jax_config(arch, smoke=smoke).supports_long_decode)
        assert dryrun._probe_plan(arch) == jdry._probe_plan(arch)
    assert run_all_dryruns.SKIPS.keys() == jrun.SKIPS.keys()
    for opt in ("pod", "multipod", "host", "both"):
        # the same combinations (each package sweeps its registry's order)
        assert (sorted(run_all_dryruns.combos(opt))
                == sorted(jrun.combos(opt)))
        assert (list(run_all_dryruns.combos(opt, ["qwen2-0.5b"],
                                            ["decode_32k"]))
                == list(jrun.combos(opt, ["qwen2-0.5b"], ["decode_32k"])))
    # the knob the probes pass is accepted (and ignored)
    assert get_config("qwen2-0.5b").replace(unroll=True).unroll


@pytest.mark.parametrize("shape,names", MESHES, ids=lambda m: str(m))
def test_opt_state_pspecs_and_arg_bytes_equal_reference(shape, names):
    pm, jm = shd.Mesh(shape, names), jmesh(shape, names)
    multi = "pod" in names
    for arch in ARCH_IDS:
        pcfg, jcfg = get_config(arch, smoke=True), jax_config(arch,
                                                              smoke=True)
        pshape, jshape = api.params_specs(pcfg), japi.params_specs(jcfg)
        with shd.axis_rules(pm, shd.production_rules_table(multi)) as pr:
            pspec = shd.param_pspecs(pshape, pr)
        with jshd.axis_rules(jm, jshd.production_rules_table(multi)) as jr:
            jspec = jshd.param_pspecs(jshape, jr)
        assert _stacked(pspec) == _jtuple(jspec), arch
        assert (_stacked(dryrun.opt_state_pspecs(pspec, pshape, pm))
                == _jtuple(jdry.opt_state_pspecs(jspec, jshape, jm))), arch
        assert (dryrun.sharded_arg_bytes(pshape, pspec, pm)
                == jdry.sharded_arg_bytes(jshape, jspec, jm)), arch


@pytest.mark.parametrize("arch,smoke", [(a, True) for a in ARCH_IDS]
                         + [("qwen2-0.5b", False), ("zamba2-7b", False)])
def test_specs_equal_reference_eval_shape(arch, smoke):
    pcfg, jcfg = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    assert (jax_layout(api.params_specs(pcfg), _sd,
                       lambda v: ((len(v),) + v[0][0], v[0][1]))
            == _jsd(japi.params_specs(jcfg)))
    assert ({k: _sd(v) for k, v in api.cache_specs(pcfg, 2, 64).items()}
            == _jsd(japi.cache_specs(jcfg, 2, 64)))
    for mode in ("train", "prefill", "decode"):
        assert ({k: _sd(v) for k, v in
                 api.input_specs(pcfg, 2, 32, mode).items()}
                == _jsd(japi.input_specs(jcfg, 2, 32, mode)))
    if pcfg.family in ("dense", "vlm", "moe"):
        assert ({k: _sd(v) for k, v in
                 api.paged_cache_specs(pcfg, 8, 16).items()}
                == _jsd(japi.paged_cache_specs(jcfg, 8, 16)))
    batch = api.make_batch(pcfg, 2, 32, torch.Generator().manual_seed(0))
    assert ({k: _sd(v) for k, v in batch.items()}
            == {k: _sd(v) for k, v in
                api.input_specs(pcfg, 2, 32, "train").items()})
    assert int(batch["tokens"].max()) < pcfg.vocab_size


# ---------------------------------------------------------------------------
# the counts against the same programs on real CPU tensors
# ---------------------------------------------------------------------------
def _program(arch, mode, mesh=(1, 1), **cfg_kw):
    cfg = get_config(arch, smoke=True, **cfg_kw)
    pm = shd.Mesh(mesh, ("data", "model"))
    return dryrun.build_program(cfg, InputShape("t", 16, 4, mode), pm,
                                shd.production_rules_table())


#: (arch, mode) of each family on paths without a kernel
PLAIN_PATHS = [("qwen2-0.5b", "train"), ("qwen2-0.5b", "prefill"),
               ("qwen2-0.5b", "decode"), ("olmoe-1b-7b", "decode"),
               ("phi-3-vision-4.2b", "decode"), ("mamba2-780m", "decode"),
               ("zamba2-7b", "decode"), ("whisper-large-v3", "decode")]


@pytest.mark.parametrize("arch,mode", PLAIN_PATHS)
def test_storage_less_flops_equal_real_cpu(arch, mode):
    prog = _program(arch, mode, remat="full")
    counts = prog.count()
    assert counts["kernels"] == {} and counts["flops"] > 0
    assert counts["output_bytes"] > 0 and counts["bytes"] > 0
    assert counts["peak_bytes"] >= counts["argument_bytes"]
    args = api.materialize(prog.args, torch.Generator().manual_seed(0),
                           prog.cfg.vocab_size)
    if mode == "train":
        for p in leaves(args[0]):
            p.requires_grad_(True)
    with prog.rules(), FlopCounterMode(display=False) as fc:
        prog.run(*args)
    assert fc.get_total_flops() == counts["flops"]


def test_kernel_paths_book_cost_terms():
    """The storage-less route books each kernel's ``cost.py`` terms, once
    a call, and computes nothing (no launch, no plain call)."""
    before = ops.counts()
    vlm = _program("phi-3-vision-4.2b", "prefill").count()
    cfg = get_config("phi-3-vision-4.2b", smoke=True)
    f, b = cost.flash_attention(4, 16, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, 4)
    n = cfg.n_layers
    assert vlm["kernels"] == {"flash_attention": {
        "calls": n, "flops": n * f, "bytes": n * b}}
    assert vlm["flops"] == vlm["torch_flops"] + n * f

    m2 = _program("mamba2-780m", "train", remat="full").count()
    cfg = get_config("mamba2-780m", smoke=True)
    h, p, nn = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    q = min(cfg.ssm_chunk, 16)
    f, b = cost.ssd_scan(4, 16, h, p, nn, q)
    fb, bb = cost.ssd_scan_backward(4, 16, h, p, nn, q)
    n = cfg.n_layers     # remat "full": the forward and its recompute
    assert m2["kernels"] == {
        "ssd_scan": {"calls": 2 * n, "flops": 2 * n * f, "bytes": 2 * n * b},
        "ssd_scan_backward": {"calls": n, "flops": n * fb, "bytes": n * bb}}

    moe = _program("olmoe-1b-7b", "train").count()
    assert moe["kernels"]["flash_attention"]["calls"] == 2
    assert moe["kernels"]["flash_attention_backward"]["calls"] == 2
    assert "refused" not in moe["kernels"]["flash_attention_backward"]
    assert "refused" not in m2["kernels"]["ssd_scan_backward"]
    # the backward kernel takes bf16 too: a bf16 step books it at bf16's
    # bytes, with no refusal
    bf = _program("olmoe-1b-7b", "train", dtype="bfloat16",
                  param_dtype="bfloat16").count()
    cfg = get_config("olmoe-1b-7b", smoke=True)
    f, b = cost.flash_attention_backward(4, 16, cfg.n_heads, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, 2)
    assert bf["kernels"]["flash_attention_backward"] == {
        "calls": cfg.n_layers, "flops": cfg.n_layers * f,
        "bytes": cfg.n_layers * b}
    assert ops.counts() == before


def test_unrunnable_step_is_marked_and_kept_out_of_the_store(tmp_path,
                                                            monkeypatch):
    """A record whose step the card cannot run (a mamba2 train step whose
    ``ssm_chunk`` 512 exceeds the SSD backward's chunk limit of 256) lists
    the refused kernel, is marked by the roofline table and is not folded
    into the placement profile; an explicit ``ranks`` wins over
    ``REPRO_DRYRUN_DEVICES``."""
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    rec, _ = dryrun.lower_combo("mamba2-780m", "train_4k", False,
                                probe=False, mesh_kind="host", ranks=2,
                                extra_cfg={"smoke": True, "ssm_chunk": 512})
    assert rec["n_chips"] == 2 and rec["mesh_shape"] == {"data": 1,
                                                         "model": 2}
    assert set(rec["not_runnable"]) == {"ssd_scan_backward"}
    assert "chunk up to 256" in rec["not_runnable"]["ssd_scan_backward"]
    assert roofline.fmt_row(rec).startswith("| mamba2-780m (not runnable) |")
    out = tmp_path / "dry.jsonl"
    out.write_text(json.dumps(rec) + "\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        roofline.main(["--jsonl", str(out), "--mesh", "host"])
    assert "not runnable on the card: mamba2-780m train_4k: " \
        "ssd_scan_backward: " in buf.getvalue()
    assert run_all_dryruns.store_from_jsonl(
        str(out), str(tmp_path / "p.jsonl")) == 0


def test_bf16_train_record_is_runnable_and_stored(tmp_path, monkeypatch):
    """The dry-run's bf16 train step of olmoe-1b-7b (the sweep's train
    dtype) books the bf16 flash backward with no refusal: its record is
    runnable, unmarked in the roofline table, and folded into the
    placement profile Synergy reads."""
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    rec, _ = dryrun.lower_combo("olmoe-1b-7b", "train_4k", False,
                                probe=False, mesh_kind="host", ranks=2,
                                extra_cfg={"smoke": True})
    assert rec["not_runnable"] == {}
    assert rec["kernels"]["flash_attention_backward"]["calls"] > 0
    assert "refused" not in rec["kernels"]["flash_attention_backward"]
    assert roofline.fmt_row(rec).startswith("| olmoe-1b-7b |")
    out = tmp_path / "dry.jsonl"
    out.write_text(json.dumps(rec) + "\n")
    assert run_all_dryruns.store_from_jsonl(
        str(out), str(tmp_path / "p.jsonl")) == 1


def test_bf16_backward_bound_is_one_tensor_core_pass():
    """The bf16 flash backward's bound at phi-3-vision-4.2b's train shape:
    3.22e10 flops in one bf16 pass at 989 TFLOP/s (0.0326 ms) against
    q, k, v, o, do, dq, dk and dv in bf16 and the f32 log-sum-exp (0.0301
    ms): bound by operations. The f32 kernel's bytes are twice the eight
    tensors' plus the same log-sum-exp."""
    f, b = cost.flash_attention_backward(2, 1024, 32, 32, 96, 2)
    bytes_ms, ops_ms = cost.bound_ms(f, b, f32=False)
    assert (round(ops_ms, 4), round(bytes_ms, 4)) == (0.0326, 0.0301)
    lse = 4 * 2 * 32 * 1024
    f4, b4 = cost.flash_attention_backward(2, 1024, 32, 32, 96, 4)
    assert f4 == f and b4 - lse == 2 * (b - lse)


def test_probe_extrapolation_is_the_full_count_on_a_uniform_stack():
    """And where nothing is held whole, the arguments are the reference's
    ``sharded_arg_bytes`` of the params and the cache."""
    rec, prog = dryrun.lower_combo("llama3.2-1b", "decode_32k", False)
    assert rec["probe"]["probe_layers"] == [2, 4]
    assert rec["probe"]["gap"] == {"flops_per_chip": 0.0,
                                   "bytes_per_chip": 0.0,
                                   "wire_bytes_per_chip": 0.0}
    pshape = api.params_specs(prog.cfg)
    cshape = api.cache_specs(prog.cfg, 128, 32768)
    with prog.rules() as rules:
        pspec = shd.param_pspecs(pshape, rules)
    cspec = dryrun.cache_pspecs(prog.cfg, cshape, prog.mesh,
                                seq_shard=False, batch=128)
    expect = (dryrun.sharded_arg_bytes(pshape, pspec, prog.mesh)
              + dryrun.sharded_arg_bytes(cshape, cspec, prog.mesh))
    assert rec["held_replicated"] == []
    assert rec["args_gib_per_device"] == round(expect / 2**30, 3)


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-780m", "decode_32k"), ("zamba2-7b", "decode_32k"),
    ("zamba2-7b", "long_500k"), ("whisper-large-v3", "decode_32k")])
def test_recurrent_families_run_the_reference_layout(arch, shape):
    """The SSM, hybrid and encdec records on the pod mesh hold nothing
    whole: their arguments a GPU are the reference's ``sharded_arg_bytes``
    of the params and the cache (the fused ``in_proj`` split flat, the
    conv over its channels, the SSM states over their heads, the K/V
    pools by head or by position)."""
    rec, prog = dryrun.lower_combo(arch, shape, False, probe=False)
    ishape = INPUT_SHAPES[shape]
    pshape = api.params_specs(prog.cfg)
    cshape = api.cache_specs(prog.cfg, ishape.global_batch, ishape.seq_len)
    with prog.rules() as rules:
        pspec = shd.param_pspecs(pshape, rules)
    cspec = dryrun.cache_pspecs(prog.cfg, cshape, prog.mesh,
                                seq_shard=shape == "long_500k",
                                batch=ishape.global_batch)
    expect = (dryrun.sharded_arg_bytes(pshape, pspec, prog.mesh)
              + dryrun.sharded_arg_bytes(cshape, cspec, prog.mesh))
    assert rec["held_replicated"] == []
    assert rec["args_gib_per_device"] == round(expect / 2**30, 3)


def test_bytes_count_storage_extents_and_live_bytes():
    """An expanded input counts by its storage extent; a storage's bytes
    are live from its creation to its free."""
    x = torch.empty(64, 1, device="meta")
    with dryrun.CountingMode((x,)) as cm:
        y = x.expand(64, 128) + 1.0      # reads 64 floats, writes 64 x 128
        assert cm.bytes == 4 * 64 + 4 * 64 * 128
        z = y * 2.0
        assert cm.current == 4 * 64 + 2 * 4 * 64 * 128 == cm.peak
        del y
        assert cm.current == 4 * 64 + 4 * 64 * 128
        z.copy_(torch.ones(64, 128, device="meta"))
    assert cm.argument_bytes == 4 * 64


def test_dry_collectives_by_kind_and_axis():
    """On a (2, 2) mesh the storage-less collectives need no process
    group: their output shapes, STATS calls, and output bytes by kind and
    axis; a real tensor off the mesh is untouched."""
    shd.reset_stats()
    pm = shd.Mesh((2, 2), ("data", "model"))
    x = torch.empty(3, 8, device="meta")
    with shd.axis_rules(pm, shd.production_rules_table()), \
            dryrun.CountingMode((x,)) as cm:
        assert shd.reduce_over(x, "model").shape == (3, 8)
        assert shd.gather_over(x, 1, "model").shape == (3, 16)
        assert shd.gather_over(x, 0, "data").shape == (6, 8)
        assert shd.reduce_over(x, "pod") is x       # no such axis
    assert cm.collectives == {("all-reduce", "model"): 96,
                              ("all-gather", "model"): 192,
                              ("all-gather", "data"): 192}
    assert (shd.STATS["all_reduce"], shd.STATS["all_gather"]) == (1, 2)
    shd.reset_stats()

    counts = _program("qwen2-0.5b", "decode", mesh=(2, 2)).count()
    cfg = get_config("qwen2-0.5b", smoke=True)
    rows = 4 // 2
    # the embedding's and each layer's wo and w_down sums; the logits
    assert counts["collectives"] == {
        ("all-reduce", "model"): (1 + 2 * cfg.n_layers) * rows
        * cfg.d_model * 4,
        ("all-gather", "model"): rows * cfg.vocab_size * 4}
    # the train step (heads split, remat none): over 'model' the forward's
    # sums (the embedding, wo and w_down) and the backward's at each
    # column-parallel entry (q/k/v, w_gate/w_up, the vocab block), all of
    # [rows, 16, d]; the loss's row max, sum of exponentials and gold
    # logit [rows, 16]; the global norm's scalar. No logits gathered.
    train = _program("qwen2-0.5b", "train", mesh=(2, 2)).count()
    booked = train["collectives"]
    act = rows * 16 * cfg.d_model * 4
    assert booked[("all-reduce", "model")] == (
        (1 + 2 * cfg.n_layers) * act + (2 * cfg.n_layers + 1) * act
        + 3 * rows * 16 * 4 + 4)
    assert ("all-gather", "model") not in booked
    # over 'data': each ZeRO-1 gradient reduce-scattered to half its
    # block and the updated halves gathered back
    assert booked[("reduce-scatter", "data")] * 2 == booked[
        ("all-gather", "data")] > 0


@pytest.mark.parametrize("entry", ["flash", "ssd", "paged", "prefill", "gmm"])
def test_cuda_tensor_launches_or_raises_without_fallback(entry,
                                                      monkeypatch):
    """A CUDA tensor (a fake one) goes to the kernel, which raises on a
    machine without the kernels' library; no plain version runs."""
    from repro_torch.kernels import build

    def no_library():
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(build, "library", no_library)
    before = ops.counts()
    with FakeTensorMode():
        def t(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device="cuda")
        calls = {
            "flash": lambda: ops.flash_attention(t(1, 8, 2, 64),
                                                 t(1, 8, 2, 64),
                                                 t(1, 8, 2, 64)),
            "ssd": lambda: ops.ssd_scan(t(1, 8, 2, 64), t(1, 8, 2),
                                        t(1, 8, 2, 16), t(1, 8, 2, 16), 8),
            "paged": lambda: ops.paged_attention(
                t(2, 2, 64), t(4, 16, 2, 64), t(4, 16, 2, 64),
                t(2, 2, dtype=torch.int32), t(2, dtype=torch.int32)),
            "prefill": lambda: ops.paged_prefill_attention(
                t(2, 4, 2, 64), t(4, 16, 2, 64), t(4, 16, 2, 64),
                t(2, 2, dtype=torch.int32), t(2, dtype=torch.int32)),
            "gmm": lambda: ops.grouped_matmul(t(2, 4, 64), t(2, 64, 64)),
        }
        with pytest.raises(RuntimeError, match="no kernel library"):
            calls[entry]()
    assert ops.counts() == before
    assert fa.flash_attention_plain.calls == before[
        ops.COUNTERS.index((fa.flash_attention_plain, "calls"))]


# ---------------------------------------------------------------------------
# cost formulas and constants
# ---------------------------------------------------------------------------
def test_cost_reproduces_the_recorded_bounds():
    """``PERF.md`` §6's bounds (ms, NVIDIA H100 80GB HBM3 peaks) from the
    formulas ``chip_smoke.py`` prints them with."""
    def ms(c, f32=True):
        return max(cost.bound_ms(*c, f32=f32))
    assert round(ms(cost.flash_attention(1, 1024, 32, 32, 96, 4)), 5) \
        == 0.03908
    assert round(ms(cost.flash_attention(2, 1024, 32, 32, 96, 4)), 5) \
        == 0.07817
    assert round(ms(cost.flash_attention(1, 256, 16, 16, 128, 4)), 5) \
        == 0.00250
    assert round(ms(cost.flash_attention(1, 448, 20, 20, 64, 4)), 5) \
        == 0.00312
    assert round(ms(cost.ssd_scan(2, 4096, 48, 64, 128, 256)), 4) == 0.1957
    assert round(ms(cost.ssd_scan(1, 4096, 112, 64, 64, 256)), 4) == 0.1408
    assert round(ms(cost.grouped_matmul(64, 40, 2048, 2048, 4)), 4) == 0.3330
    assert round(ms(cost.flash_attention_backward(2, 1024, 32, 32, 96)),
                 4) == 0.1954
    assert round(ms(cost.ssd_scan_backward(2, 4096, 48, 64, 128, 256)),
                 4) == 0.4698
    assert round(ms(cost.ssd_scan_backward(1, 4096, 112, 64, 64, 256)),
                 4) == 0.3198
    for s in (1, 5, 16, 33):
        pos = torch.arange(s)
        for causal in (True, False):
            for window in (0, 1, 3, 16, 40):
                vis = torch.ones((s, s), dtype=torch.bool)
                if causal:
                    vis &= pos[:, None] >= pos[None, :]
                if window:
                    vis &= pos[:, None] - pos[None, :] < window
                assert cost.visible_pairs(s, causal, window) == int(vis.sum())


def test_h100_constants_have_one_home():
    """``launch/mesh.py`` holds the H100's peaks; the profiler and
    ``chip_smoke.py`` read them, at the values printed before."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.obs import prof
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.TF32_FLOPS,
            mesh_mod.F32_FLOPS) == (989e12, 3.35e12, 495e12, 67e12)
    assert (mesh_mod.NVLINK_BW, mesh_mod.NET_BW) == (450e9, 50e9)
    assert (prof.PEAK_FLOPS_BF16, prof.HBM_BW) == (989e12, 3.35e12)
    assert (chip_smoke.HBM_BPS, chip_smoke.F32_FLOPS) == (3.35e12, 67e12)
    assert cost.bound_ms(989e9, 3.35e9, f32=False) == (1.0, 1.0)
    assert cost.bound_ms(165e9, 0) == (0.0, 1.0)
    assert cost.bound_ms(67e9, 0, mma=False) == (0.0, 1.0)
    pod = mesh_mod.make_production_mesh()
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert (pod.sizes, multi.sizes) == (
        {"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8})
    assert mesh_mod.make_host_mesh(ranks=8).sizes == {"data": 4, "model": 2}
    assert mesh_mod.make_host_mesh(ranks=1).sizes == {"data": 1, "model": 1}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def _reference_record_keys():
    """The keys of the reference's record (``dryrun.py:376-402``)."""
    tree = ast.parse(open(jdry.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no record dict in the reference")


def test_main_roofline_and_store_against_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    out = tmp_path / "dry.jsonl"
    with redirect_stdout(io.StringIO()):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--mesh", "host", "--no-probe", "--cfg-json",
                     '{"smoke": true}', "--out", str(out)])
        dryrun.main(["--arch", "mamba2-780m", "--shape", "train_4k",
                     "--mesh", "host", "--no-probe", "--cfg-json",
                     '{"smoke": true}', "--out", str(out), "--tag", "t"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    keys = _reference_record_keys()
    assert len(keys) == 24
    for rec in recs:
        assert set(keys) <= set(rec), set(keys) - set(rec)
        assert rec["n_chips"] == 8 and rec["mesh_shape"] == {"data": 4,
                                                             "model": 2}
        assert set(rec["memory_stats"]) == {"bytes_per_device",
                                            "argument_bytes",
                                            "output_bytes", "peak_bytes"}
        assert rec["args_gib_per_device"] == round(
            rec["memory_stats"]["argument_bytes"] / 2**30, 3)
        assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert recs[1]["tag"] == "t" and recs[1]["kernels"]["ssd_scan"]
    assert recs[1]["collective_bytes_by_axis"]["data"]["reduce-scatter"] > 0

    for rec in recs:
        assert roofline.fmt_row(rec) == jroof.fmt_row(rec)
    for mesh in ("host", "pod"):
        lines = []
        for fn in (roofline.main, jroof.main):
            buf = io.StringIO()
            with redirect_stdout(buf):
                if fn is roofline.main:
                    fn(["--jsonl", str(out), "--mesh", mesh])
                else:
                    monkeypatch.setattr(sys, "argv", [
                        "roofline", "--jsonl", str(out), "--mesh", mesh])
                    fn()
            lines.append(buf.getvalue().splitlines())
        assert lines[0][:-1] == lines[1][:-1]      # the multipod line names
        assert "2x32x8" in lines[0][-1]            # each package's mesh

    from repro.obs import ProfileStore as JStore
    from repro_torch.obs import ProfileStore
    n = run_all_dryruns.store_from_jsonl(str(out), str(tmp_path / "p.jsonl"))
    assert n == jrun.store_from_jsonl(str(out), str(tmp_path / "j.jsonl"))
    assert (ProfileStore.load(str(tmp_path / "p.jsonl")).records
            == JStore.load(str(tmp_path / "j.jsonl")).records)


def test_sweep_subprocess(tmp_path):
    out, store = tmp_path / "sweep.jsonl", tmp_path / "store.jsonl"
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_all_dryruns",
         "--mesh", "host", "--smoke", "--archs", "whisper-large-v3",
         "--shapes", "prefill_32k", "--out", str(out), "--profile-store",
         str(store)], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(out.read_text().splitlines()[-1])
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (
        "whisper-large-v3", "prefill_32k", "host")
    assert rec["kernels"]["flash_attention"]["calls"] == 2
    assert "now holds 1 records" in proc.stdout


def test_list_archs_is_the_reference_registry():
    """``configs.list_archs`` (``repro/configs/registry.py:36``): every
    registered id in the reference's order, a fresh list each call."""
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs
    assert list_archs() == jax_list_archs() == ARCH_IDS
    assert list_archs() is not ARCH_IDS


def test_serve_step_fn_matches_reference():
    """``serve.serve_step_fn`` (``repro/serve/engine.py:1730``): one decode
    step of smoke qwen2 from the JAX weights and a seeded cache, at
    position 5 of 16, against the reference's step: logits within 1e-5,
    and the new K/V written at position 5 only."""
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build
    from repro.serve import serve_step_fn as jax_serve_step_fn
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import serve_step_fn
    jcfg, cfg = (jax_config("qwen2-0.5b", smoke=True),
                 get_config("qwen2-0.5b", smoke=True))
    jparams = jax_build(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    kv = {n: rng.standard_normal(shape).astype(np.float32)
          for n in ("k", "v")}
    tokens = np.array([[7], [300]], np.int32)
    want, wcache = jax_serve_step_fn(jcfg)(
        jparams, {n: jnp.asarray(a) for n, a in kv.items()},
        jnp.asarray(tokens), 5)
    cache = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    got, cache = serve_step_fn(cfg)(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                        device="cpu"),
        cache, torch.from_numpy(tokens), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(wcache[n]),
                                   atol=1e-5, rtol=1e-5)
        assert np.array_equal(np.delete(cache[n].numpy(), 5, axis=2),
                              np.delete(kv[n], 5, axis=2))
