"""The port's boundary: ``repro_torch`` and ``chip_smoke.py`` stand without
JAX and without the JAX package, and every entry point defaults to the GPU.
"""
import ast
import inspect
import os
import subprocess
import sys

import pytest

from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convert, mamba2, moe, transformer
from repro_torch.models.api import Model
from repro_torch.serve import BlockManager, CachePool, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    for d, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_leaves_jax_and_reference_out():
    """Importing every port module and chip_smoke (without running it)
    loads neither jax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib')) or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
        "assert len(names) >= 26, names\n"
        "for n in ('repro_torch.models.moe', 'repro_torch.serve.cache',\n"
        "          'repro_torch.kernels.flash_attention',\n"
        "          'repro_torch.kernels.grouped_matmul',\n"
        "          'repro_torch.models.mamba2',\n"
        "          'repro_torch.kernels.ssd_scan',\n"
        "          'repro_torch.serve.graphs', 'repro_torch.serve.sampling',\n"
        "          'repro_torch.dist', 'repro_torch.dist.sharding',\n"
        "          'repro_torch.launch.mesh', 'repro_torch.launch.dryrun',\n"
        "          'repro_torch.serve.sharded', 'repro_torch.configs.shapes',\n"
        "          'repro_torch.kernels.cost', 'repro_torch.launch.roofline',\n"
        "          'repro_torch.launch.run_all_dryruns'):\n"
        "    assert n in names, n\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_constants_and_cost_formulas_import_without_torch():
    """The H100 constants' home, the kernels' cost formulas and the profile
    store import neither torch nor numpy (store tooling runs anywhere)."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}]\n"
        "import repro_torch.launch.mesh, repro_torch.kernels.cost\n"
        "import repro_torch.obs.prof, repro_torch.launch.roofline\n"
        "bad = sorted(m for m in ('torch', 'numpy') if m in sys.modules)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, n)


@pytest.mark.parametrize("fn", [
    transformer.init_params, transformer.init_paged_cache, Model.init,
    Model.init_paged_cache, convert.params_from_jax, BlockManager.__init__,
    ServeEngine.__init__, mesh_mod.init_distributed],
    ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("fn", [
    transformer.init_cache, moe.init_params, Model.init_cache,
    CachePool.__init__, mamba2.init_params, mamba2.init_cache],
    ids=lambda f: f"{f.__module__.split('.')[-1]}.{f.__qualname__}")
def test_contiguous_and_moe_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_cuda():
    assert serve_cli.build_parser().parse_args([]).device == "cuda"


def test_kernel_wrappers_count_launches():
    assert isinstance(ops.paged_attention.launches, int)
    assert isinstance(ops.paged_prefill_attention.launches, int)
    assert isinstance(ops.flash_attention.launches, int)
    assert isinstance(ops.grouped_matmul.launches, int)
    assert isinstance(ops.ssd_scan.launches, int)


def test_every_csrc_source_is_built():
    """``build.py`` compiles every CUDA source under csrc/ and declares the
    argument types of every C entry point the wrappers call."""
    from repro_torch.kernels import build
    names = {p.name for p in build.sources()}
    assert {"paged_attention.cu", "flash_attention.cu", "grouped_matmul.cu",
            "ssd_scan.cu", "errors.cu", "flash_attention_bwd.cu",
            "ssd_scan_bwd.cu"} <= names
    assert set(build.ARGTYPES) == {
        "paged_attention_decode", "paged_attention_prefill",
        "flash_attention_forward", "grouped_matmul_forward",
        "ssd_scan_forward", "flash_attention_backward", "ssd_scan_backward"}


def test_chip_smoke_refuses_without_a_gpu():
    """No CUDA device here: the script exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
