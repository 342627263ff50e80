"""The port's paged attention (repro_torch.kernels) against the JAX package.

On the CPU the port's wrappers run the plain PyTorch versions; they are
held against the JAX wrappers, which run the Pallas kernels in interpret
mode on the CPU (as tests/test_kernels.py runs them), and against the
pure-jnp oracles of ``repro.kernels.ref``. The sweep mirrors
tests/test_kernels.py (GQA groups, sliding windows, -1 table tails) and
adds G = 7 (qwen2-0.5b's 14 q heads over 2 kv heads) and an all -1 row,
whose output must be exactly 0 (the Pallas kernels' l == 0 -> 1 rule; the
oracle averages garbage there, so it is compared on the other rows).
Tolerances are tests/test_kernels.py's: 2e-5 in f32, 2e-2 in bf16.
tests/test_torch_cuda_kernels.py holds the CUDA kernels against these
plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS = [(4, 4), (8, 2), (6, 1), (14, 2)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NB, BS, D, MB = 10, 8, 32, 4
#: -1 tails, a full row, and an all -1 (padding) row last
TABLES = np.array([[3, 7, -1, -1], [0, 1, 2, 9], [5, 6, -1, -1],
                   [-1, -1, -1, -1]], np.int32)


def _inputs(seed, hq, hkv, q_shape):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, BS, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, hkv, D)).astype(np.float32)
    q = rng.standard_normal(q_shape).astype(np.float32)
    return q, kp, vp


def _both(arrays, dtype):
    """The same numpy inputs for JAX and for torch, cast to ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _check(out, exp, dtype, rows=slice(None)):
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(exp, np.float32)[rows],
                               atol=tol, rtol=tol)


def _cases():
    for hq, hkv in HEADS:
        for window in (0, 5):
            yield pytest.param(hq, hkv, window, "float32",
                               id=f"{hq}x{hkv}-w{window}-f32")
    for window in (0, 5):
        yield pytest.param(14, 2, window, "bfloat16", id=f"14x2-w{window}-bf16")


@pytest.mark.parametrize("hq,hkv,window,dtype", list(_cases()))
def test_paged_attention_plain_vs_pallas_and_ref(hq, hkv, window, dtype):
    q, kp, vp = _inputs(hq * 31 + hkv + window, hq, hkv, (4, hq, D))
    pos = np.array([12, 30, 10, 5], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both([q, kp, vp], dtype)
    out = ops.paged_attention(tq, tk, tv, torch.from_numpy(TABLES),
                              torch.from_numpy(pos), window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _check(out, jops.paged_attention(jq, jk, jv, TABLES, pos, window), dtype)
    _check(out, jref.paged_attention(jq, jk, jv, jnp.asarray(TABLES),
                                     jnp.asarray(pos), window), dtype,
           rows=slice(0, 3))
    assert (out[3] == 0).all()                      # no visible key -> 0


@pytest.mark.parametrize("hq,hkv,window,dtype", list(_cases()))
def test_paged_prefill_plain_vs_pallas_and_ref(hq, hkv, window, dtype):
    c = 6
    q, kp, vp = _inputs(hq * 37 + hkv + window, hq, hkv, (4, c, hq, D))
    start = np.array([8, 24, 2, 0], np.int32)       # chunks mid-table
    (jq, jk, jv), (tq, tk, tv) = _both([q, kp, vp], dtype)
    out = ops.paged_prefill_attention(tq, tk, tv, torch.from_numpy(TABLES),
                                      torch.from_numpy(start), window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _check(out, jops.paged_prefill_attention(jq, jk, jv, TABLES, start,
                                             window), dtype)
    _check(out, jref.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(TABLES), jnp.asarray(start), window), dtype,
        rows=slice(0, 3))
    assert (out[3] == 0).all()


def test_paged_prefill_causal_inside_chunk():
    """A chunk's first query row equals single-token decode at its
    position: later in-chunk K/V is invisible to it."""
    q, kp, vp = _inputs(5, 14, 2, (1, 4, 14, D))
    tables = torch.tensor([[2, 0, -1, -1]], dtype=torch.int32)
    start = torch.tensor([4], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    chunk = ops.paged_prefill_attention(tq, tk, tv, tables, start)
    single = ops.paged_attention(tq[:, 0], tk, tv, tables, start)
    torch.testing.assert_close(chunk[:, 0], single, atol=2e-5, rtol=2e-5)


def test_cpu_tensors_never_launch_kernels():
    before = (ops.paged_attention.launches,
              ops.paged_prefill_attention.launches)
    q, kp, vp = _inputs(0, 14, 2, (4, 2, 14, D))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    pos = torch.tensor([12, 30, 10, 5], dtype=torch.int32)
    ops.paged_attention(tq[:, 0], tk, tv, torch.from_numpy(TABLES), pos)
    ops.paged_prefill_attention(tq, tk, tv, torch.from_numpy(TABLES), pos)
    assert (ops.paged_attention.launches,
            ops.paged_prefill_attention.launches) == before == (0, 0)


def test_non_cpu_tensors_go_to_the_kernel_or_raise():
    """Tensors off the CPU never take the plain version: a device the
    kernels do not take raises instead of falling back."""
    calls = pa.paged_attention_plain.calls
    q = torch.empty((2, 14, D), device="meta")
    kp = torch.empty((NB, BS, 2, D), device="meta")
    tables = torch.empty((2, MB), dtype=torch.int32, device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(q, kp, kp, tables, pos)
    assert pa.paged_attention_plain.calls == calls
