"""The port's SSD chunked scan (``repro_torch.kernels.ops.ssd_scan``) against
the JAX package, on the CPU: the JAX ``ops.ssd_scan`` (its Pallas kernel in
interpret mode) and the sequential recurrence ``ref.ssd``, on the same
numpy inputs.

On the CPU the wrapper takes the kernel's plain version; the CUDA kernel
is held against that version on the card (``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``). Tolerance 5e-4, the JAX kernel test's
(``tests/test_kernels.py:134``): chunked and sequential sums of up to 256
f32 terms in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(b, s, h, p, n, seed):
    """The JAX test's distributions: decays -softplus(normal), B and C at
    half scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-np.logaddexp(rng.standard_normal((b, s, h)), 0.0)).astype(
        np.float32)
    B = (0.5 * rng.standard_normal((b, s, h, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, s, h, n))).astype(np.float32)
    return x, a, B, C


def _port(x, a, B, C, chunk):
    return ops.ssd_scan(*(torch.from_numpy(t) for t in (x, a, B, C)),
                        chunk=chunk).numpy()


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (96, 32),
                                     (256, 128)])
@pytest.mark.parametrize("n,p", [(16, 32), (64, 64)])
def test_ssd_scan_sweep_matches_jax(s, chunk, n, p):
    x, a, B, C = _inputs(2, s, 3, p, n, s + n)
    y = _port(x, a, B, C, chunk)
    assert y.dtype == np.float32 and y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(jops.ssd_scan(
        x, a, B, C, chunk=chunk)), **TOL)
    np.testing.assert_allclose(y, np.asarray(jref.ssd(x, a, B, C)), **TOL)


def test_ssd_scan_chunk_larger_than_s():
    """S = 64 with chunk 128: the wrapper halves the chunk to 64."""
    x, a, B, C = _inputs(1, 64, 2, 32, 16, 7)
    y = _port(x, a, B, C, 128)
    np.testing.assert_allclose(y, np.asarray(jops.ssd_scan(
        x, a, B, C, chunk=128)), **TOL)
    np.testing.assert_allclose(y, np.asarray(jref.ssd(x, a, B, C)), **TOL)


def test_ssd_scan_memoryless():
    """a_log = -40: no state survives a step, so y_t = (C_t . B_t) x_t."""
    x, _, B, C = _inputs(2, 64, 3, 32, 16, 3)
    a = np.full(x.shape[:3], -40.0, np.float32)
    y = _port(x, a, B, C, 32)
    want = np.einsum("bshn,bshn->bsh", C, B)[..., None] * x
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(y, np.asarray(jops.ssd_scan(
        x, a, B, C, chunk=32)), **TOL)


def test_ssd_scan_casts_to_float32_and_matches_model_path():
    """Inputs of another dtype are cast to f32 and the output is f32, as in
    the JAX wrapper; the plain version equals the model's ssd_chunked."""
    x, a, B, C = _inputs(2, 96, 2, 32, 16, 5)
    y = ops.ssd_scan(*(torch.from_numpy(t).double() for t in (x, a, B, C)),
                     chunk=256)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(B), jnp.asarray(C),
        chunk=256)), **TOL)


@pytest.mark.parametrize("s", [256, 96, 7])
def test_best_chunk_rule(s):
    from repro.models.mamba2 import _best_chunk
    assert ssd.best_chunk(s) == _best_chunk(s)


def test_plain_version_counts_calls():
    x, a, B, C = _inputs(1, 32, 1, 32, 16, 9)
    before = ssd.ssd_scan_plain.calls
    launches = ops.ssd_scan.launches
    _port(x, a, B, C, 32)
    assert ssd.ssd_scan_plain.calls == before + 1
    assert ops.ssd_scan.launches == launches      # the CPU launches nothing
