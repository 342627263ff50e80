"""The port's SSD chunked scan (``repro_torch.kernels.ops.ssd_scan``) against
the JAX package, on the CPU: the JAX ``ops.ssd_scan`` (its Pallas kernel in
interpret mode) and the sequential recurrence ``ref.ssd``, on the same
numpy inputs.

On the CPU the wrapper takes the kernel's plain version; the CUDA kernel
is held against that version on the card (``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``). Tolerance 5e-4, the JAX kernel test's
(``tests/test_kernels.py:134``): chunked and sequential sums of up to 256
f32 terms in different orders.

The CUDA route's decomposition (chunk states, the pass over chunks, 64-row
output tiles) with its arithmetic (three TF32 passes per product) is
emulated here and held against the JAX kernel too.
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
from tests._torch_tf32 import mm

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


# ---------------------------------------------------------------------------
# The CUDA route's decomposition and arithmetic
# ---------------------------------------------------------------------------
def _prod(a, b):
    """A product of the kernels: three TF32 passes, lo truncated."""
    return mm(a, b, 3, lo_trunc=True)


def _emulated_kernels(x, a, B, C, q):
    """y as csrc/ssd_scan.cu's three kernels compute it, every product
    through three TF32 passes (lo truncated, as the kernels hand it over):
    (1) each chunk's own state (B .* exp(lc_last - lc))^T x over
    64-position tiles and its decay;
    (2) the pass t = gamma_c t + s_c over the chunks; (3) per 64-row tile of
    a chunk, (C .* exp(lc)) t_in plus the masked, decayed scores of the key
    tiles at or below the diagonal (tiles above it skipped) times x."""
    b, s, h, p = x.shape
    n, nc, T = B.shape[-1], s // q, 64
    rows = lambda t: t.transpose(1, 2).reshape(b * h, nc, q, -1)   # noqa
    xr, br, cr = rows(x), rows(B), rows(C)
    lc = torch.cumsum(rows(a[..., None])[..., 0], -1)           # [bh, nc, q]
    l_last = lc[..., -1:]
    wj = torch.exp(l_last - lc)
    states = torch.zeros(b * h, nc, n, p)
    for j0 in range(0, q, T):
        bw = br[:, :, j0:j0 + T] * wj[:, :, j0:j0 + T, None]
        states = states + _prod(bw.transpose(-1, -2), xr[:, :, j0:j0 + T])
    gamma = torch.exp(l_last[..., 0])
    t, t_in = torch.zeros(b * h, n, p), []
    for c in range(nc):
        t_in.append(t)
        t = gamma[:, c, None, None] * t + states[:, c]
    t_in = torch.stack(t_in, 1)
    y = torch.zeros(b * h, nc, q, p)
    for i0 in range(0, q, T):
        ci, li = cr[:, :, i0:i0 + T], lc[:, :, i0:i0 + T]
        acc = _prod(ci * torch.exp(li)[..., None], t_in)
        ii = torch.arange(i0, i0 + ci.shape[2])
        for j0 in range(0, i0 + 1, T):
            lj = lc[:, :, j0:j0 + T]
            jj = torch.arange(j0, j0 + lj.shape[2])
            sc = _prod(ci, br[:, :, j0:j0 + T].transpose(-1, -2))
            decay = torch.exp(torch.clamp(li[..., :, None] - lj[..., None, :],
                                          max=0.0))
            m = torch.where(jj[None, :] <= ii[:, None], sc * decay, 0.0)
            acc = acc + _prod(m, xr[:, :, j0:j0 + T])
        y[:, :, i0:i0 + T] = acc
    return y.reshape(b, h, s, p).transpose(1, 2)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 32, 16, 32),      # the smoke widths: P 32, N 16, chunk 32
    (1, 512, 2, 64, 128, 256),    # mamba2-780m's widths, two chunks
    (1, 96, 2, 32, 16, 256),      # the chunk halves to 32: three chunks
])
def test_kernel_decomposition_matches_jax(b, s, h, p, n, chunk):
    x, a, B, C = _inputs(b, s, h, p, n, s + p + n)
    q = chunk
    while s % q:
        q //= 2
    got = _emulated_kernels(*(torch.from_numpy(t) for t in (x, a, B, C)), q)
    exp = np.asarray(jops.ssd_scan(x, a, B, C, chunk=chunk))
    np.testing.assert_allclose(got.numpy(), exp, **TOL)
