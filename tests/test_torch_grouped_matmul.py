"""The port's grouped matmul (repro_torch.kernels.grouped_matmul, routed by
``ops.grouped_matmul``) against the JAX package, on the CPU.

The same numpy inputs go through the JAX wrapper ``ops.grouped_matmul``
(its Pallas kernel in interpret mode, blocks shrunk to divisors, invalid
rows zeroed) and the ``ref.grouped_matmul`` oracle, and through the port's
plain version — the function the CUDA kernel is held to on the card.
Shapes keep olmoe-1b-7b's ragged capacities (40 rows for a 256-token
prompt, 8 at decode) at narrow widths. Tolerance: float32 on every side,
2e-5 (tests/test_kernels.py's): the sums run in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops

TOL = dict(atol=2e-5, rtol=2e-5)
G, K, N = 6, 64, 48


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, c, K)).astype(np.float32)
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K)).astype(np.float32)
    return x, w


def _valid(kind, c, seed):
    if kind == "none":
        return None
    rng = np.random.default_rng(seed)
    v = rng.integers(0, c + 1, size=G).astype(np.int32)
    if kind == "some_empty":
        v[::2] = 0
    return v


@pytest.mark.parametrize("c", [40, 8])
@pytest.mark.parametrize("kind", ["none", "random", "some_empty"])
def test_plain_matches_pallas_and_oracle(c, kind):
    x, w = _inputs(c, seed=c)
    valid = _valid(kind, c, seed=c + 1)
    tv = None if valid is None else torch.from_numpy(valid)
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             tv).numpy()
    jv = None if valid is None else jnp.asarray(valid)
    pallas = np.asarray(jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                            jv))
    oracle = np.asarray(jref.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                            jv))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    if valid is not None:
        rows = np.arange(c)[None, :, None] >= valid[:, None, None]
        assert (got[np.broadcast_to(rows, got.shape)] == 0).all()
        assert (got[np.broadcast_to(~rows, got.shape)] != 0).all()


def test_valid_rows_out_of_range_clamp():
    """valid_rows past C keeps every row; negative keeps none (the JAX
    wrapper's ``arange(C) < valid`` mask)."""
    x, w = _inputs(8, seed=3)
    valid = np.array([-2, 0, 3, 8, 11, 100], np.int32)
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(valid)).numpy()
    exp = np.asarray(jref.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(valid)))
    np.testing.assert_allclose(got, exp, **TOL)
    assert (got[:2] == 0).all() and (got[3:] != 0).all()


def test_output_dtype_is_x_dtype():
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(8, 4))
    out = ops.grouped_matmul(x, w)
    assert out.dtype == torch.bfloat16 and out.shape == (G, 8, N)
    exp = torch.einsum("gck,gkn->gcn", x.float(), w.float())
    torch.testing.assert_close(out.float(), exp, atol=2e-2, rtol=2e-2)


def test_cpu_route_takes_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _inputs(8, 5))
    calls = gmm.grouped_matmul_plain.calls
    launches = ops.grouped_matmul.launches
    ops.grouped_matmul(x, w)
    assert gmm.grouped_matmul_plain.calls == calls + 1
    assert ops.grouped_matmul.launches == launches
