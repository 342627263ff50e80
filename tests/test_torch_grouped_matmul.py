"""The port's grouped matmul (repro_torch.kernels.grouped_matmul, routed by
``ops.grouped_matmul``) against the JAX package, on the CPU.

The same numpy inputs go through the JAX wrapper ``ops.grouped_matmul``
(its Pallas kernel in interpret mode, blocks shrunk to divisors, invalid
rows zeroed) and the ``ref.grouped_matmul`` oracle, and through the port's
plain version — the function the CUDA kernel is held to on the card.
Shapes keep olmoe-1b-7b's ragged capacities (40 rows for a 256-token
prompt, 8 at decode) at narrow widths. Tolerance: float32 on every side,
2e-5 (tests/test_kernels.py's): the sums run in different orders.

The CUDA kernel's own arithmetic (three TF32 passes on the tensor cores,
summed k8 step by k8 step within each K-slice of 32) is emulated here at olmoe-1b-7b's depth
(K = 2048) and held against the JAX kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops
from tests._torch_tf32 import split

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


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic: three TF32 passes, slice by slice
# ---------------------------------------------------------------------------
def _emulated_kernel(x, w, valid, passes):
    """out[g] = x[g] @ w[g] as csrc/grouped_matmul.cu sums it in f32: each
    K-slice of 32 into fresh partial sums, one m16n8k8 step of 8 K at a
    time in K order, each step lo.hi, hi.lo, hi.hi (or hi.hi alone for one
    pass) with lo truncated as the kernel hands it over; the slice's
    partials then added to the accumulator; rows at or past valid_rows
    zero."""
    (xh, xl), (wh, wl) = split(x, lo_trunc=True), split(w, lo_trunc=True)
    acc = torch.zeros(x.shape[0], x.shape[1], w.shape[2])
    for s0 in range(0, x.shape[2], 32):
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + 32, x.shape[2]), 8):
            ks = slice(k0, k0 + 8)
            if passes == 3:
                part += xl[:, :, ks] @ wh[:, ks]
                part += xh[:, :, ks] @ wl[:, ks]
            part += xh[:, :, ks] @ wh[:, ks]
        acc += part
    if valid is not None:
        rows = torch.arange(x.shape[1])[None, :] < valid[:, None]
        acc = acc * rows[..., None]
    return acc


def _deep_inputs(kind, seed):
    """olmoe-1b-7b's gate-up depth (K = 2048) and capacity (C = 40), four
    experts of 64 columns."""
    rng = np.random.default_rng(seed)
    g, c, k, n = 4, 40, 2048, 64
    x = rng.standard_normal((g, c, k)).astype(np.float32)
    w = (rng.standard_normal((g, k, n)) / np.sqrt(k)).astype(np.float32)
    valid = None
    if kind != "none":
        valid = rng.integers(1, c + 1, size=g).astype(np.int32)
        if kind == "partly_zero":
            valid[::2] = 0
    return x, w, valid


@pytest.mark.parametrize("kind", ["none", "random", "partly_zero"])
def test_three_tf32_passes_match_jax_at_olmoe_depth(kind):
    x, w, valid = _deep_inputs(kind, seed=11)
    tv = None if valid is None else torch.from_numpy(valid)
    got = _emulated_kernel(torch.from_numpy(x), torch.from_numpy(w), tv, 3)
    jv = None if valid is None else jnp.asarray(valid)
    exp = np.asarray(jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jv))
    np.testing.assert_allclose(got.numpy(), exp, **TOL)
    if valid is not None:
        assert (got.numpy()[valid == 0] == 0).all()


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why the kernel runs three passes: one TF32 pass (10 mantissa bits)
    is off by far more than 2e-5 at K = 2048."""
    x, w, _ = _deep_inputs("none", seed=12)
    exp = np.asarray(jref.grouped_matmul(jnp.asarray(x), jnp.asarray(w)))
    one = _emulated_kernel(torch.from_numpy(x), torch.from_numpy(w), None, 1)
    three = _emulated_kernel(torch.from_numpy(x), torch.from_numpy(w), None,
                             3)
    err1 = np.abs(one.numpy() - exp).max()
    err3 = np.abs(three.numpy() - exp).max()
    assert err1 > 2e-5 > err3, (err1, err3)
