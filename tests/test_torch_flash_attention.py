"""The port's flash attention (repro_torch.kernels.flash_attention, routed
by ``ops.flash_attention``) against the JAX package, on the CPU.

The same numpy inputs go through the JAX wrapper ``ops.flash_attention``
(its Pallas kernel in interpret mode, S padded to the kernel's block) and
the ``ref.attention`` oracle, and through the port's plain version — the
function the CUDA kernel is held to on the card. Tolerance: float32 on
every side, 2e-5 (tests/test_kernels.py's): the three sum the same
products in different orders (block-wise online softmax vs one pass).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from tests._torch_tf32 import mm

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(s, hq, hkv, d, seed, b=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw).numpy()


def _both(q, k, v, **kw):
    got = _port(q, k, v, **kw)
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), **kw))
    oracle = np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    return got


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (14, 2)],
                         ids=["G1", "G4", "G7"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5])
def test_plain_matches_pallas_and_oracle(hq, hkv, causal, window):
    q, k, v = _inputs(32, hq, hkv, 32, seed=hq * 10 + window + causal, b=2)
    _both(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("window", [0, 5])
def test_ragged_causal_matches_the_padded_pallas_call(window):
    """S = 136: the JAX wrapper pads to 256 (block 128); the port masks
    the ragged end and must give the padded call's rows."""
    q, k, v = _inputs(136, 4, 1, 32, seed=3 + window)
    _both(q, k, v, causal=True, window=window)


def test_olmoe_head_dim():
    """olmoe-1b-7b's head_dim (128) with G = 1 at a short prompt."""
    q, k, v = _inputs(24, 2, 2, 128, seed=5)
    _both(q, k, v, causal=True)


def test_non_causal_ragged_raises_like_jax():
    q, k, v = _inputs(20, 2, 2, 32, seed=1)        # block 20: fine
    _port(q, k, v, causal=False)
    q, k, v = _inputs(5, 2, 2, 32, seed=1)         # block 8: 5 % 8 != 0
    with pytest.raises(ValueError, match="S % block"):
        _port(q, k, v, causal=False)
    with pytest.raises(ValueError, match="S % block"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False)
    q, k, v = _inputs(136, 2, 2, 32, seed=1)       # block 128
    with pytest.raises(ValueError, match="S % block"):
        _port(q, k, v, causal=False)
    _port(q, k, v, causal=True)


def test_window_one_sees_only_the_key_itself():
    """Causal with window 1 leaves each query one visible key, its own (no
    row of this function is ever empty): the output is that key's v."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 2, 2, 32, seed=2))
    out = ops.flash_attention(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out, v, **TOL)


def test_cpu_route_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(16, 4, 2, 32, seed=4))
    calls = fa.flash_attention_plain.calls
    launches = ops.flash_attention.launches
    ops.flash_attention(q, k, v)
    assert fa.flash_attention_plain.calls == calls + 1
    assert ops.flash_attention.launches == launches


def test_strided_inputs_give_the_contiguous_result():
    """The CUDA kernel reads q/k/v through their strides; the plain
    version must agree for views such as slices of a fused QKV."""
    q, k, v = _inputs(16, 4, 2, 32, seed=6)
    fused = torch.from_numpy(np.concatenate([q, k, v], axis=2))
    qv, kv, vv = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:]
    assert not qv.is_contiguous()
    np.testing.assert_allclose(ops.flash_attention(qv, kv, vv).numpy(),
                               _port(q, k, v), **TOL)


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic: three TF32 passes on the tensor cores
# ---------------------------------------------------------------------------
def _emulated_flash(q, k, v, passes):
    """Causal attention with both products through ``mm``: q [B, S, Hq,
    D], k/v [B, S, Hkv, D] -> [B, S, Hq, D]."""
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    s = mm(qh, kh.transpose(-1, -2), passes) / np.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[1])
    mask = pos[:, None] >= pos[None, :]
    s = s.masked_fill(~mask, fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = mm(p, vh, passes) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2)


@pytest.mark.parametrize("passes", [1, 3])
def test_three_tf32_passes_keep_f32_accuracy(passes):
    """At olmoe-1b-7b's prefill shape ([1, 256, 16, 128], causal) three
    TF32 passes stay within the f32 tolerance (2e-5) of the plain version;
    one pass does not, which is why the kernel runs three for f32."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(256, 16, 16, 128,
                                                    seed=11))
    exp = fa.flash_attention_plain(q, k, v)
    got = _emulated_flash(q, k, v, passes)
    close = torch.allclose(got, exp, **TOL)
    assert close == (passes == 3), (passes, (got - exp).abs().max().item())
