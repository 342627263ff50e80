"""On-device token selection (``repro/serve/engine.py:503-524``,
``_pick_fn``): logits ``[N, V]`` -> token ids ``[N]`` int32.

Greedy is ``argmax``. With ``temperature > 0`` each row samples on its own
lane: Gumbel-max over ``logits / temperature``, everything below the k-th
logit masked to ``-inf`` first when ``top_k`` is set. Torch cannot
reproduce JAX's RNG streams, so the noise is a counter-based hash of
``(seed, step, lane, vocab index)``: 32-bit arithmetic held in int64 and
masked after every product, so the CPU and CUDA compute the same bits, and
``step`` may be a device scalar (one captured graph serves every step).
The engine passes the slot id as the lane and the scheduler step as the
step; prefill sites pass ``~step`` so a slot's prefill draw and its first
decode draw (the same scheduler step) never share a key, as in the
reference (``engine.py:526-537``).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """``(h * c) mod 2**32`` for ``h`` in [0, 2**32): ``c`` in two 16-bit
    halves keeps every product under 2**48, so int64 never wraps."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(h, x):
    """Fold ``x`` (int or int64 tensor, any sign) into the 32-bit hash
    ``h``: murmur3's finalizer of ``(h ^ x) + 0x9E3779B9``."""
    h = ((h ^ (x & _M32)) + 0x9E3779B9) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel(seed: int, step, lanes: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise ``[N, vocab]`` float64 for ``lanes`` [N] at ``step``
    (an int or an int64 scalar tensor on the lanes' device): the top 24
    bits of the hash as a uniform in (0, 1), then ``-log(-log(u))``."""
    h = _mix(_mix(0, int(seed)), step)
    h = _mix(h, lanes.long())[:, None]
    v = torch.arange(vocab, dtype=torch.int64, device=lanes.device)
    h = _mix(h, v[None, :])
    u = ((h >> 8).double() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def pick(logits: torch.Tensor, lanes: torch.Tensor, step, *,
         temperature: float = 0.0, top_k: int = 0,
         seed: int = 0) -> torch.Tensor:
    """logits [N, V] -> token ids [N] int32 on the logits' device; ``lanes``
    [N] int (slot ids), ``step`` as in ``gumbel``."""
    if temperature <= 0:
        return logits.argmax(dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    noisy = scaled.double() + gumbel(seed, step, lanes, scaled.shape[-1])
    return noisy.argmax(dim=-1).to(torch.int32)
