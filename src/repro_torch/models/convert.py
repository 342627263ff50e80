"""Weights from the JAX package into the port.

``params_from_jax`` takes the reference ``Model.init`` pytree with every
leaf already a numpy array (``jax.tree_util.tree_map(np.asarray, params)``)
and maps each leaf one to one onto the port's layout: the layer-stacked
``[L, ...]`` leaves of ``params["layers"]`` become one dict per layer.
That covers the three families the port has: the dense layer's
``attn`` / ``mlp`` / norms, the MoE layer's ``attn``, ``router``
``[L, D, E]``, expert weights ``we_gate_up`` ``[L, E, D, 2F]`` and
``we_down`` ``[L, E, F, D]`` and norms, and the mamba2 layer's
``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``,
``gate_norm``, ``out_proj`` and ``norm``, each sliced per layer.
The hybrid family's ``shared`` layer maps as it is, its ``groups``
``[G, every, ...]`` leaves become G lists of ``every`` block dicts and its
``trailing`` ``[T, ...]`` leaves T block dicts (a stack the reference
leaves out because it is empty becomes an empty list); the
encoder-decoder family's ``enc_layers`` and ``dec_layers`` become one dict
per layer beside ``enc_norm`` and ``dec_norm``.
It never imports jax.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"params_from_jax takes numpy leaves, got {type(a)}")
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16: no numpy twin
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked: dict, device) -> list:
    """Layer-stacked ``[L, ...]`` leaves -> L per-layer dicts on
    ``device``."""
    depth = {a.shape[0] for a in _leaves(stacked)}
    if len(depth) != 1:
        raise ValueError(f"layer leaves disagree on depth: {depth}")
    return [_map(stacked, lambda a, i=i: _tensor(a[i], device))
            for i in range(depth.pop())]


def params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX params of any ported family (numpy leaves) -> port params on
    ``device``."""
    out = {}
    for name, sub in tree.items():
        if name in ("layers", "enc_layers", "dec_layers", "trailing"):
            out[name] = _unstack(sub, device)
        elif name == "groups":              # [G, every, ...] leaves
            n_groups = next(_leaves(sub)).shape[0]
            out[name] = [_unstack(_map(sub, lambda a, g=g: a[g]), device)
                         for g in range(n_groups)]
        else:
            out[name] = _map(sub, lambda a: _tensor(a, device))
    if "shared" in tree:                        # hybrid: empty stacks
        out.setdefault("groups", [])
        out.setdefault("trailing", [])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
