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


def params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX dense-, MoE- or SSM-family params (numpy leaves) -> port params
    on ``device``."""
    n_layers = {a.shape[0] for a in _leaves(tree["layers"])}
    if len(n_layers) != 1:
        raise ValueError(f"layer leaves disagree on depth: {n_layers}")
    return {
        "emb": _map(tree["emb"], lambda a: _tensor(a, device)),
        "layers": [_map(tree["layers"], lambda a, i=i: _tensor(a[i], device))
                   for i in range(n_layers.pop())],
        "final_norm": _tensor(tree["final_norm"], device),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
