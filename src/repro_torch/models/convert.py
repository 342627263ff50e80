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

``params_to_jax`` is the inverse: port params (any device) -> the
reference's layout with numpy leaves, per-layer lists stacked back into
``[L, ...]`` leaves, hybrid ``groups`` into ``[G, every, ...]`` and an
empty stack left out. ``state_from_jax`` carries a whole reference train
state (``{"params", "opt": {"mu", "nu"} or {"mom"}, "step"}``, numpy
leaves) into the port's (``repro_torch.train.state``): params that require
grad, moments in f32, the step an int; ``state_to_jax`` goes back.
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


#: the top-level names whose leaves the reference stacks along a leading
#: layer axis (``groups`` stacks two axes)
_STACKED = ("layers", "enc_layers", "dec_layers", "trailing")


def _stack(items: list, leaf, stack):
    """Same-structured per-layer trees -> one tree of stacked leaves."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items], leaf, stack)
                for k in items[0]}
    return stack([leaf(t) for t in items])


def jax_layout(tree: dict, leaf, stack) -> dict:
    """Port params -> the reference's structure with ``leaf`` applied to
    each tensor and ``stack`` joining the per-layer values (``np.stack``
    for arrays, or a shape rule for shapes)."""
    out = {}
    for name, sub in tree.items():
        if name in _STACKED:
            if sub:
                out[name] = _stack(sub, leaf, stack)
        elif name == "groups":
            if sub:
                out[name] = _stack([_stack(g, leaf, stack) for g in sub],
                                   lambda x: x, stack)
        else:
            out[name] = _map(sub, leaf)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def params_to_jax(params: dict) -> dict:
    """Port params -> the reference's params pytree with numpy leaves."""
    return jax_layout(params, _numpy, np.stack)


def state_from_jax(state: dict, device="cuda") -> dict:
    """A reference train state (numpy leaves) -> the port's: params on
    ``device`` requiring grad, the optimizer's trees as params, the step an
    int."""
    params = params_from_jax(state["params"], device)
    for p in _leaves(params):
        p.requires_grad_(True)
    opt = {k: params_from_jax(v, device) for k, v in state["opt"].items()}
    return {"params": params, "opt": opt, "step": int(state["step"])}


def state_to_jax(state: dict) -> dict:
    """The port's train state -> the reference's layout, numpy leaves (the
    step an int32 scalar)."""
    return {"params": params_to_jax(state["params"]),
            "opt": {k: params_to_jax(v) for k, v in state["opt"].items()},
            "step": np.asarray(state["step"], np.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
