"""The train state: params, optimizer state and step (a port of
``repro/train/state.py``).

``make_train_step`` replaces ``jax.value_and_grad`` with ``loss.backward()``:
the params are leaves with ``requires_grad``, the optimizer reads their
``.grad`` (zeros for a leaf the loss does not reach, as JAX would give),
updates params and moments in place, and the grads are cleared after each
step. The state is updated in place and returned, as the reference returns
the new one.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.train.optimizer import Optimizer, leaves, tree_map


def create(params, optimizer: Optimizer) -> Dict[str, Any]:
    """Every param leaf becomes a leaf that requires grad."""
    for p in leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def make_train_step(loss_fn, optimizer: Optimizer):
    """(state, batch) -> (state, metrics): ``loss`` and ``grad_norm`` as
    0-d tensors on the device (reading them is the caller's sync)."""

    def train_step(state, batch):
        params = state["params"]
        loss = loss_fn(params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        gnorm = optimizer.update(grads, state["opt"], params, state["step"])
        for p in leaves(params):
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
