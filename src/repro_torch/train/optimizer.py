"""Optimizers and LR schedules (a port of ``repro.train.optimizer``).

AdamW with decoupled weight decay and global-norm gradient clipping, plus
SGD-momentum; warmup-cosine and warmup-linear schedules. The arithmetic and
its order are the reference's, in float32 (the schedules on the host in
numpy float32, as ``jnp`` evaluates them on a scalar step).

One difference of form: the reference's ``update`` is pure and returns a
tree of updates and new ``mu`` / ``nu`` trees. Here ``update`` works leaf
by leaf and in place (``mul_`` / ``add_`` under ``torch.no_grad()``):
it scales the gradients by the clip factor, moves the moments and adds the
update to the parameters, returning the gradient norm. A functional tree of
updates and moments would double the optimizer's 16 bytes a parameter
(61 GB at phi-3-vision-4.2b's width in f32). Parameter trees are the
port's: nested dicts and lists of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

_F32 = np.float32


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / list tree (dict keys in sorted order,
    lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from leaves(x)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, of the same
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# schedules: step -> float32 learning rate
# ---------------------------------------------------------------------------
def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    def schedule(step):
        step = _F32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = np.clip(t, _F32(0.0), _F32(1.0))
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + np.cos(_F32(np.pi) * t)))
        return _F32(warm if step < warmup_steps else cos)
    return schedule


def warmup_linear(peak_lr: float, warmup_steps: int,
                  total_steps: int) -> Callable:
    def schedule(step):
        step = _F32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        lin = peak_lr * np.clip(1.0 - t, _F32(0.0), _F32(1.0))
        return _F32(warm if step < warmup_steps else lin)
    return schedule


def constant(lr: float) -> Callable:
    return lambda step: _F32(lr)


# ---------------------------------------------------------------------------
# grad clipping
# ---------------------------------------------------------------------------
def global_norm(tree, reduce: Optional[Callable] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32, on the leaves'
    device: no host sync). ``reduce``, for a tree of blocks held across a
    mesh: maps the leaves' sums of squares (0-d f32 tensors, in ``leaves``
    order) to their total over the mesh, each block counted once
    (``train/sharded.py``)."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(sum(sq) if reduce is None else reduce(sq))


def clip_by_global_norm(grads, max_norm: float,
                        reduce: Optional[Callable] = None):
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``;
    returns (grads, norm before clipping); ``reduce`` as
    ``global_norm``'s."""
    norm = global_norm(grads, reduce)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in leaves(grads):
            g.mul_(scale.to(g.dtype))
    return grads, norm


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Optimizer:
    init: Callable         # params -> opt_state
    update: Callable       # (grads, opt_state, params, step,
                           # norm_reduce=None) -> grad_norm, params and
                           # opt_state updated in place; norm_reduce:
                           # global_norm's reduce
    name: str = "opt"


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                               requires_grad=False), params)


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params, step, norm_reduce=None):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm_reduce)
        else:
            gnorm = global_norm(grads, norm_reduce)
        lr = float(schedule(step))
        t = _F32(step) + _F32(1.0)
        bc1 = float(_F32(1.0) - _F32(b1) ** t)
        bc2 = float(_F32(1.0) - _F32(b2) ** t)
        with torch.no_grad():
            for g, mu, nu, p in zip(leaves(grads), leaves(state["mu"]),
                                    leaves(state["nu"]), leaves(params)):
                g32 = g.float()
                mu.mul_(b1).add_(g32, alpha=1 - b1)
                nu.mul_(b2).add_(torch.square(g32), alpha=1 - b2)
                step_ = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(eps))
                step_.add_(p.float(), alpha=weight_decay)
                p.add_(step_.mul_(-lr).to(p.dtype))
        return gnorm

    return Optimizer(init=init, update=update, name="adamw")


def sgdm(schedule: Callable, momentum: float = 0.9,
         clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        return {"mom": _zeros(params)}

    def update(grads, state, params, step, norm_reduce=None):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm_reduce)
        else:
            gnorm = global_norm(grads, norm_reduce)
        lr = float(schedule(step))
        with torch.no_grad():
            for g, m, p in zip(leaves(grads), leaves(state["mom"]),
                               leaves(params)):
                m.mul_(momentum).add_(g.float())
                p.add_((m * -lr).to(p.dtype))
        return gnorm

    return Optimizer(init=init, update=update, name="sgdm")


def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place (the reference returns
    ``params + updates``)."""
    with torch.no_grad():
        for p, u in zip(leaves(params), leaves(updates)):
            p.add_(u)

