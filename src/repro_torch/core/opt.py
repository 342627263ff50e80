"""Greedy near-optimal allocation of one resource (the part of
``repro/core/opt.py`` that serving uses, ``greedy_allocate``). The LP
``solve_ideal`` and the placement LP come with the scheduler core
(ROADMAP queue A, item 13)."""
from __future__ import annotations

from typing import List, Optional, Sequence


def greedy_allocate(curves: Sequence, total: float, *,
                    weights: Optional[Sequence[float]] = None,
                    floors: Optional[Sequence[float]] = None,
                    quantum: float = 1.0) -> List[float]:
    """Split ``total`` units of one resource over rate curves.

    Maximizes ``sum_i w_i * curve_i(x_i)`` subject to ``sum_i x_i <= total``
    and ``x_i >= floor_i`` by handing the next ``quantum`` to the consumer
    with the highest weighted marginal gain: optimal for concave curves,
    near-optimal for knee-shaped ones. A step-shaped curve is read ahead:
    each consumer's gain is its weighted rate over the smallest stride of
    quanta that shows one, and the winner takes that whole stride. Once
    every curve is flat the remainder goes out by weight (heaviest first)
    so the budgets cover the pool.
    """
    n = len(curves)
    if n == 0:
        return []
    w = list(weights) if weights is not None else [1.0] * n
    x = [float(f) for f in (floors if floors is not None else [0.0] * n)]
    if sum(x) > total + 1e-9:
        raise ValueError(
            f"floors {x} already exceed the pool ({total} units)")
    left = total - sum(x)
    while left >= quantum:
        best_i, best_rate, best_stride = -1, 0.0, 0
        for i in range(n):
            base = curves[i](x[i])
            j = 1
            while j * quantum <= left + 1e-9:
                d = curves[i](x[i] + j * quantum) - base
                if d > 1e-12:
                    rate = w[i] * d / j
                    if rate > best_rate:
                        best_i, best_rate, best_stride = i, rate, j
                    break
                j += 1
        if best_i < 0:
            break
        x[best_i] += best_stride * quantum
        left -= best_stride * quantum
    order = sorted(range(n), key=lambda i: (-w[i], i))
    j = 0
    while left >= quantum:
        x[order[j % n]] += quantum
        left -= quantum
        j += 1
    return x
