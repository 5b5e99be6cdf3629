"""Leaf-node selection, paper §4.2 (port of ``repro.core.selection``).

The general formalization is a 0/1 knapsack (Eq. 1): item = filter for leaf
i, value = expected search-time reduction b_i (Eq. 2), weight = filter memory
footprint, capacity = memory budget.  Under the paper's uniform-probability
assumption it collapses to the greedy rule of Alg. 3: take leaves larger
than th = a·t_F/t_S, largest first, until the memory budget runs out.  The
build selects greedily (:func:`select_leaves`, as the reference's does);
the exact knapsack is the general solver and the tests' oracle.  Host numpy.
"""
from __future__ import annotations

import numpy as np


def size_threshold(t_filter: float, t_series: float, a: float = 2.0) -> float:
    """th = a · t_F / t_S  (Eq. 4).  a = 1/p_F; the paper uses a = 2."""
    return a * t_filter / max(t_series, 1e-30)


def expected_benefit(leaf_sizes: np.ndarray, p_lb: np.ndarray | float,
                     p_f: np.ndarray | float, t_series: float,
                     t_filter: float) -> np.ndarray:
    """b_i = (1 − p_lb)·(p_F·t_S·|N_i| − t_F)  (Eq. 2)."""
    leaf_sizes = np.asarray(leaf_sizes, np.float64)
    return (1.0 - np.asarray(p_lb)) * (
        np.asarray(p_f) * t_series * leaf_sizes - t_filter
    )


def greedy_select(leaf_sizes: np.ndarray, threshold: float,
                  max_filters: int | None = None) -> np.ndarray:
    """Leaves with |N_i| > th, largest first, until the budget; returns the
    selected leaf ids sorted by decreasing size."""
    leaf_sizes = np.asarray(leaf_sizes)
    order = np.argsort(-leaf_sizes, kind="stable")
    eligible = order[leaf_sizes[order] > threshold]
    if max_filters is not None:
        eligible = eligible[:max_filters]
    return eligible


def knapsack_select(values: np.ndarray, weights: np.ndarray,
                    capacity: int) -> np.ndarray:
    """Exact 0/1 knapsack DP (Eq. 1) over integer weights, O(n·capacity);
    returns the selected indices, ascending."""
    values = np.asarray(values, np.float64)
    weights = np.asarray(weights, np.int64)
    # items with non-positive value can never help (weights are positive)
    usable = np.where(values > 0)[0]
    best = np.zeros(capacity + 1)
    choice = np.zeros((len(usable), capacity + 1), bool)
    for row, i in enumerate(usable):
        w, v = int(weights[i]), values[i]
        if w > capacity:
            continue
        cand = best[: capacity + 1 - w] + v
        take = cand > best[w:]
        best[w:] = np.where(take, cand, best[w:])
        choice[row, w:] = take
    picked = []
    c = capacity
    for row in range(len(usable) - 1, -1, -1):
        if choice[row, c]:
            picked.append(usable[row])
            c -= int(weights[usable[row]])
    return np.asarray(sorted(picked), np.int64)


def select_leaves(leaf_sizes: np.ndarray, *, t_filter: float,
                  t_series: float, a: float = 2.0, filter_bytes: int,
                  memory_budget_bytes: int) -> np.ndarray:
    """End-to-end Alg. 3: threshold + memory cap → selected leaf ids."""
    th = size_threshold(t_filter, t_series, a)
    max_filters = int(memory_budget_bytes // max(filter_bytes, 1))
    return greedy_select(leaf_sizes, th, max_filters)
