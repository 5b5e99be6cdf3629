"""Leaf-node selection, Alg. 3 (port of ``repro.core.selection``).

Under the paper's uniform-probability assumption the knapsack of Eq. 1
collapses to the greedy rule: take leaves larger than th = a·t_F/t_S,
largest first, until the memory budget runs out.  Host numpy.
"""
from __future__ import annotations

import numpy as np


def size_threshold(t_filter: float, t_series: float, a: float = 2.0) -> float:
    """th = a · t_F / t_S  (Eq. 4).  a = 1/p_F; the paper uses a = 2."""
    return a * t_filter / max(t_series, 1e-30)


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


def select_leaves(leaf_sizes: np.ndarray, *, t_filter: float,
                  t_series: float, a: float = 2.0, filter_bytes: int,
                  memory_budget_bytes: int) -> np.ndarray:
    """End-to-end Alg. 3: threshold + memory cap → selected leaf ids."""
    th = size_threshold(t_filter, t_series, a)
    max_filters = int(memory_budget_bytes // max(filter_bytes, 1))
    return greedy_select(leaf_sizes, th, max_filters)
