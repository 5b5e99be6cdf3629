"""Synthetic data series (port of ``repro.data.series``, RandWalk only).

RandWalk follows the paper's protocol: cumulative sums of N(0, 1) steps.
The other stand-in generators are ROADMAP queue A.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.summaries import znormalize


def randwalk(n: int, m: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m), dtype=np.float32).cumsum(axis=1)


SERIES_GENERATORS: Dict[str, Callable] = {"randwalk": randwalk}
DEFAULT_LENGTHS = {"randwalk": 256}


def make_series_dataset(name: str, n: int, m: int | None = None,
                        seed: int = 0) -> np.ndarray:
    m = m or DEFAULT_LENGTHS[name]
    return SERIES_GENERATORS[name](n, m, seed)


def make_query_set(series: np.ndarray, n_queries: int, noise: float,
                   seed: int = 0) -> np.ndarray:
    """Paper §5.1: uniform random samples + ``noise`` gaussian noise, applied
    in z-normalized space (series have unit variance there)."""
    rng = np.random.default_rng(seed)
    picked = np.asarray(series[rng.integers(0, len(series), n_queries)],
                        np.float32)
    base = znormalize(torch.from_numpy(picked)).numpy()
    noisy = base + noise * rng.standard_normal(base.shape).astype(np.float32)
    return znormalize(torch.from_numpy(noisy)).numpy()
