"""Synthetic data series (port of ``repro.data.series``): numpy
generators, bitwise equal to the reference's for the same seed.

RandWalk follows the paper's protocol: cumulative sums of N(0, 1) steps.
The paper's four real collections (Seismic, Astro, Deep, SIFT) are not
available offline; the reference's stand-ins match their surface
statistics: length, heavy autocorrelation (seismic), bursty transients
(astro), low-dimensional clustered structure (deep and sift, at their own
widths m = 96 and 128).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.summaries import znormalize


def randwalk(n: int, m: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m), dtype=np.float32).cumsum(axis=1)


def seismic_like(n: int, m: int, seed: int = 0) -> np.ndarray:
    """AR(2)-filtered noise with occasional event bursts (heavy autocorr)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m + 64), dtype=np.float32)
    for t in range(2, m + 64):
        x[:, t] += 1.6 * x[:, t - 1] - 0.68 * x[:, t - 2]
    events = rng.random((n, 1)) < 0.3
    t0 = rng.integers(0, m, (n, 1))
    amp = rng.gamma(2.0, 2.0, (n, 1)).astype(np.float32)
    tt = np.arange(m + 64)[None, :]
    burst = amp * np.exp(-0.05 * np.abs(tt - t0 - 64)) * events
    return (x + burst.astype(np.float32))[:, 64:]


def astro_like(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Quasi-periodic light curves + flares (long-term AGN variability)."""
    rng = np.random.default_rng(seed)
    t = np.arange(m, dtype=np.float32)[None, :]
    periods = rng.uniform(8, 64, (n, 1)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n, 1)).astype(np.float32)
    amp = rng.lognormal(0, 0.5, (n, 1)).astype(np.float32)
    base = amp * np.sin(2 * np.pi * t / periods + phase)
    walk = rng.standard_normal((n, m), dtype=np.float32).cumsum(1) * 0.1
    flare_t = rng.integers(0, m, (n, 1))
    flare = (rng.random((n, 1)) < 0.4) * np.exp(
        -0.2 * np.clip(t - flare_t, 0, None)) * (t >= flare_t) * \
        rng.gamma(2, 1.5, (n, 1))
    return (base + walk + flare).astype(np.float32)


def _clustered_vectors(n: int, m: int, seed: int, n_clusters: int,
                       intrinsic_dim: int, noise: float) -> np.ndarray:
    """Near-manifold clustered vectors (image-descriptor-like)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, m), np.float32)
    sizes = rng.multinomial(n, np.ones(n_clusters) / n_clusters)
    row = 0
    for c in range(n_clusters):
        k = sizes[c]
        center = rng.standard_normal(m).astype(np.float32) * 2.0
        basis = rng.standard_normal((intrinsic_dim, m)).astype(np.float32)
        coef = rng.standard_normal((k, intrinsic_dim)).astype(np.float32)
        out[row:row + k] = center + coef @ basis / np.sqrt(intrinsic_dim) \
            + noise * rng.standard_normal((k, m)).astype(np.float32)
        row += k
    rng.shuffle(out, axis=0)
    return out


def deep_like(n: int, m: int = 96, seed: int = 0) -> np.ndarray:
    return _clustered_vectors(n, m, seed, n_clusters=max(n // 2000, 8),
                              intrinsic_dim=16, noise=0.3)


def sift_like(n: int, m: int = 128, seed: int = 0) -> np.ndarray:
    v = _clustered_vectors(n, m, seed, n_clusters=max(n // 1500, 8),
                           intrinsic_dim=24, noise=0.5)
    return np.abs(v)  # SIFT descriptors are non-negative histograms


SERIES_GENERATORS: Dict[str, Callable] = {
    "randwalk": randwalk,
    "seismic": seismic_like,
    "astro": astro_like,
    "deep": deep_like,
    "sift": sift_like,
}

DEFAULT_LENGTHS = {"randwalk": 256, "seismic": 256, "astro": 256,
                   "deep": 96, "sift": 128}


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
