"""Series summarizations: PAA and EAPCA (port of ``repro.core.summaries``).

``paa``, ``segment_stats`` and ``znormalize`` take tensors and run wherever
the tensor lies: the tree builder calls them on the host, the lower bounds
and the training-query generator on the card.  ``eapca_node_box`` is the
host-side numpy aggregate the tree builder uses.  The arithmetic follows the
reference's op order (mean, then the mean of squared deviations), so the
statistics, and the trees built on them, match it.
"""
from __future__ import annotations

import numpy as np
import torch


def _segments(series: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(..., m) → (..., n_segments, ceil(m / n_segments)), repeat-edge padded."""
    m = series.shape[-1]
    seg = -(-m // n_segments)
    pad = seg * n_segments - m
    if pad:
        edge = series[..., -1:].expand(*series.shape[:-1], pad)
        series = torch.cat([series, edge], dim=-1)
    return series.reshape(*series.shape[:-1], n_segments, seg)


def paa(series: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Piecewise aggregate approximation: (..., m) → (..., n_segments)."""
    return _segments(series, n_segments).mean(dim=-1)


def segment_stats(series: torch.Tensor, n_segments: int) -> torch.Tensor:
    """EAPCA statistics, per-segment (mean, std): (..., m) → (..., s, 2)."""
    shaped = _segments(series, n_segments)
    mean = shaped.mean(dim=-1)
    centered = shaped - mean[..., None]
    std = torch.sqrt((centered * centered).mean(dim=-1))
    return torch.stack([mean, std], dim=-1)


def eapca_node_box(stats: np.ndarray) -> np.ndarray:
    """Per-series stats of one node (n_node, s, 2) → its box (s, 4):
    [mean_min, mean_max, std_min, std_max]."""
    stats = np.asarray(stats)
    return np.stack(
        [
            stats[..., 0].min(axis=0),
            stats[..., 0].max(axis=0),
            stats[..., 1].min(axis=0),
            stats[..., 1].max(axis=0),
        ],
        axis=-1,
    ).astype(np.float32)


def znormalize(series: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-series z-normalization (standard in the data-series literature)."""
    series = series.float()
    mu = series.mean(dim=-1, keepdim=True)
    centered = series - mu
    sd = torch.sqrt((centered * centered).mean(dim=-1, keepdim=True))
    return centered / (sd + eps)
