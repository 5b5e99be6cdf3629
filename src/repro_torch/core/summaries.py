"""Series summarizations: PAA, SAX and EAPCA (port of
``repro.core.summaries``).

``paa``, ``segment_stats``, ``sax_from_paa`` and ``znormalize`` take tensors
and run wherever the tensor lies: the tree builder calls them on the host,
the lower bounds and the training-query generator on the card.
``eapca_node_box`` and ``sax_symbol_edges`` are the host-side numpy
aggregates the tree builders use.  The arithmetic follows the reference's
op order (mean, then the mean of squared deviations), so the statistics,
and the trees built on them, match it.

The SAX breakpoints are the inverse normal CDF at i / 2^b.  The reference
evaluates it in float32; here it is evaluated in float64 and rounded, which
differs from the reference's values by at most 2 ulp (a PAA value inside
that window can get the neighbouring symbol).
"""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _breakpoints(card_bits: int) -> torch.Tensor:
    card = 1 << card_bits
    qs = torch.arange(1, card, dtype=torch.float64) / card
    return torch.special.ndtri(qs).float()


def sax_breakpoints(card_bits: int) -> torch.Tensor:
    """The (2**card_bits - 1,) interior Gaussian equi-probable breakpoints,
    float32 on the host (a fresh copy of a cached table)."""
    return _breakpoints(card_bits).clone()


def sax_from_paa(paa_vals: torch.Tensor, card_bits: int) -> torch.Tensor:
    """SAX symbols in [0, 2**card_bits) of PAA values, int32: the number of
    breakpoints strictly below each value (left-side search)."""
    bps = _breakpoints(card_bits).to(paa_vals.device)
    return torch.searchsorted(bps, paa_vals.contiguous()).to(torch.int32)


def sax_symbol_edges(symbols: np.ndarray, card_bits: np.ndarray,
                     max_bits: int = 8) -> np.ndarray:
    """Value-space boxes of SAX symbols at per-dimension cardinalities.

    symbols (..., l) at their own cardinality, card_bits (..., l) (0 ⇒ the
    whole axis) → (..., l, 2) float32 [lower, upper], ±inf at the extremes.
    ``max_bits`` is accepted for the reference's signature; each symbol's
    box depends on its own cardinality only.
    """
    symbols = np.asarray(symbols)
    card_bits = np.broadcast_to(np.asarray(card_bits), symbols.shape)
    lo = np.full(symbols.shape, -np.inf, np.float32)
    hi = np.full(symbols.shape, np.inf, np.float32)
    for b in np.unique(card_bits):
        if b == 0:
            continue
        bps = _breakpoints(int(b)).numpy()
        mask = card_bits == b
        sym = symbols[mask]
        lo[mask] = np.where(sym > 0, bps[np.clip(sym - 1, 0, None)], -np.inf)
        hi[mask] = np.where(sym < (1 << int(b)) - 1,
                            bps[np.clip(sym, None, len(bps) - 1)], np.inf)
    return np.stack([lo, hi], axis=-1)


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
