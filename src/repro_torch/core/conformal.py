"""Conformal auto-tuners, paper §4.4 (port of ``repro.core.conformal``).

Per filter, the absolute prediction errors on the calibration split are the
candidate offsets.  Rank j across all filters jointly is one operating
point; replaying the search on the calibration queries at each rank gives
(achieved quality, offset) examples, and a monotone Steffen spline maps a
requested quality target to per-filter offsets at query time.  The replay
is the engine's own :func:`engine.replay_cascade`, run once over all ranks
stacked on the query axis (the reference vmaps it over ranks).  The spline
and the isotonic fit are host numpy, copied from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import engine


def simulate_search(d_lb: torch.Tensor, d_pred: torch.Tensor,
                    offsets: torch.Tensor, d_L: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay Alg. 2 on precollected (Q, L) matrices.

    d_pred is −inf where a leaf has no filter; offsets is (L,) or (J, L),
    one row per operating point.  Returns (bsf_final, searched_count), each
    (Q,) or (J, Q): every row of offsets replays against every query in one
    batched replay.
    """
    Q, L = d_lb.shape
    offs = offsets.reshape(-1, L)
    J = offs.shape[0]
    d_F = (d_pred[None] - offs[:, None, :]).reshape(J * Q, L)
    order = torch.argsort(d_lb, dim=1, stable=True).repeat(J, 1)
    leaf_d = d_L[..., None].repeat(J, 1, 1)                 # (J·Q, L, 1)
    leaf_i = torch.zeros(leaf_d.shape, dtype=torch.int64, device=d_L.device)
    bsf, _, n_s, _, _ = engine.replay_cascade(
        leaf_d, leaf_i, d_lb.repeat(J, 1), d_F, order, k=1)
    bsf, n_s = bsf[:, 0].reshape(J, Q), n_s.reshape(J, Q)
    if offsets.dim() == 1:
        return bsf[0], n_s[0]
    return bsf, n_s


def recall_at_1(bsf_final: torch.Tensor, d_nn: torch.Tensor,
                rtol: float = 1e-5) -> torch.Tensor:
    """A query is correct iff the returned distance equals the true NN's."""
    return (bsf_final <= d_nn * (1 + rtol) + 1e-6).float()


# ---------------------------------------------------------------------------
# Steffen (1990) monotone spline, vectorized over filters
# ---------------------------------------------------------------------------


def _steffen_slopes(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """x (K,), y (F, K) → per-knot slopes (F, K), monotonicity-preserving."""
    h = np.diff(x)                                  # (K-1,)
    s = np.diff(y, axis=1) / h                      # (F, K-1)
    d = np.zeros_like(y)
    if x.size == 1:
        return d
    p = (s[:, :-1] * h[1:] + s[:, 1:] * h[:-1]) / (h[:-1] + h[1:])
    d[:, 1:-1] = (np.sign(s[:, :-1]) + np.sign(s[:, 1:])) * np.minimum(
        np.minimum(np.abs(s[:, :-1]), np.abs(s[:, 1:])), 0.5 * np.abs(p))
    d[:, 0] = s[:, 0]
    d[:, -1] = s[:, -1]
    return d


@dataclasses.dataclass
class AutoTuner:
    """Fitted q → o mapping for every filter (shared quality knots)."""
    knots_q: np.ndarray          # (K,) strictly increasing qualities
    knots_o: np.ndarray          # (F, K) offsets per filter
    slopes: np.ndarray           # (F, K) Steffen slopes
    max_offset: np.ndarray       # (F,) most conservative offset observed

    def offsets(self, target, safety: float = 0.0) -> np.ndarray:
        """Per-filter offsets: one target → (F,), B per-query targets →
        (B, F) rows, each bitwise-equal to the scalar call.  ``safety``
        aims the spline at target + safety·(1 − target)."""
        t = np.asarray(target, np.float64)
        out = self._offsets_batch(np.atleast_1d(t), safety)
        return out[0] if t.ndim == 0 else out

    def _offsets_batch(self, targets: np.ndarray,
                       safety: float = 0.0) -> np.ndarray:
        """(B,) targets → (B, F) offsets; one vectorized spline evaluation."""
        if safety:
            targets = targets + safety * (1.0 - targets)
        x, y, d = self.knots_q, self.knots_o, self.slopes
        B, F = targets.shape[0], y.shape[0]
        if x.size == 1:
            return np.broadcast_to(y[:, 0], (B, F)).copy()
        out = np.empty((B, F), y.dtype)
        # targets beyond anything achieved in simulation: be maximally
        # conservative (largest calibrated offset).
        hi = targets >= x[-1]
        out[hi] = self.max_offset
        if (~hi).any():
            q = np.clip(targets[~hi], x[0], x[-1])
            i = np.clip(np.searchsorted(x, q, side="right") - 1, 0, x.size - 2)
            h = x[i + 1] - x[i]                           # (b,)
            t = q - x[i]
            s = (y[:, i + 1] - y[:, i]) / h               # (F, b)
            a = (d[:, i] + d[:, i + 1] - 2 * s) / (h * h)
            b = (3 * s - 2 * d[:, i] - d[:, i + 1]) / h
            out[~hi] = (((a * t + b) * t + d[:, i]) * t + y[:, i]).T
        return out


def _pava_nondecreasing(y: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: project y (F, J) onto non-decreasing rows."""
    y = y.copy()
    F, J = y.shape
    for f in range(F):
        vals = []
        counts = []
        for v in y[f]:
            vals.append(float(v))
            counts.append(1)
            while len(vals) > 1 and vals[-2] > vals[-1]:
                v2, c2 = vals.pop(), counts.pop()
                v1, c1 = vals.pop(), counts.pop()
                vals.append((v1 * c1 + v2 * c2) / (c1 + c2))
                counts.append(c1 + c2)
        y[f] = np.repeat(vals, counts)
    return y


# ---------------------------------------------------------------------------
# Auto-tuner learning (Alg. 4)
# ---------------------------------------------------------------------------


def fit_autotuners(d_lb: torch.Tensor, d_pred: torch.Tensor,
                   d_L: torch.Tensor, leaf_ids: np.ndarray,
                   max_ranks: int = 64) -> Tuple[AutoTuner, dict]:
    """Learn per-filter quality→offset mappings by simulated search.

    d_lb, d_pred (−inf where no filter), d_L: (C, L) calibration matrices,
    on the device the replay runs on; leaf_ids (F,) leaves with filters.
    """
    C, L = d_lb.shape
    leaf_ids = np.asarray(leaf_ids)
    pred_np = d_pred.cpu().numpy()
    dl_np = d_L.cpu().numpy()
    alphas = np.abs(pred_np[:, leaf_ids] - dl_np[:, leaf_ids])    # (C, F)
    A = -np.sort(-alphas, axis=0)                                 # desc, (C, F)

    # subsample ranks for the simulation sweep (quantile-spaced)
    ranks = np.unique(np.linspace(0, C - 1, min(max_ranks, C)).astype(int))
    offsets_per_rank = np.zeros((len(ranks), L), np.float32)
    for r, j in enumerate(ranks):
        offsets_per_rank[r, leaf_ids] = A[j]

    d_nn = d_L.amin(dim=1)
    bsf, searched = simulate_search(
        d_lb, d_pred, torch.from_numpy(offsets_per_rank).to(d_lb.device),
        d_L)                                                      # (J, C)
    quality = recall_at_1(bsf, d_nn[None, :]).mean(dim=1).cpu().numpy()
    pruning = 1.0 - searched.cpu().numpy().mean(axis=1) / L

    # examples (q_j, o_{f,j}) → monotone mapping q → o
    orderq = np.argsort(quality, kind="stable")
    q_sorted = quality[orderq]
    o_sorted = A[ranks][orderq].T.astype(np.float64)              # (F, J)
    o_iso = _pava_nondecreasing(o_sorted)

    # collapse duplicate quality knots (keep the largest = safest offset)
    uq, inverse = np.unique(np.round(q_sorted, 6), return_inverse=True)
    K = len(uq)
    o_knots = np.full((len(leaf_ids), K), -np.inf)
    np.maximum.at(o_knots.T, inverse, o_iso.T)
    slopes = (_steffen_slopes(uq, o_knots) if K > 1
              else np.zeros_like(o_knots))

    tuner = AutoTuner(knots_q=uq, knots_o=o_knots.astype(np.float32),
                      slopes=slopes.astype(np.float32),
                      max_offset=A.max(axis=0).astype(np.float32))
    report = {"rank_quality": quality, "rank_pruning": pruning,
              "ranks": ranks}
    return tuner, report


def scatter_offsets(tuner: Optional[AutoTuner], leaf_ids: np.ndarray,
                    n_leaves: int, target) -> np.ndarray:
    """Offset vector(s) for quality target(s); zeros where no filter.  One
    target → (L,); B per-query targets → (B, L).  tuner=None (no filters)
    gives the exact index's zeros."""
    t = None if target is None else np.asarray(target, np.float64)
    if t is not None and t.ndim:
        out = np.zeros((t.shape[0], n_leaves), np.float32)
        if tuner is not None and len(leaf_ids):
            out[:, leaf_ids] = tuner.offsets(t)
        return out
    out = np.zeros(n_leaves, np.float32)
    if target is not None and tuner is not None and len(leaf_ids):
        out[leaf_ids] = tuner.offsets(target)
    return out
