"""Comparison approaches from the paper's evaluation, §5.1 (port of
``repro.core.baselines``; host numpy, the reference's arithmetic).

All baselines (and LeaFi itself) are *simulated* from precollected
(d_lb, d_L) matrices plus a visiting order, exactly as the paper measures
them: the searched-leaf count is the hardware-agnostic search-time surrogate
(paper Fig. 1a, footnote 1).  The simulators share one core loop, the
lower-bound-order walk that ``search.search_early`` runs on real data, so
that the comparison is apples-to-apples.  On the card the matrices come
from the port's kernels (``bounds.lower_bounds``,
``filter_training.nodewise_nn_distances``,
``search.predictions_for_all_leaves``); the simulators themselves are host
loops.

* exact        — summarization-LB pruning only (the backbone index).
* ε-search     — prune when d_lb > d_bsf/(1+ε)  [16].
* δε-search    — ε-search + early stop once bsf ≤ the δ-quantile estimate of
                 the NN distance distribution  [16].
* ProS         — early stop when a learned model, fed best-so-far features at
                 checkpoints, predicts the NN has been found  [14, 22].
* LT (FLT)     — learned early-termination: predict the stop position from
                 bsf-trajectory features, expanded by a tuned multiplier [33].
* LR           — optimal leaf reordering: the NN's leaf is visited first [26].
* LeaFi        — the paper's learned-filter cascade.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass
class SimResult:
    searched: np.ndarray          # (Q,) leaves scanned
    bsf: np.ndarray               # (Q,) final answer distance
    recall: np.ndarray            # (Q,) 0/1 recall-at-1
    n_leaves: int

    @property
    def pruning_ratio(self):
        return 1.0 - self.searched / self.n_leaves

    def summary(self) -> Dict[str, float]:
        return {
            "recall": float(self.recall.mean()),
            "searched": float(self.searched.mean()),
            "pruning_ratio": float(self.pruning_ratio.mean()),
        }


def _finish(searched, bsf, d_L):
    d_nn = d_L.min(axis=1)
    recall = (bsf <= d_nn * (1 + 1e-5) + 1e-6).astype(np.float32)
    return SimResult(searched=searched, bsf=bsf, recall=recall,
                     n_leaves=d_L.shape[1])


def _core_sim(d_lb: np.ndarray, d_L: np.ndarray,
              order: np.ndarray,
              lb_scale: float = 1.0,
              d_F: Optional[np.ndarray] = None,
              stop_rule: Optional[Callable] = None) -> SimResult:
    """Shared sequential simulator.

    stop_rule(qi, step, bsf, searched) → True terminates query qi's search.
    """
    Q, L = d_lb.shape
    searched = np.zeros(Q, np.int64)
    bsf = np.full(Q, np.inf, np.float32)
    for qi in range(Q):
        for step in range(L):
            leaf = order[qi, step]
            if stop_rule is not None and stop_rule(qi, step, bsf[qi],
                                                   searched[qi]):
                break
            if d_lb[qi, leaf] * lb_scale > bsf[qi]:
                continue
            if d_F is not None and d_F[qi, leaf] > bsf[qi]:
                continue
            searched[qi] += 1
            if d_L[qi, leaf] < bsf[qi]:
                bsf[qi] = d_L[qi, leaf]
    return _finish(searched, bsf, d_L)


def _lb_order(d_lb):
    return np.argsort(d_lb, axis=1)


# ---------------------------------------------------------------------------


def exact_search(d_lb, d_L) -> SimResult:
    return _core_sim(d_lb, d_L, _lb_order(d_lb))


def leafi_search(d_lb, d_L, d_F) -> SimResult:
    return _core_sim(d_lb, d_L, _lb_order(d_lb), d_F=d_F)


def epsilon_search(d_lb, d_L, epsilon: float) -> SimResult:
    return _core_sim(d_lb, d_L, _lb_order(d_lb), lb_scale=1.0 + epsilon)


def tune_epsilon(d_lb_val, d_L_val, target: float = 0.99,
                 grid=np.linspace(1, 7, 13)) -> float:
    """Grid-search the max ε with ≥ target recall on the validation set."""
    best = 0.0
    for eps in grid:
        if epsilon_search(d_lb_val, d_L_val, float(eps)).recall.mean() >= target:
            best = float(eps)
    return best if best > 0 else 1.0


def delta_epsilon_search(d_lb, d_L, nn_quantile: float) -> SimResult:
    """Stop once bsf ≤ the δ-quantile estimate of the NN distance."""

    def stop(qi, step, bsf, searched):
        return bsf <= nn_quantile

    return _core_sim(d_lb, d_L, _lb_order(d_lb), stop_rule=stop)


def tune_delta(d_lb_val, d_L_val, target: float = 0.99,
               deltas=(0.9, 0.95, 0.99, 0.999)) -> float:
    """Pick the smallest δ with ≥ target recall (paper tunes on validation).

    The stop threshold is the (1−δ)-quantile of validation NN distances: a
    high δ ⇒ low threshold ⇒ conservative stopping.
    """
    d_nn = d_L_val.min(axis=1)
    chosen = None
    for delta in sorted(deltas):
        thr = float(np.quantile(d_nn, 1 - delta))
        if delta_epsilon_search(d_lb_val, d_L_val, thr).recall.mean() >= target:
            chosen = thr
            break
    if chosen is None:
        chosen = float(np.quantile(d_nn, 1 - 0.999))
    return chosen


# -- ProS: logistic model over bsf checkpoints ------------------------------


def _pros_features(d_lb, d_L, order, checkpoints):
    """bsf value after visiting `c` leaves, for each checkpoint c."""
    Q, L = d_lb.shape
    feats = np.zeros((Q, len(checkpoints)), np.float32)
    for qi in range(Q):
        bsf = np.inf
        visited = 0
        ci = 0
        for step in range(L):
            leaf = order[qi, step]
            if d_lb[qi, leaf] <= bsf:
                bsf = min(bsf, d_L[qi, leaf])
                visited += 1
            while ci < len(checkpoints) and visited >= checkpoints[ci]:
                feats[qi, ci] = bsf
                ci += 1
            if ci == len(checkpoints):
                break
        while ci < len(checkpoints):
            feats[qi, ci] = bsf
            ci += 1
    return feats


@dataclasses.dataclass
class ProsModel:
    checkpoints: tuple
    w: np.ndarray
    b: np.ndarray


def train_pros(d_lb_val, d_L_val, checkpoints=(16, 64, 256, 512, 1024, 2048),
               steps: int = 500, lr: float = 0.5) -> ProsModel:
    """Per-checkpoint logistic models: P(NN already found | bsf trajectory)."""
    L = d_lb_val.shape[1]
    checkpoints = tuple(c for c in checkpoints if c < L) or (max(L // 4, 1),)
    order = _lb_order(d_lb_val)
    feats = _pros_features(d_lb_val, d_L_val, order, checkpoints)
    d_nn = d_L_val.min(axis=1)
    # label: has the NN been found by checkpoint c?
    y = (feats <= d_nn[:, None] * (1 + 1e-5) + 1e-6).astype(np.float32)
    x = np.log1p(feats)
    w = np.zeros(len(checkpoints))
    b = np.zeros(len(checkpoints))
    for _ in range(steps):
        z = x * w + b
        p = 1 / (1 + np.exp(-z))
        g = p - y
        w -= lr * (g * x).mean(axis=0)
        b -= lr * g.mean(axis=0)
    return ProsModel(checkpoints, w, b)


def pros_search(d_lb, d_L, model: ProsModel, threshold: float = 0.5
                ) -> SimResult:
    def stop(qi, step, bsf, searched):
        for ci, c in enumerate(model.checkpoints):
            if searched == c:
                z = np.log1p(bsf) * model.w[ci] + model.b[ci]
                return 1 / (1 + np.exp(-z)) > threshold
        return False

    return _core_sim(d_lb, d_L, _lb_order(d_lb), stop_rule=stop)


# -- LT / FLT: predicted stop position × multiplier -------------------------


@dataclasses.dataclass
class LTModel:
    w: np.ndarray
    b: float
    multiplier: float
    checkpoints: tuple


def train_lt(d_lb_val, d_L_val, target: float = 0.99,
             checkpoints=(1, 2, 4, 8, 16)) -> LTModel:
    """Ridge-regress the position at which the NN is found from early-bsf
    features; tune the multiplier for ≥ target recall (paper adj. (4))."""
    L = d_lb_val.shape[1]
    checkpoints = tuple(c for c in checkpoints if c < L) or (1,)
    order = _lb_order(d_lb_val)
    feats = np.log1p(_pros_features(d_lb_val, d_L_val, order, checkpoints))
    # position (in searched-leaf count) at which NN is found:
    Q = d_lb_val.shape[0]
    pos = np.zeros(Q, np.float32)
    d_nn = d_L_val.min(axis=1)
    for qi in range(Q):
        bsf = np.inf
        searched = 0
        for step in range(L):
            leaf = order[qi, step]
            if d_lb_val[qi, leaf] <= bsf:
                searched += 1
                bsf = min(bsf, d_L_val[qi, leaf])
                if bsf <= d_nn[qi] * (1 + 1e-5) + 1e-6:
                    break
        pos[qi] = searched
    X = np.concatenate([feats, np.ones((Q, 1), np.float32)], axis=1)
    beta = np.linalg.lstsq(X.T @ X + 1e-3 * np.eye(X.shape[1]),
                           X.T @ np.log1p(pos), rcond=None)[0]
    w, b = beta[:-1], float(beta[-1])

    best_mult = 20.0
    for mult in range(1, 21):
        model = LTModel(w, b, float(mult), checkpoints)
        if lt_search(d_lb_val, d_L_val, model).recall.mean() >= target:
            best_mult = float(mult)
            break
    return LTModel(w, b, best_mult, checkpoints)


def lt_search(d_lb, d_L, model: LTModel) -> SimResult:
    order = _lb_order(d_lb)
    feats = np.log1p(_pros_features(d_lb, d_L, order, model.checkpoints))
    stop_at = model.multiplier * np.expm1(feats @ model.w + model.b)
    stop_at = np.maximum(stop_at, max(model.checkpoints))

    def stop(qi, step, bsf, searched):
        return searched >= stop_at[qi]

    return _core_sim(d_lb, d_L, order, stop_rule=stop)


# -- LR: optimal reordering --------------------------------------------------


def lr_optimal_search(d_lb, d_L) -> SimResult:
    """Visit the NN's leaf first (the best any reordering can do), then the
    rest in LB order — exact search semantics afterwards."""
    Q, L = d_lb.shape
    base = _lb_order(d_lb)
    nn_leaf = d_L.argmin(axis=1)
    order = np.zeros_like(base)
    for qi in range(Q):
        rest = base[qi][base[qi] != nn_leaf[qi]]
        order[qi, 0] = nn_leaf[qi]
        order[qi, 1:] = rest
    return _core_sim(d_lb, d_L, order)
