"""Cross-batch bsf warm-starting for the serving runtime (port of
``repro.serving.warmstart``; host numpy).

A served batch's answers are a free by-product: every returned k-th NN
distance is a *witnessed* distance for its query.  By the triangle
inequality, a new query ``q`` that lands near a recently answered query
``q'`` inherits an upper bound on its own true k-th NN distance::

    d_k(q)  <=  ||q - q'||  +  d_k(q')

(the k points within ``d_k(q')`` of ``q'`` are all within the right-hand
side of ``q``).  :class:`BsfCache` keeps a rolling window of recent
(query, k-th distance) pairs per ``k`` and seeds each outgoing batch with
the tightest such bound over the window.

The bound is **prune-only**: the engine uses it as ``min(bsf, ub)`` in
the *lower-bound* prune (``bsf_ub`` through
:func:`repro_torch.core.engine.run_cascade`, the replay kernel's bound
instance on the card) but never in the learned-filter test — conformal
offsets are calibrated against the unseeded bsf trajectory, so a warm
filter threshold would collapse recall — and never merges it into the
top-k or the carried bsf, so returned distances stay witnessed.  In exact
mode (no filters) answers are bitwise-unchanged; with filters the
conformal recall semantics are preserved: a leaf with lb > ub holds no
true top-k member.  A small
inflation ``(1 + eps) + eps`` absorbs float32 rounding between this cache's
distance computation and the engine's.

Determinism across serving modes: pipelined serving harvests batch ``N``
*after* dispatching ``N+1``, so batch ``N+1`` cannot see batch ``N``'s
results.  Updates are therefore *staged* with their batch sequence number
and only committed at dispatch of batch ``seq`` for staged entries with
``seq_staged <= seq - 1 - warm_lag`` (``warm_lag=1``).  The serial loop
applies the same rule, holding back its freshest harvest — both modes then
observe identical cache states and produce bitwise-identical traces.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np


class BsfCache:
    """Rolling per-``k`` cache of answered (query, k-th distance) pairs."""

    def __init__(self, capacity: int = 256, inflate: float = 1e-6):
        self.capacity = int(capacity)
        self.inflate = float(inflate)
        # k → deque of (query (m,), kth_dist) pairs, newest last
        self._rings: Dict[int, deque] = {}
        # staged (seq, k, queries (B, m), dists (B,)) awaiting commit
        self._staged: List[Tuple[int, int, np.ndarray, np.ndarray]] = []

    # -- seeding -------------------------------------------------------------

    def seed(self, queries: np.ndarray, k: int) -> Optional[np.ndarray]:
        """(B,) prune-only upper bounds for ``queries``, or None when cold.

        ``ub[i] = min_j ||q_i - c_j|| + d_j`` over the ``k``-ring, inflated
        by ``(1 + eps) + eps`` against float32 rounding.
        """
        ring = self._rings.get(int(k))
        if not ring:
            return None
        cq = np.stack([e[0] for e in ring])                  # (W, m)
        cd = np.asarray([e[1] for e in ring], np.float32)    # (W,)
        q = np.asarray(queries, np.float32)
        # direct diff-based distances — the matmul decomposition can go
        # negative under cancellation, which would *tighten* the bound
        diff = q[:, None, :] - cq[None, :, :]                # (B, W, m)
        dist = np.sqrt(np.einsum("bwm,bwm->bw", diff, diff))
        ub = (dist + cd[None, :]).min(axis=1)
        return (ub * (1.0 + self.inflate) + self.inflate).astype(np.float32)

    # -- recording -----------------------------------------------------------

    def update(self, queries: np.ndarray, kth_dists: np.ndarray,
               k: int) -> None:
        """Fold answered queries into the ``k``-ring (immediately)."""
        ring = self._rings.setdefault(int(k), deque(maxlen=self.capacity))
        q = np.asarray(queries, np.float32)
        d = np.asarray(kth_dists, np.float32)
        for i in range(q.shape[0]):
            if np.isfinite(d[i]):                    # skip padded/failed rows
                ring.append((q[i].copy(), float(d[i])))

    def stage(self, seq: int, queries: np.ndarray, kth_dists: np.ndarray,
              k: int) -> None:
        """Hold a harvested batch's results until :meth:`commit_through`."""
        self._staged.append((int(seq),
                             int(k),
                             np.asarray(queries, np.float32).copy(),
                             np.asarray(kth_dists, np.float32).copy()))

    def commit_through(self, seq: int) -> None:
        """Commit staged entries with ``seq_staged <= seq`` (in seq order)."""
        due = sorted((e for e in self._staged if e[0] <= seq),
                     key=lambda e: e[0])
        self._staged = [e for e in self._staged if e[0] > seq]
        for _, k, q, d in due:
            self.update(q, d, k)

    def reset(self) -> None:
        self._rings.clear()
        self._staged.clear()

    def __len__(self) -> int:
        return sum(len(r) for r in self._rings.values())
