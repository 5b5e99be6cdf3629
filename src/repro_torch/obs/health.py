"""Windowed per-leaf filter-health scoreboard (port of
``repro.obs.health``).

:class:`LeafHealthBoard` folds two observation streams into one rolling
per-leaf view and answers the question a targeted recalibration of a
mutable index is blocked on: *which* learned filter needs attention, not
just *that* recall is drifting.

* **Audit batches** — host-side dicts of the engine's per-leaf
  :class:`~repro_torch.obs.audit.FilterAudit` (``SearchResult.audit``,
  ``repro_torch.obs.audit.to_numpy``): prune/kept counts by bound, and
  prediction-residual stats for leaves the engine scored exactly.  A
  *negative* residual (``violations`` / ``resid_min``) means the
  conformal-adjusted prediction over-estimated that leaf's true NN
  distance — the filter would over-prune whenever the bsf lands between
  the two.  These arrive for free on every audited batch, so they are the
  high-volume early-warning stream.
* **Shadow misses** — per-miss attributions from a shadow ground-truth
  sampler: a *confirmed* lost true neighbor, named by the leaf that held
  it and the bound that pruned that leaf.  These are rare (sampled) but
  each one is ground truth, so even a single filter-attributed miss flags
  its leaf.

Both streams are kept in bounded deques of recent batches (``window``
batches each), so a long-lived session reports *recent* behaviour and a
recalibration's effect is visible once the window rolls over
(:meth:`reset` drops the windows immediately).

When a :class:`~repro_torch.obs.metrics.MetricsRegistry` is attached, the
board publishes lifetime counters (``health_violations_total``,
``health_shadow_misses_total{bound=…}``) and windowed gauges
(``health_flagged_leaves``, worst-k ``health_leaf_violation_rate{leaf=…}``)
so the scoreboard exports through the same JSON-lines / Prometheus path as
every other instrument.

Layering: this module depends only on numpy and
:mod:`repro_torch.obs.metrics`, never on ``repro_torch.core``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from .metrics import MetricsRegistry

#: Bounds a shadow miss can be attributed to.
MISS_BOUNDS = ("box", "seed", "filter", "timing")


@dataclasses.dataclass
class LeafHealthReport:
    """One flagged leaf: why it needs attention, with the evidence."""

    leaf: int                    # global leaf id
    reasons: List[str]           # subset of {"violation-rate",
                                 #            "deep-violation", "shadow-miss"}
    violations: int              # windowed negative-residual observations
    resid_count: int             # windowed residual observations
    violation_rate: float        # violations / resid_count (nan when 0 obs)
    resid_min: float             # worst (most negative) windowed residual
    resid_mean: float            # windowed mean residual (nan when 0 obs)
    shadow_misses: int           # windowed filter-attributed true-NN misses
    pruned_filter: int           # windowed filter-pruned query count
    scored: int                  # windowed exactly-scored query count

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LeafHealthBoard:
    """Rolling per-leaf health over audit batches + shadow-truth misses.

    Flag criteria (tunable at construction; a leaf is flagged when *any*
    reason fires, and :meth:`filters_needing_attention` orders flagged
    leaves most-severe first — shadow misses, then violation rate):

    * ``"violation-rate"`` — windowed ``violations / resid_count`` exceeds
      ``violation_rate_threshold`` with at least ``min_resid_count``
      residual observations (so one unlucky float tie on a cold leaf
      doesn't page anyone);
    * ``"deep-violation"`` — the windowed worst residual is below
      ``resid_min_threshold`` (a single grossly unsafe prediction is
      meaningful even at a low rate: the offset no longer covers the
      error distribution's tail);
    * ``"shadow-miss"`` — at least ``min_shadow_misses`` shadow-confirmed
      true neighbors were lost to this leaf's *filter* bound (box/seed
      attributions are float-tie noise, not filter staleness — the exact
      lower bound cannot prune a true-neighbor leaf).
    """

    def __init__(self, window: int = 64,
                 registry: Optional[MetricsRegistry] = None,
                 violation_rate_threshold: float = 0.05,
                 min_resid_count: int = 8,
                 resid_min_threshold: float = -0.5,
                 min_shadow_misses: int = 1,
                 worst_k: int = 5):
        self.window = int(window)
        self.violation_rate_threshold = float(violation_rate_threshold)
        self.min_resid_count = int(min_resid_count)
        self.resid_min_threshold = float(resid_min_threshold)
        self.min_shadow_misses = int(min_shadow_misses)
        self.worst_k = int(worst_k)
        self.n_leaves: Optional[int] = None
        self._audits: deque = deque(maxlen=self.window)   # (audit dict, Q)
        self._shadows: deque = deque(maxlen=self.window)  # list[miss dict]
        self.n_shadowed = 0                               # lifetime queries
        self._c_violations = self._c_misses = None
        self._g_flagged = self._g_worst = None
        if registry is not None:
            self._c_violations = registry.counter(
                "health_violations_total",
                help="negative prediction residuals on exactly-scored "
                     "leaves (audit stream)")
            self._c_misses = registry.counter(
                "health_shadow_misses_total",
                help="shadow-confirmed lost true neighbors, by pruning "
                     "bound")
            self._g_flagged = registry.gauge(
                "health_flagged_leaves",
                help="leaves currently needing attention (windowed)")
            self._g_worst = registry.gauge(
                "health_leaf_violation_rate",
                help="windowed violation rate of the worst-k leaves")

    # -- recording -----------------------------------------------------------

    def record_audit(self, audit: Dict[str, np.ndarray],
                     n_queries: int) -> None:
        """Fold one audited batch (``SearchResult.audit``, the
        ``repro_torch.obs.audit.to_numpy`` dict)."""
        L = int(np.asarray(audit["violations"]).shape[0])
        if self.n_leaves is None:
            self.n_leaves = L
        elif L != self.n_leaves:
            raise ValueError(
                f"audit batch has {L} leaves, board tracks {self.n_leaves}")
        self._audits.append((audit, int(n_queries)))
        if self._c_violations is not None:
            self._c_violations.inc(int(np.asarray(
                audit["violations"]).sum()))
        self._publish()

    def record_shadow(self, misses: Sequence[dict],
                      n_queries: int = 0) -> None:
        """Fold one drained shadow batch's miss attributions.

        Each miss is a dict with at least ``leaf`` (global id) and
        ``bound`` (one of :data:`MISS_BOUNDS`); ``n_queries`` counts the
        shadow-sampled queries behind the batch (misses or not), so the
        board can report a windowed miss *rate*, not just a count.
        """
        batch = [dict(m) for m in misses]
        self._shadows.append(batch)
        self.n_shadowed += int(n_queries)
        if self._c_misses is not None:
            for m in batch:
                self._c_misses.inc(1, bound=str(m.get("bound", "timing")))
        self._publish()

    def reset(self) -> None:
        """Drop the rolling windows (e.g. right after a recalibration)."""
        self._audits.clear()
        self._shadows.clear()
        self._publish()

    # -- aggregation ---------------------------------------------------------

    def window_totals(self) -> Dict[str, np.ndarray]:
        """Per-leaf aggregates over the rolling window (empty dict when no
        audit batch has been recorded)."""
        if not self._audits:
            return {}
        L = self.n_leaves
        tot = {k: np.zeros(L, np.int64)
               for k in ("violations", "resid_count", "scored", "kept",
                         "pruned_box", "pruned_seed", "pruned_filter",
                         "rows_saved")}
        tot["resid_sum"] = np.zeros(L, np.float64)
        tot["resid_min"] = np.full(L, np.inf, np.float64)
        tot["n_queries"] = 0
        for audit, q in self._audits:
            for k in tot:
                if k == "n_queries":
                    tot[k] += q
                elif k == "resid_min":
                    tot[k] = np.minimum(tot[k], np.asarray(audit[k],
                                                           np.float64))
                else:
                    tot[k] = tot[k] + np.asarray(audit[k], tot[k].dtype)
        misses = np.zeros(L, np.int64)          # filter-attributed only
        misses_any = np.zeros(L, np.int64)
        for batch in self._shadows:
            for m in batch:
                leaf = int(m.get("leaf", -1))
                if 0 <= leaf < L:
                    misses_any[leaf] += 1
                    if m.get("bound") == "filter":
                        misses[leaf] += 1
        tot["shadow_misses"] = misses
        tot["shadow_misses_any_bound"] = misses_any
        return tot

    def filters_needing_attention(
            self, limit: Optional[int] = None) -> List[LeafHealthReport]:
        """Flagged leaves, most severe first (the recalibration trigger).

        Severity order: shadow-confirmed filter misses (ground truth)
        descending, then windowed violation rate, then worst residual.
        ``limit`` caps the list (default: every flagged leaf).
        """
        tot = self.window_totals()
        if not tot:
            return []
        count = np.maximum(tot["resid_count"], 1)
        rate = tot["violations"] / count
        reports = []
        for leaf in range(self.n_leaves):
            reasons = []
            if (tot["resid_count"][leaf] >= self.min_resid_count
                    and rate[leaf] > self.violation_rate_threshold):
                reasons.append("violation-rate")
            if (tot["violations"][leaf] > 0
                    and tot["resid_min"][leaf] < self.resid_min_threshold):
                reasons.append("deep-violation")
            if tot["shadow_misses"][leaf] >= self.min_shadow_misses:
                reasons.append("shadow-miss")
            if not reasons:
                continue
            rc = int(tot["resid_count"][leaf])
            reports.append(LeafHealthReport(
                leaf=leaf, reasons=reasons,
                violations=int(tot["violations"][leaf]), resid_count=rc,
                violation_rate=(float(rate[leaf]) if rc else float("nan")),
                resid_min=float(tot["resid_min"][leaf]),
                resid_mean=(float(tot["resid_sum"][leaf]) / rc if rc
                            else float("nan")),
                shadow_misses=int(tot["shadow_misses"][leaf]),
                pruned_filter=int(tot["pruned_filter"][leaf]),
                scored=int(tot["scored"][leaf])))
        reports.sort(key=lambda r: (-r.shadow_misses, -r.violation_rate,
                                    r.resid_min, r.leaf))
        return reports[:limit] if limit is not None else reports

    def snapshot(self) -> dict:
        """JSON-serializable dump: flags + the per-leaf window table."""
        tot = self.window_totals()
        out = {
            "n_leaves": self.n_leaves,
            "window_batches": len(self._audits),
            "n_shadowed_lifetime": self.n_shadowed,
            "filters_needing_attention": [
                r.to_dict() for r in self.filters_needing_attention()],
        }
        if tot:
            out["leaves"] = {
                k: np.asarray(v).tolist() for k, v in tot.items()
                if isinstance(v, np.ndarray)}
            out["n_queries_windowed"] = int(tot["n_queries"])
        return out

    # -- registry publication ------------------------------------------------

    def _publish(self) -> None:
        if self._g_flagged is None:
            return
        flagged = self.filters_needing_attention()
        self._g_flagged.set(len(flagged))
        tot = self.window_totals()
        if not tot:
            return
        rate = tot["violations"] / np.maximum(tot["resid_count"], 1)
        worst = np.argsort(-rate, kind="stable")[:self.worst_k]
        for leaf in worst:
            self._g_worst.set(float(rate[leaf]), leaf=str(int(leaf)))
