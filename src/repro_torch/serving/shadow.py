"""Shadow ground-truth sampling: online exact-scan audit of served answers
(port of ``repro.serving.shadow``).

Calibration-split recall numbers are computed once, at build time, on
held-out queries — the Lernaean Hydra lesson (Echihabi et al.) is that
approximate-with-guarantees claims are only credible when measured against
exact ground truth *on the traffic actually served*.  The
:class:`ShadowSampler` does exactly that at a bounded cost: a
deterministic, seeded fraction of live requests is captured at harvest and
later re-executed through the session's **exact** (unfiltered) search path,
off the critical path.  Comparing the served kNN against the true kNN
yields per-query *true* recall, and every lost true neighbor is attributed
to the leaf that held it and the bound that pruned that leaf — naming the
guilty filter for :meth:`repro_torch.serving.telemetry.Telemetry.
filters_needing_attention`.

Sampling is a pure function of the request id (Knuth multiplicative hash),
so reruns of the same trace shadow the same requests regardless of
batching, pipelining or arrival timing — the determinism tests rely on
this.

Attribution is post-hoc against the *served* k-th distance ``kth`` (the
final bsf) and the warm-start seed ``ub`` the batch was dispatched with.
For a missed true neighbor residing in leaf ``l``:

* ``box``    — ``d_lb[l] > kth``: the summarization lower bound excluded
  it.  Cannot happen for a true miss up to float rounding (the lower bound
  is exact: ``d_lb[l] ≤ d(q, x) < kth`` for any true neighbor ``x`` in
  ``l``), so this label is effectively a float-tie diagnostic.
* ``seed``   — ``d_lb[l] ≤ kth`` but ``d_lb[l] > min(kth, ub)``: only the
  warm-start bound excluded it.  Same exactness argument (``ub`` upper
  bounds the true k-th distance; see :mod:`repro_torch.serving.warmstart`),
  same
  diagnostic role.
* ``filter`` — ``d_F[l] > kth``: the conformal-adjusted learned filter
  would have pruned the leaf at the final bsf.  This is the expected
  attribution for real misses — LeaFi's whole bargain is that *only* the
  filters may trade recall.
* ``timing`` — none of the above fired against the final bsf: the leaf
  was pruned mid-cascade against a looser intermediate bsf that a bound
  cannot re-trigger post-hoc (rare; counted but never flags a filter).

The bounds are checked in cascade order (box → seed → filter), mirroring
the engine's attribution stages (``repro_torch.obs.trace``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from ..core import bounds as bounds_mod
from ..core import conformal, search

_KNUTH = 2654435761                      # Knuth multiplicative hash constant


def sample_mask(rids: Sequence[int], rate: float,
                seed: int = 0) -> np.ndarray:
    """Deterministic per-request sampling decision, batching-invariant.

    ``hash(rid) = (rid · 2654435761 + seed) mod 2³²`` mapped to [0, 1);
    a request is shadowed iff that value is below ``rate``.
    """
    r = np.asarray(rids, np.uint64)
    h = (r * np.uint64(_KNUTH) + np.uint64(seed)) % np.uint64(1 << 32)
    return (h.astype(np.float64) / float(1 << 32)) < float(rate)


def leaf_of_ids(index, ids: Sequence[int]) -> np.ndarray:
    """Global leaf id holding each *original* series id.

    ``index.order`` maps sorted position → original id; inverting it and
    bucketing by ``leaf_start`` names the leaf:
    ``searchsorted(leaf_start, pos, right) − 1``, on the index's device.
    """
    order = index.order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    pos = inv[torch.as_tensor(np.asarray(ids, np.int64), device=order.device)]
    return (torch.searchsorted(index.leaf_start, pos, right=True)
            - 1).cpu().numpy()


def _bound_rows(lfi, queries: np.ndarray, targets: Optional[np.ndarray],
                device: Optional[torch.device] = None) -> tuple:
    """(Q, L) summarization lower bounds + conformal-adjusted filter bounds
    for ``queries`` (−inf d_F where no filter / filters unused), computed
    on ``device`` (the index's, by default) and brought to the host."""
    dev = lfi.index.device if device is None else device
    q = torch.atleast_2d(torch.as_tensor(np.asarray(queries, np.float32),
                                         device=dev))
    d_lb = bounds_mod.lower_bounds(lfi.index, q).cpu().numpy()
    if lfi.filter_params is None or targets is None:
        return d_lb, np.full_like(d_lb, -np.inf)
    offsets = None
    if lfi.tuner is not None:
        offsets = lfi.tuner.offsets(np.asarray(targets, np.float64))
    d_F = search.predictions_for_all_leaves(
        lfi.index, lfi.filter_params, lfi.leaf_ids, q, offsets,
        filter_type=lfi.config.filter_type).cpu().numpy()
    return d_lb, d_F


def attribute_misses(served_dists, served_ids, true_dists, true_ids,
                     d_lb_row, d_F_row, ub: float,
                     leaf_of: np.ndarray) -> tuple:
    """Score one query's served kNN against its exact kNN.

    Rank-wise hit rule shared with calibration
    (:func:`repro_torch.core.conformal.recall_at_1`, applied per rank), so
    the
    shadow recall estimator and the calibration-split estimator agree in
    definition.  Returns ``(recall, misses)`` where each miss dict carries
    the lost neighbor's id/distance, its leaf, and the attributed bound.
    """
    sd = np.asarray(served_dists, np.float32).reshape(-1)
    td = np.asarray(true_dists, np.float32).reshape(-1)
    hits = conformal.recall_at_1(torch.from_numpy(sd),
                                 torch.from_numpy(td)).numpy() > 0
    kth = float(sd[-1])
    misses = []
    for j in np.nonzero(~hits)[0]:
        leaf = int(leaf_of[j])
        lb = float(d_lb_row[leaf])
        d_f = float(d_F_row[leaf])
        if lb > kth:
            bound = "box"
        elif np.isfinite(ub) and lb > min(kth, float(ub)):
            bound = "seed"
        elif d_f > kth:
            bound = "filter"
        else:
            bound = "timing"
        misses.append({"id": int(np.asarray(true_ids).reshape(-1)[j]),
                       "rank": int(j),
                       "dist": float(td[j]), "leaf": leaf, "bound": bound,
                       "d_lb": lb, "d_F": d_f, "served_kth": kth})
    return float(hits.mean()), misses


@dataclasses.dataclass
class _Captured:
    """One shadow-sampled request awaiting its exact re-execution."""
    rid: int
    query: np.ndarray
    target: Optional[float]
    k: int
    served_dists: np.ndarray     # (k,)
    served_ids: np.ndarray       # (k,)
    ub: float                    # warm-start seed at dispatch (+inf if none)


class ShadowSampler:
    """Deterministic sampled exact-scan auditor for a serving session.

    Duck-typed over the session: needs ``session.lfi`` and
    ``session.search_exact`` only.  :meth:`capture` is called by
    ``ServingSession.harvest`` for every answered batch (cheap: a hash per
    request, a row copy per sampled request); :meth:`drain` runs the
    accumulated exact scans in bulk — call it off the critical path
    (``ServingSession.serve`` drains once per trace).
    """

    def __init__(self, session, rate: float, seed: int = 0):
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"shadow rate must be in [0, 1], got {rate}")
        self.session = session
        self.rate = float(rate)
        self.seed = int(seed)
        self._pending: List[_Captured] = []
        self.n_shadowed = 0              # lifetime drained shadow queries
        self.n_misses = 0
        self._recall_hits = 0.0          # Σ per-query recall (for the mean)
        self.reports: List[dict] = []    # per-query drained reports

    # -- capture (harvest path, cheap) --------------------------------------

    def wants(self, rid: int) -> bool:
        return bool(sample_mask([rid], self.rate, self.seed)[0])

    def capture(self, batch, res,
                bsf_ub: Optional[np.ndarray] = None) -> int:
        """Stash this batch's sampled requests; returns how many."""
        take = sample_mask(batch.rids, self.rate, self.seed)
        dists = np.asarray(res.dists)
        ids = np.asarray(res.ids)
        n = 0
        for i in np.nonzero(take)[0]:
            ub = float("inf") if bsf_ub is None else float(bsf_ub[i])
            self._pending.append(_Captured(
                rid=int(batch.rids[i]), query=batch.queries[i].copy(),
                target=(None if batch.targets is None
                        else float(batch.targets[i])),
                k=int(batch.k), served_dists=dists[i].copy(),
                served_ids=ids[i].copy(), ub=ub))
            n += 1
        return n

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    # -- drain (off the critical path) --------------------------------------

    def drain(self) -> dict:
        """Exact-scan every captured request; score + attribute misses.

        Returns a batch report (``n_shadowed``, ``recall_mean``, flattened
        ``misses``, ``per_query`` details) and folds it into the lifetime
        counters;
        :class:`~repro_torch.serving.telemetry.Telemetry.record_shadow`
        accepts it directly.
        """
        pending, self._pending = self._pending, []
        per_query: List[dict] = []
        all_misses: List[dict] = []
        by_k: Dict[int, List[_Captured]] = {}
        for e in pending:
            by_k.setdefault(e.k, []).append(e)
        for k, entries in sorted(by_k.items()):
            queries = np.stack([e.query for e in entries])
            targets = (None if all(e.target is None for e in entries)
                       else np.asarray([0.0 if e.target is None else e.target
                                        for e in entries], np.float64))
            exact = self.session.search_exact(queries, k=k)
            d_lb, d_F = _bound_rows(self.session.lfi, queries, targets,
                                    self.session.device)
            for i, e in enumerate(entries):
                true_ids = np.asarray(exact.ids)[i]
                leaf_of = leaf_of_ids(self.session.lfi.index, true_ids)
                recall, misses = attribute_misses(
                    e.served_dists, e.served_ids,
                    np.asarray(exact.dists)[i], true_ids,
                    d_lb[i], d_F[i], e.ub, leaf_of)
                for m in misses:
                    m["rid"] = e.rid
                    m["target"] = e.target
                per_query.append({"rid": e.rid, "k": k, "target": e.target,
                                  "recall": recall,
                                  "n_misses": len(misses)})
                all_misses.extend(misses)
        self.n_shadowed += len(per_query)
        self.n_misses += len(all_misses)
        self._recall_hits += sum(r["recall"] for r in per_query)
        self.reports.extend(per_query)
        return {"n_shadowed": len(per_query),
                "recall_mean": (float(np.mean([r["recall"]
                                               for r in per_query]))
                                if per_query else float("nan")),
                "misses": all_misses, "per_query": per_query}

    def summary(self) -> dict:
        """Lifetime view across every drain."""
        return {"rate": self.rate, "n_shadowed": self.n_shadowed,
                "n_misses": self.n_misses,
                "recall_mean": (self._recall_hits / self.n_shadowed
                                if self.n_shadowed else float("nan")),
                "n_pending": self.pending_count}


# ---------------------------------------------------------------------------
# per-query explain (gathers everything the renderer needs)
# ---------------------------------------------------------------------------


def explain_query(session, query: np.ndarray, *, target=None, k: int = 1,
                  rid=None, top_leaves: int = 8,
                  shadow: bool = True) -> dict:
    """Assemble the explain context for one query (see
    ``repro_torch.obs.explain``).

    Runs the session's filtered search with ``trace=True`` + ``audit=True``
    (a single-query audit's per-leaf planes *are* the per-leaf verdicts),
    plus the exact shadow scan when ``shadow=True``, and attributes every
    lost true neighbor.  Render with
    :func:`repro_torch.obs.explain.render_text` / ``render_json``.
    """
    q = np.atleast_2d(np.asarray(query, np.float32))
    qt = None if target is None else np.asarray([target], np.float64)
    res = session.search(q, quality_targets=qt, k=k, record=False,
                         trace=True, audit=True)
    d_lb, d_F = _bound_rows(session.lfi, q, qt,
                            getattr(session, "device", None))
    ctx: dict = {"k": int(k), "target": target,
                 "strategy": getattr(session, "strategy", None)}
    if rid is not None:
        ctx["rid"] = rid
    ctx["served"] = {"dists": np.asarray(res.dists)[0].tolist(),
                     "ids": np.asarray(res.ids)[0].tolist()}
    cascade = {"n_leaves": res.n_leaves,
               "searched": int(np.asarray(res.searched)[0]),
               "computed": (None if res.computed is None
                            else int(np.asarray(res.computed)[0]))}
    if res.trace is not None:
        for name in ("pruned_box", "pruned_seed", "pruned_filter",
                     "probed", "overflow", "distances"):
            cascade[name] = int(res.trace[name][0])
    ctx["cascade"] = cascade
    if res.audit is not None:
        a = res.audit
        near = np.argsort(d_lb[0], kind="stable")[:top_leaves]
        rows = []
        for leaf in near:
            leaf = int(leaf)
            if a["pruned_box"][leaf]:
                verdict = "box"
            elif a["pruned_seed"][leaf]:
                verdict = "seed"
            elif a["pruned_filter"][leaf]:
                verdict = "filter"
            else:
                verdict = "kept"
            d_f = float(d_F[0, leaf])
            rows.append({"leaf": leaf, "d_lb": float(d_lb[0, leaf]),
                         "d_F": (None if not np.isfinite(d_f) else d_f),
                         "verdict": verdict})
        ctx["leaves"] = rows
    if shadow:
        exact = session.search_exact(q, k=k)
        true_ids = np.asarray(exact.ids)[0]
        leaf_of = leaf_of_ids(session.lfi.index, true_ids)
        recall, misses = attribute_misses(
            np.asarray(res.dists)[0], np.asarray(res.ids)[0],
            np.asarray(exact.dists)[0], true_ids,
            d_lb[0], d_F[0], float("inf"), leaf_of)
        ctx["shadow"] = {"true_dists": np.asarray(exact.dists)[0].tolist(),
                         "true_ids": true_ids.tolist(),
                         "recall": recall, "misses": misses}
    telemetry = getattr(session, "telemetry", None)
    if telemetry is not None and hasattr(telemetry,
                                         "filters_needing_attention"):
        flagged = telemetry.filters_needing_attention(limit=5)
        if flagged:
            ctx["health"] = [r.to_dict() for r in flagged]
    return ctx
