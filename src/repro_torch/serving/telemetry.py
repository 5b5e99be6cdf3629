"""Serving telemetry: a facade over the :mod:`repro_torch.obs.metrics`
registry (port of ``repro.serving.telemetry``; host code).

Every number the serving runtime reports — rolling latency percentiles,
pruning/survivor counters, per-target achieved recall — lives in registry
instruments (counters / gauges / windowed histograms), not in a parallel
deque implementation: ``Telemetry`` is the serving-shaped view over one
:class:`~repro_torch.obs.metrics.MetricsRegistry`.  That buys three
things:

* one export path — ``session.telemetry.registry`` snapshots/dumps as
  JSON-lines or Prometheus text like any other instrumented component
  (``launch/serve.py --metrics-dump``);
* windowed semantics for free — histograms keep lifetime count/sum plus a
  bounded rolling window, so a long-lived session reports *recent*
  behaviour (latency p50/p95/p99 over the last W requests, pruning and
  survivor counts over the last W queries);
* the recall-drift watchdog — achieved recall@1 per requested target feeds
  a :class:`~repro_torch.obs.metrics.RecallDriftMonitor`, whose per-target
  flag is the staleness hook a recalibration trigger consumes.

Determinism contract: only the ``form``/``exec`` phase histograms are fed
host wall-clock time, and they are registered ``wall=True`` so registry
snapshots segregate them under the ``"wall"`` subtree (the
trace-determinism test masks exactly that subtree).  Latency and
queue-wait ride the batcher's virtual clock under an injected
``service_time`` and are then bitwise-reproducible.

The survivor-count window doubles as the feedback signal for a
fixed-width survivor compaction: :meth:`Telemetry.suggest_max_survivors`
feeds a percentile of the observed counts to
:func:`repro_torch.core.engine.tuned_max_survivors`, replacing the static
P/8 capacity default with one the live workload justifies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import engine
from ..obs.health import LeafHealthBoard, LeafHealthReport
from ..obs.metrics import Histogram, MetricsRegistry, RecallDriftMonitor


def latency_percentiles(samples, pcts: Sequence[int] = (50, 95, 99)
                        ) -> Dict[str, float]:
    """{'p50': …, 'p95': …, 'p99': …} from a latency sample iterable.

    NaN-safe: an empty sample set yields NaN percentiles, never a
    traceback (the zero-request serve-report contract)."""
    arr = np.asarray(list(samples), np.float64)
    if arr.size == 0:
        return {f"p{p}": float("nan") for p in pcts}
    return {f"p{p}": float(np.percentile(arr, p)) for p in pcts}


def observe_recall_cell(cells: Dict[float, list], target: float,
                        hit: bool) -> None:
    """Fold one recall@1 outcome into a {target: [hits, total]} accumulator.

    The one definition of target-group keying (rounded to 6 decimals),
    shared by the lifetime :class:`Telemetry` window and the per-trace
    report in :meth:`~repro_torch.serving.session.ServingSession.serve`."""
    cell = cells.setdefault(round(float(target), 6), [0, 0])
    cell[0] += bool(hit)
    cell[1] += 1


def recall_summary(cells: Dict[float, list]) -> Dict[float, Dict[str, float]]:
    """{target: {'recall': …, 'n': …}} view of a recall-cell accumulator."""
    return {t: {"recall": h / n if n else float("nan"), "n": n}
            for t, (h, n) in sorted(cells.items())}


class _WindowView:
    """Deque-shaped live view over one histogram's (unlabeled) window.

    Keeps the pre-registry ``Telemetry`` surface working: code that reads
    ``telemetry.latencies`` / ``len(telemetry.queue_wait)`` or seeds a
    window with ``telemetry.survivors.extend([...])`` goes through the
    registry instrument, so lifetime count/sum stay consistent with the
    window it mutates.
    """

    __slots__ = ("_hist",)

    def __init__(self, hist: Histogram):
        self._hist = hist

    def _window(self):
        s = self._hist._series.get(())
        return s.window if s is not None else ()

    def __len__(self) -> int:
        return len(self._window())

    def __iter__(self):
        return iter(list(self._window()))

    def __bool__(self) -> bool:
        return len(self) > 0

    def append(self, value: float) -> None:
        self._hist.observe(float(value))

    def extend(self, values) -> None:
        self._hist.extend(values)

    def clear(self) -> None:
        self._hist.reset_window()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_WindowView({list(self._window())!r})"


class Telemetry:
    """Registry-backed rolling serving counters; one per ServingSession.

    ``registry=None`` creates a private :class:`MetricsRegistry` so
    concurrent sessions (and determinism tests) stay isolated; pass
    ``repro_torch.obs.get_registry()`` to aggregate into the process-wide
    one.
    All instrument names carry the ``serve_`` prefix.
    """

    def __init__(self, window: int = 4096,
                 registry: Optional[MetricsRegistry] = None,
                 drift_window: int = 512, drift_min_samples: int = 64,
                 drift_slack: float = 0.0):
        self.window = window
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        r = self.registry
        self._c_requests = r.counter(
            "serve_requests_total", help="valid requests answered")
        self._c_batches = r.counter(
            "serve_batches_total", help="micro-batches executed")
        self._c_padded = r.counter(
            "serve_padded_slots_total", help="wasted pow2-bucket slots")
        self._g_n_leaves = r.gauge(
            "serve_index_leaves", help="leaf count of the served index")
        self._g_pruning = r.gauge(
            "serve_pruning_ratio_windowed",
            help="1 - mean(searched)/n_leaves over the rolling window")
        self._h_latency = r.histogram(
            "serve_latency_s", window=window,
            help="end-to-end request latency (virtual clock under an "
                 "injected service_time)")
        self._h_searched = r.histogram(
            "serve_searched_leaves", window=window,
            help="leaves actually scanned per query")
        self._h_survivors = r.histogram(
            "serve_survivor_leaves", window=window,
            help="leaves the engine paid distance compute for, per query")
        self._h_queue_wait = r.histogram(
            "serve_queue_wait_s", window=window,
            help="request arrival -> batch formation (virtual clock)")
        # host wall-clock phases: segregated under the snapshot's "wall"
        # subtree so determinism tests can mask them (see module docstring)
        self._h_form = r.histogram(
            "serve_form_s", window=window, wall=True,
            help="host batch-formation + dispatch seconds per batch")
        self._h_exec = r.histogram(
            "serve_exec_s", window=window, wall=True,
            help="device-execute / harvest-wait seconds per batch")
        self.drift = RecallDriftMonitor(
            r, window=drift_window, min_samples=drift_min_samples,
            slack=drift_slack, prefix="serve")
        self.health = LeafHealthBoard(registry=r)
        self._recall: Dict[float, list] = {}              # target → [hit, n]
        self.n_leaves: Optional[int] = None

    # -- the pre-registry deque surface (live window views) -----------------

    @property
    def latencies(self) -> _WindowView:
        return _WindowView(self._h_latency)

    @property
    def searched(self) -> _WindowView:
        return _WindowView(self._h_searched)

    @property
    def survivors(self) -> _WindowView:
        return _WindowView(self._h_survivors)

    @property
    def queue_wait(self) -> _WindowView:
        return _WindowView(self._h_queue_wait)

    @property
    def form_s(self) -> _WindowView:
        return _WindowView(self._h_form)

    @property
    def exec_s(self) -> _WindowView:
        return _WindowView(self._h_exec)

    @property
    def n_requests(self) -> int:
        return int(self._c_requests.value())

    @property
    def n_batches(self) -> int:
        return int(self._c_batches.value())

    @property
    def n_padded(self) -> int:
        return int(self._c_padded.value())

    # -- recording ----------------------------------------------------------

    def record_batch(self, result, n_valid: int, bucket: int) -> None:
        """Fold one executed batch's SearchResult (valid rows only)."""
        self._c_batches.inc()
        self._c_requests.inc(n_valid)
        self._c_padded.inc(bucket - n_valid)
        self.n_leaves = result.n_leaves
        self._g_n_leaves.set(result.n_leaves)
        self._h_searched.extend(
            np.asarray(result.searched)[:n_valid].tolist())
        if result.computed is not None:
            self._h_survivors.extend(
                np.asarray(result.computed)[:n_valid].tolist())
        self._g_pruning.set(self.pruning_ratio())

    def record_latency(self, seconds: float) -> None:
        self._h_latency.observe(float(seconds))

    def record_phases(self, *, queue_wait=None, form_s: float = None,
                      exec_s: float = None) -> None:
        """Fold one batch's latency-phase observations.

        ``queue_wait``: iterable of per-request waits (arrival → batch
        formation, virtual clock); ``form_s``: host batch-formation +
        dispatch seconds; ``exec_s``: device-execute / harvest-wait seconds.
        """
        if queue_wait is not None:
            self._h_queue_wait.extend(float(w) for w in queue_wait)
        if form_s is not None:
            self._h_form.observe(float(form_s))
        if exec_s is not None:
            self._h_exec.observe(float(exec_s))

    def record_audit(self, audit: dict, n_queries: int) -> None:
        """Fold one audited batch's per-leaf FilterAudit dict
        (``SearchResult.audit``) into the rolling health board."""
        self.health.record_audit(audit, n_queries=n_queries)

    def record_shadow(self, shadow_report: dict) -> None:
        """Fold one drained shadow batch (``ShadowSampler.drain`` report):
        miss attributions reach the health board leaf-wise."""
        self.health.record_shadow(shadow_report.get("misses", ()),
                                  n_queries=shadow_report.get("n_shadowed",
                                                              0))

    def filters_needing_attention(self, **kw) -> List["LeafHealthReport"]:
        """Per-leaf staleness trigger (finer than the per-target
        :meth:`recall_drifting` hook): flagged leaves, most severe first,
        from the windowed audit + shadow evidence."""
        return self.health.filters_needing_attention(**kw)

    def observe_recall(self, target: float, hit: bool) -> None:
        """One request's recall@1 outcome against the exact oracle.

        Feeds both the lifetime per-target accumulator and the windowed
        :class:`RecallDriftMonitor` (whose per-target flag is the
        recalibration hook)."""
        observe_recall_cell(self._recall, target, hit)
        self.drift.observe(target, hit)

    def flush_windows(self) -> None:
        """Drop every histogram's windowed samples (lifetime totals and
        recall accumulators survive) — e.g. after a recalibration, so the
        rolling views describe post-change behaviour only."""
        for h in (self._h_latency, self._h_searched, self._h_survivors,
                  self._h_queue_wait, self._h_form, self._h_exec):
            h.reset_window()

    # -- reading ------------------------------------------------------------

    def latency_percentiles(self) -> Dict[str, float]:
        return latency_percentiles(self._h_latency.window_values())

    def pruning_ratio(self) -> float:
        vals = self._h_searched.window_values()
        if not vals or not self.n_leaves:
            return float("nan")
        return 1.0 - float(np.mean(vals)) / self.n_leaves

    def recall_by_target(self) -> Dict[float, Dict[str, float]]:
        return recall_summary(self._recall)

    def recall_drifting(self) -> Dict[float, bool]:
        """Per-target windowed drift flags (the recalibration hook)."""
        return self.drift.drifting()

    def suggest_max_survivors(self, n_leaves: Optional[int] = None,
                              pct: float = 99.0) -> int:
        """Percentile-based survivor capacity from the observed window.

        Cold-start guard: with fewer observations than the ``pct``-th
        percentile needs to be meaningful (≈ ``100/(100−pct)`` samples, 100
        at the default p99), the estimate is floored at the engine's static
        default — a handful of easy early queries must not lock in an
        unstable low capacity.
        """
        L = n_leaves if n_leaves is not None else (self.n_leaves or 1)
        min_samples = int(np.ceil(100.0 / max(100.0 - pct, 1.0)))
        return engine.tuned_max_survivors(
            np.asarray(self._h_survivors.window_values()), L, pct,
            min_samples=min_samples)

    def phase_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Rolling p50/p95/p99 of each latency phase (seconds)."""
        return {
            "queue_wait": latency_percentiles(
                self._h_queue_wait.window_values()),
            "form": latency_percentiles(self._h_form.window_values()),
            "execute": latency_percentiles(self._h_exec.window_values())}

    def summary(self) -> dict:
        surv = self._h_survivors.window_values()
        out = {"n_requests": self.n_requests, "n_batches": self.n_batches,
               "padding_fraction": (self.n_padded /
                                    max(self.n_padded + self.n_requests, 1)),
               "pruning_ratio": self.pruning_ratio(),
               "recall_by_target": self.recall_by_target()}
        out.update(self.latency_percentiles())
        if self.queue_wait or self.form_s or self.exec_s:
            out["phases"] = self.phase_percentiles()
        if surv:
            out["survivors_mean"] = float(np.mean(surv))
            out["suggested_max_survivors"] = self.suggest_max_survivors()
        drift = self.recall_drifting()
        if drift:
            out["recall_windowed"] = self.drift.windowed_recall()
            out["recall_drifting"] = drift
        flagged = self.filters_needing_attention()
        if flagged:
            out["filters_needing_attention"] = [r.to_dict()
                                                for r in flagged]
        return out

    def snapshot(self) -> dict:
        """The backing registry's deterministic snapshot (see obs.metrics)."""
        return self.registry.snapshot()
