"""Observability (port of ``repro.obs``): cascade traces, filter audits,
the metrics registry, span profiling, health board and explain renderers.

This package depends only on numpy and torch, never on
``repro_torch.core``, so the engine and the build can both build on it
without cycles.

* :mod:`repro_torch.obs.trace` — ``CascadeTrace``, the per-query record
  ``engine.run_cascade(trace=True)`` returns: which bound pruned which
  leaf, survivors, probes and the exact distance rows paid.
* :mod:`repro_torch.obs.audit` — ``FilterAudit``, its per-leaf transpose:
  prune counts by bound, work saved, and the residual statistics of each
  filter's adjusted prediction on the leaves the engine scored exactly.
  Both are plain tensor code over (Q,) and (Q, L) tensors, on the device
  the engine ran on.
* :mod:`repro_torch.obs.health` — ``LeafHealthBoard``, the windowed
  per-leaf scoreboard over audited batches (``SearchResult.audit``) and
  shadow-truth misses behind the metrics registry;
  ``filters_needing_attention()`` is the staleness trigger.
* :mod:`repro_torch.obs.explain` — pure renderers (text + JSON) for
  per-query explain reports.
* :mod:`repro_torch.obs.metrics` — process-wide ``MetricsRegistry``
  (counters / gauges / windowed histograms with labels, snapshot/delta,
  JSON-lines and Prometheus export) plus the ``RecallDriftMonitor``
  staleness hook.
* :mod:`repro_torch.obs.spans` / :mod:`repro_torch.obs.export` —
  host-side span timers with ``torch.profiler.record_function``
  pass-through and Chrome trace-event JSON export (Perfetto-viewable
  timelines).  ``core/build.py`` and ``core/filter_training.py`` record
  the build's seven spans (``build.index``, ``build.collect``,
  ``collect.global``, ``collect.local``, ``build.train``, ``train.sgd``,
  ``build.calibrate``).
"""
from .audit import (AuditParts, FilterAudit, RESIDUAL_EDGES,
                    accounting_residual_leaf)
from .health import LeafHealthBoard, LeafHealthReport
from .metrics import (DEFAULT_REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, RecallDriftMonitor, get_registry)
from .spans import Span, SpanRecorder, get_recorder, recording, set_recorder, span
from .trace import (CascadeTrace, accounting_residual, combine, select,
                    to_numpy, zero_trace)
from . import audit, explain, export, health, trace

__all__ = [
    "CascadeTrace", "accounting_residual", "combine", "select", "to_numpy",
    "zero_trace",
    "AuditParts", "FilterAudit", "RESIDUAL_EDGES",
    "accounting_residual_leaf",
    "LeafHealthBoard", "LeafHealthReport",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RecallDriftMonitor", "DEFAULT_REGISTRY", "get_registry",
    "Span", "SpanRecorder", "get_recorder", "recording", "set_recorder",
    "span",
    "audit", "explain", "export", "health", "trace",
]
