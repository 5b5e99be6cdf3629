"""Process-wide metrics registry: counters, gauges, windowed histograms
(port of ``repro.obs.metrics``; its exports are byte-equal to the
reference's for the same calls).

One instrument model backs every number reported at runtime: a serving
telemetry facade is a thin layer over instances of these instruments
rather than a parallel implementation.

Design constraints, in order:

* **Determinism.**  Snapshots of instruments fed only virtual-clock or
  device-derived values are bitwise-reproducible run to run.  Anything fed
  wall-clock time must be declared ``wall=True`` at creation; snapshots
  segregate those instruments under a separate ``"wall"`` namespace so a
  determinism test can mask exactly one subtree.
* **Static memory.**  Histograms keep a bounded rolling window (deque) plus
  lifetime count/sum.
* **Zero deps.**  numpy only; importable from any layer without cycles
  (``repro_torch.obs`` imports nothing from ``repro_torch.core``).

Labels are plain keyword arguments on the observation calls
(``counter.inc(1, target="0.99")``); each distinct sorted label set is an
independent series.  Export formats: :meth:`MetricsRegistry.to_jsonl`
(one JSON object per series per line) and
:meth:`MetricsRegistry.prometheus_text` (Prometheus text exposition 0.0.4).
"""
from __future__ import annotations

import collections
import json
import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_suffix(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f"{k}={v}" for k, v in key)
    return "{" + inner + "}"


def _prom_escape(value: str) -> str:
    """Prometheus 0.0.4 label-value escaping: backslash first (so the other
    escapes don't double up), then quote and newline."""
    return (value.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


class _Instrument:
    """Shared series bookkeeping for all instrument kinds."""

    kind = "instrument"

    def __init__(self, name: str, help: str = "", wall: bool = False):
        self.name = name
        self.help = help
        self.wall = bool(wall)
        self._lock = threading.Lock()

    def series(self):  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing per-label-set totals."""

    kind = "counter"

    def __init__(self, name, help="", wall=False):
        super().__init__(name, help, wall)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self):
        return sorted(self._values.items())


class Gauge(_Instrument):
    """Last-written value per label set."""

    kind = "gauge"

    def __init__(self, name, help="", wall=False):
        super().__init__(name, help, wall)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, default: float = 0.0, **labels) -> float:
        return self._values.get(_label_key(labels), default)

    def series(self):
        return sorted(self._values.items())


class _HistSeries:
    __slots__ = ("count", "total", "window")

    def __init__(self, window: int):
        self.count = 0
        self.total = 0.0
        self.window = collections.deque(maxlen=window)


class Histogram(_Instrument):
    """Lifetime count/sum plus a bounded rolling window of raw samples.

    Percentiles are computed over the *window* (the serving runtime's
    rolling-window semantics); ``count``/``sum`` are lifetime.  An empty
    window yields NaN percentiles — callers render them, they do not
    traceback (the empty-window contract).
    """

    kind = "histogram"

    def __init__(self, name, help="", wall=False, window: int = 4096):
        super().__init__(name, help, wall)
        self.window_size = int(window)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def _get(self, key: LabelKey) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series.setdefault(key, _HistSeries(self.window_size))
        return s

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._get(key)
            v = float(value)
            s.count += 1
            s.total += v
            s.window.append(v)

    def extend(self, values: Iterable[float], **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._get(key)
            for v in values:
                v = float(v)
                s.count += 1
                s.total += v
                s.window.append(v)

    def window_values(self, **labels) -> list:
        s = self._series.get(_label_key(labels))
        return list(s.window) if s is not None else []

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return s.count if s is not None else 0

    def reset_window(self, **labels) -> None:
        """Drop windowed samples (lifetime count/sum survive).  With no
        labels given, flushes every series' window."""
        with self._lock:
            if labels:
                s = self._series.get(_label_key(labels))
                if s is not None:
                    s.window.clear()
            else:
                for s in self._series.values():
                    s.window.clear()

    def percentiles(self, pcts=(50, 95, 99), **labels) -> dict:
        """NaN-safe window percentiles: ``{"p50": …}``; NaN when empty."""
        vals = self.window_values(**labels)
        if not vals:
            return {f"p{g:g}": float("nan") for g in pcts}
        arr = np.asarray(vals, dtype=np.float64)
        return {f"p{g:g}": float(np.percentile(arr, g)) for g in pcts}

    def series(self):
        return sorted(self._series.items())


class MetricsRegistry:
    """Named instruments with idempotent creation and structured export.

    ``counter``/``gauge``/``histogram`` return the existing instrument when
    the name is already registered (and raise on a kind mismatch), so any
    layer can say ``registry.counter("serve_requests")`` without
    coordinating creation order.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: "collections.OrderedDict[str, _Instrument]" = \
            collections.OrderedDict()

    def _register(self, cls, name, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {inst.kind}")
                return inst
            inst = cls(name, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name, help="", wall=False) -> Counter:
        return self._register(Counter, name, help=help, wall=wall)

    def gauge(self, name, help="", wall=False) -> Gauge:
        return self._register(Gauge, name, help=help, wall=wall)

    def histogram(self, name, help="", wall=False,
                  window: int = 4096) -> Histogram:
        return self._register(Histogram, name, help=help, wall=wall,
                              window=window)

    def get(self, name) -> Optional[_Instrument]:
        return self._instruments.get(name)

    def instruments(self):
        return list(self._instruments.values())

    # -- structured export --------------------------------------------------

    @staticmethod
    def _hist_summary(s: _HistSeries) -> dict:
        out = {"count": s.count, "sum": s.total}
        if s.window:
            arr = np.asarray(s.window, dtype=np.float64)
            out.update(window=len(s.window),
                       min=float(arr.min()), max=float(arr.max()),
                       p50=float(np.percentile(arr, 50)),
                       p95=float(np.percentile(arr, 95)),
                       p99=float(np.percentile(arr, 99)))
        else:
            out.update(window=0, min=None, max=None,
                       p50=None, p95=None, p99=None)
        return out

    def snapshot(self) -> dict:
        """Deterministic nested dict of every series' current state.

        Wall-clock instruments (``wall=True`` at creation) land under the
        ``"wall"`` key; everything else is bitwise-reproducible given the
        same seeded inputs, which is what the trace-determinism test pins.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}, "wall": {}}
        for inst in self._instruments.values():
            if inst.wall:
                bucket = out["wall"].setdefault(inst.kind + "s", {})
            else:
                bucket = out[inst.kind + "s"]
            for key, val in inst.series():
                label = inst.name + _label_suffix(key)
                if inst.kind == "histogram":
                    bucket[label] = self._hist_summary(val)
                else:
                    bucket[label] = val
        return out

    def delta(self, prev: dict) -> dict:
        """Counter movement since a previous :meth:`snapshot`."""
        cur = self.snapshot()
        out = {}
        for scope in ("counters",):
            prev_scope = prev.get(scope, {})
            for name, val in cur.get(scope, {}).items():
                d = val - prev_scope.get(name, 0.0)
                if d:
                    out[name] = d
        return out

    def to_jsonl(self) -> str:
        """One JSON object per series per line (ingestion-friendly dump)."""
        lines = []
        for inst in self._instruments.values():
            for key, val in inst.series():
                row = {"kind": inst.kind, "name": inst.name,
                       "labels": dict(key), "wall": inst.wall}
                if inst.kind == "histogram":
                    row.update(self._hist_summary(val))
                else:
                    row["value"] = val
                lines.append(json.dumps(row, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4) of every series."""
        out = []
        for inst in self._instruments.values():
            if inst.help:
                out.append(f"# HELP {inst.name} {inst.help}")
            prom_kind = ("summary" if inst.kind == "histogram"
                         else inst.kind)
            out.append(f"# TYPE {inst.name} {prom_kind}")
            for key, val in inst.series():
                if inst.kind == "histogram":
                    summ = self._hist_summary(val)
                    out.append(f"{inst.name}_count{_prom_labels(key)} "
                               f"{summ['count']}")
                    out.append(f"{inst.name}_sum{_prom_labels(key)} "
                               f"{summ['sum']}")
                    for q, p in (("0.5", "p50"), ("0.95", "p95"),
                                 ("0.99", "p99")):
                        if summ[p] is None:
                            continue
                        qkey = key + (("quantile", q),)
                        out.append(f"{inst.name}{_prom_labels(qkey)} "
                                   f"{summ[p]}")
                else:
                    out.append(f"{inst.name}{_prom_labels(key)} {val}")
        return "\n".join(out) + ("\n" if out else "")


#: Process-wide default registry.  Library code that is not handed an
#: explicit registry records here; tests and serving sessions that need
#: isolation construct their own.
DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return DEFAULT_REGISTRY


class RecallDriftMonitor:
    """Windowed achieved-recall watchdog per requested target.

    Feeds two gauges (``recall_windowed``, ``recall_drift`` — both labeled
    by target) and raises a per-target drift flag when the rolling window
    holds at least ``min_samples`` observations and its achieved recall
    sits more than ``slack`` below the requested target.  This is the hook
    a staleness-triggered recalibration consumes: filter
    drift (stale training data after inserts) surfaces as sustained
    windowed recall below target long before the lifetime average moves.
    """

    def __init__(self, registry: MetricsRegistry, *, window: int = 512,
                 min_samples: int = 64, slack: float = 0.0,
                 prefix: str = "serve"):
        self.registry = registry
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.slack = float(slack)
        self._hits: Dict[float, collections.deque] = {}
        self._recall_gauge = registry.gauge(
            f"{prefix}_recall_windowed",
            help="rolling-window achieved recall per requested target")
        self._drift_gauge = registry.gauge(
            f"{prefix}_recall_drift",
            help="1 when windowed recall sits below the requested target")

    @staticmethod
    def _key(target: float) -> float:
        return round(float(target), 6)

    def observe(self, target: float, hit: bool) -> None:
        t = self._key(target)
        dq = self._hits.get(t)
        if dq is None:
            dq = self._hits.setdefault(
                t, collections.deque(maxlen=self.window))
        dq.append(1.0 if hit else 0.0)
        label = f"{t:g}"
        rec = sum(dq) / len(dq)
        self._recall_gauge.set(rec, target=label)
        self._drift_gauge.set(
            1.0 if self._drifting(t, dq) else 0.0, target=label)

    def _drifting(self, target: float, dq) -> bool:
        if len(dq) < self.min_samples:
            return False
        return (sum(dq) / len(dq)) < (target - self.slack)

    def windowed_recall(self) -> dict:
        return {t: (sum(dq) / len(dq) if dq else float("nan"))
                for t, dq in sorted(self._hits.items())}

    def drifting(self) -> dict:
        """Per-target drift flags — the recalibration hook."""
        return {t: self._drifting(t, dq)
                for t, dq in sorted(self._hits.items())}

    def any_drifting(self) -> bool:
        return any(self.drifting().values())
