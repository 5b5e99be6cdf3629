"""Host-side span profiling: nested context-manager timers with
``torch.profiler.record_function`` pass-through (port of
``repro.obs.spans``).

Spans answer "where did the wall-clock go" for the host-orchestrated
phases the device profiler cannot see — build-pipeline stages
(collect/train/calibrate), serving dispatch/harvest, checkpoint IO.  Each
``span(...)`` block records name, category, nesting depth, thread lane and
wall-clock ``(t0, dur)``; :mod:`repro_torch.obs.export` renders the
recorded list as Chrome trace-event JSON for Perfetto.

Every span also enters ``torch.profiler.record_function`` of the same
name, so under ``torch.profiler`` it shows as a ``user_annotation`` around
the kernels launched inside it; with no profiler active the annotation is
a cheap no-op.  A span closes on the host: around asynchronous device
work it times the enqueue unless the block ends with a synchronize (the
build's phases do).

Determinism contract: wall-clock readings stay inside the ``t0``/``dur``
fields (exported as Chrome ``ts``/``dur``); span names, categories, lanes
and args must be derived from deterministic run state only — a
determinism test masks exactly ``ts``/``dur`` and pins the rest.

Instrumented code calls the module-level :func:`span`, which records into
the installed default recorder (a bounded deque, enabled from the start so
ad-hoc profiling needs no setup).  Drivers that want an isolated capture
install their own recorder via ``recording()``::

    with recording() as rec:
        run()
    export.write_chrome_trace(path, spans=rec.drain())
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple, Optional

from torch.profiler import record_function


class Span(NamedTuple):
    name: str
    cat: str
    t0: float          # wall-clock (time.perf_counter) — export as ts only
    dur: float         # wall-clock seconds — export as dur only
    lane: int          # small stable per-thread index (first-seen order)
    depth: int         # nesting depth within the lane
    args: dict         # deterministic metadata only (no wall-clock)


class SpanRecorder:
    """Bounded, thread-safe span sink.

    ``maxlen`` bounds memory for long-lived processes (old spans fall off);
    per-thread nesting depth is tracked thread-locally, and thread idents
    are normalized to dense ``lane`` indices in first-seen order so exports
    do not leak nondeterministic OS thread ids.
    """

    def __init__(self, maxlen: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self._spans = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._lanes: dict = {}
        self._tls = threading.local()

    def _lane(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            lane = self._lanes.get(ident)
            if lane is None:
                lane = self._lanes.setdefault(ident, len(self._lanes))
        return lane

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args):
        if not self.enabled:
            yield self
            return
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield self
        finally:
            dur = time.perf_counter() - t0
            self._tls.depth = depth
            lane = self._lane()        # before taking _lock: not reentrant
            with self._lock:
                self._spans.append(
                    Span(name, cat, t0, dur, lane, depth, dict(args)))

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def drain(self) -> list:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


_DEFAULT = SpanRecorder()
_current = _DEFAULT


def get_recorder() -> SpanRecorder:
    return _current


def set_recorder(recorder: Optional[SpanRecorder]) -> SpanRecorder:
    """Install ``recorder`` as the module-level sink (None → the built-in
    default); returns the previously installed one."""
    global _current
    prev = _current
    _current = recorder if recorder is not None else _DEFAULT
    return prev


@contextlib.contextmanager
def recording(recorder: Optional[SpanRecorder] = None):
    """Temporarily route :func:`span` into a fresh (or given) recorder."""
    rec = recorder if recorder is not None else SpanRecorder()
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)


def span(name: str, cat: str = "host", **args):
    """Record a span into the currently installed recorder."""
    return _current.span(name, cat, **args)
