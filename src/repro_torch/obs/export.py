"""Chrome trace-event JSON and metrics-dump export (port of
``repro.obs.export``).

Renders the host-side observability state — recorded spans
(:mod:`repro_torch.obs.spans`) and a serving ``batch_log`` (per-batch
dicts in the reference serving runtime's layout) — as Chrome trace-event
JSON.  Load the file in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: pipelined runs show batch N's in-flight device window
overlapping batch N+1's dispatch lane.

Lane layout (``tid``, named via metadata events):

* ``1`` dispatch — host batch formation + async submit (``dispatch_s``)
* ``2`` in-flight — submit to harvest-return (device + queue residency)
* ``3`` harvest — residual blocking wait (``harvest_s``)
* ``10 + lane`` — recorded spans, one lane per recording thread

Determinism contract: wall-clock readings appear **only** in the
``ts``/``dur`` fields of emitted events; ``name``, ``cat``, ``tid`` and
``args`` carry deterministic run state only, so a masked comparison of two
seeded runs is bitwise.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional

from .metrics import MetricsRegistry
from .spans import Span

_PID = 1
_TID_DISPATCH = 1
_TID_INFLIGHT = 2
_TID_HARVEST = 3
_TID_SPAN_BASE = 10


def _usec(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 3)


def _meta(tid: int, name: str) -> dict:
    return {"ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
            "args": {"name": name}}


def span_events(spans: Iterable[Span], t0: float) -> List[dict]:
    events = []
    for s in spans:
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X", "pid": _PID,
            "tid": _TID_SPAN_BASE + s.lane,
            "ts": _usec(s.t0, t0), "dur": round(s.dur * 1e6, 3),
            "args": dict(s.args, depth=s.depth),
        })
    return events


def batch_events(batch_log: Iterable[dict], t0: float) -> List[dict]:
    """Dispatch / in-flight / harvest slices for every logged batch.

    Serial ``run_trace`` entries (no ``t_disp``) render as one combined
    execute slice; pipelined entries split into the three lanes so the
    overlap window is visible.
    """
    events = []
    for seq, entry in enumerate(batch_log):
        args = {"seq": seq, "bucket": entry.get("bucket"),
                "n_valid": entry.get("n_valid"), "k": entry.get("k"),
                "service": entry.get("service"),
                "n_requests": len(entry.get("rids", ()))}
        name = f"batch[{entry.get('bucket')}x k={entry.get('k')}]"
        t_disp = entry.get("t_disp")
        if t_disp is None:
            events.append({"name": name, "cat": "serve", "ph": "X",
                           "pid": _PID, "tid": _TID_DISPATCH,
                           "ts": 0.0, "dur": round(
                               float(entry.get("wall", 0.0)) * 1e6, 3),
                           "args": args})
            continue
        disp_s = float(entry.get("dispatch_s") or 0.0)
        events.append({"name": f"dispatch {name}", "cat": "serve",
                       "ph": "X", "pid": _PID, "tid": _TID_DISPATCH,
                       "ts": _usec(t_disp - disp_s, t0),
                       "dur": round(disp_s * 1e6, 3), "args": args})
        t_done = entry.get("t_done")
        if t_done is None:
            continue
        harv_s = float(entry.get("harvest_s") or 0.0)
        events.append({"name": f"in-flight {name}", "cat": "serve",
                       "ph": "X", "pid": _PID, "tid": _TID_INFLIGHT,
                       "ts": _usec(t_disp, t0),
                       "dur": round(max(t_done - harv_s - t_disp, 0.0)
                                    * 1e6, 3),
                       "args": args})
        events.append({"name": f"harvest {name}", "cat": "serve",
                       "ph": "X", "pid": _PID, "tid": _TID_HARVEST,
                       "ts": _usec(t_done - harv_s, t0),
                       "dur": round(harv_s * 1e6, 3), "args": args})
    return events


def chrome_trace(spans: Optional[Iterable[Span]] = None,
                 batch_log: Optional[Iterable[dict]] = None) -> dict:
    """Assemble a Chrome trace-event JSON object (``traceEvents`` list)."""
    spans = list(spans or ())
    batch_log = list(batch_log or ())
    starts = [s.t0 for s in spans]
    starts += [e["t_disp"] - float(e.get("dispatch_s") or 0.0)
               for e in batch_log if e.get("t_disp") is not None]
    t0 = min(starts) if starts else 0.0

    events = [_meta(_TID_DISPATCH, "serve/dispatch"),
              _meta(_TID_INFLIGHT, "serve/in-flight"),
              _meta(_TID_HARVEST, "serve/harvest")]
    for lane in sorted({s.lane for s in spans}):
        events.append(_meta(_TID_SPAN_BASE + lane, f"spans/lane{lane}"))
    events += batch_events(batch_log, t0)
    events += span_events(spans, t0)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, spans=None, batch_log=None) -> dict:
    trace = chrome_trace(spans=spans, batch_log=batch_log)
    with open(path, "w") as fh:
        json.dump(trace, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return trace


def write_metrics(path, registry: MetricsRegistry) -> None:
    """Dump a registry as JSON-lines (``*.prom`` paths get Prometheus
    text exposition instead)."""
    text = (registry.prometheus_text() if str(path).endswith(".prom")
            else registry.to_jsonl())
    with open(path, "w") as fh:
        fh.write(text)


def mask_wallclock(trace: dict) -> dict:
    """Copy of a Chrome trace object with every ``ts``/``dur`` zeroed —
    the determinism tests compare masked traces bitwise."""
    events = []
    for e in trace.get("traceEvents", ()):
        e = dict(e)
        for key in ("ts", "dur"):
            if key in e:
                e[key] = 0.0
        events.append(e)
    out = dict(trace)
    out["traceEvents"] = events
    return out
