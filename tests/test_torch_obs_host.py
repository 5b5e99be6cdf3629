"""The port's host-side observability (``repro_torch.obs``: ``metrics``,
``spans``, ``export``, ``health``, ``explain``) against the JAX package's
(``repro.obs``), on the same calls and inputs, on the CPU.

* Metrics: ``to_jsonl`` and ``prometheus_text`` byte-equal (pathological
  label values included), ``snapshot`` and ``delta`` equal, the ``wall``
  subtree, the kind-mismatch and negative-increment errors, and the
  ``RecallDriftMonitor``'s flags over one seeded hit sequence.
* Spans: nesting, lanes, a bounded recorder that drains, the disabled
  recorder; spans from two threads get dense lanes without deadlock; a
  port span is a ``user_annotation`` under ``torch.profiler``.
* Export: ``chrome_trace`` on the same span list and batch log equal
  (unmasked), and on recorded spans after ``mask_wallclock``.
* Health: ``LeafHealthBoard`` fed the same audit dicts gives equal
  reports, totals, snapshots and registry text; fed each package's own
  audits of a carried index (k = 5, 0.99) the same flagged leaves,
  reasons and integer totals (the residual sums within rtol 1e-5, as the
  audits' own float fields are held).
* Explain: ``render_text`` / ``render_json`` byte-equal.
* Build spans: a small port build (``device="cpu"``) and a reference build
  of the same config record the same span names, categories, args,
  depths, lanes and order.
"""
import importlib.util
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.core import build as j_build
from repro.core import filter_training as j_training
from repro.obs import explain as j_explain
from repro.obs import export as j_export
from repro.obs import health as j_health
from repro.obs import metrics as j_metrics
from repro.obs import spans as j_spans
from repro_torch import obs as t_obs
from repro_torch.core import build as t_build
from repro_torch.core import filter_training as t_training
from repro_torch.obs import explain as t_explain
from repro_torch.obs import export as t_export
from repro_torch.obs import health as t_health
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import spans as t_spans
from test_torch_isax import carry, isax_config
from _torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
#: (metrics, spans, export, health, explain) of each package
PKG = {"ref": (j_metrics, j_spans, j_export, j_health, j_explain),
       "port": (t_metrics, t_spans, t_export, t_health, t_explain)}
EVIL = ('a\\b"c\nd', "}{,=", "", "x\\", 'say "hi"', "line1\nline2\n",
        "ünï ✓")


def _both(fn, *args):
    """``fn`` applied to each package's modules: (reference, port)."""
    return fn(*PKG["ref"], *args), fn(*PKG["port"], *args)


def _dumps(x) -> str:
    """A canonical JSON text (NaN as NaN), so NaN compares equal."""
    return json.dumps(x, sort_keys=True, default=repr)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _counters(M, *_):
    r = M.MetricsRegistry()
    c = r.counter("reqs", help="requests")
    c.inc()
    c.inc(2.0)
    c.inc(5, target="0.9")
    c.inc(0.25, target="0.99", lane=3)
    r.counter("reqs").inc(1, lane=3, target="0.99")   # same series
    r.counter("no_help_total")
    return r


def _gauges(M, *_):
    r = M.MetricsRegistry()
    g = r.gauge("depth", help="queue depth")
    g.set(3)
    g.set(7, lane="a")
    g.set(4)
    g.set(np.float32(0.1), lane="b")
    r.gauge("odd").set(float("nan"))
    r.gauge("odd").set(float("inf"), sign="+")
    r.gauge("odd").set(-float("inf"), sign="-")
    return r


def _histograms(M, *_):
    r = M.MetricsRegistry()
    h = r.histogram("lat", help="latency (s)", window=4)
    h.extend([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    h.observe(0.5, target="0.9")
    h.extend(np.linspace(0.0, 1.0, 7), target="0.99")
    r.histogram("empty_h", window=8)              # registered, no series
    flushed = r.histogram("flushed", window=3)
    flushed.extend([9.0, 8.0], k=5)
    flushed.reset_window(k=5)                     # lifetime survives
    r.histogram("lat").reset_window(target="0.9")
    return r


def _wall(M, *_):
    r = M.MetricsRegistry()
    r.counter("n").inc(3)
    r.histogram("virt", window=8).observe(1.0)
    r.histogram("wallclock_s", window=8, wall=True).observe(0.125)
    r.gauge("wall_g", wall=True).set(2.5, phase="form")
    r.counter("wall_c", help="host", wall=True).inc(4)
    return r


def _pathological(M, *_):
    r = M.MetricsRegistry()
    for i, v in enumerate(EVIL):
        r.counter("evil_total", help='a "help" \\ line').inc(1 + i, path=v)
        r.gauge("evil_gauge").set(i, **{"k": v, "w": "ok"})
        r.histogram("evil_h", window=2).observe(i, q=v)
    return r


def _drift(M, *_):
    r = M.MetricsRegistry()
    mon = M.RecallDriftMonitor(r, window=16, min_samples=8, slack=0.01,
                               prefix="audit")
    rng = np.random.default_rng(3)
    for t in (0.9, 0.95, 0.99):
        for hit in rng.random(40) < t - 0.05:
            mon.observe(t, bool(hit))
    return r


SCENARIOS = [_counters, _gauges, _histograms, _wall, _pathological, _drift]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_registry_exports_equal_the_reference(scenario):
    ref, port = _both(scenario)
    assert port.to_jsonl() == ref.to_jsonl()
    assert port.prometheus_text() == ref.prometheus_text()
    assert _dumps(port.snapshot()) == _dumps(ref.snapshot())
    assert [i.name for i in port.instruments()] == \
        [i.name for i in ref.instruments()]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_write_metrics_files_equal_the_reference(scenario, tmp_path):
    for suffix in (".prom", ".jsonl"):
        texts = []
        for name, mods in PKG.items():
            path = tmp_path / f"{name}{suffix}"
            mods[2].write_metrics(path, scenario(*mods))
            texts.append(path.read_bytes())
        assert texts[0] == texts[1], suffix


def test_prometheus_escapes_pathological_labels_as_the_reference():
    ref, port = _both(_pathological)
    text = port.prometheus_text()
    assert 'evil_total{path="a\\\\b\\"c\\nd"} 1.0' in text
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    # one line a series: 7 counters, 7 gauges, 7 x (count, sum, 3 quantiles)
    assert len(samples) == 7 + 7 + 7 * 5
    assert text == ref.prometheus_text()


def test_snapshot_wall_subtree_and_delta_equal_the_reference():
    def run(M, *_):
        r = _wall(M)
        prev = r.snapshot()
        r.counter("n").inc(2, target="0.9")
        r.counter("n").inc(0)                     # no movement: no entry
        r.counter("wall_c", wall=True).inc(1)     # wall: not in delta
        r.histogram("virt").observe(3.0)
        return r, prev, r.delta(prev)
    (rr, rprev, rdelta), (pr, pprev, pdelta) = _both(run)
    assert pdelta == rdelta == {"n{target=0.9}": 2.0}
    assert _dumps(pprev) == _dumps(rprev)
    snap = pr.snapshot()
    assert "wallclock_s" not in snap["histograms"]
    assert snap["wall"]["histograms"]["wallclock_s"]["count"] == 1
    assert snap["wall"]["counters"] == {"wall_c": 5.0}
    assert _dumps(snap) == _dumps(rr.snapshot())


@pytest.mark.parametrize("first,second", [("counter", "gauge"),
                                          ("gauge", "histogram"),
                                          ("histogram", "counter")])
def test_kind_mismatch_raises_as_the_reference(first, second):
    msgs = []
    for M, *_ in PKG.values():
        r = M.MetricsRegistry()
        a = getattr(r, first)("x")
        assert getattr(r, first)("x") is a        # idempotent creation
        with pytest.raises(ValueError, match="already registered") as e:
            getattr(r, second)("x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_negative_increment_and_empty_window_as_the_reference():
    msgs = []
    for M, *_ in PKG.values():
        r = M.MetricsRegistry()
        with pytest.raises(ValueError, match="negative") as e:
            r.counter("c").inc(-1)
        msgs.append(str(e.value))
        p = r.histogram("h").percentiles((50, 99.9))
        assert set(p) == {"p50", "p99.9"} and all(np.isnan(list(p.values())))
    assert msgs[0] == msgs[1]


def test_recall_drift_monitor_flags_as_the_reference():
    """One seeded hit sequence over three targets: the drift flags, the
    windowed recall and the two gauges after every observation."""
    rng = np.random.default_rng(11)
    seq = [(t, bool(rng.random() < p)) for t, p in
           [(0.99, 0.999)] * 50 + [(0.99, 0.9)] * 80 + [(0.95, 0.97)] * 60
           + [(0.9, 0.5)] * 40 + [(0.99, 1.0)] * 70]
    hist = {}
    for name, (M, *_) in PKG.items():
        r = M.MetricsRegistry()
        mon = M.RecallDriftMonitor(r, window=64, min_samples=32)
        steps = []
        for t, hit in seq:
            mon.observe(t, hit)
            steps.append((mon.drifting(), mon.windowed_recall(),
                          mon.any_drifting()))
        hist[name] = (steps, r.prometheus_text(), r.to_jsonl())
    assert hist["port"] == hist["ref"]
    flags = [any(d.values()) for d, _, _ in hist["port"][0]]
    assert any(flags) and not all(flags)          # fires and clears


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _nested(M, S, *_):
    before = S.get_recorder()
    with S.recording() as rec:
        assert S.get_recorder() is rec
        with S.span("outer", cat="t", a=1):
            with S.span("inner", cat="t"):
                with S.span("innermost", cat="u", k=5, name2="x"):
                    pass
            with S.span("sibling"):
                pass
        with S.span("second"):
            pass
    assert S.get_recorder() is before
    return rec.spans()


def _fields(spans):
    return [(s.name, s.cat, s.lane, s.depth, s.args) for s in spans]


def test_span_nesting_and_lanes_equal_the_reference():
    ref, port = _both(_nested)
    assert _fields(port) == _fields(ref)
    assert _fields(port) == [
        ("innermost", "u", 0, 2, {"k": 5, "name2": "x"}),
        ("inner", "t", 0, 1, {}), ("sibling", "host", 0, 1, {}),
        ("outer", "t", 0, 0, {"a": 1}), ("second", "host", 0, 0, {})]
    by = {s.name: s for s in port}
    assert by["outer"].dur >= by["inner"].dur >= by["innermost"].dur >= 0
    assert type(port[0]) is t_spans.Span
    assert t_spans.Span._fields == j_spans.Span._fields


@pytest.mark.parametrize("maxlen", [1, 4, 16])
def test_bounded_recorder_drains_as_the_reference(maxlen):
    got = []
    for _, S, *_ in PKG.values():
        rec = S.SpanRecorder(maxlen=maxlen)
        for i in range(10):
            with rec.span(f"s{i}", i=i):
                pass
        got.append(_fields(rec.drain()))
        assert rec.spans() == []
        with rec.span("after"):
            pass
        rec.clear()
        assert rec.spans() == []
    assert got[0] == got[1]
    assert [f[0] for f in got[1]] == [f"s{i}" for i in range(10)][-maxlen:]


def test_disabled_recorder_and_set_recorder_as_the_reference():
    for _, S, *_ in PKG.values():
        rec = S.SpanRecorder(enabled=False)
        with rec.span("x") as inner:
            assert inner is rec
        assert rec.spans() == []
        mine = S.SpanRecorder()
        prev = S.set_recorder(mine)
        with S.span("routed", cat="c", n=2):
            pass
        assert S.set_recorder(None) is mine       # None → the default
        S.set_recorder(prev)
        assert _fields(mine.spans()) == [("routed", "c", 0, 0, {"n": 2})]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_spans_from_two_threads_take_dense_lanes(pkg):
    """Two threads record nested spans at once into one recorder, with the
    interpreter switching threads every microsecond: two dense lanes, one
    per thread, the depth tracked per thread, every span recorded, no
    deadlock (the lane lookup takes the lock before the append does, never
    inside it)."""
    S = PKG[pkg][1]
    rec = S.SpanRecorder()
    start = threading.Barrier(2)

    def work(tag):
        start.wait()
        for i in range(300):
            with rec.span(f"{tag}.outer", i=i):
                with rec.span(f"{tag}.inner"):
                    pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "deadlock"
    spans = rec.spans()
    assert len(spans) == 1200
    lanes = {tag: {s.lane for s in spans if s.name.startswith(tag)}
             for tag in "ab"}
    assert sorted(lanes["a"] | lanes["b"]) == [0, 1]
    assert len(lanes["a"]) == len(lanes["b"]) == 1
    assert all(s.depth == s.name.endswith(".inner") for s in spans)


def test_port_span_is_a_user_annotation_under_the_profiler(tmp_path):
    """``torch.profiler.record_function`` pass-through: each port span
    shows in the profiler's trace as a ``user_annotation`` of its name,
    enclosing the ops run inside it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_obs.recording() as rec:
            with t_obs.span("obs.outer", cat="build", n=1):
                with t_obs.span("obs.inner"):
                    torch.ones(8).mul_(2).sum()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"obs.outer", "obs.inner"} <= set(ann)
    outer, inner = ann["obs.outer"], ann["obs.inner"]
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    ops = [e for e in events if e.get("name") == "aten::mul_"]
    assert ops and all(inner["ts"] <= e["ts"] <= inner["ts"] + inner["dur"]
                       for e in ops)
    assert [s.name for s in rec.spans()] == ["obs.inner", "obs.outer"]


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _demo_batch_log():
    """``tests/test_obs.py``'s demo log."""
    return [
        {"bucket": 4, "n_valid": 3, "k": 1, "service": 0.01,
         "rids": [0, 1, 2], "wall": 0.02},
        {"bucket": 8, "n_valid": 8, "k": 1, "service": 0.01,
         "rids": list(range(3, 11)), "t_disp": 10.0, "dispatch_s": 0.001,
         "t_done": 10.5, "harvest_s": 0.002},
    ]


BATCH_LOGS = {
    "demo": _demo_batch_log(),
    "none": None,
    "ragged": _demo_batch_log() + [
        {"bucket": 2, "k": 5, "t_disp": 9.5, "dispatch_s": None},
        {"bucket": 16, "n_valid": 1, "k": 3, "rids": (7,), "t_disp": 11.0,
         "dispatch_s": 0.25, "t_done": 11.1, "harvest_s": None},
        {}],
}


def _span_list(S):
    """The same span list for either package (fixed clock readings)."""
    return [S.Span("build.index", "build", 100.0, 0.5, 0, 0,
                   {"backbone": "dstree"}),
            S.Span("collect.global", "build", 100.5, 0.125, 0, 1,
                   {"n_global": 600}),
            S.Span("build.collect", "build", 100.5, 0.25, 0, 0,
                   {"n_filters": 4, "n_global": 600, "n_local": 200}),
            S.Span("serve.dispatch", "serve", 101.0, 0.001, 1, 0,
                   {"seq": 3}),
            S.Span("late", "host", 99.0, 0.0, 3, 2, {})]


@pytest.mark.parametrize("log_name", list(BATCH_LOGS))
@pytest.mark.parametrize("with_spans", [True, False], ids=["spans", "none"])
def test_chrome_trace_equals_the_reference(log_name, with_spans, tmp_path):
    traces, files = [], []
    for name, (_, S, E, *_) in PKG.items():
        spans = _span_list(S) if with_spans else None
        trace = E.chrome_trace(spans=spans, batch_log=BATCH_LOGS[log_name])
        traces.append(trace)
        path = tmp_path / f"{name}.json"
        assert E.write_chrome_trace(path, spans=spans,
                                    batch_log=BATCH_LOGS[log_name]) == trace
        files.append(path.read_bytes())
        assert json.loads(path.read_text()) == trace
        masked = E.mask_wallclock(trace)
        assert all(e.get("ts", 0.0) == 0.0 and e.get("dur", 0.0) == 0.0
                   for e in masked["traceEvents"])
        traces.append(masked)
    assert traces[2] == traces[0] and traces[3] == traces[1]
    assert files[0] == files[1]


def test_recorded_spans_export_equal_after_masking():
    masked = []
    for _, S, E, *_ in PKG.values():
        spans = _nested(None, S)
        trace = E.chrome_trace(spans=spans, batch_log=_demo_batch_log())
        assert E.span_events(spans, spans[0].t0)[0]["args"]["depth"] == 2
        masked.append(E.mask_wallclock(trace))
    assert masked[0] == masked[1]


# ---------------------------------------------------------------------------
# health board
# ---------------------------------------------------------------------------

def _audit_dict(L, **cols):
    """``tests/test_obs.py``'s audit dict."""
    base = {k: np.zeros(L, np.int64)
            for k in ("violations", "resid_count", "scored", "kept",
                      "pruned_box", "pruned_seed", "pruned_filter",
                      "rows_saved")}
    base["resid_sum"] = np.zeros(L, np.float64)
    base["resid_min"] = np.full(L, np.inf)
    for k, v in cols.items():
        base[k] = np.asarray(v)
    return base


def _reference_case(H, M):
    """``test_health_board_flags_reasons_and_severity_order``'s inputs."""
    r = M.MetricsRegistry()
    board = H.LeafHealthBoard(window=4, registry=r, min_resid_count=8,
                              violation_rate_threshold=0.05,
                              resid_min_threshold=-0.5)
    board.record_audit(_audit_dict(
        4, violations=[0, 3, 1, 0], resid_count=[9, 10, 2, 9],
        resid_min=[0.2, -0.05, -1.0, 0.3]), n_queries=16)
    board.record_shadow([{"leaf": 3, "bound": "filter"},
                         {"leaf": 3, "bound": "filter"},
                         {"leaf": 0, "bound": "box"}], n_queries=8)
    return board, r


def _random_case(H, M, seed):
    """Seeded audits and shadow misses through a window that rolls over:
    more batches than the window, misses out of range, without a bound,
    on every bound."""
    rng = np.random.default_rng(seed)
    r = M.MetricsRegistry()
    board = H.LeafHealthBoard(window=3, registry=r, min_resid_count=4,
                              violation_rate_threshold=0.1,
                              resid_min_threshold=-0.3, worst_k=3)
    L = 12
    for b in range(6):
        count = rng.integers(0, 12, L)
        viol = np.minimum(rng.integers(0, 4, L), count)
        resid_min = np.where(count > 0, rng.normal(0.0, 0.5, L), np.inf)
        board.record_audit(_audit_dict(
            L, violations=viol, resid_count=count,
            scored=count + rng.integers(0, 3, L),
            kept=rng.integers(0, 9, L), pruned_box=rng.integers(0, 9, L),
            pruned_seed=rng.integers(0, 2, L),
            pruned_filter=rng.integers(0, 9, L),
            rows_saved=rng.integers(0, 999, L),
            resid_sum=rng.normal(0.0, 2.0, L) * count,
            resid_min=resid_min), n_queries=8 + b)
        misses = [{"leaf": int(rng.integers(-1, L + 1)),
                   "bound": str(rng.choice(j_health.MISS_BOUNDS))}
                  for _ in range(int(rng.integers(0, 4)))]
        if b == 2:
            misses.append({"leaf": 5})            # no bound: "timing"
        board.record_shadow(misses, n_queries=int(rng.integers(0, 5)))
    return board, r


def _board_state(board, registry):
    tot = board.window_totals()
    return (_dumps([rep.to_dict() for rep in
                    board.filters_needing_attention()]),
            _dumps([rep.to_dict() for rep in
                    board.filters_needing_attention(limit=1)]),
            _dumps({k: np.asarray(v).tolist() for k, v in tot.items()}),
            _dumps(board.snapshot()), registry.prometheus_text(),
            registry.to_jsonl())


@pytest.mark.parametrize("case", ["reference", "seed0", "seed1", "seed2"])
def test_health_board_equals_the_reference(case):
    states = []
    for M, _, _, H, _ in PKG.values():
        if case == "reference":
            board, r = _reference_case(H, M)
        else:
            board, r = _random_case(H, M, int(case[-1]))
        states.append(_board_state(board, r))
        board.reset()
        states.append(_board_state(board, r))
    assert states[2] == states[0] and states[3] == states[1]
    if case == "reference":
        reps = json.loads(states[2][0])
        assert [rep["leaf"] for rep in reps] == [3, 2, 1]
        assert [rep["reasons"] for rep in reps] == [
            ["shadow-miss"], ["deep-violation"], ["violation-rate"]]
    assert t_health.MISS_BOUNDS == j_health.MISS_BOUNDS


def test_health_board_rejects_a_mismatched_leaf_count_as_the_reference():
    msgs = []
    for _, _, _, H, _ in PKG.values():
        board = H.LeafHealthBoard()
        assert board.window_totals() == {} and \
            board.filters_needing_attention() == []
        board.record_audit(_audit_dict(4), n_queries=2)
        with pytest.raises(ValueError, match="leaves") as e:
            board.record_audit(_audit_dict(5), n_queries=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------

def _health_reports():
    board, _ = _reference_case(t_health, t_metrics)
    return [rep.to_dict() for rep in board.filters_needing_attention()]


CONTEXTS = {
    "full": {
        "rid": 7, "k": 3, "target": 0.95, "strategy": "compact",
        "served": {"dists": [1.0, 2.5, 3.25], "ids": [4, 9, 1]},
        "cascade": {"n_leaves": 12, "searched": 5, "computed": 5,
                    "pruned_box": 3, "pruned_seed": 1, "pruned_filter": 3,
                    "probed": 1, "overflow": 1, "distances": 640},
        "leaves": [{"leaf": 2, "d_lb": 0.5, "d_F": 1.25,
                    "verdict": "kept"},
                   {"leaf": 11, "d_lb": 0.75, "d_F": None,
                    "verdict": "box"},
                   {"leaf": 4, "d_lb": 1.0, "d_F": 9.0,
                    "verdict": "filter"}],
        "shadow": {"true_dists": [1.0, 2.0, 3.25], "true_ids": [4, 8, 1],
                   "recall": 2 / 3,
                   "misses": [{"id": 8, "dist": 2.0, "leaf": 4,
                               "bound": "filter"}]},
        "health": _health_reports()},
    "empty": {},
    "partial": {
        "k": None, "target": None, "strategy": "",
        "served": {"ids": [1]},
        "cascade": {"searched": 2},
        "leaves": [{"d_F": None}, {"leaf": 1, "d_lb": "n/a"}],
        "shadow": {"recall": 1.0, "misses": []},
        "health": [{}]},
    "numpy": {
        "rid": np.int64(3), "k": np.int32(1), "target": np.float32(0.99),
        "served": {"dists": [np.float32(0.5)], "ids": [np.int64(2)]},
        "cascade": {"n_leaves": np.int64(4), "searched": np.int64(1),
                    "pruned_filter": np.int64(3), "probed": 0,
                    "overflow": 0, "distances": np.int64(10)},
        "leaves": [{"leaf": np.int64(0), "d_lb": np.float32(0.25),
                    "d_F": np.float64(0.5), "verdict": "kept"}],
        "shadow": {"recall": np.float64(1.0)},
        "health": [{"leaf": 1, "reasons": ["shadow-miss"],
                    "violation_rate": float("nan"),
                    "resid_min": np.float32(-0.75), "shadow_misses": 2}]},
}


@pytest.mark.parametrize("ctx", list(CONTEXTS))
def test_explain_renderers_equal_the_reference(ctx):
    ctx = CONTEXTS[ctx]
    assert t_explain.render_text(ctx) == j_explain.render_text(ctx)
    for indent in (None, 2):
        assert t_explain.render_json(ctx, indent=indent) == \
            j_explain.render_json(ctx, indent=indent)
    assert t_explain.render_text(ctx).startswith("explain")


# ---------------------------------------------------------------------------
# the build's spans, and the health board over each package's own audits
# ---------------------------------------------------------------------------

def _dstree_config(mod, training):
    return mod.LeaFiConfig(backbone="dstree", leaf_capacity=64, n_global=60,
                           n_local=16, t_filter_over_t_series=10.0,
                           train=training.TrainConfig(epochs=5))


@pytest.fixture(scope="module", params=["dstree", "isax"])
def recorded(request, randwalk_small):
    """A reference build and a port build (``device="cpu"``) of the same
    config and series, each under its package's ``recording()``."""
    config = (_dstree_config if request.param == "dstree" else isax_config)
    series = randwalk_small[:1500]
    with j_obs.recording() as jrec:
        ref = j_build.build_leafi(series, config(j_build, j_training))
    with t_obs.recording() as trec:
        port = t_build.build_leafi(series, config(t_build, t_training),
                                   device="cpu")
    assert len(ref.leaf_ids) > 4
    return ref, jrec.drain(), port, trec.drain()


def test_build_spans_equal_the_reference(recorded):
    ref, jspans, port, tspans = recorded
    assert _fields(tspans) == _fields(jspans)
    assert [s.name for s in tspans] == [
        "build.index", "collect.global", "collect.local", "build.collect",
        "train.sgd", "build.train", "build.calibrate"]
    for s in tspans:
        assert s.cat == "build"
        assert s.depth == (s.name.split(".")[0] in ("collect", "train"))
        assert all(type(v) in (int, str) for v in s.args.values())
    json.dumps(t_export.chrome_trace(spans=tspans))
    by = {s.name: s for s in tspans}
    for name, key in (("build.index", "t_index_build"),
                      ("build.collect", "t_collect"),
                      ("build.train", "t_train"),
                      ("build.calibrate", "t_calibrate")):
        assert 0 <= by[name].dur <= port.build_report[key]
    assert by["build.train"].args["n_filters"] == len(port.leaf_ids)


def test_chip_smoke_build_span_check_on_the_cpu(recorded, tmp_path, capsys):
    """``chip_smoke.check_build_spans`` on the port build's spans at this
    tiny size: the table printed, the durations within their limit of
    ``build_report``, the Chrome trace read back equal."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, port, tspans = recorded
    durs = smoke.check_build_spans(tspans, port, "cpu ", str(tmp_path))
    assert set(durs) == set(smoke.BUILD_SPANS)
    assert len(list(tmp_path.glob("build_spans_cpu.json"))) == 1
    printed = capsys.readouterr().out
    assert "cpu build spans (name, depth, lane, duration, args)" in printed
    assert "read back equal" in printed
    with pytest.raises(AssertionError, match="build spans"):
        smoke.check_build_spans(tspans[1:], port, "cpu ")


@pytest.mark.parametrize("thresholds", ["default", "sensitive"])
def test_health_board_over_each_package_audits(recorded, queries_small,
                                               thresholds):
    """The reference index carried to the port, both searched at k = 5,
    0.99 in four batches of 8 with ``audit=True``; each package's board
    folds its own audits.  Flagged leaves, reasons and integer totals and
    report fields equal; the residual sums and minima within rtol 1e-5.
    Fed the reference's audits, the port's board equals the reference's
    bytewise."""
    ref, _, _, _ = recorded
    port = carry(ref)
    kw = ({} if thresholds == "default" else
          dict(min_resid_count=1, violation_rate_threshold=0.0,
               resid_min_threshold=0.0))
    regs = {name: mods[0].MetricsRegistry() for name, mods in PKG.items()}
    boards = {name: mods[3].LeafHealthBoard(registry=regs[name], **kw)
              for name, mods in PKG.items()}
    cross_reg = t_metrics.MetricsRegistry()
    cross = t_health.LeafHealthBoard(registry=cross_reg, **kw)
    for b in range(4):
        q = queries_small[8 * b: 8 * (b + 1)]
        want = ref.search(q, k=5, quality_target=0.99, audit=True).audit
        got = port.search(q, k=5, quality_target=0.99, audit=True,
                          device="cpu").audit
        boards["ref"].record_audit(want, 8)
        boards["port"].record_audit(got, 8)
        cross.record_audit({k: np.asarray(v) for k, v in want.items()}, 8)
    jt, tt = (boards[n].window_totals() for n in ("ref", "port"))
    assert set(tt) == set(jt)
    for k in tt:
        if k in ("resid_sum", "resid_min"):
            finite = np.isfinite(jt[k])
            assert np.array_equal(finite, np.isfinite(tt[k])), k
            np.testing.assert_allclose(
                tt[k][finite], jt[k][finite], rtol=1e-5,
                atol=1e-5 * max(np.abs(jt[k][finite]).max(initial=0), 1))
        else:
            assert np.array_equal(tt[k], jt[k]), k
    jr, tr = (boards[n].filters_needing_attention() for n in ("ref", "port"))
    assert [(r.leaf, r.reasons) for r in tr] == \
        [(r.leaf, r.reasons) for r in jr]
    for a, b in zip(tr, jr):
        assert (a.violations, a.resid_count, a.shadow_misses,
                a.pruned_filter, a.scored) == \
            (b.violations, b.resid_count, b.shadow_misses, b.pruned_filter,
             b.scored)
        assert a.violation_rate == b.violation_rate
    if thresholds == "sensitive" and jt["violations"].sum() > 0:
        assert tr, "no leaf flagged at the sensitive thresholds"
    assert _board_state(cross, cross_reg) == \
        _board_state(boards["ref"], regs["ref"])
